"""Client data partitioning (IID and Dirichlet Non-IID) + round loaders.

Pure numpy, copied from ``repro.data.partition`` so both packages build
the same shards and round batches (held array-equal in the tests).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def iid_partition(n: int, n_clients: int, *, key: int = 0) -> List[np.ndarray]:
    """Equal-size disjoint shards (the paper's CIFAR/IMDB setting)."""
    rng = np.random.default_rng(key)
    idx = rng.permutation(n)
    per = n // n_clients
    return [idx[c * per:(c + 1) * per] for c in range(n_clients)]


def dirichlet_partition(labels: np.ndarray, n_clients: int, *,
                        alpha: float = 0.5, key: int = 0,
                        min_per_client: int = 8) -> List[np.ndarray]:
    """Label-skewed Non-IID shards (CASA-style heterogeneity)."""
    rng = np.random.default_rng(key)
    classes = np.unique(labels)
    shards: List[List[int]] = [[] for _ in range(n_clients)]
    for c in classes:
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet(np.full(n_clients, alpha))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for shard, part in zip(shards, np.split(idx, cuts)):
            shard.extend(part.tolist())
    out = []
    for shard in shards:
        if len(shard) < min_per_client:  # top up from the global pool
            extra = rng.integers(0, len(labels), min_per_client - len(shard))
            shard = shard + extra.tolist()
        out.append(np.asarray(shard))
    return out


class FederatedLoader:
    """Builds per-round (C, steps, B, ...) batch pytrees from client shards.

    Deterministic per (round, client): each client cycles its shard with a
    per-round shuffle, mirroring FEDn's one-epoch-per-round default.
    """

    def __init__(self, client_data: Sequence[Dict[str, np.ndarray]],
                 *, batch_size: int, steps_per_round: int, key: int = 0):
        self.client_data = list(client_data)
        self.batch_size = batch_size
        self.steps = steps_per_round
        self.key = key

    @property
    def n_clients(self) -> int:
        return len(self.client_data)

    def weights(self) -> np.ndarray:
        sizes = [len(next(iter(d.values()))) for d in self.client_data]
        return np.asarray(sizes, np.float32)

    def round_batches(self, rnd: int) -> Dict[str, np.ndarray]:
        return self.client_batches(rnd, range(self.n_clients))

    def client_batches(self, rnd: int,
                       client_ids: Sequence[int]) -> Dict[str, np.ndarray]:
        """Batches for a subset of clients: (len(ids), steps, B, ...).

        Each client's draw is a pure function of (key, round, client
        id), so a chunk of a sampled cohort gets bitwise the rows the
        full-fleet ``round_batches`` would have built — the cohort
        engine's loader contract (DESIGN.md §13), with host memory
        bounded by the chunk, not the fleet.
        """
        need = self.batch_size * self.steps
        per_client = []
        for ci in client_ids:
            ci = int(ci)
            data = self.client_data[ci]
            n = len(next(iter(data.values())))
            rng = np.random.default_rng((self.key, rnd, ci))
            idx = rng.permutation(n)
            if n < need:
                idx = np.concatenate(
                    [idx, rng.integers(0, n, need - n)])
            idx = idx[:need]
            per_client.append({k: v[idx].reshape(
                (self.steps, self.batch_size) + v.shape[1:])
                for k, v in data.items()})
        return {k: np.stack([pc[k] for pc in per_client])
                for k in per_client[0]}
