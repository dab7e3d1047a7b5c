"""Synthetic stand-ins for the paper's datasets (offline container).

Pure numpy, copied from ``repro.data.synthetic`` so both packages draw
the same arrays from the same seed (held array-equal in the tests).

CIFAR-10 / IMDB / CASA are not downloadable here, so we generate
statistically-matched tasks with the same shapes and cardinalities and a
controllable amount of learnable structure — enough for the paper's
*trends* (partial-layer training ≈ full training) to be reproducible.
Absolute paper accuracies are not claimable (EXPERIMENTS.md §Paper-claims).

* cifar_like : class prototypes + noise, (32,32,3) float images, 10 cls
* imdb_like  : binary sentiment — class-indicative token distributions,
               length-100 int sequences, vocab 20k
* casa_like  : 30 "homes", Non-IID sizes and label mixes (Dirichlet),
               (100, 36) sensor sequences, 10 activities
* lm_tokens / lm_batch : Markov token streams for the zoo LMs (the
               training launcher's data)
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def cifar_like(n: int, *, key: int = 0, num_classes: int = 10,
               noise: float = 0.35) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(key)
    protos = rng.normal(0, 1, (num_classes, 32, 32, 3)).astype(np.float32)
    # low-frequency prototypes: smooth across space so convs can pick it up
    for _ in range(2):
        protos = (protos + np.roll(protos, 1, 1) + np.roll(protos, 1, 2)) / 3
    labels = rng.integers(0, num_classes, n)
    x = protos[labels] + rng.normal(0, noise, (n, 32, 32, 3)).astype(np.float32)
    return x.astype(np.float32), labels.astype(np.int32)


def imdb_like(n: int, *, key: int = 0, vocab: int = 20000, maxlen: int = 100,
              signal_tokens: int = 200) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(key)
    labels = rng.integers(0, 2, n)
    # Zipf background + class-indicative tokens sprinkled in
    base = rng.zipf(1.3, (n, maxlen)).clip(1, vocab - 1)
    pos_tokens = rng.integers(100, 100 + signal_tokens, (n, maxlen))
    neg_tokens = rng.integers(100 + signal_tokens, 100 + 2 * signal_tokens,
                              (n, maxlen))
    signal = np.where(labels[:, None] == 1, pos_tokens, neg_tokens)
    use_signal = rng.random((n, maxlen)) < 0.15
    x = np.where(use_signal, signal, base)
    return x.astype(np.int32), labels.astype(np.int32)


def casa_like(n_homes: int = 30, *, key: int = 0, num_classes: int = 10,
              features: int = 36, seq: int = 100,
              min_samples: int = 200, max_samples: int = 1200
              ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Per-home Non-IID datasets (sizes and label mixes vary)."""
    rng = np.random.default_rng(key)
    protos = rng.normal(0, 1, (num_classes, seq, features)).astype(np.float32)
    for _ in range(2):
        protos = (protos + np.roll(protos, 1, 1)) / 2
    homes = []
    for h in range(n_homes):
        n = int(rng.integers(min_samples, max_samples))
        mix = rng.dirichlet(np.full(num_classes, 0.5))
        labels = rng.choice(num_classes, n, p=mix)
        x = protos[labels] + rng.normal(0, 0.5, (n, seq, features))
        homes.append((x.astype(np.float32), labels.astype(np.int32)))
    return homes


def lm_tokens(n_seqs: int, seq_len: int, vocab: int, *, key: int = 0
              ) -> np.ndarray:
    """Markov token streams: next token ~ structured function of current.

    Cheap to sample at any vocab size and gives an LM a learnable signal
    (per-token bigram successor sets)."""
    rng = np.random.default_rng(key)
    # successor rule: t -> (a*t + b + small noise) mod vocab, 4 branches
    a = np.asarray([1, 3, 7, 11], np.int64)
    b = rng.integers(0, vocab, 4)
    x = np.empty((n_seqs, seq_len), np.int64)
    cur = rng.integers(0, vocab, n_seqs)
    for t in range(seq_len):
        x[:, t] = cur
        branch = rng.integers(0, 4, n_seqs)
        cur = (a[branch] * cur + b[branch]) % vocab
    return x.astype(np.int32)


def lm_batch(n_seqs: int, seq_len: int, vocab: int, *, key: int = 0
             ) -> Dict[str, np.ndarray]:
    toks = lm_tokens(n_seqs, seq_len + 1, vocab, key=key)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
