"""Layer-selection helpers (paper Alg. 2 line 3) — thin wrappers.

The strategies themselves live in ``core/strategies.py`` as registered
plugins; this module keeps the functional API for call sites that think
in terms of one selection draw, and the paper's fraction settings.
Each draw takes the ``torch.Generator`` it draws from where the
reference takes a key.
"""
from __future__ import annotations

from typing import Optional

import torch

from .strategies import SelectionContext, get_strategy, resolve_strategy


def _ctx(n_clients: int, n_units: int, n_train: int,
         scores: Optional[torch.Tensor] = None) -> SelectionContext:
    if scores is not None:
        scores = torch.as_tensor(scores, dtype=torch.float32)
    return SelectionContext(n_clients=n_clients, n_units=n_units,
                            n_train=n_train, scores=scores)


def select_uniform(gen: Optional[torch.Generator], n_units: int,
                   n_train: int) -> torch.Tensor:
    """(U,) 0/1 — exactly n_train randomly chosen units."""
    return get_strategy("uniform").select_row(
        gen, _ctx(1, n_units, n_train))


def select_fixed_last(n_units: int, n_train: int) -> torch.Tensor:
    return get_strategy("fixed_last").select_row(
        None, _ctx(1, n_units, n_train))


def select_weighted(gen: Optional[torch.Generator], n_units: int,
                    n_train: int, scores) -> torch.Tensor:
    """Top-n_train by perturbed score (Gumbel top-k ∝ softmax(scores))."""
    return get_strategy("weighted").select_row(
        gen, _ctx(1, n_units, n_train, scores))


def select_clients(gen: Optional[torch.Generator], n_clients: int,
                   n_units: int, n_train: int, *, strategy: str = "uniform",
                   synchronized: bool = False, scores=None) -> torch.Tensor:
    """(C, U) 0/1 selection matrix for one round.

    ``synchronized=True`` gives every client the same subset; otherwise
    each client draws its own row from ``gen``, in client order.
    """
    strat = resolve_strategy(strategy, synchronized)
    return strat.select(gen, _ctx(n_clients, n_units, n_train, scores))


def n_train_from_fraction(n_units: int, fraction: float) -> int:
    """The paper's 25%/50%/75% settings -> unit counts (at least 1)."""
    return max(1, round(n_units * fraction))
