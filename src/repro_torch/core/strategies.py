"""Pluggable layer-selection strategies (the paper's Alg. 2 line 3).

A **strategy** decides, per round, which freeze units each client
trains.  Contract: ``select_row(gen, ctx) -> (U,)`` 0/1 float32 over
freeze units, drawn from the ``torch.Generator`` the server owns.
``n_train`` is fixed per run, so masks have fixed sparsity and the comm
accounting is exact.

Ported so far: ``uniform`` (the paper's random subsets), ``fixed_last``
(transfer-learning baseline), ``full`` (conventional FedAvg) and the
``synchronized`` wrapper.  The scored family (``score_weighted``,
``depth_dropout``, ``successive``) and the deprecated ``weighted`` wait
for a later slice.  The reference draws with JAX threefry keys, which
have no torch twin: the port's draws are held to the contract, and the
parity tests replay the reference's rows through a strategy instance.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, Optional, Type, Union

import numpy as np
import torch

from .registry import unknown_name_message


@dataclasses.dataclass(frozen=True)
class SelectionContext:
    """Static per-run facts a strategy may consult."""
    n_clients: int
    n_units: int
    n_train: int                       # N_l in the paper


class SelectionStrategy:
    """Base class for layer-selection plugins.

    * ``stochastic`` — the row depends on the generator; False means the
      row is a pure function of the context and is broadcast to all
      clients.
    * ``dense`` — every unit is trained every round by construction (the
      ``full`` baseline): the round uses unmasked local training and
      plain FedAvg.
    """

    name: ClassVar[str] = ""
    stochastic: ClassVar[bool] = True
    dense: ClassVar[bool] = False

    def select_row(self, gen: Optional[torch.Generator],
                   ctx: SelectionContext) -> torch.Tensor:
        raise NotImplementedError

    def select(self, gen: Optional[torch.Generator],
               ctx: SelectionContext) -> torch.Tensor:
        """(C, U) float32 selection matrix for one round (on the CPU).

        Stochastic strategies draw one row per client, in client order
        (paper semantics: independent per-client selection);
        deterministic ones broadcast a single row.
        """
        if not self.stochastic:
            row = self.select_row(gen, ctx)
            return row.expand(ctx.n_clients, ctx.n_units).clone()
        return torch.stack([self.select_row(gen, ctx)
                            for _ in range(ctx.n_clients)])

    def __repr__(self):
        return f"{type(self).__name__}(name={self.name!r})"


class Synchronized(SelectionStrategy):
    """All clients of a round share the inner strategy's subset."""

    def __init__(self, inner: SelectionStrategy):
        self.inner = inner
        self.name = f"synchronized({inner.name})"

    @property
    def dense(self):                       # type: ignore[override]
        return self.inner.dense

    def select(self, gen, ctx):
        row = self.inner.select_row(gen, ctx)
        return row.expand(ctx.n_clients, ctx.n_units).clone()


# ---------------------------------------------------------------------------
# registry

_REGISTRY: Dict[str, SelectionStrategy] = {}


class UnknownStrategyError(ValueError):
    pass


def register_strategy(obj: Union[Type[SelectionStrategy], SelectionStrategy],
                      *, name: Optional[str] = None):
    """Register a strategy class (instantiated with no args) or instance.
    Usable as a decorator."""
    strat = obj() if isinstance(obj, type) else obj
    key = name or strat.name
    if not key:
        raise ValueError(f"strategy {obj!r} has no name")
    _REGISTRY[key] = strat
    return obj


def get_strategy(name: str) -> SelectionStrategy:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise UnknownStrategyError(unknown_name_message(
            "selection strategy", name, _REGISTRY)) from None


def resolve_strategy(spec: Union[str, SelectionStrategy],
                     synchronized: bool = False) -> SelectionStrategy:
    """Name or instance -> instance, optionally wrapped in Synchronized."""
    strat = get_strategy(spec) if isinstance(spec, str) else spec
    if synchronized and not isinstance(strat, Synchronized) \
            and strat.stochastic:
        strat = Synchronized(strat)
    return strat


# ---------------------------------------------------------------------------
# built-in strategies (the paper's family)

@register_strategy
class Uniform(SelectionStrategy):
    """Exactly n_train units, uniformly at random per client (paper)."""
    name = "uniform"

    def select_row(self, gen, ctx):
        perm = torch.randperm(ctx.n_units, generator=gen)
        return (perm < ctx.n_train).float()


@register_strategy
class FixedLast(SelectionStrategy):
    """Transfer-learning baseline: always the last n_train units."""
    name = "fixed_last"
    stochastic = False

    def select_row(self, gen, ctx):
        return (torch.arange(ctx.n_units) >=
                ctx.n_units - ctx.n_train).float()


@register_strategy
class Full(SelectionStrategy):
    """Conventional FedAvg baseline: every unit trained by every client."""
    name = "full"
    stochastic = False
    dense = True

    def select_row(self, gen, ctx):
        return torch.ones((ctx.n_units,), dtype=torch.float32)


# the beyond-paper synchronized variant as a named plugin of its own
register_strategy(Synchronized(Uniform()), name="synchronized")


class Replay(SelectionStrategy):
    """Replays recorded ``(C, U)`` selection matrices, one per round, in
    order — e.g. the reference's ``sel_history``, so a port run trains
    exactly the units a reference run trained.  Not registered."""
    name = "replay"

    def __init__(self, rounds):
        self._rounds = [torch.tensor(np.array(s, np.float32))
                        for s in rounds]
        self._next = 0

    def select(self, gen, ctx):
        if self._next >= len(self._rounds):
            raise IndexError(f"replay strategy exhausted after "
                             f"{len(self._rounds)} rounds")
        sel = self._rounds[self._next].clone()
        if tuple(sel.shape) != (ctx.n_clients, ctx.n_units):
            raise ValueError(f"replayed selection has shape "
                             f"{tuple(sel.shape)}, the round needs "
                             f"{(ctx.n_clients, ctx.n_units)}")
        self._next += 1
        return sel
