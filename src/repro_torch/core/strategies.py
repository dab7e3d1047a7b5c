"""Pluggable layer-selection strategies (the paper's Alg. 2 line 3).

A **strategy** decides, per round, which freeze units each client
trains.  Contract: ``select_row(gen, ctx) -> (U,)`` 0/1 float32 over
freeze units, drawn from the ``torch.Generator`` the server owns.
``n_train`` is fixed per run, so masks have fixed sparsity and the comm
accounting is exact.

Registered: ``uniform`` (the paper's random subsets), ``fixed_last``
(transfer-learning baseline), ``full`` (conventional FedAvg), the
``synchronized`` wrapper, the deprecated ``weighted`` and the scored
family ``score_weighted``, ``depth_dropout`` and ``successive``.

**Stateful scored selection** (DESIGN.md §11): strategies that adapt to
live training signal set ``stateful = True`` and implement
``init_state`` / ``update_state`` over a :class:`SelectionState` (per-unit
gradient-norm EMA, per-unit train counts, round index).  The ``Server``
owns the state, threads it into the round step (where ``ctx.scores`` /
``ctx.state`` become the live values) and feeds ``update_state`` the
round's :class:`NormTelemetry`.  Stateless strategies ignore all of it.

The reference draws with JAX threefry keys, which have no torch twin.
Every draw goes through one of two sites — ``torch.randperm`` for a
uniform row and :meth:`SelectionStrategy.gumbel` for Gumbel top-k — so
a parity test can inject the reference's draws by overriding
``gumbel`` on an instance, or replay whole rows with :class:`Replay`.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import (ClassVar, Dict, NamedTuple, Optional, Tuple, Type,
                    Union)

import numpy as np
import torch

from .registry import unknown_name_message


class SelectionState(NamedTuple):
    """Per-run adaptive selection state (checkpointed), on the CPU.

    ``scores`` — (U,) float32 EMA of per-unit gradient norms;
    ``counts`` — (U,) float32 cumulative count of client updates that
    trained each unit; ``round`` — () int32 rounds completed.
    """
    scores: torch.Tensor
    counts: torch.Tensor
    round: torch.Tensor


class NormTelemetry(NamedTuple):
    """One round's aggregated gradient-norm signal.

    ``unit_sqnorm`` — (U,) weighted sum over contributing client updates
    of their per-unit squared gradient norms (summed over local steps);
    ``unit_count`` — (U,) the matching weighted count of updates that
    trained each unit; ``unit_raw_count`` — (U,) the unweighted count.
    Sync rounds weight participants by 1 (dropped clients 0), so the two
    counts are equal.
    """
    unit_sqnorm: torch.Tensor
    unit_count: torch.Tensor
    unit_raw_count: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SelectionContext:
    """Per-run facts a strategy may consult.

    Inside a scored round step, ``scores``/``state`` are swapped for the
    live :class:`SelectionState` values; outside one they keep their
    build-time values (``None`` by default).
    """
    n_clients: int
    n_units: int
    n_train: int                       # N_l in the paper
    scores: Optional[torch.Tensor] = None   # (U,) per-unit scores
    state: Optional[SelectionState] = None  # live state (scored rounds)
    score_ema: float = 0.9             # EMA decay for update_state


def _uniform_row(gen, ctx: SelectionContext) -> torch.Tensor:
    """Exactly n_train units, uniformly at random — the shared draw of
    ``uniform`` and every score strategy's no-signal degeneration, so
    "no scores" is bitwise ``uniform`` on the same generator."""
    perm = torch.randperm(ctx.n_units, generator=gen)
    return (perm < ctx.n_train).float()


def _topk_row(noise: torch.Tensor, ranking_scores: torch.Tensor,
              ctx: SelectionContext) -> torch.Tensor:
    """Gumbel top-k: exactly n_train units, without replacement, biased
    by ``ranking_scores``; ``noise`` is the row's (U,) Gumbel draw.  The
    stable sort breaks ties by unit index, as ``jnp.argsort`` does."""
    ranked = torch.argsort(-(ranking_scores.float() + noise), stable=True)
    row = torch.zeros(ctx.n_units, dtype=torch.float32)
    row[ranked[:ctx.n_train]] = 1.0
    return row


class SelectionStrategy:
    """Base class for layer-selection plugins.

    * ``stochastic`` — the row depends on the generator; False means the
      row is a pure function of the context and is broadcast to all
      clients.
    * ``dense`` — every unit is trained every round by construction (the
      ``full`` baseline): the round uses unmasked local training and
      plain FedAvg.
    * ``stateful`` — the strategy consumes per-round state: the server
      threads a :class:`SelectionState` through the round step and calls
      ``update_state`` once a round with that round's
      :class:`NormTelemetry` (``None`` on skipped or off-cadence rounds;
      the round counter still advances).
    * ``deprecated`` — a message; ``get_strategy`` warns with it.
    """

    name: ClassVar[str] = ""
    stochastic: ClassVar[bool] = True
    dense: ClassVar[bool] = False
    stateful: ClassVar[bool] = False
    deprecated: ClassVar[Optional[str]] = None

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

    def gumbel(self, gen: Optional[torch.Generator], n: int) -> torch.Tensor:
        """(n,) float32 standard Gumbel noise from ``gen`` — the draw site
        of every Gumbel top-k row.  Uniforms in [tiny, 1), as
        ``jax.random.gumbel`` draws them."""
        tiny = torch.finfo(torch.float32).tiny
        u = torch.rand(n, generator=gen).clamp_min(tiny)
        return -torch.log(-torch.log(u))

    # -- stateful contract (no-ops for stateless strategies) -------------

    def init_state(self, ctx: SelectionContext) -> Optional[SelectionState]:
        """Fresh state for a run, or None for stateless strategies."""
        return None

    def update_state(self, state: SelectionState, ctx: SelectionContext,
                     telemetry: Optional[NormTelemetry]) -> SelectionState:
        """Fold one round's telemetry into the state (ScoredStrategy)."""
        return state

    def __repr__(self):
        return f"{type(self).__name__}(name={self.name!r})"


class ScoredStrategy(SelectionStrategy):
    """Shared state engine of the score-driven strategies.

    ``scores`` is an EMA of observed per-unit gradient norms: a unit
    trained this round moves toward ``sqrt(sqnorm / count)`` with step
    ``(1 - ctx.score_ema) * confidence``, where ``confidence = count /
    raw_count`` (1 on a synchronous round).  A never-seen unit adopts
    its first observation outright; untrained units keep their score.
    ``counts`` accumulates the per-unit update counts, ``round`` the
    rounds completed.  All in float32 on the CPU.
    """

    stateful = True

    def init_state(self, ctx):
        u = ctx.n_units
        return SelectionState(scores=torch.zeros((u,), dtype=torch.float32),
                              counts=torch.zeros((u,), dtype=torch.float32),
                              round=torch.zeros((), dtype=torch.int32))

    def update_state(self, state, ctx, telemetry):
        new_round = state.round + 1
        if telemetry is None:
            return state._replace(round=new_round)
        sqn, cnt, raw = (torch.as_tensor(np.asarray(x, np.float32))
                         for x in telemetry)
        observed = cnt > 0
        norm = torch.sqrt(sqn / torch.clamp_min(cnt, 1e-9))
        conf = cnt / torch.clamp_min(raw, 1e-9)      # mean staleness factor
        step = (1 - ctx.score_ema) * conf
        seen_before = state.counts > 0
        ema = torch.where(seen_before,
                          (1 - step) * state.scores + step * norm, norm)
        return SelectionState(
            scores=torch.where(observed, ema, state.scores),
            counts=state.counts + cnt,
            round=new_round)

    @staticmethod
    def _round_index(ctx: SelectionContext) -> torch.Tensor:
        return (ctx.state.round if ctx.state is not None
                else torch.zeros((), dtype=torch.int32))


class Synchronized(SelectionStrategy):
    """All clients of a round share the inner strategy's subset."""

    def __init__(self, inner: SelectionStrategy):
        self.inner = inner
        self.name = f"synchronized({inner.name})"

    @property
    def dense(self):                       # type: ignore[override]
        return self.inner.dense

    @property
    def stateful(self):                    # type: ignore[override]
        return self.inner.stateful

    def select_row(self, gen, ctx):
        return self.inner.select_row(gen, ctx)

    def select(self, gen, ctx):
        row = self.inner.select_row(gen, ctx)
        return row.expand(ctx.n_clients, ctx.n_units).clone()

    def init_state(self, ctx):
        return self.inner.init_state(ctx)

    def update_state(self, state, ctx, telemetry):
        return self.inner.update_state(state, ctx, telemetry)


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


def unregister_strategy(name: str):
    _REGISTRY.pop(name, None)


def registered_strategies() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_strategy(name: str) -> SelectionStrategy:
    try:
        strat = _REGISTRY[name]
    except KeyError:
        raise UnknownStrategyError(unknown_name_message(
            "selection strategy", name, _REGISTRY)) from None
    if strat.deprecated:
        warnings.warn(f"selection strategy {name!r} is deprecated: "
                      f"{strat.deprecated}", DeprecationWarning,
                      stacklevel=2)
    return strat


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
        return _uniform_row(gen, ctx)


@register_strategy
class FixedLast(SelectionStrategy):
    """Transfer-learning baseline: always the last n_train units."""
    name = "fixed_last"
    stochastic = False

    def select_row(self, gen, ctx):
        return (torch.arange(ctx.n_units) >=
                ctx.n_units - ctx.n_train).float()


@register_strategy
class Weighted(SelectionStrategy):
    """Deprecated static-score selection (use ``score_weighted``).

    With explicit ``ctx.scores``: top-n_train by perturbed score (Gumbel
    top-k ∝ softmax(scores)).  With no scores it is bitwise ``uniform``
    (the shared draw).
    """
    name = "weighted"
    deprecated = ("static scores degenerate to uniform without a signal; "
                  "use 'score_weighted' (live gradient-norm EMAs)")

    def select_row(self, gen, ctx):
        if ctx.scores is None:
            return _uniform_row(gen, ctx)
        return _topk_row(self.gumbel(gen, ctx.n_units), ctx.scores, ctx)


@register_strategy
class Full(SelectionStrategy):
    """Conventional FedAvg baseline: every unit trained by every client."""
    name = "full"
    stochastic = False
    dense = True

    def select_row(self, gen, ctx):
        return torch.ones((ctx.n_units,), dtype=torch.float32)


@register_strategy
class ScoreWeighted(ScoredStrategy):
    """The paper's future-work variant: Gumbel top-k over live
    gradient-norm EMAs.

    Scores are standardized (population std) before ranking, so the
    selection pressure is scale-free, then perturbed with Gumbel noise:
    exactly n_train units, larger recent norms exponentially more
    likely.  With no live state attached (a bare ``build_round_step``
    with no server) it is bitwise ``uniform``.
    """
    name = "score_weighted"

    def select_row(self, gen, ctx):
        if ctx.scores is None:
            return _uniform_row(gen, ctx)
        s = torch.as_tensor(ctx.scores, dtype=torch.float32)
        z = (s - s.mean()) / (s.std(correction=0) + 1e-6)
        return _topk_row(self.gumbel(gen, ctx.n_units), z, ctx)


@register_strategy
class DepthDropout(ScoredStrategy):
    """Depth-biased keep probabilities à la Guo et al. 2023.

    Early rounds concentrate training on shallow units (a negative bias
    on depth) and the bias anneals linearly to uniform over ``horizon``
    rounds.  Realized as Gumbel top-k, so every round trains exactly
    n_train units.
    """
    name = "depth_dropout"
    horizon: ClassVar[int] = 64        # rounds to anneal to uniform
    strength: ClassVar[float] = 4.0    # initial shallow-vs-deep log-odds

    def select_row(self, gen, ctx):
        r = self._round_index(ctx).to(torch.float32)
        progress = torch.clamp(r / float(self.horizon), 0.0, 1.0)
        depth = torch.arange(ctx.n_units, dtype=torch.float32) \
            / float(max(ctx.n_units - 1, 1))
        bias = -(1.0 - progress) * self.strength * depth
        return _topk_row(self.gumbel(gen, ctx.n_units), bias, ctx)


@register_strategy
class Successive(ScoredStrategy):
    """Deterministic layer-wise growth à la Pfeiffer et al. 2023.

    Phase p trains the contiguous window of n_train units starting at
    ``p * n_train`` (clipped to the deep end, where it stays), advancing
    one phase every ``phase_rounds`` rounds; every client of a round
    trains the same window.
    """
    name = "successive"
    stochastic = False
    phase_rounds: ClassVar[int] = 4    # rounds per growth phase

    def select_row(self, gen, ctx):
        phase = int(self._round_index(ctx)) // self.phase_rounds
        start = min(phase * ctx.n_train, max(ctx.n_units - ctx.n_train, 0))
        idx = torch.arange(ctx.n_units)
        return ((idx >= start) & (idx < start + ctx.n_train)).float()


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
