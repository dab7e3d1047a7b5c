"""FedBuff-style semi-asynchronous buffered aggregation (DESIGN.md §8),
PyTorch port.

The synchronous round loop stalls on the slowest client — the exact
straggler regime ``StragglerDropout`` simulates by discarding work.
Buffered async aggregation (Nguyen et al. 2022) keeps that work instead:
clients train on whatever global snapshot they last pulled, the server
buffers their **packed trained-slot deltas** as they arrive, and once
``FLConfig.async_buffer`` updates have accumulated the buffer flushes
into the global model as one "round".  Stale deltas are down-weighted by
a registered staleness rule (``@register_staleness``; the default is
FedBuff's polynomial ``1/(1+s)^a``).

Three properties anchor the design:

* **Buffering is cheap** because entries hold only the packed slot
  buffers of the round's trained units (DESIGN.md §7); they stay on the
  round's device.
* **A flush is a synchronous round in disguise**: it feeds the stacked
  buffer through the same ``masked_fedavg_packed`` /
  ``hierarchical_masked_fedavg_packed`` accumulate the sync packed round
  uses, with entries drained in canonical ``(client, seq)`` order — so a
  flush whose entries all carry zero staleness is **bitwise equal** to
  the synchronous packed round (codec included: the first dispatch
  draws its rounding uniforms from the server's codec generator in the
  sync round's order).
* **Everything is deterministic under a seed**: each version's
  selection comes off the server's generator, and the simulated-delay
  scheduler draws each client's latency as a pure function of
  ``(seed, client, seq)`` (numpy ``SeedSequence``, the reference's own
  draws) — clients report back out of order, but the same order every
  run, and checkpoint restore rebuilds the buffer, per-client round
  tags and in-flight work bit-exactly.

The engine computes client updates *eagerly at dispatch*: the first
dispatch trains the whole cohort, each later one only the client that
reported back (the reference runs its width-C vmapped trace each time
and keeps the dispatched rows; a client's row does not depend on the
others, so the port trains only the rows it keeps).  Under a codec each
dispatch is one grouped encode (K2 on the card).  Simulated wall-clock
comes from the scheduler, not host time.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..analysis.compileguard import CompileGuard
from ..common import TensorSpec, flatten_with_paths
from .registry import unknown_name_message

Tree = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# staleness reweighting registry (mirrors strategies/topologies)

_STALENESS: Dict[str, Callable[[np.ndarray, float], np.ndarray]] = {}


class UnknownStalenessError(ValueError):
    pass


def register_staleness(fn: Optional[Callable] = None, *,
                       name: Optional[str] = None):
    """Register ``fn(staleness, alpha) -> weight`` (vectorized over a
    float array of staleness values).  Usable bare or with ``name=``::

        @register_staleness
        def polynomial(s, alpha): ...
    """
    def _register(f):
        _STALENESS[name or f.__name__] = f
        return f
    return _register(fn) if fn is not None else _register


def unregister_staleness(name: str):
    _STALENESS.pop(name, None)


def registered_staleness() -> Tuple[str, ...]:
    return tuple(sorted(_STALENESS))


def get_staleness(name: str) -> Callable[[np.ndarray, float], np.ndarray]:
    try:
        return _STALENESS[name]
    except KeyError:
        raise UnknownStalenessError(unknown_name_message(
            "staleness rule", name, _STALENESS)) from None


@register_staleness
def polynomial(s: np.ndarray, alpha: float) -> np.ndarray:
    """FedBuff's polynomial decay ``1/(1+s)^alpha`` — exactly 1.0 at
    s=0, so a zero-staleness flush leaves client weights untouched."""
    return 1.0 / np.power(1.0 + np.asarray(s, np.float64), alpha)


@register_staleness
def constant(s: np.ndarray, alpha: float) -> np.ndarray:
    """No reweighting (FedAsync's naive baseline): stale deltas count
    at full weight."""
    return np.ones_like(np.asarray(s, np.float64))


def staleness_weights(weights: np.ndarray, staleness: np.ndarray,
                      rule: str, alpha: float) -> np.ndarray:
    """Per-entry effective weights: ``w * rule(s, alpha)`` in float64,
    rounded once to float32 (exact pass-through where the factor is 1)."""
    factor = get_staleness(rule)(np.asarray(staleness, np.float64), alpha)
    return (np.asarray(weights, np.float32) * factor).astype(np.float32)


# ---------------------------------------------------------------------------
# simulated-delay scheduler

_DELAY_DEFAULTS = {"none": 0.0, "fixed": 0.0, "exponential": 1.0,
                   "lognormal": 1.0, "pareto": 1.5}


def parse_delay_dist(spec: str) -> Tuple[str, float]:
    """``"name"`` or ``"name:param"`` -> (name, param).

    ``none``/``fixed`` — unit delay (deterministic completion order);
    ``exponential:scale`` — light tail; ``lognormal:sigma`` — moderate
    tail; ``pareto:alpha`` — heavy tail (the straggler regime; smaller
    alpha = heavier tail, delays ``1 + Pareto(alpha)``).
    """
    name, _, param = str(spec).partition(":")
    if name not in _DELAY_DEFAULTS:
        raise ValueError(
            f"unknown client_delay_dist {spec!r}; one of "
            f"{', '.join(sorted(_DELAY_DEFAULTS))} (optionally ':param')")
    return name, float(param) if param else _DELAY_DEFAULTS[name]


class DelayScheduler:
    """Seeded per-client latency model with **stateless** draws: the
    delay of client ``c``'s ``seq``-th dispatch is a pure function of
    ``(seed, c, seq)`` — no mutable RNG state, so checkpoint restore
    needs only the per-client dispatch counters to reproduce every
    future draw."""

    def __init__(self, dist: str = "none", seed: int = 0,
                 drop_prob: float = 0.0):
        self.dist, self.param = parse_delay_dist(dist)
        self.seed = int(seed)
        if not 0.0 <= drop_prob < 1.0:
            raise ValueError(
                f"drop_prob must be in [0, 1), got {drop_prob}")
        self.drop_prob = float(drop_prob)

    def dropped(self, client: int, seq: int) -> bool:
        """Permanent in-transit loss of client ``c``'s ``seq``-th update
        (not just delay).  Drawn in its own tag domain so enabling drops
        never shifts the delay draws — a drop_prob=0 run replays the
        plain scheduler bit-exactly without drawing at all."""
        if self.drop_prob <= 0.0:
            return False
        rng = np.random.default_rng(np.random.SeedSequence(
            (self.seed, 0xD70B, int(client), int(seq))))
        return float(rng.random()) < self.drop_prob

    def delay(self, client: int, seq: int) -> float:
        if self.dist in ("none", "fixed"):
            return 1.0
        rng = np.random.default_rng(
            np.random.SeedSequence((self.seed, int(client), int(seq))))
        if self.dist == "exponential":
            return 0.05 + float(rng.exponential(self.param))
        if self.dist == "lognormal":
            return float(rng.lognormal(0.0, self.param))
        # pareto: heavy-tailed with minimum 1 (a round never takes less
        # than one unit of work)
        return 1.0 + float(rng.pareto(self.param))


# ---------------------------------------------------------------------------
# buffered updates + the aggregator

@dataclasses.dataclass
class BufferedUpdate:
    """One client's completed dispatch: the packed trained-slot delta
    tagged with its origin version (the global model it trained from).
    ``pdelta``/``rows``/``valid`` are one client's slot trees on the
    round's device."""
    client: int
    seq: int                 # the client's dispatch counter (batch window)
    version: int             # global model version at dispatch time
    t_done: float            # simulated completion time
    weight: float            # data weight at dispatch (0 = dropped)
    loss: float
    sel_row: np.ndarray      # (U,) trained-unit selection
    pdelta: Tree             # packed (L, ...) slot deltas / dense scalars
    rows: Tree               # (L,) slot -> macro-row indices
    valid: Tree              # (L,) slot masks / scalar participation
    # per-unit squared gradient norms of this update's local training
    # (scored selection, DESIGN.md §11); None when scoring is off
    unit_sqnorm: Optional[np.ndarray] = None


def _stack_entries(entries: Sequence[BufferedUpdate]):
    """Stack per-entry trees into leading-B tensors (on their device)."""
    def stack(trees):
        return {p: torch.stack([t[p] for t in trees]) for p in trees[0]}
    return (stack([e.pdelta for e in entries]),
            stack([e.rows for e in entries]),
            stack([e.valid for e in entries]),
            torch.as_tensor(np.stack([e.sel_row for e in entries])))


class BufferedAggregator:
    """The FedBuff combiner role: hold packed updates, flush when full.

    ``flush_fn(global, pdeltas, rows, valid, sel, weights, client_ids)``
    is the topology's buffered aggregation (``build_buffered_flush``) —
    the same accumulate as the sync packed round.  Entries are drained
    in canonical ``(client, seq)`` order so the flush is independent of
    arrival order (and bit-equal to a synchronous round when every
    entry has zero staleness).
    """

    def __init__(self, buffer_size: int, staleness: str, alpha: float,
                 flush_fn: Callable, gated: bool = False):
        if buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got {buffer_size}")
        get_staleness(staleness)          # fail fast on unknown rules
        self.buffer_size = buffer_size
        self.staleness = staleness
        self.alpha = alpha
        # gated flush_fns (the validation gate wrapped around the
        # topology's buffered aggregation, session.py) return
        # (new_params, quarantined) instead of bare params
        self.gated = gated
        self._flush = CompileGuard(flush_fn, name="async_flush",
                                   max_programs=1)
        self.entries: List[BufferedUpdate] = []
        # duplicate-delivery defense: per-client seq watermark.  Each
        # client has at most one dispatch in flight, so its seqs arrive
        # strictly increasing — any (client, seq) at or below the
        # watermark is a redelivery and is rejected
        self._last_seq: Dict[int, int] = {}

    def __len__(self) -> int:
        return len(self.entries)

    @property
    def ready(self) -> bool:
        return len(self.entries) >= self.buffer_size

    def push(self, update: BufferedUpdate) -> bool:
        """Accept ``update`` into the buffer; False = duplicate
        delivery (seq at/below the client's watermark), discarded."""
        last = self._last_seq.get(update.client)
        if last is not None and update.seq <= last:
            return False
        self._last_seq[update.client] = update.seq
        self.entries.append(update)
        return True

    def flush(self, global_params: Tree, version: int
              ) -> Tuple[Tree, Dict[str, Any]]:
        """Apply the buffered updates to ``global_params`` and clear."""
        entries = sorted(self.entries, key=lambda e: (e.client, e.seq))
        self.entries = []
        s = np.asarray([version - e.version for e in entries], np.float64)
        w = np.asarray([e.weight for e in entries], np.float32)
        factor = get_staleness(self.staleness)(s, self.alpha)
        eff = (w * factor).astype(np.float32)
        pdeltas, rows, valid, sel = _stack_entries(entries)
        clients = np.asarray([e.client for e in entries], np.int32)
        out = self._flush(global_params, pdeltas, rows, valid, sel,
                          torch.from_numpy(eff), clients)
        if self.gated:
            new_params, quarantined = out
        else:
            new_params, quarantined = out, None
        stats = {
            "entry_sel": sel.numpy(),
            "entry_clients": clients,
            "staleness": s,
            "staleness_factor": factor,
            "effective_weights": eff,
            "losses": np.asarray([e.loss for e in entries], np.float32),
        }
        if quarantined is not None:
            stats["quarantined"] = np.asarray(quarantined.cpu(), np.float32)
        if all(e.unit_sqnorm is not None for e in entries):
            stats["entry_sqnorm"] = np.stack(
                [np.asarray(e.unit_sqnorm, np.float32) for e in entries])
        return new_params, stats


# ---------------------------------------------------------------------------
# the round pieces

def build_cohort_step(loss_fn: Callable, assign, fl,
                      loss_kwargs: Optional[Dict] = None, *,
                      strategy=None, scores=None):
    """The async engine's two round pieces.

    Returns ``(select_fn, cohort_fn, n_slots)``:

    * ``select_fn(gen, sel_state=None) -> sel (C, U)`` — the version's
      per-client trained-unit selection, drawn from ``gen`` (the
      server's generator); stateful (scored) strategies select against
      the server's live :class:`SelectionState`;
    * ``cohort_fn(global_params, sel, client_batches, *, uniform=None,
      codec_state=None, codec_decay=None) -> (pdeltas, rows, valid,
      metrics)`` — the sync packed round's packed local training for
      the K clients of ``sel (K, U)`` / ``client_batches (K, steps,
      ...)``, then the codec (one grouped encode for the K clients),
      **without** the aggregation stage (that happens at flush time,
      from the buffer).  ``metrics`` carries per-client ``loss_mean``,
      for stateful strategies the ``unit_sqnorm`` telemetry, and under
      a stateful codec the K clients' new residual ``codec_state``
      (``codec_state`` in: those K clients' residual rows,
      ``codec_decay`` their (K,) staleness factors).

    Local training is ``client.packed_cohort_fn`` — the loop the sync
    packed round runs — so a client's row here is bitwise the row the
    synchronous round would have computed.
    """
    from . import codecs as _codecs
    from .client import packed_cohort_fn
    from .masking import cohort_slot_plans
    from .topology import _cohort_runner, _live_ctx, _selection_setup
    strat, ctx = _selection_setup(assign, fl, strategy, scores)
    if strat.dense:
        raise ValueError(
            "async buffered rounds carry packed trained-slot deltas; the "
            "dense 'full' strategy has nothing to pack — use a partial "
            "strategy (train_fraction < 1)")
    n_slots = fl.resolve_n_slots(ctx.n_units)
    scoring = strat.stateful
    cohort_stage = packed_cohort_fn(loss_fn, assign, fl, loss_kwargs,
                                    scoring=scoring)
    # codec axis (core/codecs.py): encode/decode at dispatch time — the
    # buffer holds DECODED deltas (billing uses encoded wire bytes)
    codec_fn = _codecs.build_codec_transform(
        _codecs.resolve_codec(fl.codec), assign, fl)
    runner: Dict[str, Any] = {}          # the cohort runner, built on the
    #                                      params' device at first use

    def select(gen, sel_state=None):
        sel = strat.select(gen, _live_ctx(ctx, sel_state))
        if fl.always_train_head:
            sel[:, -1] = 1.0
        return sel

    def cohort(global_params, sel, client_batches, *, uniform=None,
               codec_state=None, codec_decay=None):
        k = sel.shape[0]
        rows, valid = cohort_slot_plans(assign, sel, n_slots,
                                        global_params)
        dev = next(iter(global_params.values())).device
        if "shards" not in runner:
            runner["shards"] = _cohort_runner(fl, dev)
        # with client shards a dispatch of fewer clients than shards leaves
        # some ranks' blocks empty: they train nothing and take the rows
        pdeltas, metrics = runner["shards"].run(
            cohort_stage, global_params, rows, valid, client_batches)
        rows = {p: r.to(dev) for p, r in rows.items()}
        valid = {p: v.to(dev) for p, v in valid.items()}
        out = {"loss_mean": metrics["loss_mean"]}
        if scoring:
            out["unit_sqnorm"] = metrics["unit_sqnorm"]
        if codec_fn is not None:
            # residual gating for dispatched-vs-not happens at the
            # engine (it merges only dispatched clients' rows back), so
            # every row here counts as an upload
            pdeltas, new_state = codec_fn(pdeltas, rows, valid,
                                          torch.ones(k), uniform,
                                          codec_state, codec_decay)
            if new_state is not None:
                out["codec_state"] = new_state
        return pdeltas, rows, valid, out

    # the reference runs every dispatch at the cohort's full width (one
    # program); this one trains only the dispatched clients, so the
    # cohort piece sees two signatures: all C clients at the first fill,
    # one client at every refill
    return (CompileGuard(select, name="async_select", max_programs=1),
            CompileGuard(cohort, name="async_cohort", max_programs=2),
            n_slots)


def slot_template(assign, params, n_slots: int) -> Dict[str, Any]:
    """TensorSpecs of one packed update's ``pdelta``/``rows``/``valid``
    trees — the single source of buffered-entry shapes for flush specs
    and checkpoint restore templates."""
    out: Dict[str, Dict[str, TensorSpec]] = {"pdelta": {}, "rows": {},
                                              "valid": {}}
    for path, p in flatten_with_paths(params):
        shape = tuple(p.shape)
        if assign.leaf_units[path].kind == "scalar":
            out["pdelta"][path] = TensorSpec(shape, p.dtype)
            out["rows"][path] = TensorSpec((0,), torch.int64)
            out["valid"][path] = TensorSpec((), torch.float32)
        else:
            n = min(shape[0], n_slots)
            out["pdelta"][path] = TensorSpec((n,) + shape[1:], p.dtype)
            out["rows"][path] = TensorSpec((n,), torch.int64)
            out["valid"][path] = TensorSpec((n,), torch.float32)
    return out


def flush_arg_specs(assign, params, fl) -> Tuple[Any, ...]:
    """TensorSpecs of one flush call's buffer arguments: ``(pdeltas,
    rows, valid, sel, weights, client_ids)`` for a full buffer."""
    tpl = slot_template(assign, params, fl.resolve_n_slots(assign.n_units))
    b = fl.async_buffer

    def lead(tree):
        return {p: TensorSpec((b,) + x.shape, x.dtype)
                for p, x in tree.items()}
    return (lead(tpl["pdelta"]), lead(tpl["rows"]), lead(tpl["valid"]),
            TensorSpec((b, assign.n_units), torch.float32),
            TensorSpec((b,), torch.float32),
            TensorSpec((b,), torch.int32))


# ---------------------------------------------------------------------------
# the engine

class AsyncRoundEngine:
    """Drives FedBuff-style semi-async rounds for a :class:`Server`.

    One engine "round" = one buffer flush.  Between flushes the
    simulated-delay scheduler pops client completions in time order;
    each completion pushes its packed update into the buffer and
    immediately re-dispatches the client against the *current* global
    model (so in-flight work goes stale exactly when flushes land
    mid-flight).  Each version's selection comes off the server's
    generator — a zero-staleness flush draws exactly the selection the
    sync round would have.

    Under a stochastic codec the rounding uniforms come from the
    server's codec generator (``Server.codec_uniform``) in dispatch
    order.  ``codec_draw``, when set, replaces that draw:
    ``codec_draw(dispatch, clients, i, shape)`` gets the dispatch
    counter and the dispatched clients (the parity tests inject the
    reference's uniforms through it).
    """

    def __init__(self, server, assign, fl, *, select_fn, cohort_fn,
                 flush_fn, seed: int = 0, gated: bool = False):
        from . import codecs as _codecs
        self.server = server
        self.assign = assign
        self.fl = fl
        self.select_fn = select_fn
        self.cohort_fn = cohort_fn
        self.n_slots = fl.resolve_n_slots(assign.n_units)
        self.buffer = BufferedAggregator(fl.async_buffer, fl.staleness,
                                         fl.staleness_alpha, flush_fn,
                                         gated=gated)
        self.scheduler = DelayScheduler(fl.client_delay_dist, seed=seed,
                                        drop_prob=fl.client_drop_prob)
        # codec axis: the dispatch counter (checkpointed, in the
        # reference's format); a stateful codec's EF residual lives on
        # the Server — the engine merges back only the rows of clients
        # it dispatched, and tracks per-client residual age for
        # staleness decay
        self.codec = _codecs.resolve_codec(fl.codec)
        self.codec_draw: Optional[Callable] = None
        self._codec_dispatch = 0
        self._codec_version = (np.zeros(fl.n_clients, np.int64)
                               if self.codec.stateful else None)
        # bytes clients uploaded since the last flush that never landed
        # in the buffer (in-transit loss, crashes, rejected duplicates)
        self._wasted = 0.0
        self.started = False
        self.version = 0
        self.clock = 0.0
        self.seq = np.zeros(fl.n_clients, np.int64)
        self.pending: List[Tuple[float, int, int]] = []   # (t, client, seq)
        self.inflight: Dict[Tuple[int, int], BufferedUpdate] = {}
        self.flush_clients: List[np.ndarray] = []
        self._sel: Optional[np.ndarray] = None

    # -- dispatch ---------------------------------------------------------

    def _begin_version(self):
        st = self.server.sel_state
        # scored strategies select against the live state — stale
        # in-flight work keeps the selection its dispatch version saw
        sel = self.select_fn(self.server.generator, st)
        self._sel = np.asarray(sel, np.float32)

    def _dispatch(self, clients: Sequence[int], weights: np.ndarray,
                  batch_fn: Callable[[int], Any]):
        """Start local training for ``clients`` at the current version,
        each client on its own batch window: one packed local update per
        client and, under a codec, one grouped encode for them all."""
        clients = [int(c) for c in clients]
        server = self.server
        batches = _mixed_window_batches(batch_fn, self.seq, clients)
        gp = server.global_params()
        sel = torch.as_tensor(self._sel[clients])
        kw: Dict[str, Any] = {}
        idx = None
        if self.codec.name != "none":
            d = self._codec_dispatch
            self._codec_dispatch += 1
            if self.codec.stochastic:
                kw["uniform"] = server.codec_uniform \
                    if self.codec_draw is None else \
                    (lambda i, shape: self.codec_draw(d, clients, i, shape))
            if self.codec.stateful:
                idx = torch.as_tensor(clients, dtype=torch.long)
                kw["codec_state"] = {
                    p: x.index_select(0, idx.to(x.device))
                    for p, x in server.codec_state.items()}
                kw["codec_decay"] = torch.as_tensor(
                    self._codec_decay()[clients])
        pdeltas, rows, valid, mets = self.cohort_fn(gp, sel, batches, **kw)
        if idx is not None:
            # only dispatched clients transmitted: merge their residual
            # rows back
            new_state = mets.pop("codec_state")
            server.codec_state = {
                p: x.index_copy(0, idx.to(x.device), new_state[p])
                for p, x in server.codec_state.items()}
            self._codec_version[clients] = self.version
        losses = mets["loss_mean"].float().cpu().numpy()
        sqnorm = mets.get("unit_sqnorm")
        if sqnorm is not None:
            sqnorm = sqnorm.float().cpu().numpy()
        for j, c in enumerate(clients):
            seq = int(self.seq[c])
            t_done = self.clock + self.scheduler.delay(c, seq)
            upd = BufferedUpdate(
                client=c, seq=seq, version=self.version, t_done=t_done,
                weight=float(weights[c]), loss=float(losses[j]),
                sel_row=self._sel[c].copy(),
                pdelta={p: x[j] for p, x in pdeltas.items()},
                rows={p: x[j] for p, x in rows.items()},
                valid={p: x[j] for p, x in valid.items()},
                unit_sqnorm=None if sqnorm is None else sqnorm[j].copy())
            heapq.heappush(self.pending, (t_done, c, seq))
            self.inflight[(c, seq)] = upd
            self.seq[c] += 1

    # -- the flush loop ---------------------------------------------------

    def run_flush(self, batch_fn: Callable[[int], Any], weights):
        from .server import RoundRecord
        server = self.server
        t0 = time.perf_counter()
        r = len(server.history)
        w = torch.as_tensor(weights, dtype=torch.float32).cpu()
        for hook in server.hooks:
            new_w = hook.on_round_start(server, r, w)
            if new_w is not None:
                w = new_w
        w_np = np.asarray(w, np.float32)
        if not self.started:
            self.started = True
            self._begin_version()
            self._dispatch(range(self.fl.n_clients), w_np, batch_fn)
        trigger = None
        inj = server.fault_injector
        while not self.buffer.ready:
            t_done, c, seq = heapq.heappop(self.pending)
            self.clock = max(self.clock, t_done)
            upd = self.inflight.pop((c, seq))
            if self.scheduler.dropped(c, seq) or \
                    (inj is not None and inj.crashed_async(c, seq)):
                # the update never arrives (in-transit loss / client
                # crash): the client's upload is wasted work and the
                # engine re-dispatches it against the current version
                self._wasted += self._entry_bytes(upd)
                self._dispatch([c], w_np, batch_fn)
                continue
            if inj is not None:
                upd = inj.perturb_update(upd)     # torn/corrupt delivery
                accepted = self.buffer.push(upd)
                if accepted and inj.duplicated(c, seq) \
                        and not self.buffer.push(upd):
                    # duplicate delivery: the redelivered bytes crossed
                    # the WAN, the watermark defense rejected them
                    self._wasted += self._entry_bytes(upd)
            else:
                self.buffer.push(upd)
            if self.buffer.ready:
                trigger = c           # re-dispatched at the NEW version
            else:
                self._dispatch([c], w_np, batch_fn)
        new_params, stats = self.buffer.flush(server.global_params(),
                                              self.version)
        server.params = new_params    # star topologies: state == params
        self.version += 1
        # stale telemetry decays with the SAME staleness factor the
        # aggregation applied to its delta; the state must advance
        # before the next version's selection is drawn
        server.update_sel_state(self._flush_telemetry(r, stats))
        self._begin_version()
        if trigger is not None:
            self._dispatch([trigger], w_np, batch_fn)

        ev = None
        if server.eval_fn is not None:
            ev = float(server.eval_fn(server.global_params()))
        s = stats["staleness"]
        eff = stats["effective_weights"]
        rec = RoundRecord(
            r, float(stats["losses"].mean()), ev,
            time.perf_counter() - t0, 0.0, 0.0,
            # like the sync loop: dropped (weight-0) entries aggregate
            # nothing and don't count as participants
            n_participants=int(np.unique(
                stats["entry_clients"][eff > 0]).size),
            effective_weights=[float(x) for x in eff],
            staleness_mean=float(s.mean()), staleness_max=float(s.max()),
            sim_time=float(self.clock))
        server.sel_history.append(stats["entry_sel"])
        self.flush_clients.append(stats["entry_clients"])
        metrics = {"entry_sel": stats["entry_sel"],
                   "entry_clients": stats["entry_clients"],
                   "staleness": s, "loss_per_entry": stats["losses"],
                   "dropped_bytes": self._wasted}
        if "quarantined" in stats:
            metrics["quarantined"] = stats["quarantined"]
        self._wasted = 0.0     # billed to this flush's record
        for hook in server.hooks:
            hook.on_round_end(server, rec, metrics)
        rec.seconds = time.perf_counter() - t0
        server.history.append(rec)
        return rec

    def _codec_decay(self) -> np.ndarray:
        """(C,) residual staleness factors: a client's EF residual ages
        by the model versions since it last transmitted, decayed by the
        run's registered staleness rule (the same rule the aggregation
        applies to stale deltas; 1.0 at age 0, matching the sync path)."""
        rule = get_staleness(self.fl.staleness)
        age = np.maximum(self.version - self._codec_version, 0)
        return rule(age.astype(np.float64),
                    self.fl.staleness_alpha).astype(np.float32)

    def _entry_bytes(self, upd: BufferedUpdate) -> float:
        """Upload cost of one packed update (the client's trained-unit
        bytes at *encoded* wire width — hub math; good enough for the
        wasted-bytes column)."""
        return float((np.asarray(upd.sel_row, np.float32)
                      * self.server.wire_unit_bytes()).sum())

    def _flush_telemetry(self, flush_idx: int, stats: Dict[str, Any]):
        """One flush's staleness-weighted NormTelemetry, or None.

        Each buffered entry's per-unit squared norms and unit counts
        are weighted by its staleness factor (dropped entries — data
        weight 0 — excluded); the unweighted counts ride along so
        ``ScoredStrategy.update_state`` can scale its EMA step by the
        weighted/raw ratio — a stale update moves the score EMA by the
        same factor the aggregation applied to its delta.
        """
        if self.server.sel_state is None or "entry_sqnorm" not in stats \
                or flush_idx % self.fl.score_every != 0:
            return None
        from .strategies import NormTelemetry
        active = (stats["effective_weights"] > 0)
        if "quarantined" in stats:
            # a quarantined entry's delta was discarded by the gate;
            # its telemetry must not steer selection scores either
            active = active & (stats["quarantined"] <= 0)
        f = np.where(active, stats["staleness_factor"],
                     0.0).astype(np.float32)
        raw = active.astype(np.float32)
        return NormTelemetry(
            unit_sqnorm=(stats["entry_sqnorm"] * f[:, None]).sum(0),
            unit_count=(stats["entry_sel"] * f[:, None]).sum(0),
            unit_raw_count=(stats["entry_sel"] * raw[:, None]).sum(0))

    def run(self, flushes: int, batch_fn: Callable[[int], Any],
            weights=None, log_every: int = 0):
        from .server import RoundLogger
        server = self.server
        if weights is None:
            weights = torch.ones((self.fl.n_clients,))
        extra = [RoundLogger(log_every,
                             total=len(server.history) + flushes,
                             base=len(server.history))] if log_every else []
        server.hooks.extend(extra)
        try:
            for _ in range(flushes):
                self.run_flush(batch_fn, weights)
        finally:
            for h in extra:
                server.hooks.remove(h)
        for hook in server.hooks:
            hook.on_fit_end(server, server.history)
        return server.history

    # -- run-level accounting --------------------------------------------

    def comm_summary(self) -> Dict[str, float]:
        from . import comm
        server = self.server
        if not server.sel_history:
            return {"avg_uplink_bytes": 0.0, "avg_trained_params": 0.0,
                    "total_uplink_bytes": 0.0, "reduction_vs_full": 0.0,
                    "total_wasted_bytes": 0.0, "avg_wasted_bytes": 0.0}
        ub = server.unit_bytes()
        # flushed uplink bills at encoded wire width; the reduction
        # denominator (a full fp32 entry per buffered slot) stays fp32
        # so the reported reduction composes freeze × codec
        wub = server.wire_unit_bytes()
        counts = comm.unit_param_counts(self.assign, server.global_params())
        ups, fulls, tps = [], [], []
        for entry_sel, clients, rec in zip(server.sel_history,
                                           self.flush_clients,
                                           server.history):
            es = np.asarray(entry_sel)
            eff = np.asarray(rec.effective_weights, np.float32)
            es = es * (eff > 0).astype(es.dtype)[:, None]
            ups.append(server.topology.buffered_round_bytes(
                es, clients, wub, self.fl)["uplink"])
            fulls.append(server.topology.buffered_round_bytes(
                np.ones_like(es), clients, ub, self.fl)["uplink"])
            tps.append(float(np.einsum("bu,u->", es, counts)))
        total_full = float(np.sum(fulls))
        return {
            "avg_uplink_bytes": float(np.mean(ups)),
            "avg_trained_params": float(np.mean(tps)),
            "total_uplink_bytes": float(np.sum(ups)),
            "reduction_vs_full": 1.0 - float(np.sum(ups)) / total_full
            if total_full else 0.0,
            "avg_staleness": float(np.mean(
                [r.staleness_mean for r in server.history])),
            "sim_time": float(self.clock),
            "total_wasted_bytes": float(np.sum(
                [r.wasted_bytes for r in server.history])),
            "avg_wasted_bytes": float(np.mean(
                [r.wasted_bytes for r in server.history])),
        }

    # -- checkpoint state (ckpt/store.py) ---------------------------------

    def entry_template(self, scored: bool) -> Dict[str, Any]:
        """TensorSpecs of one buffered update's arrays, in the port's
        layout (``ckpt/store.py`` converts conv kernels)."""
        tpl: Dict[str, Any] = slot_template(
            self.assign, self.server.global_params(), self.n_slots)
        u = self.assign.n_units
        tpl["sel_row"] = TensorSpec((u,), torch.float32)
        if scored:
            tpl["unit_sqnorm"] = TensorSpec((u,), torch.float32)
        return tpl

    @staticmethod
    def _update_meta(u: BufferedUpdate) -> Dict[str, Any]:
        return {"client": int(u.client), "seq": int(u.seq),
                "version": int(u.version), "t_done": float(u.t_done),
                "weight": float(u.weight), "loss": float(u.loss)}

    @staticmethod
    def _update_arrays(u: BufferedUpdate) -> Dict[str, Any]:
        out = {"pdelta": u.pdelta, "rows": u.rows, "valid": u.valid,
               "sel_row": u.sel_row}
        if u.unit_sqnorm is not None:
            out["unit_sqnorm"] = u.unit_sqnorm
        return out

    def checkpoint_state(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(json metadata, arrays) capturing buffer contents, per-client
        round tags and in-flight (delay-scheduled) work; the metadata is
        the reference's, field for field."""
        inflight = [self.inflight[k] for k in sorted(self.inflight)]
        meta = {
            "version": int(self.version),
            "clock": float(self.clock),
            "seq": [int(x) for x in self.seq],
            "scored": self.server.sel_state is not None,
            "buffer": [self._update_meta(u) for u in self.buffer.entries],
            "inflight": [self._update_meta(u) for u in inflight],
            "flush_clients": [np.asarray(c).tolist()
                              for c in self.flush_clients],
            # fault-axis state: the dedup watermark and wasted bytes
            # accumulated since the last flush
            "last_seq": {str(c): int(s)
                         for c, s in self.buffer._last_seq.items()},
            "wasted_pending": float(self._wasted),
        }
        if self.codec.name != "none":
            # codec-axis replay state: the dispatch counter, plus
            # (stateful codecs) each client's residual age
            meta["codec_dispatch"] = int(self._codec_dispatch)
            if self.codec.stateful:
                meta["codec_version"] = [int(x)
                                         for x in self._codec_version]
        arrays = {
            "sel": self._sel,
            "buffer": [self._update_arrays(u) for u in self.buffer.entries],
            "inflight": [self._update_arrays(u) for u in inflight],
        }
        return meta, arrays

    def arrays_template(self, meta: Dict[str, Any]) -> Dict[str, Any]:
        tpl = self.entry_template(bool(meta.get("scored")))
        return {
            "sel": TensorSpec((self.fl.n_clients, self.assign.n_units),
                              torch.float32),
            "buffer": [tpl for _ in meta["buffer"]],
            "inflight": [tpl for _ in meta["inflight"]],
        }

    def restore_state(self, meta: Dict[str, Any], arrays: Dict[str, Any]):
        """Rebuild the engine from :meth:`checkpoint_state`'s pair (the
        arrays as tensors of the port's layout; slot trees are moved to
        the server's device)."""
        dev = self.server.device

        def on_dev(tree):
            return {p: torch.as_tensor(x).to(dev) for p, x in tree.items()}

        def updates(metas, arrs):
            out = []
            for m, a in zip(metas, arrs):
                out.append(BufferedUpdate(
                    client=int(m["client"]), seq=int(m["seq"]),
                    version=int(m["version"]), t_done=float(m["t_done"]),
                    weight=float(m["weight"]), loss=float(m["loss"]),
                    sel_row=np.asarray(a["sel_row"], np.float32),
                    pdelta=on_dev(a["pdelta"]), rows=on_dev(a["rows"]),
                    valid=on_dev(a["valid"]),
                    unit_sqnorm=np.asarray(a["unit_sqnorm"], np.float32)
                    if "unit_sqnorm" in a else None))
            return out

        if len(meta["buffer"]) >= self.buffer.buffer_size:
            raise ValueError(
                f"checkpoint buffer holds {len(meta['buffer'])} entries, "
                f">= this run's async_buffer={self.buffer.buffer_size}; "
                "restore with the original buffer size")
        if self.codec.name != "none" and "codec_dispatch" not in meta:
            raise ValueError(
                f"this run uses codec {self.codec.name!r} but the "
                "checkpoint carries no codec replay state; restore with "
                "the codec the checkpoint was written under")
        if self.codec.name == "none" and "codec_dispatch" in meta:
            raise ValueError(
                "checkpoint carries codec replay state but this run has "
                "codec 'none'; restore with the original codec config")
        if self.codec.stateful and "codec_version" not in meta:
            raise ValueError(
                f"stateful codec {self.codec.name!r} needs the "
                "checkpoint's per-client residual ages (codec_version); "
                "this checkpoint has none")
        self._codec_dispatch = int(meta.get("codec_dispatch", 0))
        if self.codec.stateful:
            self._codec_version = np.asarray(meta["codec_version"],
                                             np.int64)
        self.version = int(meta["version"])
        self.clock = float(meta["clock"])
        self.seq = np.asarray(meta["seq"], np.int64)
        self.buffer._last_seq = {int(c): int(s) for c, s in
                                 meta.get("last_seq", {}).items()}
        self._wasted = float(meta.get("wasted_pending", 0.0))
        self._sel = np.asarray(arrays["sel"], np.float32)
        self.buffer.entries = updates(meta["buffer"], arrays["buffer"])
        self.inflight = {(u.client, u.seq): u
                         for u in updates(meta["inflight"],
                                          arrays["inflight"])}
        self.pending = [(u.t_done, u.client, u.seq)
                        for u in self.inflight.values()]
        heapq.heapify(self.pending)
        self.flush_clients = [np.asarray(c, np.int32)
                              for c in meta["flush_clients"]]
        self.started = True


def _mixed_window_batches(batch_fn: Callable[[int], Any],
                          windows: Sequence[int],
                          clients: Optional[Sequence[int]] = None
                          ) -> Dict[str, torch.Tensor]:
    """Assemble a (K, steps, ...) batch for ``clients`` (all of
    ``windows``' clients when None) where client ``c`` rides its OWN
    batch window ``windows[c]`` (clients progress through their local
    streams at their own pace in async rounds).

    ``batch_fn(w)`` returns the full-cohort batches of window ``w``
    (the sync loop's per-round loader contract).
    """
    clients = range(len(windows)) if clients is None else clients
    pairs = [(int(c), int(windows[c])) for c in clients]
    per = {w: batch_fn(w) for w in sorted({w for _, w in pairs})}
    keys = per[pairs[0][1]].keys()
    return {k: torch.stack([torch.as_tensor(per[w][k][c]) for c, w in pairs])
            for k in keys}
