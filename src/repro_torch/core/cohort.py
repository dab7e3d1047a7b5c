"""Fleet-scale cohort engine: chunk-streamed rounds over a registered
client fleet (DESIGN.md §13), PyTorch port.

The synchronous loop materializes the whole cohort at once: one
``(C, steps, ...)`` batch tree, every client's packed deltas, one
aggregate.  That couples *how many clients exist* to *how much memory
one round takes*.  This module breaks the coupling along three axes:

* **Registered fleet vs. in-flight cohort** (``FLConfig.n_registered``):
  the server knows R clients but trains an ``n_clients``-sized cohort
  per round.  Host state per registered client is O(1) scalars — the
  :class:`FleetState` loss/grad-norm EMAs — never a batch or a delta.
* **Chunk streaming** (``FLConfig.cohort_chunk``): the cohort flows
  through the round in fixed-size chunks, each chunk's packed uploads
  folded into a partial aggregate carried across chunks
  (``aggregation.packed_accumulate``).  Because the accumulate adds
  clients one by one in cohort order, *any* chunking is
  **bitwise-equal** to the single-shot round.
* **Client-sampling plugin axis** (``@register_client_sampler``):
  which R-fleet members form the round's cohort.  ``uniform`` draws
  without replacement (Floyd); ``loss_proportional`` and
  ``telemetry_driven`` Gumbel-top-k against the fleet's loss /
  gradient-norm EMAs.

Randomness.  The reference seeds its samplers with the raw words of a
threefry key (``fold_in(sampler_base, round)``); the port has no
threefry, so a sampler takes its **key words as an input**: the engine
derives two uint32 words per round from ``(seed, round)`` with a numpy
``SeedSequence`` (``CohortEngine.sampler_words``, which the parity tests
replace with the reference's words), and the Floyd draw from the words
is the reference's, verbatim.  The scored samplers' Gumbel rows come
from :meth:`ClientSampler.gumbel`, which a test overrides on an instance.
Sampler draws never touch the server's generator, so with R == C the
cohort is the identity and the engine's rounds are bitwise the plain
loop's.  Under a stochastic codec each cohort position's rounding
uniforms come from a device generator seeded by ``(seed, round,
position)`` — a stateless stream, so any chunking encodes every client
with the same uniforms (chunk 4 == chunk 8, bitwise) and a mid-round
checkpoint needs no codec state.  ``CohortEngine.codec_draw`` replaces
that draw in the parity tests.

The engine mirrors ``Server.run_round``'s observable contract — the
round's selection drawn from the server's generator after the start
hooks, as the plain loop draws it; the same hook call points; the same
``RoundRecord``/``sel_history``/telemetry layout — so every
``ServerHook`` composes unchanged.
"""
from __future__ import annotations

import dataclasses
import time
from typing import (Any, Callable, ClassVar, Dict, List, Optional, Sequence,
                    Tuple, Type, Union)

import numpy as np
import torch

from ..analysis.compileguard import CompileGuard
from ..common import TensorSpec
from .registry import unknown_name_message

# the reference's sampler-stream tag (fold_in(PRNGKey(seed), 0x0C0F0E))
SAMPLER_TAG = 0x0C0F0E


# ---------------------------------------------------------------------------
# fleet state: O(1) host scalars per registered client

@dataclasses.dataclass
class FleetState:
    """Per-registered-client signals the samplers read.

    All ``(R,)`` numpy arrays — the ONLY per-registered-client host
    state the engine keeps (batches and deltas exist per cohort chunk
    only), which is what bounds host memory at fleet scale.
    """
    loss_ema: np.ndarray      # (R,) EMA of the client's round mean loss
    norm_ema: np.ndarray      # (R,) EMA of the client's total grad norm
    counts: np.ndarray        # (R,) participation counts (0 = unseen)
    round: int = 0            # rounds the fleet has advanced through


def fleet_init(n_registered: int) -> FleetState:
    return FleetState(loss_ema=np.zeros((n_registered,), np.float32),
                      norm_ema=np.zeros((n_registered,), np.float32),
                      counts=np.zeros((n_registered,), np.int32))


@dataclasses.dataclass(frozen=True)
class CohortContext:
    """What a sampler sees when drawing a round's cohort."""
    n_registered: int
    cohort: int
    fleet: FleetState


# ---------------------------------------------------------------------------
# client-sampler registry (mirrors strategies/topologies)

class ClientSampler:
    """Base class for cohort-sampling plugins.

    ``sample(words, ctx)`` returns the round's cohort as a **sorted**
    ``(cohort,)`` array of unique registered-client ids, drawn from the
    round's key ``words`` (a list of uint32 ints).  Sorted order is
    load-bearing: with R == C every sampler then returns ``arange(C)``
    and the engine's rounds are bitwise the plain loop's.
    ``needs_norms`` turns the per-unit gradient-norm hook on inside
    local training so :class:`FleetState.norm_ema` gets fed.
    """

    name: ClassVar[str] = ""
    needs_norms: ClassVar[bool] = False

    def sample(self, words, ctx: CohortContext) -> np.ndarray:
        raise NotImplementedError

    def gumbel(self, words, n: int) -> np.ndarray:
        """(n,) float64 standard Gumbel noise for the scored draw — the
        one draw site a parity test overrides with the reference's
        rows.  The port's own: ``-log(-log(u))`` of a Philox stream
        seeded by the words."""
        rng = np.random.Generator(np.random.Philox(
            np.random.SeedSequence([int(w) for w in words] + [0x6E3B])))
        u = rng.random(n)
        return -np.log(-np.log(np.clip(u, 1e-300, 1.0 - 1e-16)))

    def __repr__(self):
        return f"{type(self).__name__}(name={self.name!r})"


_SAMPLERS: Dict[str, ClientSampler] = {}


class UnknownClientSamplerError(ValueError):
    pass


def register_client_sampler(obj: Union[Type[ClientSampler], ClientSampler],
                            *, name: Optional[str] = None):
    """Register a sampler class (instantiated with no args) or instance.
    Usable as a decorator."""
    sampler = obj() if isinstance(obj, type) else obj
    key = name or sampler.name
    if not key:
        raise ValueError(f"client sampler {obj!r} has no name")
    _SAMPLERS[key] = sampler
    return obj


def unregister_client_sampler(name: str):
    _SAMPLERS.pop(name, None)


def registered_client_samplers() -> Tuple[str, ...]:
    return tuple(sorted(_SAMPLERS))


def get_client_sampler(name: str) -> ClientSampler:
    try:
        return _SAMPLERS[name]
    except KeyError:
        raise UnknownClientSamplerError(unknown_name_message(
            "client sampler", name, _SAMPLERS)) from None


def resolve_client_sampler(spec: Union[str, ClientSampler, None]
                           ) -> ClientSampler:
    """Name or instance -> instance (None -> the uniform default)."""
    if spec is None:
        return get_client_sampler("uniform")
    return get_client_sampler(spec) if isinstance(spec, str) else spec


def _uniform_draw(words, n_registered: int, cohort: int) -> np.ndarray:
    """O(cohort) uniform draw without replacement (Floyd's algorithm).

    Floyd's F2 touches exactly ``cohort`` draws: for j in R-C..R-1 pick
    t uniform on [0, j], take t unless already taken, else take j.
    Exactly uniform over C-subsets, O(C) time and memory, independent of
    R.  The key ``words`` plus the tag ``0xF107D`` seed a numpy
    ``SeedSequence`` driving a ``Philox`` generator, as in the
    reference, so on the reference's words the draw is the reference's.
    With cohort == n_registered the draw is the identity ``arange``
    (the R == C bitwise anchor).
    """
    if cohort >= n_registered:
        return np.arange(n_registered, dtype=np.int32)
    rng = np.random.Generator(np.random.Philox(
        np.random.SeedSequence([int(w) for w in words] + [0xF107D])))
    # vectorized pre-draw: t_j ~ U[0, j] for j = R-C .. R-1
    ts = rng.integers(0, np.arange(n_registered - cohort,
                                   n_registered) + 1)
    chosen: set = set()
    for j, t in zip(range(n_registered - cohort, n_registered), ts):
        t = int(t)
        chosen.add(j if t in chosen else t)
    return np.asarray(sorted(chosen), np.int32)


def _scored_draw(words, signal: np.ndarray, seen: np.ndarray, cohort: int,
                 gumbel: Callable[[Any, int], np.ndarray]) -> np.ndarray:
    """Gumbel-top-k draw ∝ softmax of the z-scored signal.

    Unseen clients take the *maximum* seen signal (optimistic
    initialization: every fleet member gets sampled eventually), and
    with no signal at all the draw degrades to uniform on the same
    words.  ``gumbel(words, n)`` is the noise.
    """
    if not seen.any():
        return _uniform_draw(words, signal.shape[0], cohort)
    s = np.where(seen, signal, signal[seen].max()).astype(np.float64)
    z = (s - s.mean()) / (s.std() + 1e-6)
    g = np.asarray(gumbel(words, s.shape[0]), np.float64)
    top = np.argsort(-(z + g), kind="stable")[:cohort]
    return np.sort(top).astype(np.int32)


@register_client_sampler
class UniformSampler(ClientSampler):
    """Uniform without replacement — the FedAvg default."""
    name = "uniform"

    def sample(self, words, ctx):
        return _uniform_draw(words, ctx.n_registered, ctx.cohort)


@register_client_sampler
class LossProportionalSampler(ClientSampler):
    """Prefer clients whose recent loss EMA is high (they have the most
    to learn from another round)."""
    name = "loss_proportional"

    def sample(self, words, ctx):
        return _scored_draw(words, ctx.fleet.loss_ema,
                            ctx.fleet.counts > 0, ctx.cohort, self.gumbel)


@register_client_sampler
class TelemetryDrivenSampler(ClientSampler):
    """Prefer clients whose gradient-norm EMA is high — the fleet-level
    analogue of score-weighted unit selection (DESIGN.md §11), fed by
    the same norm-hook telemetry."""
    name = "telemetry_driven"
    needs_norms = True

    def sample(self, words, ctx):
        return _scored_draw(words, ctx.fleet.norm_ema,
                            ctx.fleet.counts > 0, ctx.cohort, self.gumbel)


# ---------------------------------------------------------------------------
# the round pieces

@dataclasses.dataclass
class CohortPrograms:
    """The engine's four round pieces plus resolved plugins.

    * ``select(gen[, sel_state]) -> sel (C, U)`` — the round's
      per-client trained-unit selection (bitwise the sync round's);
    * ``acc_init(global) -> acc`` — the zero partial aggregate;
    * ``chunk(global, acc, sel_chunk, w_chunk, positions, batches, *,
      mode=None, scale=None, uniform=None) -> (acc, {"loss"[,
      "unit_sqnorm"][, "quarantined"]})`` — one chunk's packed local
      training, codec (one grouped encode a chunk), corruption and gate,
      folded into the carry in place;
    * ``finalize(global, acc, sel, weights, losses) -> (new_global,
      loss_mean)`` — full-cohort denominators + the round loss.
    """
    select: Callable
    acc_init: Callable
    chunk: Callable
    finalize: Callable
    sampler: ClientSampler
    strategy: Any
    scoring: bool
    n_slots: int


def build_cohort_programs(loss_fn: Callable, assign, fl,
                          loss_kwargs: Optional[Dict] = None, *,
                          strategy=None, scores=None,
                          topology=None) -> CohortPrograms:
    """Build the chunk-streamed round's pieces.

    The chunk piece is the sync packed round's packed local training
    (``client.packed_cohort_fn``) followed by ``Topology.build_chunk_agg``'s
    accumulate.  Streaming every chunk and finalizing is bitwise the
    single-shot ``masked_fedavg_packed`` by construction: the accumulate
    adds clients one by one in cohort order, and splitting that loop
    across calls changes nothing about its float-add order.
    """
    from . import codecs as _codecs
    from . import faults as _faults
    from .aggregation import gate_packed_updates
    from .client import packed_cohort_fn
    from .masking import cohort_slot_plans
    from .topology import (_cohort_runner, _live_ctx, _selection_setup,
                           resolve_topology)
    topo = resolve_topology(topology if topology is not None
                            else fl.topology)
    strat, ctx = _selection_setup(assign, fl, strategy, scores)
    if strat.dense:
        raise ValueError(
            "the chunked cohort engine carries packed trained-slot "
            "deltas; the dense 'full' strategy has nothing to pack — "
            "use a partial strategy (train_fraction < 1)")
    sampler = resolve_client_sampler(fl.client_sampler)
    n_slots = fl.resolve_n_slots(ctx.n_units)
    scoring = strat.stateful or sampler.needs_norms
    acc_init, accumulate, finalize_agg = topo.build_chunk_agg(assign, fl)
    cohort = packed_cohort_fn(loss_fn, assign, fl, loss_kwargs,
                              scoring=scoring)

    def select(gen, sel_state=None):
        sel = strat.select(gen, _live_ctx(ctx, sel_state))
        if fl.always_train_head:
            sel[:, -1] = 1.0
        return sel

    inject_on = _faults.delta_faults_configured(fl)
    gate_on = _faults.gate_enabled(fl)
    codec_fn = _codecs.build_codec_transform(
        _codecs.resolve_codec(fl.codec), assign, fl)
    runner: Dict[str, Any] = {}          # the chunk's cohort runner, built
    #                                      on the params' device at first use

    def chunk_step(global_params, acc, sel_chunk, w_chunk, positions,
                   batches, *, mode=None, scale=None, uniform=None):
        k = sel_chunk.shape[0]
        rows, valid = cohort_slot_plans(assign, sel_chunk, n_slots,
                                        global_params)
        dev = next(iter(global_params.values())).device
        if "shards" not in runner:
            runner["shards"] = _cohort_runner(fl, dev)
        pdeltas, metrics = runner["shards"].run(cohort, global_params, rows,
                                                valid, batches)
        rows = {p: r.to(dev) for p, r in rows.items()}
        valid = {p: v.to(dev) for p, v in valid.items()}
        out = {"loss": metrics["loss_mean"]}
        if scoring:
            out["unit_sqnorm"] = metrics["unit_sqnorm"]
        # uplink codec (DESIGN.md §16) between local training and the
        # fault axis, so wire corruption hits what crossed the WAN.
        # Only stateless codecs reach this path — FLConfig rejects the
        # error-feedback codec × cohort engine combination up front.
        if codec_fn is not None:
            pdeltas, _ = codec_fn(pdeltas, rows, valid, w_chunk, uniform)
        # fault axis (DESIGN.md §14): corruption + validation gate —
        # both bitwise identities when untripped, so zero-rate chaos
        # keeps chunked == single-shot == plain bitwise
        if inject_on:
            if mode is None:
                mode = torch.zeros((k,), dtype=torch.int32)
                scale = torch.ones((k,))
            pdeltas = _faults.chaos_inject(pdeltas, mode, scale)
        if gate_on:
            pdeltas, w_chunk, quar = gate_packed_updates(
                assign, pdeltas, valid, w_chunk, fl.max_delta_norm)
            out["quarantined"] = quar
        acc = accumulate(acc, pdeltas, rows, valid, w_chunk, positions)
        return acc, out

    def finalize(global_params, acc, sel, weights, losses):
        new_params = finalize_agg(global_params, acc, sel, weights)
        # the same mean over the same (C,) values the sync round
        # reduces, so the recorded loss is bitwise the sync round's
        return new_params, losses.mean()

    # CompileGuard pins each piece to one input signature across the
    # round's chunks and across rounds; the chunk folds into its carry
    # (argument 1) in place
    return CohortPrograms(
        select=CompileGuard(select, name="cohort_select", max_programs=1),
        acc_init=CompileGuard(acc_init, name="cohort_acc_init",
                              max_programs=1),
        chunk=CompileGuard(chunk_step, name="cohort_chunk", max_programs=1,
                           donate_argnums=(1,)),
        finalize=CompileGuard(finalize, name="cohort_finalize",
                              max_programs=1),
        sampler=sampler, strategy=strat, scoring=scoring, n_slots=n_slots)


def _seed_words(*coords: int) -> List[int]:
    """Two uint32 words, a pure function of ``coords`` (numpy
    ``SeedSequence``): the port's stand-in for a threefry key."""
    return [int(w) for w in np.random.SeedSequence(
        [int(c) for c in coords]).generate_state(2, np.uint32)]


# ---------------------------------------------------------------------------
# the engine

class CohortEngine:
    """Drives chunk-streamed rounds over a registered fleet.

    A round is three phases — ``begin_round`` (sample the cohort, draw
    the selection, zero the partial aggregate), ``step_chunk`` × the
    chunk count (stream one chunk's batches through packed local
    training into the carry), ``finish_round`` (full-cohort finalize,
    record, telemetry, fleet EMAs) — composed by ``run_round``/``run``.
    Memory in flight is O(chunk) batches and deltas + O(cohort)
    selection rows + one packed accumulator, regardless of R.

    ``batch_fn(round_idx, client_ids) -> (len(ids), steps, ...)`` tree
    is the loader contract (``FederatedLoader.client_batches``).

    ``sampler_words(round) -> words`` and ``codec_draw(round,
    positions, i, shape) -> uniforms`` are the engine's two draw sites
    (module docstring); the parity tests replace them with the
    reference's draws.

    Checkpointing: ``checkpoint_state``/``restore_state`` carry the
    fleet EMAs and — mid-round — the partial aggregate, streamed-chunk
    counter, cohort ids/selection/weights and per-chunk losses, so a
    restore at any chunk boundary resumes bitwise.
    """

    def __init__(self, server, assign, fl, *, programs: CohortPrograms,
                 seed: int = 0):
        from . import codecs as _codecs
        self.server = server
        self.assign = assign
        self.fl = fl
        self.programs = programs
        self.seed = int(seed)
        self.n_registered = fl.n_registered or fl.n_clients
        self.chunk = fl.cohort_chunk or fl.n_clients
        self.n_chunks = fl.n_clients // self.chunk
        self.fleet = fleet_init(self.n_registered)
        self.codec = _codecs.resolve_codec(fl.codec)
        self.sampler_words: Callable[[int], List[int]] = \
            lambda r: _seed_words(self.seed, SAMPLER_TAG, r)
        self.codec_draw: Optional[Callable] = None
        self._partial: Optional[Dict[str, Any]] = None

    @property
    def started(self) -> bool:
        return self.fleet.round > 0 or self._partial is not None

    def _chunk_uniform(self, r: int, positions: Sequence[int]):
        """The chunk's ``uniform(i, shape)``: leaf i's rows, client by
        client, each from its cohort position's own stream."""
        if self.codec_draw is not None:
            return lambda i, shape: self.codec_draw(r, list(positions), i,
                                                    shape)
        dev = self.server.device
        gens = []
        for pos in positions:
            g = torch.Generator(device=dev)
            g.manual_seed(int(np.random.SeedSequence(
                (self.seed, 0xC0DEC, int(r), int(pos))).generate_state(
                    1, np.uint64)[0]) & ((1 << 63) - 1))
            gens.append(g)

        def uniform(i, shape):
            rows = shape[0] // len(gens)
            return torch.cat([torch.rand((rows,) + tuple(shape[1:]),
                                         generator=g, device=dev)
                              for g in gens])
        return uniform

    # -- the three phases -------------------------------------------------

    def begin_round(self, weights=None) -> Dict[str, Any]:
        server = self.server
        if self._partial is not None:
            raise RuntimeError(
                "a cohort round is already in flight; stream its "
                "remaining chunks and finish_round() first")
        r = len(server.history)
        t0 = time.perf_counter()
        ids = np.asarray(self.programs.sampler.sample(
            self.sampler_words(r),
            CohortContext(self.n_registered, self.fl.n_clients,
                          self.fleet)), np.int32)
        # crash-resilient cohort assembly (DESIGN.md §14): crashed
        # members are resampled from the rest of the registered fleet
        # with bounded jittered backoff; slots that exhaust their
        # retries degrade to zero-weight holes (partial round)
        dead: List[int] = []
        inj = server.fault_injector
        if inj is not None and inj.crash_prob > 0.0:
            ids, dead = self._resample_crashed(r, ids)
        c = self.fl.n_clients
        if weights is None:
            w = torch.ones((c,))
        else:
            wr = np.asarray(torch.as_tensor(weights).cpu(), np.float32)
            if wr.shape[0] == c:
                w = torch.as_tensor(wr)
            elif wr.shape[0] == self.n_registered:
                w = torch.as_tensor(wr[ids])  # fleet weights -> cohort view
            else:
                raise ValueError(
                    f"weights must have length n_clients={c} (cohort) or "
                    f"n_registered={self.n_registered} (fleet), got "
                    f"{wr.shape[0]}")
        if dead:
            mask = np.ones((c,), np.float32)
            mask[dead] = 0.0
            w = w * torch.as_tensor(mask)
        for hook in server.hooks:
            new_w = hook.on_round_start(server, r, w)
            if new_w is not None:
                w = new_w
        w_np = np.asarray(w, np.float32)
        n_part = int(np.count_nonzero(w_np))
        p: Dict[str, Any] = {
            "round": r, "t0": t0, "ids": ids, "w": torch.as_tensor(w_np),
            "eff_w": [float(x) for x in w_np], "n_part": n_part,
            "chunk": 0, "losses": [], "sqnorms": [], "quars": [],
            "skipped": n_part == 0, "sel": None, "acc": None,
        }
        if n_part:
            # the round's selection from the server's generator, as the
            # plain loop draws it (a skipped round draws nothing, as the
            # plain loop's skipped round calls no round step)
            st = server.sel_state
            p["sel"] = self.programs.select(server.generator, st)
            p["acc"] = self.programs.acc_init(server.global_params())
        self._partial = p
        return p

    def _resample_crashed(self, r: int,
                          ids: np.ndarray) -> Tuple[np.ndarray, List[int]]:
        """Replace crashed cohort members with freshly sampled fleet
        clients (bounded attempts via ``common/retry.py``); returns the
        repaired ids and the positions that stayed dead."""
        from ..common.retry import Backoff, retry_call
        from .faults import ClientCrashed
        inj = self.server.fault_injector
        ids = np.array(ids, np.int32)
        taken = {int(i) for i in ids}
        dead: List[int] = []
        backoff = Backoff(attempts=max(1, self.fl.fault_retries),
                          seed=inj.seed)
        for pos in range(ids.shape[0]):
            if not inj.crashed(r, int(ids[pos])):
                continue
            taken.discard(int(ids[pos]))

            def attempt(k, _pos=pos):
                cand = inj.resample(r, _pos, k, self.n_registered,
                                    frozenset(taken))
                if cand is None or inj.crashed(r, cand):
                    raise ClientCrashed(
                        f"round {r} slot {_pos}: no live replacement "
                        f"on attempt {k}")
                return cand

            try:
                # simulated time: the jittered backoff schedule bounds
                # attempts but nobody really sleeps (sleep=None)
                new = retry_call(attempt, backoff=backoff,
                                 retry_on=(ClientCrashed,),
                                 token=(r, pos), sleep=None)
                ids[pos] = new
                taken.add(int(new))
            except ClientCrashed:
                dead.append(pos)
        return ids, dead

    def step_chunk(self, batch_fn: Callable[[int, np.ndarray], Any]):
        p = self._partial
        if p is None:
            raise RuntimeError("no cohort round in flight; begin_round "
                               "first")
        if p["skipped"]:
            return
        j = p["chunk"]
        if j >= self.n_chunks:
            raise RuntimeError(
                f"all {self.n_chunks} chunks of round {p['round']} are "
                "already streamed; finish_round()")
        lo, hi = j * self.chunk, (j + 1) * self.chunk
        pos = np.arange(lo, hi)
        batches = batch_fn(p["round"], p["ids"][pos])
        inj = self.server.fault_injector
        chunk_kw: Dict[str, Any] = {}
        if inj is not None and inj.has_delta:
            # the corruption plan is a pure function of (seed, round,
            # client id) — recomputed here, never checkpointed
            plan = inj.corrupt_plan(p["round"], p["ids"][pos])
            chunk_kw = {"mode": torch.as_tensor(plan["mode"]),
                        "scale": torch.as_tensor(plan["scale"])}
        if self.codec.stochastic:
            chunk_kw["uniform"] = self._chunk_uniform(p["round"], pos)
        acc, mets = self.programs.chunk(
            self.server.global_params(), p["acc"], p["sel"][lo:hi],
            p["w"][lo:hi], pos, batches, **chunk_kw)
        p["acc"] = acc
        p["losses"].append(mets["loss"])
        if "unit_sqnorm" in mets:
            p["sqnorms"].append(mets["unit_sqnorm"].float().cpu().numpy())
        if "quarantined" in mets:
            p["quars"].append(np.asarray(mets["quarantined"].cpu(),
                                         np.float32))
        p["chunk"] = j + 1

    def finish_round(self):
        from .server import RoundRecord
        p = self._partial
        if p is None:
            raise RuntimeError("no cohort round in flight; begin_round "
                               "first")
        server = self.server
        r = p["round"]
        c = self.fl.n_clients
        t0 = p["t0"]
        if p["skipped"]:
            # loss 0.0 (NOT NaN): a skipped round must never leak NaN
            # into loss summaries / EMA consumers downstream
            rec = RoundRecord(r, 0.0, None,
                              time.perf_counter() - t0, 0.0, 0.0,
                              n_participants=0, skipped=True,
                              dropped=True, effective_weights=p["eff_w"])
            server.sel_history.append(
                np.zeros((c, self.assign.n_units), np.float32))
            metrics = None
        else:
            if p["chunk"] != self.n_chunks:
                raise RuntimeError(
                    f"round {r} has streamed {p['chunk']}/"
                    f"{self.n_chunks} chunks; step_chunk the rest first")
            losses = torch.cat(p["losses"]) if len(p["losses"]) > 1 \
                else p["losses"][0]
            w_fin = p["w"]
            quar_full = None
            if p["quars"]:
                quar_full = np.concatenate(p["quars"])
                # quarantined clients already accumulated with weight 0
                # per chunk; zero them in the full-cohort denominator too
                w_fin = w_fin * torch.as_tensor(1.0 - quar_full)
            new_params, loss_mean = self.programs.finalize(
                server.global_params(), p["acc"], p["sel"], w_fin, losses)
            server.params = new_params   # star topologies: state==params
            server.sel_history.append(np.asarray(p["sel"], np.float32))
            metrics = {"loss_mean": loss_mean,
                       "loss_per_client": losses.float().cpu(),
                       "sel": p["sel"]}
            if p["sqnorms"]:
                metrics["unit_sqnorm"] = torch.as_tensor(
                    np.concatenate(p["sqnorms"], axis=0))
            if quar_full is not None:
                metrics["quarantined"] = quar_full
            ev = None
            if server.eval_fn is not None:
                ev = float(server.eval_fn(server.global_params()))
            rec = RoundRecord(r, float(loss_mean), ev,
                              time.perf_counter() - t0, 0.0, 0.0,
                              n_participants=p["n_part"],
                              effective_weights=p["eff_w"])
        # selection-state telemetry BEFORE end-of-round hooks, exactly
        # like the sync loop (a Checkpointer hook must save post-round
        # state for bit-exact mid-fit resume)
        server.update_sel_state(server._round_telemetry(r, metrics,
                                                        p["eff_w"]))
        self._update_fleet(p, metrics)
        # clear the in-flight round BEFORE end hooks: a ChaosHook kill
        # must not leave a completed round marked partial, or the resumed
        # run would double-apply it
        self._partial = None
        for hook in server.hooks:
            hook.on_round_end(server, rec, metrics)
        rec.seconds = time.perf_counter() - t0
        server.history.append(rec)
        server._trim_history()
        return rec

    def _update_fleet(self, p: Dict[str, Any],
                      metrics: Optional[Dict]) -> None:
        """Fold the round into the fleet EMAs at the *sampled* ids.
        Dropped clients (effective weight 0) contributed nothing and
        update nothing, matching the aggregation and sel-state rules."""
        f = self.fleet
        if metrics is not None:
            active = np.asarray(p["eff_w"], np.float32) > 0
            if "quarantined" in metrics:
                # a quarantined upload contributed nothing to the model;
                # its (possibly poisoned) telemetry must not steer the
                # sampler either
                active &= np.asarray(metrics["quarantined"],
                                     np.float32) <= 0
            act = p["ids"][active]
            if act.size:
                e = self.fl.sampler_ema
                seen = f.counts[act] > 0
                loss = np.asarray(metrics["loss_per_client"],
                                  np.float32)[active]
                f.loss_ema[act] = np.where(
                    seen, e * f.loss_ema[act] + (1.0 - e) * loss, loss)
                if "unit_sqnorm" in metrics:
                    norm = np.asarray(metrics["unit_sqnorm"],
                                      np.float32)[active].sum(axis=1)
                    f.norm_ema[act] = np.where(
                        seen, e * f.norm_ema[act] + (1.0 - e) * norm,
                        norm)
                f.counts[act] += 1
        f.round += 1

    # -- composed loops ---------------------------------------------------

    def run_round(self, batch_fn: Callable[[int, np.ndarray], Any],
                  weights=None):
        """One full round; resumes a restored mid-round partial (whose
        hooks and draws already happened) instead of re-beginning."""
        if self._partial is None:
            self.begin_round(weights)
        p = self._partial
        while not p["skipped"] and p["chunk"] < self.n_chunks:
            self.step_chunk(batch_fn)
        return self.finish_round()

    def run(self, rounds: int, batch_fn: Callable[[int, np.ndarray], Any],
            weights=None, log_every: int = 0):
        from .server import RoundLogger
        server = self.server
        extra = [RoundLogger(log_every,
                             total=len(server.history) + rounds,
                             base=len(server.history))] if log_every else []
        server.hooks.extend(extra)
        try:
            for _ in range(rounds):
                self.run_round(batch_fn, weights)
        finally:
            for h in extra:
                server.hooks.remove(h)
        for hook in server.hooks:
            hook.on_fit_end(server, server.history)
        return server.history

    # -- checkpoint state (ckpt/store.py) ---------------------------------

    def checkpoint_state(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(json metadata, arrays): fleet EMAs always, plus the in-flight
        round's carry when saving at a chunk boundary; the metadata is
        the reference's, field for field."""
        meta: Dict[str, Any] = {
            "fleet_round": int(self.fleet.round),
            "n_registered": int(self.n_registered),
        }
        arrays: Dict[str, Any] = {"fleet": {
            "loss_ema": self.fleet.loss_ema,
            "norm_ema": self.fleet.norm_ema,
            "counts": self.fleet.counts,
        }}
        p = self._partial
        if p is not None:
            meta["partial"] = {
                "round": int(p["round"]), "chunk": int(p["chunk"]),
                "n_part": int(p["n_part"]),
                "eff_w": [float(x) for x in p["eff_w"]],
                "skipped": bool(p["skipped"]),
                "scored": bool(self.programs.scoring),
                "gated": bool(p["quars"]),
            }
            pa: Dict[str, Any] = {
                "ids": np.asarray(p["ids"], np.int32),
                "w": np.asarray(p["w"], np.float32),
            }
            if not p["skipped"]:
                pa["sel"] = np.asarray(p["sel"], np.float32)
                pa["acc"] = p["acc"]
                if p["losses"]:
                    pa["losses"] = torch.cat(p["losses"]).float().cpu()
                if p["sqnorms"]:
                    pa["sqnorm"] = np.concatenate(p["sqnorms"], axis=0)
                if p["quars"]:
                    pa["quar"] = np.concatenate(p["quars"])
            arrays["partial"] = pa
        return meta, arrays

    def arrays_template(self, meta: Dict[str, Any]) -> Dict[str, Any]:
        """TensorSpecs of :meth:`checkpoint_state`'s arrays for ``meta``
        (the partial aggregate in the port's layout)."""
        n_r = int(meta["n_registered"])
        tpl: Dict[str, Any] = {"fleet": {
            "loss_ema": TensorSpec((n_r,), torch.float32),
            "norm_ema": TensorSpec((n_r,), torch.float32),
            "counts": TensorSpec((n_r,), torch.int32),
        }}
        pm = meta.get("partial")
        if pm is not None:
            c = self.fl.n_clients
            u = self.assign.n_units
            pa: Dict[str, Any] = {"ids": TensorSpec((c,), torch.int32),
                                  "w": TensorSpec((c,), torch.float32)}
            if not pm["skipped"]:
                pa["sel"] = TensorSpec((c, u), torch.float32)
                acc = self.programs.acc_init(self.server.global_params())
                pa["acc"] = {p: TensorSpec(tuple(x.shape), x.dtype)
                             for p, x in acc.items()}
                done = int(pm["chunk"]) * self.chunk
                if done:
                    pa["losses"] = TensorSpec((done,), torch.float32)
                    if pm.get("scored"):
                        pa["sqnorm"] = TensorSpec((done, u), torch.float32)
                    if pm.get("gated"):
                        pa["quar"] = TensorSpec((done,), torch.float32)
            tpl["partial"] = pa
        return tpl

    def restore_state(self, meta: Dict[str, Any], arrays: Dict[str, Any]):
        if int(meta["n_registered"]) != self.n_registered:
            raise ValueError(
                f"checkpoint fleet has {meta['n_registered']} registered "
                f"clients, this engine {self.n_registered}; restore with "
                "the original FLConfig.n_registered")
        fa = arrays["fleet"]
        # np.array (copy): the fleet EMAs are updated in place every round
        self.fleet = FleetState(
            loss_ema=np.array(fa["loss_ema"], np.float32),
            norm_ema=np.array(fa["norm_ema"], np.float32),
            counts=np.array(fa["counts"], np.int32),
            round=int(meta["fleet_round"]))
        pm = meta.get("partial")
        if pm is None:
            self._partial = None
            return
        pa = arrays["partial"]
        p: Dict[str, Any] = {
            "round": int(pm["round"]), "t0": time.perf_counter(),
            "ids": np.asarray(pa["ids"], np.int32),
            "w": torch.as_tensor(np.asarray(pa["w"], np.float32)),
            "eff_w": [float(x) for x in pm["eff_w"]],
            "n_part": int(pm["n_part"]), "chunk": int(pm["chunk"]),
            "skipped": bool(pm["skipped"]),
            "losses": [], "sqnorms": [], "quars": [],
            "sel": None, "acc": None,
        }
        if not p["skipped"]:
            p["sel"] = torch.as_tensor(np.asarray(pa["sel"], np.float32))
            dev = self.server.device
            p["acc"] = {k: torch.as_tensor(v).to(device=dev,
                                                 dtype=torch.float32)
                        for k, v in pa["acc"].items()}
            if "losses" in pa:
                p["losses"] = [torch.as_tensor(
                    np.asarray(pa["losses"], np.float32)).to(dev)]
            if "sqnorm" in pa:
                p["sqnorms"] = [np.asarray(pa["sqnorm"], np.float32)]
            if "quar" in pa:
                p["quars"] = [np.asarray(pa["quar"], np.float32)]
        self._partial = p
