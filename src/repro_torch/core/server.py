"""Round orchestration (paper Alg. 1) — the FEDn-combiner role.

The ``Server`` drives rounds at the Python level: handing client
batches to the ``round_step``, evaluation and history.  Everything
*situational* — straggler dropout, comm accounting, logging — is a
composable :class:`ServerHook` rather than an inlined branch.

Hook call order per round::

    on_round_start(server, round_idx, weights) -> weights   (may reweight)
    ... round step ...
    (the scored selection state takes the round's telemetry)
    on_round_end(server, record, metrics)                   (may annotate)

If every client drops (all weights zero) the round is a recorded no-op:
the global params are untouched and the ``RoundRecord`` carries
``skipped=True`` with zero participants.

Three engines can own the round loop instead of ``run_round``
(attached by the ``Federation`` facade): the buffered-async engine
(``core/async_agg.py``: one record per buffer flush), the
chunk-streamed cohort engine (``core/cohort.py``) and, beside either,
the fault injector (``core/faults.py``), whose delta-corruption plan
``run_round`` threads into the packed round step.  ``history_cap``
folds old selection rows into running byte totals (``_trim_history``),
so ``comm_summary`` stays exact with O(cap * cohort) memory.

The server owns one CPU ``torch.Generator`` seeded from ``seed``; the
round's selection and the straggler draws come from it.  Under a
stochastic uplink codec it also owns a generator on the round's device
(seeded from ``seed`` and ``CODEC_KEY_TAG``) that draws the
stochastic-rounding uniforms where the codec runs, and under a stateful
codec the per-client error-feedback residual, which it threads through
the round step.

Under a stateful (scored) strategy the server owns its
``SelectionState`` (DESIGN.md §11): it passes it to the round step as
``sel_state`` and folds the round's gradient-norm telemetry into it
before the end-of-round hooks run, so a ``Checkpointer`` saves the
post-round state.  ``Checkpointer`` writes the reference's checkpoint
format (``repro_torch/ckpt``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..analysis.compileguard import CompileGuard
from ..common import Device, resolve_device
from . import codecs, comm
from .federation import FLConfig
from .masking import UnitAssignment
from .strategies import (NormTelemetry, SelectionContext, SelectionStrategy,
                         resolve_strategy)
from .topology import Topology, resolve_topology


@dataclasses.dataclass
class RoundRecord:
    round: int
    loss: float
    eval_metric: Optional[float]
    seconds: float
    uplink_bytes: float
    trained_params: float
    n_participants: int = 0
    skipped: bool = False
    # the round's post-hook client weights (dropped clients are 0)
    effective_weights: Optional[List[float]] = None
    # buffered-async flush annotations (zero on synchronous rounds)
    staleness_mean: float = 0.0
    staleness_max: float = 0.0
    sim_time: float = 0.0
    # bytes that crossed the WAN (or left a client) without landing in
    # the aggregate: quarantined uploads, duplicate deliveries, updates
    # lost in transit (DESIGN.md §14)
    wasted_bytes: float = 0.0
    # every client dropped: the round was a recorded no-op (loss 0.0)
    dropped: bool = False


class ServerHook:
    """Override any subset; defaults are no-ops."""

    def on_round_start(self, server: "Server", round_idx: int,
                       weights: torch.Tensor) -> Optional[torch.Tensor]:
        """Return new weights to reweight/drop clients, or None."""
        return None

    def on_round_end(self, server: "Server", record: RoundRecord,
                     metrics: Optional[Dict]) -> None:
        pass

    def on_fit_end(self, server: "Server",
                   history: List[RoundRecord]) -> None:
        pass


class StragglerDropout(ServerHook):
    """Simulated stragglers: each client independently drops with
    probability ``rate``; dropped clients contribute weight 0.  Draws
    from the server's generator (reproducible per server seed)."""

    def __init__(self, rate: float):
        self.rate = rate

    def on_round_start(self, server, round_idx, weights):
        if self.rate <= 0.0:
            # a rate-0 hook must be a true no-op: drawing anyway would
            # desync a rate-0 run from a no-hook run
            return None
        keep = torch.rand((server.fl.n_clients,),
                          generator=server.generator) < 1.0 - self.rate
        return weights * keep.float()


class CommAccounting(ServerHook):
    """Exact per-round transfer accounting (paper Table 4) from the
    round's selection matrix — fills ``uplink_bytes``/``trained_params``
    on the record with the server topology's byte math."""

    def on_round_end(self, server, record, metrics):
        if record.skipped or metrics is None:
            return
        # bill at wire width: the codec's encoded per-unit byte table
        # (identical to the fp32 table for codec "none").  Wasted bytes
        # (quarantine/duplicates) use the same table
        if "entry_sel" in metrics:
            # buffered-async flush: one entry per buffered update, the
            # topology's buffered byte math
            ub = server.wire_unit_bytes()
            counts = comm.unit_param_counts(server.assign,
                                            server.global_params())
            entry_sel = self._mask_dropped(np.asarray(metrics["entry_sel"]),
                                           record)
            clients = np.asarray(metrics["entry_clients"])
            record.uplink_bytes = server.topology.buffered_round_bytes(
                entry_sel, clients, ub, server.fl)["uplink"]
            record.trained_params = float(np.einsum("cu,u->", entry_sel,
                                                    counts))
            # wasted: bytes the engine saw leave a client but never
            # aggregate (duplicates, in-transit loss) plus entries the
            # validation gate quarantined at flush time
            wasted = float(metrics.get("dropped_bytes", 0.0))
            quar = metrics.get("quarantined")
            if quar is not None:
                qm = (np.asarray(quar) > 0).astype(entry_sel.dtype)
                wasted += server.topology.buffered_round_bytes(
                    entry_sel * qm[:, None], clients, ub,
                    server.fl)["uplink"]
            record.wasted_bytes = wasted
            return
        sel = np.asarray(metrics["sel"])
        if server.assign.leaf_units is None:
            # the deprecated no-assign shim (one pseudo-unit): the whole
            # fp32 model ships for every participating client
            n_up = float(self._mask_dropped(np.ones((sel.shape[0], 1),
                                                    sel.dtype), record).sum())
            n = sum(x.numel() for x in server.global_params().values())
            record.uplink_bytes = 4.0 * n * n_up
            record.trained_params = float(n) * n_up
            return
        ub = server.wire_unit_bytes()
        counts = comm.unit_param_counts(server.assign,
                                        server.global_params())
        # bill only clients that actually uploaded: rows zeroed by
        # straggler dropout (effective weight 0) ship nothing
        sel = self._mask_dropped(sel, record)
        record.uplink_bytes = server.topology.round_bytes(
            sel, ub, server.fl)["uplink"]
        record.trained_params = float(np.einsum("cu,u->", sel, counts))
        quar = metrics.get("quarantined")
        if quar is not None:
            # quarantined clients uploaded (billed above) but their
            # deltas were discarded by the validation gate
            qm = (np.asarray(quar) > 0).astype(sel.dtype)
            record.wasted_bytes = server.topology.round_bytes(
                sel * qm[:, None], ub, server.fl)["uplink"]

    @staticmethod
    def _mask_dropped(sel: np.ndarray, record) -> np.ndarray:
        eff = record.effective_weights
        if eff is None or len(eff) != sel.shape[0]:
            return sel
        keep = (np.asarray(eff, np.float32) > 0).astype(sel.dtype)
        return sel * keep[:, None]


class RoundLogger(ServerHook):
    """Print a one-line round summary every ``every`` rounds; the final
    round (``total - 1``) always prints."""

    def __init__(self, every: int = 1, total: Optional[int] = None,
                 base: int = 0):
        self.every = max(1, every)
        self.total = total
        self.base = base

    def on_round_end(self, server, record, metrics):
        if record.skipped:
            print(f"  round {record.round:>4d} SKIPPED "
                  f"(all clients dropped)")
            return
        last = self.total is not None and record.round == self.total - 1
        if (record.round - self.base) % self.every and not last:
            return
        line = f"  round {record.round:>4d}"
        line += f" loss={record.loss:.4f}"
        if record.eval_metric is not None:
            line += f" eval={record.eval_metric:.4f}"
        line += f" uplink={record.uplink_bytes/1e6:.1f}MB"
        if record.wasted_bytes > 0.0:
            line += f" wasted={record.wasted_bytes/1e6:.1f}MB"
        if record.sim_time > 0.0:          # buffered-async flush
            line += (f" t_sim={record.sim_time:.1f}"
                     f" stale={record.staleness_mean:.2f}")
        line += f" {record.seconds:.3f}s"
        print(line)


class Checkpointer(ServerHook):
    """Persist restartable server state every ``every`` rounds (and at
    fit end), in the reference's format (``repro_torch.ckpt``)."""

    def __init__(self, path: str, every: int = 0):
        self.path = path
        self.every = every

    def _save(self, server, pending_record=None):
        from ..ckpt import save_server_state
        save_server_state(self.path, server, pending_record=pending_record)

    def on_round_end(self, server, record, metrics):
        # end hooks run before history.append, so the in-flight record
        # rides along as pending_record: without it the checkpoint would
        # pair post-round params with pre-round history
        if self.every and (record.round + 1) % self.every == 0:
            self._save(server, pending_record=record)

    def on_fit_end(self, server, history):
        self._save(server)


class Server:
    """Owns the topology state (on ``device``), the generator, the hooks
    and the run history.

    ``params`` is the topology *state*: the single global model for star
    topologies (hub, hierarchical), the stacked per-client replicas for
    gossip.  ``global_params()`` is always the single-model view (what
    ``eval_fn`` sees and what accounting sizes against).  Plain model
    params are lifted into state by ``Topology.init_state``.

    The selection strategy is ``strategy`` when given, else the one
    ``build_round_step`` attached to the step (``selection_strategy``),
    else ``fl.strategy``.  ``conv_spatial`` is the conv kernels' spatial rank
    (2 for VGG16, 1 for IMDB), which a checkpoint's layout conversion
    needs (``convert.py``)."""

    def __init__(self, round_step: Callable, assign: UnitAssignment,
                 fl: FLConfig, params, *, eval_fn: Optional[Callable] = None,
                 seed: int = 0, dropout_rate: float = 0.0,
                 hooks: Sequence[ServerHook] = (),
                 topology: Optional[Topology] = None,
                 strategy: Union[str, SelectionStrategy, None] = None,
                 conv_spatial: int = 2, device: Device = "cuda"):
        self.device = resolve_device(device)
        # CompileGuard (repro_torch.analysis.compileguard) holds the path
        # to ONE input signature and names the argument that changed
        # otherwise.  The step returns new params (the reference donates
        # its params argument; this one overwrites nothing it is given)
        self.round_step = CompileGuard(round_step, name="round_step",
                                       max_programs=1)
        self.assign = assign
        self.fl = fl
        self.topology = resolve_topology(topology if topology is not None
                                         else fl.topology)
        # own the state outright: a caller-held reference to the init
        # params must not alias the server's
        self.params = self.topology.init_state(
            {p: torch.as_tensor(x).detach().to(self.device, copy=True)
             for p, x in params.items()}, fl)
        self.eval_fn = eval_fn
        self.conv_spatial = conv_spatial
        self.generator = torch.Generator().manual_seed(seed)
        # the scored-selection engine: the strategy instance the round
        # step selects with (an explicit strategy= override may differ
        # from fl.strategy), and its state (None when stateless: the
        # round step is then called exactly as before)
        baked = getattr(round_step, "selection_strategy", None)
        if strategy is not None:
            self.strategy = resolve_strategy(strategy, fl.synchronized)
        elif baked is not None:
            self.strategy = baked
        else:
            self.strategy = resolve_strategy(fl.strategy, fl.synchronized)
        self.sel_ctx = SelectionContext(
            n_clients=fl.n_clients, n_units=assign.n_units,
            n_train=fl.resolve_n_train(assign.n_units),
            score_ema=fl.score_ema)
        self.sel_state = self.strategy.init_state(self.sel_ctx)
        self.hooks: List[ServerHook] = [CommAccounting()]
        if dropout_rate > 0.0:
            self.hooks.append(StragglerDropout(dropout_rate))
        self.hooks.extend(hooks)
        self.history: List[RoundRecord] = []
        self.sel_history: List[np.ndarray] = []
        self._ubytes = None
        self._wire_ubytes = None
        # codec axis (core/codecs.py): the per-client error-feedback
        # residual of a stateful codec (None for stateless ones), and the
        # device generator of a stochastic codec's rounding uniforms —
        # drawn where the codec runs, never copied from the host
        self.codec = codecs.resolve_codec(fl.codec)
        self.codec_state = codecs.init_codec_state(
            self.codec, self.global_params(), fl.n_clients)
        self.codec_generator = None
        if self.codec.stochastic:
            self.codec_generator = torch.Generator(
                device=self.device).manual_seed(seed ^ codecs.CODEC_KEY_TAG)
        # fault axis (core/faults.py): set by the Federation facade when
        # FLConfig.faults is non-empty; owns every seeded fault draw
        # (numpy SeedSequence domain — never the server's generators)
        self.fault_injector = None
        # buffered-async engine (core/async_agg.py); attached by the
        # Federation facade when FLConfig.async_buffer > 0
        self.async_engine = None
        # chunk-streamed cohort engine (core/cohort.py); attached when
        # FLConfig.n_registered/cohort_chunk switch the round loop over
        self.cohort_engine = None
        # history_cap retention (DESIGN.md §13): rounds trimmed off the
        # front of sel_history fold their byte/param totals here so
        # comm_summary stays exact while memory stays O(cap * cohort)
        self._sel_base = 0
        self._comm_totals = {"uplink": 0.0, "trained": 0.0, "rounds": 0}

    def global_params(self):
        """Single-model view of the topology state."""
        return self.topology.global_params(self.params, self.fl)

    def unit_bytes(self) -> np.ndarray:
        if self._ubytes is None:
            self._ubytes = comm.unit_bytes(self.assign, self.global_params())
        return self._ubytes

    def wire_unit_bytes(self) -> np.ndarray:
        """Per-unit *encoded* uplink bytes under the active codec — what
        CommAccounting bills (== ``unit_bytes`` for codec ``none``)."""
        if self._wire_ubytes is None:
            self._wire_ubytes = codecs.codec_unit_bytes(
                self.codec, self.assign, self.global_params(), self.fl)
        return self._wire_ubytes

    def codec_uniform(self, i: int, shape) -> torch.Tensor:
        """Stochastic-rounding uniforms for flattened leaf ``i``, drawn on
        the round's device from the server's codec generator."""
        return torch.rand(shape, generator=self.codec_generator,
                          device=self.device)

    def add_hook(self, hook: ServerHook) -> "Server":
        self.hooks.append(hook)
        return self

    def run_round(self, client_batches, weights=None) -> RoundRecord:
        """client_batches: tree with (C, steps, ...) leaves."""
        if self.async_engine is not None:
            raise RuntimeError(
                "server is in buffered-async mode (FLConfig.async_buffer "
                "> 0); a synchronous round would desync the engine's "
                "version/key bookkeeping — use run()/Federation.fit")
        if self.cohort_engine is not None:
            raise RuntimeError(
                "server is in cohort-engine mode (FLConfig.n_registered/"
                "cohort_chunk); a plain round would desync the engine's "
                "fleet/key bookkeeping — use run()/Federation.fit")
        t0 = time.perf_counter()
        r = len(self.history)
        c = self.fl.n_clients
        weights = torch.ones((c,)) if weights is None \
            else torch.as_tensor(weights, dtype=torch.float32).cpu()
        for hook in self.hooks:
            new_w = hook.on_round_start(self, r, weights)
            if new_w is not None:
                weights = new_w
        n_part = int(torch.count_nonzero(weights))
        eff_w = [float(x) for x in weights]
        if n_part == 0:
            # every client dropped: a FedAvg denominator of zero — the
            # round is a recorded no-op, global params unchanged
            rec = RoundRecord(r, 0.0, None, time.perf_counter() - t0,
                              0.0, 0.0, n_participants=0, skipped=True,
                              dropped=True, effective_weights=eff_w)
            self.sel_history.append(
                np.zeros((c, self.assign.n_units), np.float32))
            metrics = None
        else:
            step_kw = {}
            inj = self.fault_injector
            if inj is not None and inj.has_delta:
                plan = inj.corrupt_plan(r, range(c))
                step_kw["fault_plan"] = {
                    "mode": torch.as_tensor(plan["mode"]),
                    "scale": torch.as_tensor(plan["scale"])}
            if self.codec.stochastic:
                step_kw["uniform"] = self.codec_uniform
            if self.codec_state is not None:
                # stateful codec: thread the EF residual through the
                # step; the new residual rides the metrics back out
                step_kw["codec_state"] = self.codec_state
            if self.sel_state is not None:
                step_kw["sel_state"] = self.sel_state
            self.params, metrics = self.round_step(
                self.params, client_batches, weights, self.generator,
                **step_kw)
            if "codec_state" in metrics:
                self.codec_state = metrics.pop("codec_state")
            self.sel_history.append(np.asarray(metrics["sel"]))
            ev = None
            if self.eval_fn is not None:
                ev = float(self.eval_fn(self.global_params()))
            rec = RoundRecord(r, float(metrics["loss_mean"]), ev,
                              time.perf_counter() - t0, 0.0, 0.0,
                              n_participants=n_part,
                              effective_weights=eff_w)
        # fold the round's telemetry into the selection state BEFORE the
        # end-of-round hooks, so a Checkpointer saves the post-round state
        self.update_sel_state(self._round_telemetry(r, metrics, eff_w))
        for hook in self.hooks:
            hook.on_round_end(self, rec, metrics)
        rec.seconds = time.perf_counter() - t0
        self.history.append(rec)
        self._trim_history()
        return rec

    def _trim_history(self) -> None:
        """Enforce ``FLConfig.history_cap``: fold selection rows older
        than the cap into running uplink/params totals and drop them,
        bounding accounting memory at O(cap * cohort) for long fits
        while keeping ``comm_summary`` exact."""
        cap = self.fl.history_cap
        if not cap:
            return
        while len(self.sel_history) > cap:
            s = self.sel_history.pop(0)
            i = self._sel_base
            rec = self.history[i] if i < len(self.history) else None
            eff = rec.effective_weights if rec is not None else None
            if eff is not None and len(eff) == s.shape[0]:
                s = s * (np.asarray(eff, np.float32) > 0
                         ).astype(s.dtype)[:, None]
            if s.shape[1] == self.assign.n_units:
                counts = comm.unit_param_counts(self.assign,
                                                self.global_params())
                self._comm_totals["uplink"] += self.topology.round_bytes(
                    s, self.wire_unit_bytes(), self.fl)["uplink"]
                self._comm_totals["trained"] += float(
                    np.einsum("cu,u->", s, counts))
                self._comm_totals["rounds"] += 1
            if rec is not None:
                # the O(cohort) weight list already served accounting;
                # null it so long fits keep O(1) state per old round
                rec.effective_weights = None
            self._sel_base += 1

    def _round_telemetry(self, round_idx: int, metrics: Optional[Dict],
                         eff_w: Sequence[float]):
        """One round's NormTelemetry, or None (stateless strategy,
        skipped round, or off-cadence under ``FLConfig.score_every``).
        Dropped clients (effective weight 0) shipped nothing and
        contribute no telemetry, matching the aggregation."""
        if self.sel_state is None or metrics is None \
                or round_idx % self.fl.score_every != 0:
            return None
        active = (torch.as_tensor(eff_w, dtype=torch.float32) > 0).float()
        sq = metrics["unit_sqnorm"].float().cpu()
        sel = torch.as_tensor(metrics["sel"], dtype=torch.float32).cpu()
        counts = (sel * active[:, None]).sum(0)
        # synchronous participants all carry weight 1, so the weighted
        # and raw counts coincide (staleness confidence 1)
        return NormTelemetry(unit_sqnorm=(sq * active[:, None]).sum(0),
                             unit_count=counts, unit_raw_count=counts)

    def update_sel_state(self, telemetry) -> None:
        """Advance the scored-selection state one round (no-op for
        stateless strategies)."""
        if self.sel_state is not None:
            self.sel_state = self.strategy.update_state(
                self.sel_state, self.sel_ctx, telemetry)

    def attach_async_engine(self, engine) -> "Server":
        """Switch the server to buffered-async rounds: ``run`` drives
        the engine's flush loop (one history record per flush) and
        ``comm_summary`` uses its per-flush buffered accounting."""
        self.async_engine = engine
        return self

    def attach_cohort_engine(self, engine) -> "Server":
        """Switch the server to chunk-streamed cohort rounds
        (core/cohort.py): ``run`` drives the engine's round loop; its
        records are ordinary sync records, so accounting and summary
        need no special casing."""
        self.cohort_engine = engine
        return self

    def run(self, rounds: int, batch_fn: Callable[[int], Dict],
            weights=None, log_every: int = 0) -> List[RoundRecord]:
        if self.async_engine is not None:
            # buffered-async mode: batch_fn is indexed by each client's
            # own dispatch window, not a shared round counter
            return self.async_engine.run(rounds, batch_fn, weights=weights,
                                         log_every=log_every)
        if self.cohort_engine is not None:
            # cohort-engine mode: batch_fn(round_idx, client_ids) loads
            # one chunk of the sampled cohort at a time
            return self.cohort_engine.run(rounds, batch_fn, weights=weights,
                                          log_every=log_every)
        extra = [RoundLogger(log_every, total=len(self.history) + rounds,
                             base=len(self.history))] \
            if log_every else []
        self.hooks.extend(extra)
        try:
            for r in range(rounds):
                self.run_round(batch_fn(r), weights)
        finally:
            for h in extra:
                self.hooks.remove(h)
        for hook in self.hooks:
            hook.on_fit_end(self, self.history)
        return self.history

    def _wasted_summary(self) -> Dict[str, float]:
        """Fault-accounting columns (DESIGN.md §14), from the per-round
        records CommAccounting already filled."""
        per_round = [r.wasted_bytes for r in self.history]
        total = float(np.sum(per_round)) if per_round else 0.0
        return {"total_wasted_bytes": total,
                "avg_wasted_bytes": total / max(1, len(per_round))}

    def comm_summary(self) -> Dict[str, float]:
        if self.async_engine is not None and self.async_engine.started:
            return self.async_engine.comm_summary()
        if self._sel_base:
            return dict(self._capped_summary(), **self._wasted_summary())
        if not self.sel_history:
            return {"avg_uplink_bytes": 0.0, "avg_trained_params": 0.0,
                    "total_uplink_bytes": 0.0, "reduction_vs_full": 0.0,
                    "total_wasted_bytes": 0.0, "avg_wasted_bytes": 0.0}
        # selection rows of clients whose effective weight was zeroed
        # (straggler dropout) shipped nothing — mask them out so the
        # run summary matches the per-round records
        hist = np.stack([CommAccounting._mask_dropped(s, rec)
                         for s, rec in zip(self.sel_history, self.history)])
        if self.assign.leaf_units is None:         # the no-assign shim
            per_round = [r.uplink_bytes for r in self.history]
            return dict({"avg_uplink_bytes": float(np.mean(per_round)),
                         "avg_trained_params": float(np.mean(
                             [r.trained_params for r in self.history])),
                         "total_uplink_bytes": float(np.sum(per_round)),
                         "reduction_vs_full": 0.0},
                        **self._wasted_summary())
        sum_kw = {}
        if self.codec.name != "none":
            # bill the run at encoded wire width; custom topologies
            # without the wire_ubytes parameter keep working when no
            # codec is configured
            sum_kw["wire_ubytes"] = self.wire_unit_bytes()
        return dict(self.topology.summary(self.assign, self.global_params(),
                                          hist, self.fl, **sum_kw),
                    **self._wasted_summary())

    def _capped_summary(self) -> Dict[str, float]:
        """``comm_summary`` with ``history_cap`` trimming active: the
        folded totals of trimmed rounds plus the retained window,
        through the same per-round ``Topology.round_bytes`` math — the
        result matches the uncapped summary up to float accumulation
        order."""
        ub = self.unit_bytes()
        wub = self.wire_unit_bytes()
        counts = comm.unit_param_counts(self.assign, self.global_params())
        up = self._comm_totals["uplink"]
        tp = self._comm_totals["trained"]
        n = self._comm_totals["rounds"]
        for i, s in enumerate(self.sel_history):
            rec_i = self._sel_base + i
            eff = self.history[rec_i].effective_weights \
                if rec_i < len(self.history) else None
            if eff is not None and len(eff) == s.shape[0]:
                s = s * (np.asarray(eff, np.float32) > 0
                         ).astype(s.dtype)[:, None]
            up += self.topology.round_bytes(s, wub, self.fl)["uplink"]
            tp += float(np.einsum("cu,u->", s, counts))
            n += 1
        if not n:
            return {"avg_uplink_bytes": 0.0, "avg_trained_params": 0.0,
                    "total_uplink_bytes": 0.0, "reduction_vs_full": 0.0}
        # full-model uplink is a per-round constant given the cohort
        # shape, so the reduction needs no retained history
        c = self.sel_history[0].shape[0] if self.sel_history \
            else self.fl.n_clients
        full = self.topology.round_bytes(
            np.ones((c, self.assign.n_units), np.float32), ub,
            self.fl)["uplink"]
        return {
            "avg_uplink_bytes": up / n,
            "avg_trained_params": tp / n,
            "total_uplink_bytes": up,
            "reduction_vs_full": 1.0 - (up / n) / full if full else 0.0,
        }
