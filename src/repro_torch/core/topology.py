"""Federation topologies as registered plugins (DESIGN.md §6).

A **topology** owns the aggregation stage of the round step and its
exact byte accounting (``round_bytes``/``summary``; core/comm.py has
the formulas).  Adding one is a subclass + ``@register_topology``.

Registered plugins:

* ``hub`` — the paper's FEDn combiner star (the default).  Its masked
  aggregate goes through the fused CUDA kernel when
  ``FLConfig.resolve_fused_agg`` says so (``kernels/masked_agg``), with
  each client's delta written straight into the kernel's client-stacked
  tile buffer.
* ``hierarchical`` — clients partitioned under ``FLConfig.n_edges``
  edge aggregators; two-stage masked FedAvg (per-edge partial means,
  then the hub combine, which runs through the fused kernel over the E
  edge planes when ``fused_agg`` resolves on).  Only the per-edge
  selection *union* crosses the edge->hub WAN link.
* ``gossip`` — hubless peer averaging over a doubly-stochastic ring
  mixing matrix; the per-client replicas are the server state
  (``stateful = True``) and no aggregation kernel runs.

With ``FLConfig.packed`` the star topologies run on packed slot buffers
instead (DESIGN.md §7), the uplink codec round-trips the packed deltas,
and the topology's ``aggregate_packed`` reduces them; that path ignores
``fused_agg``, as the reference's does.  The fault axis (core/faults.py)
rides that branch too: delta corruption and the validation gate run
between the codec and the aggregate.

The star topologies also supply the round engines' aggregation stages:
``build_buffered_flush`` (the async engine's flush over a buffer of
packed updates) and ``build_chunk_agg`` (the cohort engine's
init/accumulate/finalize over chunks), both on the packed primitives of
core/aggregation.py, and ``buffered_round_bytes``, a flush's bill.
Gossip has no global model to buffer against and keeps the base class's
``ValueError``.

Stateful (scored) strategies (DESIGN.md §11) add two wires to every
topology's round step, both absent for stateless strategies: the
``sel_state`` keyword threads the server's live ``SelectionState`` into
the selection context, and ``metrics["unit_sqnorm"]`` carries the (C, U)
per-client gradient-norm telemetry of the local-update norm hook.  The
aggregation (K1 on the dense hub and the hierarchical combine, K2 on the
packed path) is the same under every strategy.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, Dict, Optional, Tuple, Type, Union

import numpy as np
import torch

from ..common import tree_stack
from ..kernels.masked_agg import ops as agg_ops
from . import codecs as _codecs
from . import comm
from . import faults as _faults
from .aggregation import (fedavg, gate_packed_updates,
                          hierarchical_edge_partials,
                          hierarchical_masked_fedavg,
                          hierarchical_masked_fedavg_packed, masked_fedavg,
                          masked_fedavg_packed, packed_acc_init,
                          packed_accumulate, packed_finalize)
from .client import local_update, packed_cohort_fn
from .masking import (UnitAssignment, cohort_slot_plans, dense_norm_hook,
                      mask_tree)
from .registry import unknown_name_message
from .strategies import SelectionContext, resolve_strategy


def ring_mixing_matrix(n: int) -> np.ndarray:
    """Doubly-stochastic Metropolis weights on a ring of ``n`` peers.

    n=1 -> identity; n=2 -> exact pair averaging; n>=3 -> 1/3 self +
    1/3 to each ring neighbour.  Rows AND columns sum to one, so the
    uniform average of the replicas is invariant under mixing.
    """
    if n < 1:
        raise ValueError("ring needs at least one peer")
    if n == 1:
        return np.ones((1, 1), np.float32)
    if n == 2:
        return np.full((2, 2), 0.5, np.float32)
    w = np.eye(n, dtype=np.float32) / 3.0
    w += np.roll(np.eye(n, dtype=np.float32), 1, axis=1) / 3.0
    w += np.roll(np.eye(n, dtype=np.float32), -1, axis=1) / 3.0
    return w


def _selection_setup(assign: UnitAssignment, fl, strategy, scores=None):
    """Resolve the strategy, validate n_train, build the selection
    context (shared preamble of every topology's round step)."""
    strat = resolve_strategy(strategy if strategy is not None
                             else fl.strategy, fl.synchronized)
    n_train = fl.resolve_n_train(assign.n_units)
    if not strat.dense and not 1 <= n_train <= assign.n_units:
        raise ValueError(
            f"n_train={n_train} out of range for {assign.n_units} units; "
            "set FLConfig.n_train_units or train_fraction")
    if scores is not None:
        scores = torch.as_tensor(np.asarray(scores, np.float32))
    ctx = SelectionContext(n_clients=fl.n_clients, n_units=assign.n_units,
                           n_train=n_train, scores=scores,
                           score_ema=fl.score_ema)
    return strat, ctx


def _live_ctx(ctx: SelectionContext, sel_state) -> SelectionContext:
    """The build-time context with the round's live selection state
    swapped in, when the server threads one."""
    if sel_state is None:
        return ctx
    return dataclasses.replace(ctx, scores=sel_state.scores,
                               state=sel_state)


class _OneShard:
    """The unsharded cohort: this process runs every client."""

    def block(self, n_clients: int) -> Tuple[int, int]:
        return 0, n_clients

    def gather(self, local, n_clients: int, device=None):
        return local

    def fill(self, full: torch.Tensor) -> torch.Tensor:
        return full

    def run(self, fn: Callable, replicated, *per_client):
        return fn(replicated, *per_client)


def _cohort_runner(fl, device: torch.device):
    """How a round step runs its cohort stage: every client in this
    process, or split over the ``(client,)`` mesh when
    ``fl.client_shards`` is set (DESIGN.md §13; ``launch.mesh``).  The
    result has ``run(fn, gp, *per_client)`` (``gp`` replicated,
    everything else carrying a leading client axis), ``block(n)`` (this
    rank's clients), ``gather(local, n)`` and ``fill(tile_buffer)``.  A
    client's row of a local update does not depend on the others, and
    the gathers copy bytes, so both agree bitwise."""
    if not fl.client_shards:
        return _OneShard()
    from ..launch.mesh import ClientShards, make_client_mesh
    return ClientShards(make_client_mesh(fl.client_shards,
                                         device_type=device.type))


def _star_round_step(loss_fn: Callable, assign: UnitAssignment, fl,
                     loss_kwargs: Optional[Dict], *, strategy, scores=None,
                     device: torch.device, fused: bool = False,
                     aggregate: Optional[Callable] = None,
                     aggregate_dense: Optional[Callable] = None,
                     aggregate_packed: Optional[Callable] = None):
    """The star-topology skeleton: selection -> masked local training
    (an ordered loop over clients) -> an aggregation stage.

    ``aggregate(global_params, deltas, sel, weights)`` is a topology's
    own masked aggregate over the client-stacked deltas, and
    ``aggregate_dense`` the dense (``full``-strategy) one (``fedavg``
    when None).  Without ``aggregate`` the round takes the hub's masked
    FedAvg: through the fused kernel (``fused``), each client's delta
    written straight into the kernel's tile planes, or the plain
    ``masked_fedavg``.

    With ``fl.packed`` (DESIGN.md §7) local training and aggregation run
    on packed slot buffers instead: ``aggregate_packed(g, pdeltas, rows,
    valid, sel, weights)`` reduces only the trained slots, and the codec
    (``fl.codec``) round-trips the packed deltas first.  That branch is
    taken whatever ``fused`` says.  The round step then takes two more
    keywords: ``uniform(i, shape)``, the stochastic-rounding draws of a
    stochastic codec, and ``codec_state``, the error-feedback residual
    of a stateful one (the new residual comes back in
    ``metrics["codec_state"]``).  When ``fl.faults`` names a delta fault
    the ``fault_plan`` keyword (``{"mode": (C,), "scale": (C,)}``, zeros
    and ones when omitted) corrupts the decoded deltas through
    ``faults.chaos_inject``, and when the gate is on
    (``faults.gate_enabled``) ``gate_packed_updates`` quarantines bad
    uploads before the aggregate (``metrics["quarantined"]``).

    ``metrics["deltas"]`` is the client-stacked delta tree the round
    aggregated: on the fused path every leaf is a view into the kernel's
    ``(C, T, tile)`` tile buffer (``agg_ops.unpack``; a stacked leaf's
    view strides over its macro rows' segments, so no delta is copied);
    on the packed path the decoded packed deltas.  A stateful strategy
    adds the ``sel_state`` keyword and ``metrics["unit_sqnorm"]`` (module
    docstring).  The step carries the strategy it selects with as
    ``round_step.selection_strategy``.
    """
    strat, ctx = _selection_setup(assign, fl, strategy, scores)
    scoring = strat.stateful
    hook = dense_norm_hook(assign) if scoring else None
    if aggregate_dense is None:
        aggregate_dense = lambda g, d, sel, w: fedavg(g, d, w)  # noqa: E731
    use_packed = fl.packed and not strat.dense
    if use_packed and aggregate_packed is None:
        raise ValueError(
            f"topology {fl.topology!r} has no packed aggregation path; "
            "set FLConfig.packed=False")
    # the fault axis: delta corruption + the validation gate run in the
    # packed branch only — both bitwise identities when untripped, so a
    # zero-rate chaos config keeps the plain round's numbers exactly
    inject_on = _faults.delta_faults_configured(fl)
    gate_on = _faults.gate_enabled(fl)
    if (inject_on or gate_on) and not use_packed:
        raise ValueError(
            "delta faults / the validation gate run inside the packed "
            "scatter-accumulate; set FLConfig.packed=True (or drop "
            "delta faults and max_delta_norm)")
    n_slots = fl.resolve_n_slots(ctx.n_units)
    packed_cohort = packed_cohort_fn(loss_fn, assign, fl, loss_kwargs,
                                     scoring=scoring)
    codec_fn = _codecs.build_codec_transform(
        _codecs.resolve_codec(fl.codec), assign, fl)
    shards = _cohort_runner(fl, device)
    plan = {}

    def packed_step(global_params, client_batches, weights, sel, uniform,
                    codec_state, fault_plan):
        rows, valid = cohort_slot_plans(assign, sel, n_slots,
                                        global_params)
        deltas, m = shards.run(packed_cohort, global_params, rows, valid,
                               client_batches)
        # the plan on the round's device, moved once per leaf
        rows = {p: r.to(device) for p, r in rows.items()}
        valid = {p: v.to(device) for p, v in valid.items()}
        new_codec_state = None
        if codec_fn is not None:
            deltas, new_codec_state = codec_fn(deltas, rows, valid, weights,
                                               uniform, codec_state)
        quarantined = None
        if inject_on:
            if fault_plan is None:
                fault_plan = {"mode": torch.zeros(fl.n_clients,
                                                  dtype=torch.int32),
                              "scale": torch.ones(fl.n_clients)}
            deltas = _faults.chaos_inject(deltas, fault_plan["mode"],
                                          fault_plan["scale"])
        if gate_on:
            deltas, weights, quarantined = gate_packed_updates(
                assign, deltas, valid, weights, fl.max_delta_norm)
        new_params = aggregate_packed(global_params, deltas, rows, valid,
                                      sel, weights)
        metrics = {"loss_mean": m["loss_mean"].mean(),
                   "loss_per_client": m["loss_mean"],
                   "sel": sel,
                   "deltas": deltas}
        if scoring:
            metrics["unit_sqnorm"] = m["unit_sqnorm"]
        if quarantined is not None:
            metrics["quarantined"] = quarantined
        if new_codec_state is not None:
            metrics["codec_state"] = new_codec_state
        return new_params, metrics

    def round_step(global_params, client_batches, weights,
                   gen: Optional[torch.Generator], *, sel_state=None,
                   uniform=None, codec_state=None, fault_plan=None):
        sel = strat.select(gen, _live_ctx(ctx, sel_state))
        if fl.always_train_head:
            sel[:, -1] = 1.0
        weights = torch.as_tensor(weights, dtype=torch.float32).cpu()
        if use_packed:
            return packed_step(global_params, client_batches, weights, sel,
                               uniform, codec_state, fault_plan)
        n = fl.n_clients
        fused_tiles = fused and not strat.dense and aggregate is None
        if fused_tiles:
            if "plan" not in plan:
                plan["plan"] = agg_ops.build_agg_plan(assign, global_params)
            # the planes take the dtype the reference's concatenation of the
            # deltas would: bf16 for an all-bf16 tree, else fp32
            d_t = agg_ops.new_tile_buffer(
                plan["plan"], (n,), device=device,
                dtype=agg_ops.tile_dtype(global_params))
        losses, deltas, norms = [], [], []
        lo, hi = shards.block(n)
        for c in range(lo, hi):
            # the dense (full) strategy trains every unit unmasked
            mask = None if strat.dense else \
                mask_tree(assign, sel[c], global_params)
            d, m = local_update(
                loss_fn, global_params, mask,
                {k: v[c] for k, v in client_batches.items()}, lr=fl.lr,
                optimizer=fl.optimizer, prox_mu=fl.prox_mu,
                loss_kwargs=loss_kwargs, norm_hook=hook)
            losses.append(m["loss_mean"])
            if scoring:
                norms.append(m["unit_sqnorm"])
            if fused_tiles:
                # straight into the kernel's client plane: no stacked copy
                agg_ops.pack_into(plan["plan"], d, d_t[c])
            else:
                deltas.append(d)
        # with client shards: the other ranks' clients, gathered (their
        # rows of the tile buffer filled in place)
        per_client, norms = shards.gather(
            (torch.stack(losses), torch.stack(norms) if scoring else None),
            n)
        if fused_tiles:
            shards.fill(d_t)
        else:
            deltas = shards.gather(tree_stack(deltas), n)
        if strat.dense:
            new_params = aggregate_dense(global_params, deltas, sel, weights)
        elif aggregate is not None:
            new_params = aggregate(global_params, deltas, sel, weights)
        elif fused_tiles:
            new_params = agg_ops.masked_combine_packed(
                global_params, d_t, sel, weights, plan["plan"])
            deltas = agg_ops.unpack(plan["plan"], d_t, global_params)
        else:
            new_params = masked_fedavg(global_params, deltas, sel, weights,
                                       assign)
        metrics = {"loss_mean": per_client.mean(),
                   "loss_per_client": per_client,
                   "sel": sel,
                   "deltas": deltas}
        if scoring:
            metrics["unit_sqnorm"] = norms
        return new_params, metrics

    round_step.selection_strategy = strat
    return round_step


def _fused_hier_aggregate(assign: UnitAssignment, mem: torch.Tensor
                          ) -> Callable:
    """Two-stage masked FedAvg with the hub combine through the fused
    kernel: per-edge partial means (stage 1, plain PyTorch) packed into
    an ``(E, T, tile)`` buffer, then one K1 launch over the E planes with
    the per-edge weight mass ``e_den (E, U)`` as the selection and unit
    client weights (an edge plane is read only where ``e_den > 0``, and
    stage 1 writes zeros elsewhere).  The tiling plan is built once, at
    the first call."""
    plan = {}

    def aggregate(g, d, sel, w):
        if "plan" not in plan:
            plan["plan"] = agg_ops.build_agg_plan(assign, g)
        means, e_den = hierarchical_edge_partials(d, sel, w, assign, mem)
        dev = next(iter(g.values())).device
        d_t = agg_ops.pack_into(plan["plan"], means, agg_ops.new_tile_buffer(
            plan["plan"], (mem.shape[0],), device=dev))
        return agg_ops.masked_combine_packed(
            g, d_t, e_den, torch.ones(mem.shape[0]), plan["plan"])

    return aggregate


class Topology:
    """Base class for federation-topology plugins.

    Subclasses set ``name`` and implement ``build_round_step``
    (aggregation stage) and ``round_bytes`` (exact accounting; the
    run-level ``summary`` is derived from it).  ``stateful`` declares
    that the server state is not a single global model —
    ``init_state``/``global_params`` convert between the two (identity
    for star topologies).
    """

    name: ClassVar[str] = ""
    stateful: ClassVar[bool] = False

    def init_state(self, params, fl):
        return params

    def global_params(self, state, fl):
        return state

    def build_round_step(self, loss_fn: Callable, assign: UnitAssignment,
                         fl, loss_kwargs: Optional[Dict] = None, *,
                         strategy=None, scores=None, device: torch.device):
        raise NotImplementedError

    def build_buffered_flush(self, assign: UnitAssignment, fl):
        """The topology's buffered-async aggregation stage (DESIGN.md
        §8): ``flush(global, pdeltas, rows, valid, sel, weights,
        client_ids) -> new_global`` over a stacked ``(B, ...)`` buffer
        of packed updates — the same accumulate as the sync packed
        round, so a zero-staleness flush is bitwise the sync round.
        Star topologies implement this; stateful ones (gossip) have no
        global model to buffer against.
        """
        raise ValueError(
            f"topology {self.name!r} has no buffered-async path; set "
            "FLConfig.async_buffer=0 or use hub/hierarchical")

    def build_chunk_agg(self, assign: UnitAssignment, fl):
        """The topology's chunk-streamed aggregation stage (DESIGN.md
        §13): ``(init, accumulate, finalize)`` over the packed carry
        primitives of core/aggregation.py.  ``init(global) -> acc``;
        ``accumulate(acc, pdeltas, rows, valid, weights, positions) ->
        acc`` folds one chunk of packed uploads (``positions`` are the
        chunk's cohort positions, in order); ``finalize(global, acc,
        sel, weights) -> new_global`` applies the full-cohort
        denominators.  Streaming any chunking of the cohort in order
        reproduces the single-shot packed aggregate bitwise.
        """
        raise ValueError(
            f"topology {self.name!r} has no chunked cohort path; set "
            "FLConfig.cohort_chunk=0/n_registered=0 or use "
            "hub/hierarchical")

    def round_bytes(self, sel: np.ndarray, ubytes: np.ndarray,
                    fl) -> Dict[str, float]:
        raise NotImplementedError

    def buffered_round_bytes(self, entry_sel: np.ndarray,
                             client_ids: np.ndarray, ubytes: np.ndarray,
                             fl) -> Dict[str, float]:
        """Per-flush byte math for buffered async rounds (one
        ``entry_sel`` row per buffered update)."""
        raise ValueError(
            f"topology {self.name!r} has no buffered-async accounting")

    def summary(self, assign: UnitAssignment, params,
                sel_history: np.ndarray, fl,
                wire_ubytes: Optional[np.ndarray] = None
                ) -> Dict[str, float]:
        """Run-level comm summary over ``sel_history (rounds, C, U)``;
        the same core keys for every topology.

        ``wire_ubytes`` (the codec-encoded per-unit byte table) bills
        the per-round uplink at wire width; the ``reduction_vs_full``
        denominator stays the fp32 full-model round.
        """
        ub = comm.unit_bytes(assign, params)
        wub = ub if wire_ubytes is None else wire_ubytes
        counts = comm.unit_param_counts(assign, params)
        hist = np.asarray(sel_history)
        per_round = [self.round_bytes(s, wub, fl)["uplink"] for s in hist]
        per_round_params = np.einsum("rcu,u->r", hist, counts)
        full = self.round_bytes(np.ones_like(hist[0]), ub, fl)["uplink"]
        return {
            "avg_uplink_bytes": float(np.mean(per_round)),
            "avg_trained_params": float(per_round_params.mean()),
            "total_uplink_bytes": float(np.sum(per_round)),
            "reduction_vs_full": 1.0 - float(np.mean(per_round)) / full
            if full else 0.0,
        }

    # -- mesh view --------------------------------------------------------

    def make_mesh(self, fl, *, multi_pod: bool = False,
                  device_type: str = "cuda"):
        from ..launch.mesh import make_fl_mesh
        return make_fl_mesh(fl.n_clients, multi_pod=multi_pod,
                            device_type=device_type)

    def __repr__(self):
        return f"{type(self).__name__}(name={self.name!r})"


# ---------------------------------------------------------------------------
# registry (mirrors core/strategies.py)

_REGISTRY: Dict[str, Topology] = {}


class UnknownTopologyError(ValueError):
    pass


def register_topology(obj: Union[Type[Topology], Topology], *,
                      name: Optional[str] = None):
    """Register a topology class (instantiated with no args) or
    instance.  Usable as a decorator."""
    topo = obj() if isinstance(obj, type) else obj
    key = name or topo.name
    if not key:
        raise ValueError(f"topology {obj!r} has no name")
    _REGISTRY[key] = topo
    return obj


def unregister_topology(name: str):
    _REGISTRY.pop(name, None)


def registered_topologies() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_topology(name: str) -> Topology:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise UnknownTopologyError(unknown_name_message(
            "topology", name, _REGISTRY)) from None


def resolve_topology(spec: Union[str, Topology, None]) -> Topology:
    """Name or instance -> instance (None -> the hub default)."""
    if spec is None:
        return get_topology("hub")
    return get_topology(spec) if isinstance(spec, str) else spec


# ---------------------------------------------------------------------------
# built-in topologies

@register_topology
class Hub(Topology):
    """The paper's FEDn combiner star: every client talks to one hub."""
    name = "hub"

    def build_round_step(self, loss_fn, assign, fl, loss_kwargs=None, *,
                         strategy=None, scores=None, device):
        return _star_round_step(
            loss_fn, assign, fl, loss_kwargs, strategy=strategy,
            scores=scores, device=device, fused=fl.resolve_fused_agg(device),
            aggregate_packed=lambda g, d, r, v, sel, w:
                masked_fedavg_packed(g, d, r, v, sel, w, assign))

    def build_buffered_flush(self, assign, fl):
        def flush(g, pdeltas, rows, valid, sel, weights, client_ids):
            return masked_fedavg_packed(g, pdeltas, rows, valid, sel,
                                        weights, assign)
        return flush

    def build_chunk_agg(self, assign, fl):
        def init(g):
            return packed_acc_init(assign, g)

        def accumulate(acc, pdeltas, rows, valid, weights, positions):
            return packed_accumulate(assign, acc, pdeltas, rows, valid,
                                     weights)

        def finalize(g, acc, sel, weights):
            return packed_finalize(assign, g, acc, sel, weights)

        return init, accumulate, finalize

    def round_bytes(self, sel, ubytes, fl):
        return comm.hub_round_bytes(
            sel, ubytes,
            downlink="selected" if fl.synchronized else "full")

    def buffered_round_bytes(self, entry_sel, client_ids, ubytes, fl):
        return comm.buffered_hub_round_bytes(
            entry_sel, ubytes,
            downlink="selected" if fl.synchronized else "full")

    def summary(self, assign, params, sel_history, fl, wire_ubytes=None):
        # the exact Table 4 reproduction (uplink at codec wire width
        # when a codec is configured)
        return comm.table4_row(assign, params, sel_history,
                               wire_ubytes=wire_ubytes)


@register_topology
class Hierarchical(Topology):
    """Edge aggregators between clients and hub (FLConfig.n_edges).

    Clients are partitioned into contiguous edge groups; each edge
    reduces its clients' masked deltas into per-unit partial aggregates
    and only the per-edge selection union crosses the edge->hub WAN
    link — ``round_bytes`` reports that WAN term as ``uplink``.  The
    ``full`` strategy takes the same two-stage aggregate.
    """
    name = "hierarchical"

    def build_round_step(self, loss_fn, assign, fl, loss_kwargs=None, *,
                         strategy=None, scores=None, device):
        mem = torch.as_tensor(comm.edge_membership(fl.n_clients,
                                                   fl.resolve_n_edges()))
        if fl.resolve_fused_agg(device):
            agg = _fused_hier_aggregate(assign, mem)
        else:
            agg = lambda g, d, sel, w: hierarchical_masked_fedavg(  # noqa
                g, d, sel, w, assign, mem)
        return _star_round_step(
            loss_fn, assign, fl, loss_kwargs, strategy=strategy,
            scores=scores, device=device, aggregate=agg,
            aggregate_dense=agg,
            aggregate_packed=lambda g, d, r, v, sel, w:
                hierarchical_masked_fedavg_packed(g, d, r, v, sel, w,
                                                  assign, mem))

    def make_mesh(self, fl, *, multi_pod: bool = False,
                  device_type: str = "cuda"):
        from ..launch.mesh import make_hier_fl_mesh
        return make_hier_fl_mesh(fl.resolve_n_edges(), fl.n_clients,
                                 multi_pod=multi_pod,
                                 device_type=device_type)

    def build_buffered_flush(self, assign, fl):
        mem = torch.as_tensor(comm.edge_membership(fl.n_clients,
                                                   fl.resolve_n_edges()))

        def flush(g, pdeltas, rows, valid, sel, weights, client_ids):
            # (E, B) membership: entry j reduces at its client's edge
            ids = torch.as_tensor(np.asarray(client_ids), dtype=torch.long)
            return hierarchical_masked_fedavg_packed(
                g, pdeltas, rows, valid, sel, weights, assign, mem[:, ids])
        return flush

    def build_chunk_agg(self, assign, fl):
        mem = torch.as_tensor(comm.edge_membership(
            fl.n_clients, fl.resolve_n_edges()))
        edge_of = mem.argmax(0)                               # (C,)

        def init(g):
            return packed_acc_init(assign, g, n_edges=mem.shape[0])

        def accumulate(acc, pdeltas, rows, valid, weights, positions):
            # each chunk client lands in its edge's stage-1 partial
            pos = torch.as_tensor(np.asarray(positions), dtype=torch.long)
            return packed_accumulate(assign, acc, pdeltas, rows, valid,
                                     weights, edge_idx=edge_of[pos])

        def finalize(g, acc, sel, weights):
            return packed_finalize(assign, g, acc, sel, weights,
                                   membership=mem)

        return init, accumulate, finalize

    def round_bytes(self, sel, ubytes, fl):
        mem = comm.edge_membership(fl.n_clients, fl.resolve_n_edges())
        return comm.hierarchical_round_bytes(
            sel, ubytes, mem,
            downlink="selected" if fl.synchronized else "full")

    def buffered_round_bytes(self, entry_sel, client_ids, ubytes, fl):
        mem = comm.edge_membership(fl.n_clients, fl.resolve_n_edges())
        return comm.buffered_hierarchical_round_bytes(
            entry_sel, client_ids, ubytes, mem,
            downlink="selected" if fl.synchronized else "full")


@register_topology
class Gossip(Topology):
    """Hubless peer averaging over a doubly-stochastic ring.

    The server state is the stacked per-client replicas (leading C axis)
    carried across rounds.  Per round each client runs masked local
    training from its OWN replica, then the replicas mix: ``x' = W @ x``
    in fp32 with the ring Metropolis matrix W.  W is doubly stochastic,
    so the uniform replica average — ``global_params`` — is preserved by
    mixing and drifts only through local training.  Client data weights
    reweight nothing here; zero-weight clients (stragglers) train (their
    loss is reported, as in the reference) but their update is not
    applied, and they still mix.  No aggregation kernel runs.

    A withheld update leaves the replica untouched (``torch.where``),
    where the reference adds ``delta * 0``: the two agree on finite
    deltas up to the sign of a zero, and a NaN delta of a zero-weight
    client leaves the port's replicas finite where the reference's
    replica takes the NaN and the mix spreads it (a parity limit,
    ``tests/test_torch_topology.py``).
    """
    name = "gossip"
    stateful = True

    def init_state(self, params, fl):
        c = fl.n_clients
        return {p: x.unsqueeze(0).repeat((c,) + (1,) * x.ndim)
                for p, x in params.items()}

    def global_params(self, state, fl):
        return {p: x.float().mean(0).to(x.dtype) for p, x in state.items()}

    def build_round_step(self, loss_fn, assign, fl, loss_kwargs=None, *,
                         strategy=None, scores=None, device):
        if fl.packed:
            raise ValueError(
                "packed round path: gossip mixing blends full replicas, "
                "so there is nothing to pack — use hub or hierarchical")
        if fl.client_shards:
            raise ValueError(
                "client_shards: gossip carries per-client replicas as "
                "server state and mixes them with a ring matmul — the "
                "cohort cannot shard over the client mesh axis; use "
                "hub or hierarchical")
        strat, ctx = _selection_setup(assign, fl, strategy, scores)
        mix = torch.as_tensor(ring_mixing_matrix(fl.n_clients),
                              device=device)
        scoring = strat.stateful
        hook = dense_norm_hook(assign) if scoring else None

        def round_step(state, client_batches, weights,
                       gen: Optional[torch.Generator], *, sel_state=None):
            sel = strat.select(gen, _live_ctx(ctx, sel_state))
            if fl.always_train_head:
                sel[:, -1] = 1.0
            active = torch.as_tensor(weights, dtype=torch.float32).cpu() > 0
            losses, deltas, norms = [], [], []
            for c in range(fl.n_clients):
                params_c = {p: x[c] for p, x in state.items()}
                d, m = local_update(
                    loss_fn, params_c, mask_tree(assign, sel[c], params_c),
                    {k: v[c] for k, v in client_batches.items()}, lr=fl.lr,
                    optimizer=fl.optimizer, prox_mu=fl.prox_mu,
                    loss_kwargs=loss_kwargs, norm_hook=hook)
                losses.append(m["loss_mean"])
                deltas.append(d)
                if scoring:
                    norms.append(m["unit_sqnorm"])
            deltas = tree_stack(deltas)
            keep = active.to(device)
            mixed = {}
            for p, x in state.items():
                upd = keep.reshape((-1,) + (1,) * (x.ndim - 1))
                trained = torch.where(upd, x + deltas[p].to(x.dtype), x)
                mixed[p] = torch.tensordot(
                    mix, trained.float(), dims=([1], [0])).to(x.dtype)
            per_client = torch.stack(losses)
            metrics = {"loss_mean": per_client.mean(),
                       "loss_per_client": per_client,
                       "sel": sel, "deltas": deltas}
            if scoring:
                metrics["unit_sqnorm"] = torch.stack(norms)
            return mixed, metrics

        round_step.selection_strategy = strat
        return round_step

    def round_bytes(self, sel, ubytes, fl):
        return comm.gossip_round_bytes(sel, ubytes)

    def summary(self, assign, params, sel_history, fl, wire_ubytes=None):
        # codecs are rejected for gossip at config time (no packed
        # uplink), so wire_ubytes can only be the fp32 table here
        out = Topology.summary(self, assign, params, sel_history, fl,
                               wire_ubytes)
        hist = np.asarray(sel_history)
        ub = comm.unit_bytes(assign, params)
        out["degree"] = comm.gossip_round_bytes(hist[0], ub)["degree"]
        return out
