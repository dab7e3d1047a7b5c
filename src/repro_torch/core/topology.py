"""Federation topologies as registered plugins (DESIGN.md §6).

A **topology** owns the aggregation stage of the round step and its
exact byte accounting (``round_bytes``/``summary``; core/comm.py has
the formulas).  Adding one is a subclass + ``@register_topology``.

Ported so far: ``hub`` — the paper's FEDn combiner star (the default).
Its masked aggregate goes through the fused CUDA kernel when
``FLConfig.resolve_fused_agg`` says so (``kernels/masked_agg``), with
each client's delta written straight into the kernel's client-stacked
tile buffer.  With ``FLConfig.packed`` the round runs on packed slot
buffers instead (DESIGN.md §7), the uplink codec round-trips the packed
deltas, and the hub's ``aggregate_packed`` reduces them; that path
ignores ``fused_agg``, as the reference's does.  ``hierarchical`` and
``gossip`` are not ported yet and :func:`resolve_topology` says so by
name.
"""
from __future__ import annotations

from typing import Callable, ClassVar, Dict, Optional, Type, Union

import numpy as np
import torch

from ..common import flatten_with_paths, tree_stack
from ..kernels.masked_agg import ops as agg_ops
from . import codecs as _codecs
from . import comm
from .aggregation import fedavg, masked_fedavg, masked_fedavg_packed
from .client import local_update, packed_cohort_fn
from .masking import UnitAssignment, mask_tree, slot_plan
from .registry import NotPortedError, unknown_name_message
from .strategies import SelectionContext, resolve_strategy

# topologies of the reference that wait for a later slice
_NOT_PORTED = ("gossip", "hierarchical")


def _selection_setup(assign: UnitAssignment, fl, strategy):
    """Resolve the strategy, validate n_train, build the selection
    context (shared preamble of every topology's round step)."""
    strat = resolve_strategy(strategy if strategy is not None
                             else fl.strategy, fl.synchronized)
    n_train = fl.resolve_n_train(assign.n_units)
    if not strat.dense and not 1 <= n_train <= assign.n_units:
        raise ValueError(
            f"n_train={n_train} out of range for {assign.n_units} units; "
            "set FLConfig.n_train_units or train_fraction")
    ctx = SelectionContext(n_clients=fl.n_clients, n_units=assign.n_units,
                           n_train=n_train)
    return strat, ctx


def _star_round_step(loss_fn: Callable, assign: UnitAssignment, fl,
                     loss_kwargs: Optional[Dict], *, strategy,
                     device: torch.device, fused: bool,
                     aggregate_packed: Optional[Callable] = None):
    """The star-topology skeleton: selection -> masked local training
    (an ordered loop over clients) -> masked FedAvg, fused or plain.

    With ``fl.packed`` (DESIGN.md §7) local training and aggregation run
    on packed slot buffers instead: ``aggregate_packed(g, pdeltas, rows,
    valid, sel, weights)`` reduces only the trained slots, and the codec
    (``fl.codec``) round-trips the packed deltas first.  That branch is
    taken whatever ``fused`` says.  The round step then takes two more
    keywords: ``uniform(i, shape)``, the stochastic-rounding draws of a
    stochastic codec, and ``codec_state``, the error-feedback residual
    of a stateful one (the new residual comes back in
    ``metrics["codec_state"]``).

    ``metrics["deltas"]`` is the client-stacked delta tree the round
    aggregated (views into the kernel's tile buffer on the fused path;
    the decoded packed deltas on the packed path).
    """
    strat, ctx = _selection_setup(assign, fl, strategy)
    use_packed = fl.packed and not strat.dense
    if use_packed and aggregate_packed is None:
        raise ValueError(
            f"topology {fl.topology!r} has no packed aggregation path; "
            "set FLConfig.packed=False")
    n_slots = fl.resolve_n_slots(ctx.n_units)
    packed_cohort = packed_cohort_fn(loss_fn, assign, fl, loss_kwargs)
    codec_fn = _codecs.build_codec_transform(
        _codecs.resolve_codec(fl.codec), assign, fl)
    plan = {}

    def packed_step(global_params, client_batches, weights, sel, uniform,
                    codec_state):
        plans = [slot_plan(assign, sel[c], n_slots, global_params)
                 for c in range(fl.n_clients)]
        paths = [p for p, _ in flatten_with_paths(global_params)]
        rows = {p: torch.stack([r[p] for r, _ in plans]) for p in paths}
        valid = {p: torch.stack([v[p] for _, v in plans]) for p in paths}
        deltas, m = packed_cohort(global_params, rows, valid, client_batches)
        # the plan on the round's device, moved once per leaf
        rows = {p: r.to(device) for p, r in rows.items()}
        valid = {p: v.to(device) for p, v in valid.items()}
        new_codec_state = None
        if codec_fn is not None:
            deltas, new_codec_state = codec_fn(deltas, rows, valid, weights,
                                               uniform, codec_state)
        new_params = aggregate_packed(global_params, deltas, rows, valid,
                                      sel, weights)
        metrics = {"loss_mean": m["loss_mean"].mean(),
                   "loss_per_client": m["loss_mean"],
                   "sel": sel,
                   "deltas": deltas}
        if new_codec_state is not None:
            metrics["codec_state"] = new_codec_state
        return new_params, metrics

    def round_step(global_params, client_batches, weights,
                   gen: Optional[torch.Generator], *, uniform=None,
                   codec_state=None):
        sel = strat.select(gen, ctx)
        if fl.always_train_head:
            sel[:, -1] = 1.0
        weights = torch.as_tensor(weights, dtype=torch.float32).cpu()
        if use_packed:
            return packed_step(global_params, client_batches, weights, sel,
                               uniform, codec_state)
        n = fl.n_clients
        fused_tiles = fused and not strat.dense
        if fused_tiles:
            if "plan" not in plan:
                plan["plan"] = agg_ops.build_agg_plan(assign, global_params)
            d_t = agg_ops.new_tile_buffer(plan["plan"], (n,), device=device)
        losses, deltas = [], []
        for c in range(n):
            # the dense (full) strategy trains every unit unmasked
            mask = None if strat.dense else \
                mask_tree(assign, sel[c], global_params)
            d, m = local_update(
                loss_fn, global_params, mask,
                {k: v[c] for k, v in client_batches.items()}, lr=fl.lr,
                optimizer=fl.optimizer, prox_mu=fl.prox_mu,
                loss_kwargs=loss_kwargs)
            losses.append(m["loss_mean"])
            if fused_tiles:
                # straight into the kernel's client plane: no stacked copy
                agg_ops.pack_into(plan["plan"], d, d_t[c])
            else:
                deltas.append(d)
        if strat.dense:
            deltas = tree_stack(deltas)
            new_params = fedavg(global_params, deltas, weights)
        elif fused_tiles:
            new_params = agg_ops.masked_combine_packed(
                global_params, d_t, sel * weights[:, None], plan["plan"])
            deltas = agg_ops.unpack(plan["plan"], d_t, global_params)
        else:
            deltas = tree_stack(deltas)
            new_params = masked_fedavg(global_params, deltas, sel, weights,
                                       assign)
        per_client = torch.stack(losses)
        metrics = {"loss_mean": per_client.mean(),
                   "loss_per_client": per_client,
                   "sel": sel,
                   "deltas": deltas}
        return new_params, metrics

    return round_step


class Topology:
    """Base class for federation-topology plugins.

    Subclasses set ``name`` and implement ``build_round_step``
    (aggregation stage) and ``round_bytes``/``summary`` (exact
    accounting).
    """

    name: ClassVar[str] = ""

    def build_round_step(self, loss_fn: Callable, assign: UnitAssignment,
                         fl, loss_kwargs: Optional[Dict] = None, *,
                         strategy=None, device: torch.device):
        raise NotImplementedError

    def round_bytes(self, sel: np.ndarray, ubytes: np.ndarray,
                    fl) -> Dict[str, float]:
        raise NotImplementedError

    def summary(self, assign: UnitAssignment, params,
                sel_history: np.ndarray, fl,
                wire_ubytes: Optional[np.ndarray] = None
                ) -> Dict[str, float]:
        """Run-level comm summary over ``sel_history (rounds, C, U)``;
        ``wire_ubytes`` bills the uplink at a codec's encoded width."""
        raise NotImplementedError

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


def get_topology(name: str) -> Topology:
    try:
        return _REGISTRY[name]
    except KeyError:
        if name in _NOT_PORTED:
            raise NotPortedError(
                f"topology {name!r} is not ported to repro_torch yet "
                f"(not yet ported: {', '.join(_NOT_PORTED)}; "
                f"registered: {', '.join(sorted(_REGISTRY))})") from None
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
                         strategy=None, device):
        return _star_round_step(
            loss_fn, assign, fl, loss_kwargs, strategy=strategy,
            device=device, fused=fl.resolve_fused_agg(device),
            aggregate_packed=lambda g, d, r, v, sel, w:
                masked_fedavg_packed(g, d, r, v, sel, w, assign))

    def round_bytes(self, sel, ubytes, fl):
        return comm.hub_round_bytes(
            sel, ubytes,
            downlink="selected" if fl.synchronized else "full")

    def summary(self, assign, params, sel_history, fl, wire_ubytes=None):
        # the exact Table 4 reproduction (uplink at codec wire width
        # when a codec is configured)
        return comm.table4_row(assign, params, sel_history,
                               wire_ubytes=wire_ubytes)
