"""Dry run: does (arch × shape × mesh) fit, and what bounds its step.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch qwen3-1.7b --shape train_4k [--mesh one] [--step fl_round]

The port of ``repro.launch.dryrun``.  The step runs once on the ``meta``
device, through ``launch/specs.py`` (``params_sds``, ``batch_specs``,
``cache_sds``) and ``launch/steps.py``: shapes and dtypes flow, nothing
is allocated, no card is needed (the reference lowers onto fake host
devices the same way).  Meta tensors take the card's routes: attention
goes where K5/K6 would run (``models.attention.attend``) and the kernel
wrapper adds the work the launch would do
(``kernels.flash_attention.ops.META_WORK``, from
``roofline.attention_work``), so the count is what the card computes,
not the plain chunks' full blocks.  In one run:

* FLOPs — ``torch.utils.flop_counter.FlopCounterMode`` over the step,
  plus attention's allowed pairs.  There is no scan, so the full depth
  runs and nothing is extrapolated (``depth_variants`` stays for the
  reference's schema);
* bytes — the operand and result bytes of every aten op that is not a
  view or a bare allocation (the op-level "bytes accessed" XLA's
  ``cost_analysis`` reports), plus attention's;
* memory — argument bytes exactly (params, optimizer moments, batch,
  cache, summed over the argument storages), and temps as the peak of
  the storage the step allocated and still held (weakref finalizers on
  each new storage).

Meshes: ``one`` (the default) is one card, chips 1.  ``single`` /
``multi`` keep the reference's 16x16 / 2x16x16 shapes; no per-rank
program is traced (the record says ``"per_device": "placements"``).
Per-device argument bytes come from ``launch/specs.py``'s specs, each
leaf divided by the mesh axes it is sharded over; FLOPs and temps are
divided by the ways the work splits (``_compute_split``: the data axes
the batch shards over, times the model axis where the layout shards the
matmuls on it).  Collective bytes per device, with ``n`` the size of
the axes a collective runs over and ring costs:

* all-gather — every leaf sharded over data axes (FSDP) is gathered
  once a forward, and once more a backward in ``train``:
  ``(n-1)/n · leaf bytes / model shards``;
* reduce-scatter — ``train``'s gradients of those leaves, the same
  bytes once; leaves replicated over the data axes all-reduce their
  gradients instead (``2(n-1)/n`` of the leaf's model shard);
* all-reduce — the tensor-parallel activations, two a layer (attention
  and MLP outputs) a forward, two more a backward and two for the remat
  recompute in ``train``: ``2(n-1)/n · tokens a data shard · d_model ·
  itemsize`` each, over the model axis;
* ``fl_round`` — ``core/comm.collective_round_bytes`` of the round's
  selection (the client-axis all-reduce's ring bytes), divided by the
  devices a client holds.

Record keys follow the reference's; where a reference key is an XLA
artifact the port records its counterpart (``RENAMED_KEYS``):
``lower_s`` -> ``trace_s`` (building the meta arguments and recording
the step's signature), ``compile_s`` -> none (nothing compiles),
``fits_hbm_16gb`` -> ``fits_hbm_80gb``; in ``cost_analysis``,
``raw_2macro`` / ``raw_3macro`` -> ``attention`` (K5/K6's share of the
full-depth count).  ``ADDED_KEYS`` are the port's own.

Writes one JSON record per run under ``results/dryrun/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time
import weakref
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..analysis.compileguard import CompileGuard
from ..common import TensorSpec
from ..common import pytree as pt
from ..configs.base import ArchConfig, get_config
from ..sharding import layout_for
from . import roofline, specs
from .shapes import SHAPES, InputShape, shape_applicable
from .steps import (default_loss_kwargs, make_decode_step, make_fl_round_step,
                    make_prefill_step, make_train_step)

META = torch.device("meta")
MESHES = {"one": {}, "single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
RENAMED_KEYS = {"lower_s": "trace_s", "compile_s": None,
                "fits_hbm_16gb": "fits_hbm_80gb"}
RENAMED_COST_KEYS = {"raw_2macro": None, "raw_3macro": "attention"}
ADDED_KEYS = ("device", "dtype", "per_device")
_ALLOC_ONLY = ("empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided")


def param_counts(cfg, params_sds) -> Dict[str, int]:
    total = pt.param_count(params_sds)
    active = total
    if cfg.moe is not None:
        from ..models.transformer import block_layout, n_macro
        n_moe_layers = sum(s.moe for s in block_layout(cfg)) * n_macro(cfg)
        e, k, ff = cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.expert_d_ff
        inactive = 3 * (e - k) * cfg.d_model * ff * n_moe_layers
        active = total - inactive
    return {"total": total, "active": active}


def depth_variants(cfg):
    """(2-macro cfg, 3-macro cfg, n_macro) of the reference's cost
    extrapolation; the port counts the full depth and keeps these for
    the schema."""
    if cfg.family == "audio":
        return (cfg.replace(n_layers=2, n_enc_layers=2),
                cfg.replace(n_layers=3, n_enc_layers=3), cfg.n_layers)
    from ..models.transformer import block_layout
    macro = len(block_layout(cfg))
    return (cfg.replace(n_layers=2 * macro), cfg.replace(n_layers=3 * macro),
            cfg.n_layers // macro)


# ---------------------------------------------------------------------------
# the counts

@dataclasses.dataclass
class StepCounts:
    """What one run of a step on ``meta`` counted (global, one device)."""
    flops: float = 0.0
    bytes: float = 0.0
    attention_flops: float = 0.0
    attention_bytes: float = 0.0
    argument_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    temp_bytes: int = 0


def _tensors(tree):
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Tally(TorchDispatchMode):
    """Bytes every aten op reads and writes, and the peak of the storage
    allocated while the mode is on and still alive."""

    def __init__(self, known_storages):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._known = set(known_storages)     # argument storages

    def _free(self, sid, n):
        self._known.discard(sid)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if not func.is_view and name not in _ALLOC_ONLY:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
        for t in _tensors(out):
            st = t.untyped_storage()
            sid = st._cdata
            if sid in self._known:
                continue
            self._known.add(sid)
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, sid, n)
        return out


def count_step(fn, args, *, flops: bool = True) -> tuple:
    """Run ``fn(*args)`` once and count it: ``(out, StepCounts)``."""
    from ..kernels.flash_attention import ops as fa_ops
    arg_t = _tensors(args)
    arg_storages = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                    for t in arg_t}
    counts = StepCounts(argument_bytes=int(sum(arg_storages.values())))
    fa_ops.META_WORK.update(flops=0, bytes=0)
    tally = _Tally(arg_storages)
    if flops:
        fc = FlopCounterMode(display=False)
        with fc, tally:
            out = fn(*args)
        counts.flops = float(fc.get_total_flops())
    else:
        with tally:
            out = fn(*args)
    counts.attention_flops = float(fa_ops.META_WORK["flops"])
    counts.attention_bytes = float(fa_ops.META_WORK["bytes"])
    counts.flops += counts.attention_flops
    counts.bytes = float(tally.bytes) + counts.attention_bytes
    counts.temp_bytes = int(tally.peak)
    seen = set()
    for t in _tensors(out):
        st = t.untyped_storage()
        if st._cdata in seen:
            continue
        seen.add(st._cdata)
        counts.output_bytes += st.nbytes()
        if st._cdata in arg_storages:
            counts.alias_bytes += st.nbytes()
    return out, counts


# ---------------------------------------------------------------------------
# the steps

def _meta(tree):
    """TensorSpecs (or tensors) -> empty tensors on ``meta``."""
    def one(x):
        if isinstance(x, TensorSpec):
            return torch.empty(x.shape, dtype=x.dtype, device=META)
        return x
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and not isinstance(tree, TensorSpec):
        return tuple(_meta(v) for v in tree)
    return one(tree)


def build_step(cfg, shape: InputShape, step_kind: str, *, remat: bool,
               dtype: torch.dtype, params=None, fl_fraction: float = 0.5,
               fl_synchronized: bool = False,
               fl_clients: Optional[int] = None, fl_topology: str = "hub",
               fl_edges: Optional[int] = None, fl_async_buffer: int = 0,
               fl_strategy: str = "uniform",
               loss_overrides: Optional[Dict] = None):
    """Returns (guard, args, tokens_processed, is_train, extra_record) on
    ``meta``; ``guard`` is the step as a one-signature CompileGuard.
    ``params`` are the meta params when the caller already built them."""
    params = specs.params_sds(cfg, dtype) if params is None else params
    extra: Dict[str, Any] = {}

    if step_kind == "train":
        from ..optim.masked import adam_init
        opt = adam_init(params)
        batch = _meta(specs.batch_specs(cfg, shape, dtype))
        kw = default_loss_kwargs(cfg, remat=remat)
        kw.update(loss_overrides or {})
        fn = make_train_step(cfg, loss_kwargs=kw)
        return CompileGuard(fn, name="dryrun_train", max_programs=1), \
            (params, opt, batch), shape.global_batch * shape.seq_len, \
            True, extra
    if step_kind == "prefill":
        batch = _meta(specs.batch_specs(cfg, shape, dtype))
        kw = default_loss_kwargs(cfg)
        kw.update(loss_overrides or {})
        fn = make_prefill_step(cfg, shape, loss_kwargs=kw)
        return CompileGuard(fn, name="dryrun_prefill", max_programs=1), \
            (params, batch), shape.global_batch * shape.seq_len, False, extra
    if step_kind == "decode":
        cache = specs.cache_sds(cfg, shape, dtype)
        token = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                            device=META)
        fn = make_decode_step(cfg)
        return CompileGuard(fn, name="dryrun_decode", max_programs=1), \
            (params, cache, token), shape.global_batch, False, extra
    if step_kind == "fl_round":
        c = fl_clients
        fn, assign, fl = make_fl_round_step(
            cfg, n_clients=c, train_fraction=fl_fraction,
            strategy=fl_strategy, synchronized=fl_synchronized,
            topology=fl_topology, n_edges=fl_edges,
            loss_kwargs=default_loss_kwargs(cfg, remat=remat), device=META)
        extra["fl"] = {"n_clients": c, "n_units": assign.n_units,
                       "n_train_units": fl.n_train_units,
                       "strategy": fl_strategy,
                       "synchronized": fl_synchronized,
                       "topology": fl_topology}
        if fl_topology == "hierarchical":
            extra["fl"]["n_edges"] = fl.resolve_n_edges()
        if fl_async_buffer:
            # buffered-async mode: the FLUSH program — the topology's
            # scatter-accumulate over a (B, ...) stacked buffer of packed
            # trained-slot updates (core/async_agg.py)
            from ..core.async_agg import flush_arg_specs
            from ..core.topology import resolve_topology
            fl = dataclasses.replace(fl, async_buffer=fl_async_buffer)
            extra["fl"]["async_buffer"] = fl_async_buffer
            flush = resolve_topology(fl_topology).build_buffered_flush(
                assign, fl)
            buf = _meta(flush_arg_specs(assign, params, fl))
            buf = buf[:4] + (torch.ones(fl_async_buffer),
                             np.arange(fl_async_buffer, dtype=np.int32) % c)
            return CompileGuard(flush, name="dryrun_async_flush",
                                max_programs=1), (params,) + buf, \
                fl_async_buffer * shape.seq_len, False, extra
        if fl_topology == "gossip":
            # stateful topology: per-client replicas
            params = {p: torch.empty((c,) + tuple(x.shape), dtype=x.dtype,
                                     device=META) for p, x in params.items()}
        b_per = max(shape.global_batch // c, 1)
        bspec = specs.batch_specs(
            cfg, dataclasses.replace(shape, global_batch=b_per), dtype)
        batch = {k: torch.empty((c, 1) + tuple(v.shape), dtype=v.dtype,
                                device=META) for k, v in bspec.items()}
        args = (params, batch, torch.ones(c),
                torch.Generator().manual_seed(0))
        strat = fn.selection_strategy
        kwargs = {}
        if strat.stateful:
            from ..core.strategies import SelectionContext
            kwargs["sel_state"] = strat.init_state(SelectionContext(
                n_clients=c, n_units=assign.n_units,
                n_train=fl.resolve_n_train(assign.n_units)))
            extra["fl"]["scored"] = True
        step = functools.partial(fn, **kwargs) if kwargs else fn
        return CompileGuard(step, name="dryrun_fl_round", max_programs=1), \
            args, b_per * c * shape.seq_len, True, extra
    raise ValueError(step_kind)


# ---------------------------------------------------------------------------
# placements

def _axes(spec_entry):
    if spec_entry is None:
        return ()
    return (spec_entry,) if isinstance(spec_entry, str) else tuple(spec_entry)


def _shards(spec, sizes, which=None) -> int:
    """Ways a leaf of ``spec`` is split (over ``which`` axes only)."""
    n = 1
    for e in spec:
        for a in _axes(e):
            if which is None or a in which:
                n *= sizes[a]
    return n


def _compute_split(layout: str, sizes: Dict[str, int]) -> int:
    from ..sharding.rules import _LOGICAL_TO_MESH
    dp = int(np.prod([sizes[a] for a in ("pod", "data") if a in sizes]))
    table = _LOGICAL_TO_MESH[layout]
    model = sizes.get("model", 1)
    uses_model = any("model" in _axes(table.get(k)) for k in ("ff", "fsdp"))
    return dp * (model if uses_model else 1)


def argument_bytes_per_device(tree, spec_tree, sizes) -> float:
    return float(sum(_nbytes(x) / _shards(spec_tree[p], sizes)
                     for p, x in tree.items()))


def collective_terms(cfg, step_kind, params, layout, sizes, tokens_dp,
                     itemsize, remat) -> Dict[str, float]:
    """Per-device collective bytes of one step from the placements (the
    formulas of the module docstring)."""
    from ..sharding import params_specs
    out = {k: 0.0 for k in ("all-reduce", "all-gather", "reduce-scatter",
                            "all-to-all", "collective-permute")}
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    n_dp = int(np.prod([sizes[a] for a in dp_axes]))
    pspecs = params_specs(params, layout, _Mesh(sizes))
    train = step_kind == "train"
    for p, x in params.items():
        spec = pspecs[p]
        shard = _nbytes(x) / _shards(spec, sizes, ("model",))
        n = _shards(spec, sizes, dp_axes)
        if n > 1:
            out["all-gather"] += (2 if train else 1) * (n - 1) / n * shard
            if train:
                out["reduce-scatter"] += (n - 1) / n * shard
        elif train and n_dp > 1:
            out["all-reduce"] += 2 * (n_dp - 1) / n_dp * shard
    from ..sharding.rules import _LOGICAL_TO_MESH
    m = sizes.get("model", 1)
    tp = "model" in _axes(_LOGICAL_TO_MESH[layout].get("ff"))
    if tp and m > 1:
        layers = cfg.n_layers + cfg.n_enc_layers
        per_layer = 2 * (3 if remat else 2) if train else 2
        payload = tokens_dp * cfg.d_model * itemsize
        out["all-reduce"] += layers * per_layer * 2 * (m - 1) / m * payload
    out["total"] = sum(out[k] for k in list(out))
    return out


class _Mesh:
    """A stand-in mesh: ``shape`` is ``{axis: size}`` (what
    ``sharding.rules.axis_sizes`` reads); no process group."""

    def __init__(self, sizes):
        self.shape = dict(sizes)


# ---------------------------------------------------------------------------
# the run

def run_dryrun(arch: Union[str, ArchConfig], shape_name: Union[str,
                                                              InputShape],
               *, mesh: str = "one", step_kind: str = "auto",
               layout: Optional[str] = None, batch: Optional[int] = None,
               fl_fraction: float = 0.5, fl_synchronized: bool = False,
               fl_topology: str = "hub", fl_async_buffer: int = 0,
               fl_strategy: str = "uniform", lower_only: bool = False,
               remat: bool = True, skip_accounting: bool = False,
               verbose: bool = True) -> Dict[str, Any]:
    """One dry-run record.  ``arch`` / ``shape_name`` are registered names
    or an ``ArchConfig`` / ``InputShape`` (a cut config); ``batch``
    overrides the shape's global batch."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if batch is not None:
        shape = dataclasses.replace(shape, global_batch=batch)
    ok, why = shape_applicable(cfg.name, cfg, shape)
    if not ok:
        return {"arch": cfg.name, "shape": shape.name, "skipped": True,
                "reason": why}
    if step_kind == "auto":
        step_kind = shape.kind
    sizes = MESHES[mesh]
    layout = layout or layout_for(cfg)
    if (step_kind == "decode" and cfg.family != "ssm" and sizes
            and cfg.n_kv_heads % sizes["model"] != 0
            and not layout.endswith("_hd")):
        layout = layout + "_hd"
    dtype = getattr(torch, cfg.param_dtype)
    t0 = time.perf_counter()
    record: Dict[str, Any] = {
        "arch": cfg.name, "shape": shape.name,
        "mesh": {"one": "1", "single": "16x16", "multi": "2x16x16"}[mesh],
        "step": step_kind, "layout": layout, "skipped": False,
        "device": "meta", "dtype": cfg.param_dtype,
        "per_device": "placements" if sizes else "one card",
    }
    chips = int(np.prod(list(sizes.values()))) if sizes else 1
    record["chips"] = chips
    fl_clients = cfg.fl_clients_single_pod * (2 if mesh == "multi" else 1)
    fl_edges = None
    if step_kind == "fl_round" and fl_topology == "hierarchical":
        from ..core.federation import FLConfig
        fl_edges = FLConfig(n_clients=fl_clients).resolve_n_edges()
        while cfg.fl_clients_single_pod % fl_edges:
            fl_edges -= 1

    params_shape = specs.params_sds(cfg, dtype)
    counts = param_counts(cfg, params_shape)
    record.update({"n_params": counts["total"],
                   "n_params_active": counts["active"]})

    guard, args, tokens, train, extra = build_step(
        cfg, shape, step_kind, remat=remat, dtype=dtype, params=params_shape,
        fl_fraction=fl_fraction, fl_synchronized=fl_synchronized,
        fl_clients=fl_clients, fl_topology=fl_topology, fl_edges=fl_edges,
        fl_async_buffer=fl_async_buffer, fl_strategy=fl_strategy)
    record.update(extra)
    guard.lower(*args)
    record["trace_s"] = round(time.perf_counter() - t0, 1)
    if lower_only:
        return record
    out, sc = count_step(guard, args, flops=not skip_accounting)
    # the retrace contract: the whole dry run saw one signature
    guard.assert_programs(1)

    split = _compute_split(layout, sizes) if sizes else 1
    ma = roofline.memory_analysis_terms(sc)
    if sizes:
        ma["argument_size_in_bytes"] = _args_per_device(
            args, step_kind, params_shape, layout, sizes, fl_clients)
        for k in ("temp_size_in_bytes", "output_size_in_bytes",
                  "alias_size_in_bytes"):
            ma[k] /= split
        ma["peak_bytes"] = ma["argument_size_in_bytes"] + \
            ma["temp_size_in_bytes"]
    record["memory_analysis"] = ma
    record["bytes_per_device"] = ma["peak_bytes"]
    record["fits_hbm_80gb"] = bool(ma["peak_bytes"] <= roofline.HBM_BYTES)
    if skip_accounting:
        record["total_s"] = round(time.perf_counter() - t0, 1)
        return record

    flops, hbytes = sc.flops / split, sc.bytes / split
    coll = {k: 0.0 for k in ("all-reduce", "all-gather", "reduce-scatter",
                             "all-to-all", "collective-permute", "total")}
    if sizes and step_kind == "fl_round" and not fl_async_buffer:
        coll["all-reduce"] = _fl_collective(cfg, out, params_shape, chips,
                                            fl_clients)
        coll["total"] = coll["all-reduce"]
    elif sizes and step_kind != "fl_round":
        tokens_dp = (shape.global_batch * (1 if step_kind == "decode"
                                           else shape.seq_len)) / \
            int(np.prod([sizes[a] for a in ("pod", "data") if a in sizes]))
        coll = collective_terms(cfg, step_kind, params_shape, layout, sizes,
                                tokens_dp, torch.empty((), dtype=dtype)
                                .element_size(), remat)
    terms = roofline.roofline_terms(hlo_flops=flops, hlo_bytes=hbytes,
                                    coll_bytes=coll["total"],
                                    dtype=cfg.param_dtype)
    mf = roofline.model_flops(cfg, counts["total"], counts["active"],
                              tokens, train=train)
    record.update({
        "cost_analysis": {"flops_per_device": flops,
                          "bytes_per_device": hbytes,
                          "attention": {"flops": sc.attention_flops / split,
                                        "bytes": sc.attention_bytes / split}},
        "collective_bytes": coll,
        "roofline": terms,
        "model_flops_global": mf,
        "useful_flops_ratio": (mf / chips / flops) if flops else None,
        "total_s": round(time.perf_counter() - t0, 1),
    })
    if verbose:
        _print_record(record)
    return record


def _args_per_device(args, step_kind, params, layout, sizes,
                     fl_clients) -> float:
    """Per-device argument bytes: params and optimizer moments by their
    specs, the batch / cache / token split over the data axes (for
    ``fl_round`` the FL mesh (client, data, model), client x data =
    the data-parallel chips)."""
    from ..sharding import params_specs
    msizes = dict(sizes)
    if step_kind == "fl_round":
        dp = int(np.prod([sizes[a] for a in ("pod", "data") if a in sizes]))
        msizes = {"client": fl_clients, "data": max(dp // fl_clients, 1),
                  "model": sizes["model"]}
    pspecs = params_specs(params, layout, _Mesh(msizes))
    n_dp = int(np.prod([msizes[a] for a in ("client", "pod", "data")
                        if a in msizes]))
    total = argument_bytes_per_device(params, pspecs, msizes)
    if step_kind == "train":
        opt = args[1]
        total += argument_bytes_per_device(opt.mu, pspecs, msizes)
        total += argument_bytes_per_device(opt.nu, pspecs, msizes)
    rest = args[2:] if step_kind == "train" else args[1:]
    total += sum(_nbytes(t) for t in _tensors(rest)) / n_dp
    return float(total)


def _fl_collective(cfg, out, params, chips, n_clients) -> float:
    """The client-axis all-reduce's ring bytes of the round's selection
    (``core/comm.collective_round_bytes``), a device's share."""
    from ..core import comm
    from ..core.masking import build_units_zoo
    _, metrics = out
    sel = np.asarray(metrics["sel"], np.float32)
    ub = comm.unit_bytes(build_units_zoo(cfg, params), params)
    ring = comm.collective_round_bytes(sel, ub)["ring_bytes"]
    return float(ring / max(chips // n_clients, 1))


def _print_record(record):
    ma, r = record["memory_analysis"], record["roofline"]
    ca, coll = record["cost_analysis"], record["collective_bytes"]
    print(f"[{record['arch']} × {record['shape']} × {record['mesh']} × "
          f"{record['step']}] trace {record['trace_s']}s total "
          f"{record['total_s']}s on meta ({record['dtype']})")
    print(f"  params {record['n_params'] / 1e9:.2f}B (active "
          f"{record['n_params_active'] / 1e9:.2f}B)  layout "
          f"{record['layout']}")
    print(f"  memory/device: arg {ma['argument_size_in_bytes'] / 1e9:.2f}GB"
          f" temp {ma['temp_size_in_bytes'] / 1e9:.2f}GB"
          f" peak {ma['peak_bytes'] / 1e9:.2f}GB"
          f" fits80GB={record['fits_hbm_80gb']}")
    print(f"  per-device: {ca['flops_per_device']:.3e} FLOPs "
          f"(attention {ca['attention']['flops']:.3e}), "
          f"{ca['bytes_per_device']:.3e} B, {coll['total'] / 1e9:.3f} GB "
          f"coll (ar {coll['all-reduce'] / 1e9:.2f} ag "
          f"{coll['all-gather'] / 1e9:.2f} rs "
          f"{coll['reduce-scatter'] / 1e9:.2f})")
    ratio = record["useful_flops_ratio"]
    print(f"  roofline (H100): compute {r['compute_s'] * 1e3:.2f}ms memory "
          f"{r['memory_s'] * 1e3:.2f}ms collective "
          f"{r['collective_s'] * 1e3:.2f}ms -> {r['dominant']}-bound; "
          f"useful-FLOP ratio {None if ratio is None else round(ratio, 3)}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--mesh", default="one", choices=sorted(MESHES),
                    help="one card (default), or the reference's 16x16 / "
                         "2x16x16 meshes by placements")
    ap.add_argument("--step", default="auto",
                    choices=["auto", "train", "prefill", "decode", "fl_round"])
    ap.add_argument("--layout", default=None)
    ap.add_argument("--batch", type=int, default=None,
                    help="override the shape's global batch")
    ap.add_argument("--fl-fraction", type=float, default=0.5)
    ap.add_argument("--fl-synchronized", action="store_true")
    ap.add_argument("--fl-topology", default="hub",
                    choices=["hub", "hierarchical", "gossip"])
    ap.add_argument("--fl-strategy", default="uniform",
                    help="registered selection strategy; stateful "
                         "(scored) strategies run the round step with its "
                         "SelectionState argument")
    ap.add_argument("--fl-async-buffer", type=int, default=0,
                    help="run the buffered-async FLUSH (B stacked packed "
                         "updates) instead of the sync round step")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--skip-accounting", action="store_true")
    ap.add_argument("--lower-only", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)

    rec = run_dryrun(args.arch, args.shape, mesh=args.mesh,
                     step_kind=args.step, layout=args.layout,
                     batch=args.batch, fl_fraction=args.fl_fraction,
                     fl_synchronized=args.fl_synchronized,
                     fl_topology=args.fl_topology,
                     fl_strategy=args.fl_strategy,
                     fl_async_buffer=args.fl_async_buffer,
                     lower_only=args.lower_only, remat=not args.no_remat,
                     skip_accounting=args.skip_accounting)
    os.makedirs(args.out, exist_ok=True)
    suffix = "" if args.step == "auto" else f"_{args.step}"
    path = os.path.join(
        args.out, f"{args.arch}_{args.shape}_{args.mesh}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    print(f"wrote {path}")
    return rec


if __name__ == "__main__":
    main()
