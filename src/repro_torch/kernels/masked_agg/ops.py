"""Masked FedAvg through the hand-written CUDA kernel.

Tree-level wrapper: pack params/deltas into unit tiles, run the fused
kernel, unpack.  Drop-in replacement for ``core.aggregation.
masked_fedavg`` (held to it in tests/test_torch_masked_agg.py and, on
the card, by chip_smoke.py).

The packing metadata — which unit owns each tile row, segment sizes,
row offsets — is a pure function of the unit assignment and the leaf
shapes, so it is planned ONCE (:func:`build_agg_plan`) and reused.

Layout.  Each (leaf, unit) segment is padded to whole ``tile`` rows.
The global tiles are ``(T, tile)``, the weights ``(T, C)`` and the
deltas a client-stacked ``(C, T, tile)`` buffer: the hub round writes
each client's delta straight into its plane (:func:`pack_into`), and the
kernel reads the planes in place through their client stride — there
is no ``(T, C, tile)`` transpose copy as in the TPU wrapper.

:func:`masked_agg` is the kernel's wrapper: it checks device, dtype,
shape, strides and alignment, launches the CUDA kernel for CUDA
tensors (counting each launch in ``masked_agg.launches``) and runs the
plain version (``ref.masked_agg_ref``) only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...common import flatten_with_paths
from ...core.masking import UnitAssignment, leaf_unit_ids
from .. import _build
from .ref import masked_agg_ref

TILE = 2048
SOURCE = Path(__file__).resolve().parent / "csrc" / "masked_agg.cu"


class AggSegment(NamedTuple):
    """One contiguous run of tile rows belonging to one (leaf, unit)."""
    path: str
    unit: int        # freeze unit owning these rows
    n: int           # payload elements (before padding)
    n_tiles: int     # tile rows
    macro: int       # macro index within the leaf (-1 for scalar leaves)
    row: int         # first tile row


class AggPlan(NamedTuple):
    """Build-time tiling plan for the fused masked aggregation."""
    tile: int
    leaves: Tuple[Tuple[str, Tuple[int, ...], Tuple[int, ...]], ...]
    # (path, leaf shape, unit ids per macro row — len 1 for scalar)
    segments: Tuple[AggSegment, ...]
    n_rows: int                  # total tile rows
    row_unit: np.ndarray         # (n_rows,) unit id of every tile row


def build_agg_plan(assign: UnitAssignment, params, tile: int = TILE
                   ) -> AggPlan:
    """Plan the unit-tile packing once; only leaf *shapes* are read."""
    if tile % 4:
        raise ValueError(f"tile must be a multiple of 4, got {tile}")
    leaves, segments, row_unit = [], [], []
    n_rows = 0
    for path, leaf in flatten_with_paths(params):
        shape = tuple(leaf.shape)
        unit_ids = leaf_unit_ids(assign.leaf_units[path], shape)
        leaves.append((path, shape, tuple(int(u) for u in unit_ids)))
        if assign.leaf_units[path].kind == "scalar":
            sizes = [(int(np.prod(shape)) if shape else 1, -1)]
        else:
            per = int(np.prod(shape[1:])) if len(shape) > 1 else 1
            sizes = [(per, m) for m in range(shape[0])]
        for (n, macro), u in zip(sizes, unit_ids):
            nt = -(-n // tile)
            segments.append(AggSegment(path, int(u), n, nt, macro, n_rows))
            row_unit.extend([int(u)] * nt)
            n_rows += nt
    return AggPlan(tile, tuple(leaves), tuple(segments), n_rows,
                   np.asarray(row_unit, np.int64))


def _segment_views(plan: AggPlan, buf: torch.Tensor):
    """Yield ``(segment, view)``: the segment's payload inside ``buf
    (..., T, tile)`` as a ``(..., n)`` view."""
    lead = tuple(buf.shape[:-2])
    for seg in plan.segments:
        rows = buf[..., seg.row:seg.row + seg.n_tiles, :]
        yield seg, rows.reshape(lead + (seg.n_tiles * plan.tile,))[..., :seg.n]


def pack_into(plan: AggPlan, tree: Dict[str, torch.Tensor],
              buf: torch.Tensor) -> torch.Tensor:
    """Copy ``tree``'s leaves (with ``buf``'s leading dims) into their
    tile rows of ``buf (..., T, tile)``; padding is left untouched."""
    lead = tuple(buf.shape[:-2])
    for seg, view in _segment_views(plan, buf):
        leaf = tree[seg.path]
        flat = leaf.reshape(lead + (-1,)) if seg.macro < 0 else \
            leaf.reshape(lead + (leaf.shape[len(lead)], -1))[..., seg.macro, :]
        view.copy_(flat)
    return buf


def new_tile_buffer(plan: AggPlan, lead: Tuple[int, ...] = (), *,
                    device=None) -> torch.Tensor:
    """Uninitialised ``(*lead, T, tile)`` float32 buffer.  Its padding
    is never set: the kernel's output at a payload element reads only
    that element, and :func:`unpack` reads payload only."""
    return torch.empty(lead + (plan.n_rows, plan.tile), dtype=torch.float32,
                       device=device)


def unpack(plan: AggPlan, buf: torch.Tensor,
           like: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``(..., T, tile)`` -> tree with ``buf``'s leading dims and the
    leaf shapes and dtypes of ``like``.  Every float32 leaf is a view
    into ``buf``: a stacked leaf's macro rows are consecutive segments of
    equal length (:func:`build_agg_plan`), so its ``(n_macro, ...)``
    view strides over them and skips each segment's padding."""
    lead = tuple(buf.shape[:-2])
    flat = buf.reshape(lead + (-1,))
    first = {}
    for seg in plan.segments:
        first.setdefault(seg.path, seg)
    out = {}
    for path, shape, _ in plan.leaves:
        seg = first[path]
        start = seg.row * plan.tile
        if seg.macro < 0:
            view = flat[..., start:start + seg.n].view(lead + shape)
        else:
            span = seg.n_tiles * plan.tile
            view = flat[..., start:start + shape[0] * span].unflatten(
                -1, (shape[0], span))[..., :seg.n].view(lead + shape)
        out[path] = view.to(like[path].dtype)
    return out


def _check(name, x, shape, device):
    if x.device != device:
        raise ValueError(f"masked_agg: {name} is on {x.device}, "
                         f"expected {device}")
    if x.dtype != torch.float32:
        raise ValueError(f"masked_agg: {name} must be float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"masked_agg: {name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load(SOURCE)
    fn = lib.masked_agg_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def masked_agg(g_t: torch.Tensor, d_t: torch.Tensor,
               w_t: torch.Tensor) -> torch.Tensor:
    """global (T, tile); deltas (C, T, tile); weights (T, C) -> (T, tile).

    CUDA tensors launch the CUDA kernel (or raise); CPU tensors run the
    plain version.  ``d_t`` may be any view whose (T, tile) planes are
    contiguous — the kernel reads it through its client stride.
    """
    t, tile = g_t.shape
    c = d_t.shape[0]
    device = g_t.device
    _check("global", g_t, (t, tile), device)
    _check("deltas", d_t, (c, t, tile), device)
    _check("weights", w_t, (t, c), device)
    if device.type == "cpu":
        return masked_agg_ref(g_t, d_t, w_t)
    if device.type != "cuda":
        raise ValueError(f"masked_agg: no kernel for device {device}")
    if not (g_t.is_contiguous() and w_t.is_contiguous()):
        raise ValueError("masked_agg: global and weights must be contiguous")
    if d_t.stride(2) != 1 or d_t.stride(1) != tile or d_t.stride(0) % 4:
        raise ValueError(
            f"masked_agg: each client plane of the deltas must be a "
            f"contiguous (T, tile) block with a client stride that is a "
            f"multiple of 4; got strides {d_t.stride()}")
    if tile % 4:
        raise ValueError(f"masked_agg: tile must be a multiple of 4, "
                         f"got {tile}")
    out = torch.empty_like(g_t)
    for name, x in (("global", g_t), ("deltas", d_t), ("out", out)):
        if x.data_ptr() % 16:
            raise ValueError(f"masked_agg: {name} is not 16-byte aligned")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _kernel()(g_t.data_ptr(), d_t.data_ptr(), w_t.data_ptr(),
                        out.data_ptr(), t, c, tile, d_t.stride(0), stream)
    if err != 0:
        raise RuntimeError(f"masked_agg: CUDA kernel launch failed with "
                           f"cudaError {err}")
    masked_agg.launches += 1
    return out


masked_agg.launches = 0


def row_weights(plan: AggPlan, wsel: torch.Tensor,
                device) -> torch.Tensor:
    """``wsel (C, U)`` -> per-tile-row weights ``(T, C)`` on ``device``."""
    rows = torch.as_tensor(plan.row_unit)
    return wsel.float()[:, rows].t().contiguous().to(device)


def masked_combine_packed(global_params, d_t: torch.Tensor,
                          wsel: torch.Tensor, plan: AggPlan):
    """Fused ``new_u = g_u + Σ_c wsel_cu·Δ_cu / Σ_c wsel_cu`` over deltas
    already packed into a ``(C, T, tile)`` buffer."""
    dev = d_t.device
    g_t = pack_into(plan, global_params, new_tile_buffer(plan, device=dev))
    out_t = masked_agg(g_t, d_t, row_weights(plan, wsel, dev))
    return unpack(plan, out_t, global_params)


def masked_combine_fused(global_params, deltas, wsel: torch.Tensor,
                         assign: UnitAssignment, *, tile: int = TILE,
                         plan: Optional[AggPlan] = None):
    """``deltas``: client-stacked tree (C leading); ``wsel (C, U)`` is
    the per-client per-unit weight mass (``sel * weights``)."""
    if plan is None or plan.tile != tile:
        plan = build_agg_plan(assign, global_params, tile)
    dev = next(iter(global_params.values())).device
    d_t = pack_into(plan, deltas,
                    new_tile_buffer(plan, (wsel.shape[0],), device=dev))
    return masked_combine_packed(global_params, d_t, wsel, plan)


def masked_fedavg_fused(global_params, deltas, sel: torch.Tensor,
                        weights: torch.Tensor, assign: UnitAssignment, *,
                        tile: int = TILE, plan: Optional[AggPlan] = None):
    """Same contract as core.aggregation.masked_fedavg.

    deltas: client-stacked tree (C leading); sel (C, U); weights (C,).
    """
    wsel = sel.float() * weights.float().to(sel.device)[:, None]
    return masked_combine_fused(global_params, deltas, wsel, assign,
                                tile=tile, plan=plan)


def reset_launch_counts() -> None:
    masked_agg.launches = 0
