"""Masked FedAvg through the hand-written CUDA kernel.

Tree-level wrapper: pack the deltas into unit tiles, run the fused
kernel, unpack.  Drop-in replacement for ``core.aggregation.
masked_fedavg`` (held to it in tests/test_torch_masked_agg.py and, on
the card, by chip_smoke.py).

The packing metadata — which unit owns each tile row, segment sizes,
row offsets — is a pure function of the unit assignment and the leaf
shapes, so it is planned ONCE (:func:`build_agg_plan`) and reused; the
row -> unit table goes to each device once (``AggPlan.row_unit_on``).

Layout.  Each (leaf, unit) segment is padded to whole ``tile`` rows.
The global tiles are ``(T, tile)`` and the deltas a client-stacked
``(C, T, tile)`` buffer: the hub round writes each client's delta
straight into its plane (:func:`pack_into`), and the kernel reads the
planes in place through their client stride — there is no ``(T, C,
tile)`` transpose copy as in the TPU wrapper.  The weights stay ``(C,
U)`` selections and ``(C,)`` client weights: the kernel looks each row's
unit up itself, so no ``(T, C)`` table is built per round.  A fused
round's new params are views of the kernel's output buffer, and the next
round reads them there (:func:`tile_source`) instead of packing them.

:func:`masked_agg` is the kernel's wrapper: it checks device, dtype,
shape, strides and alignment, launches the CUDA kernel for CUDA
tensors (counting each launch in ``masked_agg.launches`` and, by entry
point, in :data:`LAUNCHES`) and runs the plain version
(``ref.masked_agg_ref``) only for CPU tensors.

Dtypes.  The kernel has an fp32 and a bf16 instance (:data:`ENTRY`),
as the Pallas kernel has one for each dtype it is given: the global
tiles, the planes and the output are one of the two, sums are fp32.  A
tree's tiles take its leaves' dtype where every leaf is bf16, else fp32
(:func:`tile_dtype`): the reference concatenates the leaves, so an
all-bf16 tree gives bf16 tiles and a mixed one fp32; a float64 tree
(the card-vs-CPU parity's) is tiled in fp32, as before.
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
from .ref import bf16_agrees, masked_agg_ref

TILE = 2048
SOURCE = Path(__file__).resolve().parent / "csrc" / "masked_agg.cu"
# the kernel's C entry point for each dtype of tiles it takes
ENTRY = {torch.float32: "masked_agg_f32", torch.bfloat16: "masked_agg_bf16"}
LAUNCHES = {name: 0 for name in ENTRY.values()}


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
    n_units: int                 # U of the assignment
    tables: Dict[torch.device, torch.Tensor]   # row_unit_on's cache

    def row_unit_on(self, device) -> torch.Tensor:
        """``row_unit`` as an int32 tensor on ``device``, copied there
        once per plan (callers only read it)."""
        device = torch.device(device)
        if device not in self.tables:
            self.tables[device] = torch.as_tensor(
                self.row_unit.astype(np.int32), device=device)
        return self.tables[device]


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
                   np.asarray(row_unit, np.int64), assign.n_units, {})


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


def tile_dtype(tree: Dict[str, torch.Tensor]) -> torch.dtype:
    """The dtype ``tree``'s tiles take: bf16 where every leaf is bf16,
    else fp32 (module docstring)."""
    return torch.bfloat16 if all(x.dtype == torch.bfloat16
                                 for x in tree.values()) else torch.float32


def new_tile_buffer(plan: AggPlan, lead: Tuple[int, ...] = (), *,
                    device=None, dtype=torch.float32) -> torch.Tensor:
    """Uninitialised ``(*lead, T, tile)`` buffer of ``dtype``.  Its
    padding is never set: the kernel's output at a payload element reads
    only that element, and :func:`unpack` reads payload only."""
    return torch.empty(lead + (plan.n_rows, plan.tile), dtype=dtype,
                       device=device)


def unpack(plan: AggPlan, buf: torch.Tensor,
           like: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``(..., T, tile)`` -> tree with ``buf``'s leading dims and the
    leaf shapes and dtypes of ``like``.  Every leaf of ``buf``'s dtype
    is a view into ``buf``, with no copy (any other is cast): a stacked
    leaf's macro rows are consecutive segments of equal length
    (:func:`build_agg_plan`), so its ``(n_macro, ...)`` view strides over
    them and skips each segment's padding."""
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


def tile_source(plan: AggPlan, tree: Dict[str, torch.Tensor]
                ) -> Optional[torch.Tensor]:
    """The ``(T, tile)`` buffer whose :func:`unpack` views ``tree``'s
    leaves are, or None.

    A fused round's result is :func:`unpack`'s views of the kernel's
    output buffer, and the server keeps it as the next round's global
    params: the next round then reads its global tiles in place instead
    of packing them anew.  Every leaf must be of one dtype the kernel
    takes (fp32 or bf16), with exactly the storage, offset, strides and
    shape that ``unpack`` gives it; anything else (the first round, a
    restored checkpoint, a replaced or cast leaf) returns None, and the
    caller packs as before."""
    leaves = [tree.get(path) for path, _, _ in plan.leaves]
    if any(x is None for x in leaves) or leaves[0].dtype not in ENTRY or \
            any(x.dtype != leaves[0].dtype for x in leaves):
        return None
    storage = leaves[0].untyped_storage()
    if any(x.untyped_storage().data_ptr() != storage.data_ptr()
           for x in leaves):
        return None
    first = next(s for s in plan.segments if s.path == plan.leaves[0][0])
    base = leaves[0].storage_offset() - first.row * plan.tile
    esz = leaves[0].element_size()
    if base < 0 or (base + plan.n_rows * plan.tile) * esz > storage.nbytes():
        return None
    buf = leaves[0].as_strided((plan.n_rows, plan.tile), (plan.tile, 1),
                               base)
    if buf.data_ptr() % 16:
        return None
    views = unpack(plan, buf, tree)
    for (path, _, _), x in zip(plan.leaves, leaves):
        v = views[path]
        if (x.storage_offset(), x.stride(), x.shape) != \
                (v.storage_offset(), v.stride(), v.shape):
            return None
    return buf


def _check(name, x, shape, device, dtype):
    if x.device != device:
        raise ValueError(f"masked_agg: {name} is on {x.device}, "
                         f"expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"masked_agg: {name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"masked_agg: {name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")


@functools.lru_cache(maxsize=None)
def _kernel(entry: str):
    fn = getattr(_build.load(SOURCE), entry)
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# Launch shape: blocks of THREADS threads, each owning ``vec`` 16-byte
# vectors of one tile row (masked_agg.cu's note has the sweep that chose
# it).
THREADS = 64
MIN_BLOCKS = 8 * 132           # 8 blocks for each of the H100's 132 SMs
CHECK_ROWS = 1 << 16           # rows a plain-version call in check_kernel


def launch_vec(n_rows: int, tile: int, esz: int = 4) -> int:
    """16-byte vectors a thread for a ``(n_rows, tile)`` call of
    ``esz``-byte elements (4 fp32 or 8 bf16 a vector): 2 where that still
    gives at least :data:`MIN_BLOCKS` blocks, else 1 (CASA's 44 rows).  A
    block moves the same bytes in either dtype, so the rule is one: a
    2,048-element bf16 row is 256 vectors, 2 blocks at 2 a thread."""
    chunks = -(-(tile * esz // 16) // (THREADS * 2))
    return 2 if n_rows * chunks >= MIN_BLOCKS else 1


def masked_agg(g_t: torch.Tensor, d_t: torch.Tensor, sel_cu: torch.Tensor,
               w_c: torch.Tensor, row_unit: torch.Tensor) -> torch.Tensor:
    """global (T, tile); deltas (C, T, tile); selection (C, U); client
    weights (C,); row -> unit table (T,) int32 -> (T, tile).  Global,
    deltas and output are one dtype, fp32 or bf16 (a mix raises); the
    selection and weights fp32.

    The weight of (row t, client c) is ``sel_cu[c, row_unit[t]]·w_c[c]``;
    a client's plane is read only in the rows of units it selected
    (``ref.masked_agg_ref`` has the full contract).  CUDA tensors launch
    the CUDA kernel (or raise); CPU tensors run the plain version.
    ``d_t`` may be any view whose (T, tile) planes are contiguous — the
    kernel reads it through its client stride.  ``row_unit``'s entries
    must lie below U (the tiling plan's table does); the kernel does not
    check them.
    """
    for name, x, dims in (("global", g_t, 2), ("deltas", d_t, 3),
                          ("selection", sel_cu, 2),
                          ("client weights", w_c, 1),
                          ("row_unit", row_unit, 1)):
        if x.dim() != dims:
            raise ValueError(f"masked_agg: {name} has shape "
                             f"{tuple(x.shape)}, expected {dims} dims")
    t, tile = g_t.shape
    c, u = sel_cu.shape
    device, dtype = g_t.device, g_t.dtype
    if dtype not in ENTRY:
        raise ValueError(f"masked_agg: global must be float32 or bfloat16, "
                         f"got {dtype}")
    _check("global", g_t, (t, tile), device, dtype)
    _check("deltas", d_t, (c, t, tile), device, dtype)
    _check("selection", sel_cu, (c, u), device, torch.float32)
    _check("client weights", w_c, (c,), device, torch.float32)
    _check("row_unit", row_unit, (t,), device, torch.int32)
    if device.type == "cpu":
        return masked_agg_ref(g_t, d_t, sel_cu, w_c, row_unit)
    if device.type != "cuda":
        raise ValueError(f"masked_agg: no kernel for device {device}")
    if not all(x.is_contiguous() for x in (g_t, sel_cu, w_c, row_unit)):
        raise ValueError("masked_agg: global, selection, client weights and "
                         "row_unit must be contiguous")
    esz = g_t.element_size()
    vec = 16 // esz                       # elements a 16-byte vector
    if d_t.stride(2) != 1 or d_t.stride(1) != tile or d_t.stride(0) % vec:
        raise ValueError(
            f"masked_agg: each client plane of the deltas must be a "
            f"contiguous (T, tile) block with a client stride that is a "
            f"multiple of {vec}; got strides {d_t.stride()}")
    if tile % vec:
        raise ValueError(f"masked_agg: tile must be a multiple of {vec} "
                         f"for {dtype}, got {tile}")
    out = torch.empty_like(g_t)
    for name, x in (("global", g_t), ("deltas", d_t), ("out", out)):
        if x.data_ptr() % 16:
            raise ValueError(f"masked_agg: {name} is not 16-byte aligned")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _kernel(ENTRY[dtype])(
            g_t.data_ptr(), d_t.data_ptr(), sel_cu.data_ptr(),
            w_c.data_ptr(), row_unit.data_ptr(), out.data_ptr(), t, c, u,
            tile, d_t.stride(0), launch_vec(t, tile, esz), stream)
    if err != 0:
        raise RuntimeError(f"masked_agg: CUDA kernel launch failed with "
                           f"cudaError {err}")
    masked_agg.launches += 1
    LAUNCHES[ENTRY[dtype]] += 1
    return out


masked_agg.launches = 0


def masked_combine_packed(global_params, d_t: torch.Tensor,
                          sel_cu: torch.Tensor, w_c: torch.Tensor,
                          plan: AggPlan):
    """Fused ``new_u = g_u + Σ_c w_c·sel_cu·Δ_cu / Σ_c w_c·sel_cu`` over
    deltas already packed into a ``(C, T, tile)`` buffer.  The global
    tiles are read in place when ``global_params`` are the views of a
    previous call's output (:func:`tile_source`) of ``d_t``'s dtype, else
    packed into a new buffer of that dtype; the output is always a new
    buffer, so ``global_params`` are never written."""
    dev = d_t.device
    if tuple(sel_cu.shape) != (d_t.shape[0], plan.n_units):
        raise ValueError(f"masked_agg: selection has shape "
                         f"{tuple(sel_cu.shape)}, expected "
                         f"{(d_t.shape[0], plan.n_units)}")
    g_t = tile_source(plan, global_params)
    if g_t is None or g_t.device != dev or g_t.dtype != d_t.dtype:
        g_t = pack_into(plan, global_params,
                        new_tile_buffer(plan, device=dev, dtype=d_t.dtype))
    out_t = masked_agg(g_t, d_t, sel_cu.to(dev, torch.float32).contiguous(),
                       w_c.to(dev, torch.float32).contiguous(),
                       plan.row_unit_on(dev))
    return unpack(plan, out_t, global_params)


def masked_fedavg_fused(global_params, deltas, sel: torch.Tensor,
                        weights: torch.Tensor, assign: UnitAssignment, *,
                        tile: int = TILE, plan: Optional[AggPlan] = None):
    """Same contract as core.aggregation.masked_fedavg.

    deltas: client-stacked tree (C leading); sel (C, U); weights (C,).
    """
    if plan is None or plan.tile != tile:
        plan = build_agg_plan(assign, global_params, tile)
    dev = next(iter(global_params.values())).device
    d_t = pack_into(plan, deltas, new_tile_buffer(
        plan, (sel.shape[0],), device=dev, dtype=tile_dtype(global_params)))
    return masked_combine_packed(global_params, d_t, sel, weights, plan)


def check_kernel(k1_in, tol: float = 2e-5, *, nobody: bool = False
                 ) -> dict:
    """:func:`masked_agg` on ``k1_in = (g_t, d_t, sel_cu, w_c, row_unit)``
    against its plain version on every row, within ``tol`` in fp32 and
    by ``ref.bf16_agrees`` in bf16 (one bf16 step, or the fp32 sums' own
    rounding where the update cancels the global value) (the plain
    version run :data:`CHECK_ROWS` rows at a time, so that a plan of 10^6
    rows needs no full-size temporaries beside the output), bitwise
    repeatable, and the rows of a unit nobody selected unchanged (with
    ``nobody``, such rows must exist); then with a NaN planted in a plane
    whose unit its client did not select (in a row that moves where
    there is one): the output bitwise the clean one and the plain
    version's rows around it within the same bar.  Raises RuntimeError
    on a failure; returns the max abs error and the NaN's ``(client,
    row)`` (None where every plane is live)."""
    g_t, d_t, sel, w, ru = k1_in
    t = g_t.shape[0]

    def agree(got, want, a, b):
        if got.dtype == torch.bfloat16:
            return bool(bf16_agrees(got, want, g_t[a:b]).all())
        return torch.allclose(got, want, atol=tol, rtol=tol)

    out = masked_agg(*k1_in)
    err = 0.0
    for a in range(0, t, CHECK_ROWS):
        b = min(a + CHECK_ROWS, t)
        want = masked_agg_ref(g_t[a:b], d_t[:, a:b], sel, w, ru[a:b])
        e = float((out[a:b].float() - want.float()).abs().max())
        if not agree(out[a:b], want, a, b):
            raise RuntimeError(f"masked_agg disagrees with its plain version "
                               f"in rows {a}-{b}: max abs err {e}")
        err = max(err, e)
    del want
    if not torch.equal(out, masked_agg(*k1_in)):
        raise RuntimeError("masked_agg is not bitwise repeatable")
    live = sel[:, ru.long()] != 0                        # (C, T)
    still = ~live.any(0)
    if nobody and not bool(still.any()):
        raise RuntimeError("no row of a unit nobody selected to check")
    if not torch.equal(out[still], g_t[still]):
        raise RuntimeError("masked_agg changed a unit nobody selected")
    where = torch.nonzero(~live & live.any(0))
    if not len(where):
        where = torch.nonzero(~live)
    if not len(where):
        return {"max_abs_err": err, "nan_at": None}
    c0, t0 = (int(x) for x in where[0])
    saved = d_t[c0, t0, :4].clone()
    d_t[c0, t0, :4] = float("nan")
    try:
        out_n = masked_agg(*k1_in)
        a, b = max(t0 - 8, 0), t0 + 8
        near = masked_agg_ref(g_t[a:b], d_t[:, a:b], sel, w, ru[a:b])
    finally:
        d_t[c0, t0, :4] = saved
    if not (torch.equal(out_n, out) and
            agree(out_n[a:b], near, a, b)):
        raise RuntimeError(f"a NaN in client {c0}'s unselected row {t0} "
                           f"reached masked_agg's output")
    return {"max_abs_err": err, "nan_at": (c0, t0)}


def reset_launch_counts() -> None:
    masked_agg.launches = 0
    for name in LAUNCHES:
        LAUNCHES[name] = 0
