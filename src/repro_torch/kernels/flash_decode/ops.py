"""Flash decode through the hand-written CUDA kernel (K3), paged and
dense (K4).

:func:`paged_decode_attention` is the serving decode step's attention, in
the model layout of ``repro.kernels.flash_decode.ops``: ``q (B,1,H,hd)``,
pools ``(P, ps, Hkv, hd)`` (one layer's view of the engine's pool),
``page_table (B, MP)`` int32, ``valid_len (B,)`` int32.  It checks
device, dtype, shape, strides and alignment, launches the CUDA kernel
(``csrc/flash_decode_paged.cu``) for CUDA tensors, counting each call
that launches in ``paged_decode_attention.launches``, and runs the plain
version (``ref.paged_decode_ref``) only for CPU tensors.  The kernel
reads the pool in place through its strides: unlike the TPU wrapper,
which copies the whole layer pool into ``(Hkv, P, ps, hd)`` on every
call, nothing is copied.

:func:`flash_decode_paged` takes the reference kernel's own layout
(``q (BH,1,hd)``, pools ``(Hkv,P,ps,hd)``, ``valid_len (BH,)``), as
strided views onto the same launch, so that tests can hold it against
``repro.kernels.flash_decode.kernel.flash_decode_paged``.

:func:`decode_attention` (model layout: caches ``(B, S, Hkv, hd)``) and
:func:`flash_decode` (the reference kernel's layout: ``(BHkv, S, hd)``)
are K4, the dense decode of ``repro.kernels.flash_decode``, launched on
the same kernel: a dense cache is a pool of B pages of
``(S // blk_k)·blk_k`` tokens behind the table ``[[0], [1], ...]``, read
through the cache's own strides.  As in the reference, ``window > 0``
clamps valid lengths to the window (a ring cache), and positions at or
past ``(S // blk_k)·blk_k`` are never read (its grid has ``S // blk_k``
blocks).  Their launches count in ``paged_decode_attention.launches``
too, the one counter of K3's kernel.

Every launch runs the split plan of :func:`_plan_splits`: one block per
(sequence, KV head, split of ``span`` tokens), worked out on the host
from the batch, the KV heads, the table's capacity and the card's SM
count, never from ``valid_len`` (reading it would sync the decode step
on the card).  With more than one split the wrapper allocates the fp32
workspace of the partials and the C entry point enqueues the combine
kernel behind the split kernel; a call still counts once in
``paged_decode_attention.launches``.

At ``valid_len == 0`` the kernel returns zeros and the plain version
the mean of V (see ``ref.py``); the model never passes 0.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from .. import _build
from .ref import (decode_attention_ref, dense_span, flash_decode_paged_ref,
                  flash_decode_ref, paged_decode_ref)

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_decode_paged.cu"
HEAD_DIMS = (32, 64, 80, 128, 256)     # 80: stablelm-3b
N_REPS = (1, 2, 4, 5, 6, 8)     # GQA groups: 5 hymba-1.5b, qwen2.5-14b
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCKS_PER_SM = 4       # the plan's aim were every sequence full length
MIN_TILES = 2           # a split spans at least this many ring tiles
SPLIT_BYTES = 1 << 20   # and at most this many bytes of K and V


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load(SOURCE)
    fn = lib.flash_decode_paged
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 \
        + [ctypes.c_int64] * 9 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _tile_tokens(head_dim: int, elem: int) -> int:
    """Tokens of one ring stage, as the kernel's ``Shape::TILE``: a lane
    holds 16 bytes of a row, a row takes its chunks' count of lanes
    rounded up to a power of two (at most 32), a warp step covers ``32 /
    lanes per row`` tokens, and 4 warps take 4 steps each."""
    chunks = head_dim * elem // 16
    lanes = min(1 << (chunks - 1).bit_length(), 32)
    return 16 * (32 // lanes)


def _plan_splits(batch: int, n_kv_heads: int, max_pages: int,
                 page_size: int, n_sm: int, tile: int, row_bytes: int,
                 n_splits: Optional[int] = None) -> tuple:
    """``(n_splits, span)``: blocks per (sequence, KV head) and the tokens
    each covers, from ints the host holds (``row_bytes``: one token's K
    row of one KV head).  Aims at ``BLOCKS_PER_SM`` blocks per SM were
    every sequence as long as the table allows; no split spans more than
    ``SPLIT_BYTES`` of K and V (so that the last wave of a ragged batch,
    where a few blocks stream alone, stays short) or fewer than
    ``MIN_TILES`` tiles.  ``n_splits`` forces a count instead.  ``span``
    is a multiple of ``tile`` (and of small pages), and ``n_splits *
    span`` covers the table."""
    cap = max_pages * page_size
    granule = math.lcm(tile, page_size) if page_size <= 64 else tile
    if n_splits is None:
        want = -(-BLOCKS_PER_SM * n_sm // max(batch * n_kv_heads, 1))
        span = min(-(-cap // want), SPLIT_BYTES // (2 * row_bytes))
        span = max(MIN_TILES * tile, span)
    else:
        span = -(-cap // max(n_splits, 1))
    span = max(granule, -(-span // granule) * granule)
    return max(1, -(-cap // span)), span


class Plan(NamedTuple):
    n_splits: int
    span: int           # tokens per split
    tile: int           # tokens per ring stage
    blocks: int         # of the split kernel
    workspace_bytes: int


def plan(batch, n_kv_heads, n_rep, max_pages, page_size, head_dim, dtype,
         device, n_splits=None) -> Plan:
    """The launch's split plan for these shapes on ``device`` (a CUDA
    device: the SM count is the card's)."""
    elem = torch.finfo(dtype).bits // 8
    tile = _tile_tokens(head_dim, elem)
    dev = torch.device(device)
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    splits, span = _plan_splits(batch, n_kv_heads, max_pages, page_size,
                                _sm_count(index), tile, head_dim * elem,
                                n_splits)
    groups = batch * n_kv_heads
    ws = 4 * groups * splits * n_rep * (head_dim + 2) if splits > 1 else 0
    return Plan(splits, span, tile, groups * splits, ws)


def _check(name, q, k_pool, v_pool, page_table, valid_len):
    """Devices, dtypes and pool layout; ``page_table`` None for the dense
    decode (the wrapper makes its own)."""
    for tname, t in (("k_pool", k_pool), ("v_pool", v_pool),
                     ("page_table", page_table), ("valid_len", valid_len)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name}: {tname} is on {t.device}, expected "
                             f"{q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{name}: q must be float32 or bfloat16, got "
                         f"{q.dtype}")
    for tname, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype != q.dtype:
            raise ValueError(f"{name}: {tname} is {t.dtype}, q is {q.dtype}")
    for tname, t in (("page_table", page_table), ("valid_len", valid_len)):
        if t is not None and t.dtype != torch.int32:
            raise ValueError(f"{name}: {tname} must be int32, got {t.dtype}")
    if tuple(k_pool.shape) != tuple(v_pool.shape) or \
            tuple(k_pool.stride()) != tuple(v_pool.stride()):
        raise ValueError(f"{name}: k_pool and v_pool differ in shape or "
                         f"strides: {tuple(k_pool.shape)} "
                         f"{tuple(k_pool.stride())} vs {tuple(v_pool.shape)} "
                         f"{tuple(v_pool.stride())}")
    if page_table is not None and page_table.ndim != 2:
        raise ValueError(f"{name}: page_table must be (B, MP), got "
                         f"{tuple(page_table.shape)}")


def _launch(name, q, k_pool, v_pool, page_table, valid_len, out, *, b, h,
            hkv, hd, ps, q_s, p_s, o_s, v_s, splits=None):
    """Shared launch of both layouts; ``*_s`` are element strides:
    q/o ``(b, h)``, pools ``(page, token, kv head)``, valid ``(b, h)``.
    ``splits`` forces the plan's split count (tests only)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {HEAD_DIMS}")
    if h % hkv or h // hkv not in N_REPS:
        raise ValueError(f"{name}: {h} query heads over {hkv} KV heads: the "
                         f"group size must be one of {N_REPS}")
    vec = 16 // q.element_size()       # elements of one 16-byte load
    for tname, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {tname} must be contiguous in "
                             f"head_dim, strides {tuple(t.stride())}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} must be aligned to 16 bytes "
                             f"(the kernel's load width), its address is "
                             f"{t.data_ptr() % 16} bytes past")
    if any(s % vec for s in (*q_s, *p_s)):
        raise ValueError(f"{name}: strides {q_s} (q), {p_s} (pools) must be "
                         f"multiples of {vec} elements (16 bytes, the "
                         f"kernel's load width)")
    if not page_table.is_contiguous():
        raise ValueError(f"{name}: page_table must be contiguous")
    mp = page_table.shape[1]
    pl = plan(b, hkv, h // hkv, mp, ps, hd, q.dtype, q.device, splits)
    if pl.n_splits * pl.span >= 2 ** 31 or pl.blocks >= 2 ** 31:
        raise ValueError(f"{name}: {b} x {mp} pages of {ps} is too large")
    ws = (torch.empty(pl.workspace_bytes // 4, dtype=torch.float32,
                      device=q.device) if pl.n_splits > 1 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                        page_table.data_ptr(), valid_len.data_ptr(),
                        out.data_ptr(), ws.data_ptr() if ws is not None
                        else None, _DTYPES[q.dtype], hd, h // hkv, b, hkv,
                        mp, ps, pl.n_splits, pl.span, *q_s, *p_s, *o_s, *v_s,
                        1.0 / math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {err}")
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           valid_len: torch.Tensor) -> torch.Tensor:
    """Single-token attention through a page table (the serving decode
    step's hot op).

    q (B,1,H,hd); pools (P, ps, Hkv, hd); page_table (B, MP) int32;
    valid_len (B,) int32 — callers pre-clamp it to the ring allocation
    for sliding-window layers.  Returns (B,1,H,hd) in q's dtype.  CUDA
    tensors launch the kernel (or raise); CPU tensors run the plain
    version.
    """
    name = "paged_decode_attention"
    _check(name, q, k_pool, v_pool, page_table, valid_len)
    if q.ndim != 4 or q.shape[1] != 1 or k_pool.ndim != 4:
        raise ValueError(f"{name}: q must be (B,1,H,hd) and pools (P,ps,Hkv,"
                         f"hd), got {tuple(q.shape)}, {tuple(k_pool.shape)}")
    b, _, h, hd = q.shape
    _, ps, hkv, hd_k = k_pool.shape
    if hd_k != hd or tuple(page_table.shape[:1]) != (b,) or \
            tuple(valid_len.shape) != (b,):
        raise ValueError(f"{name}: shapes disagree: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}, page_table "
                         f"{tuple(page_table.shape)}, valid_len "
                         f"{tuple(valid_len.shape)}")
    if q.device.type == "cpu":
        return paged_decode_ref(q, k_pool, v_pool, page_table, valid_len)
    out = torch.empty((b, 1, h, hd), dtype=q.dtype, device=q.device)
    ks = k_pool.stride()
    return _launch(name, q, k_pool, v_pool, page_table, valid_len, out, b=b,
                   h=h, hkv=hkv, hd=hd, ps=ps,
                   q_s=(q.stride(0), q.stride(2)), p_s=(ks[0], ks[1], ks[2]),
                   o_s=(h * hd, hd), v_s=(valid_len.stride(0), 0))


paged_decode_attention.launches = 0


def flash_decode_paged(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, page_table: torch.Tensor,
                       valid_len: torch.Tensor) -> torch.Tensor:
    """The reference kernel's layout: q (BH,1,hd); pools (Hkv,P,ps,hd);
    page_table (B,MP) int32; valid_len (BH,) int32, one valid length per
    query head.  Returns (BH,1,hd).  The same launch as
    :func:`paged_decode_attention`, on strided views."""
    name = "flash_decode_paged"
    _check(name, q, k_pool, v_pool, page_table, valid_len)
    if q.ndim != 3 or q.shape[1] != 1 or k_pool.ndim != 4:
        raise ValueError(f"{name}: q must be (BH,1,hd) and pools (Hkv,P,ps,"
                         f"hd), got {tuple(q.shape)}, {tuple(k_pool.shape)}")
    bh, _, hd = q.shape
    hkv, _, ps, hd_k = k_pool.shape
    b = page_table.shape[0]
    if hd_k != hd or b == 0 or bh % b or tuple(valid_len.shape) != (bh,):
        raise ValueError(f"{name}: shapes disagree: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}, page_table "
                         f"{tuple(page_table.shape)}, valid_len "
                         f"{tuple(valid_len.shape)}")
    if q.device.type == "cpu":
        return flash_decode_paged_ref(q, k_pool, v_pool, page_table,
                                      valid_len)
    h = bh // b
    out = torch.empty((bh, 1, hd), dtype=q.dtype, device=q.device)
    ks = k_pool.stride()
    vs = valid_len.stride(0)
    return _launch(name, q, k_pool, v_pool, page_table, valid_len, out, b=b,
                   h=h, hkv=hkv, hd=hd, ps=ps,
                   q_s=(h * q.stride(0), q.stride(0)),
                   p_s=(ks[1], ks[2], ks[0]), o_s=(h * hd, hd),
                   v_s=(h * vs, vs))


def _identity_table(n, device):
    """(n, 1) int32 table [[0], [1], ...]: sequence i is page i."""
    return torch.arange(n, dtype=torch.int32, device=device).reshape(n, 1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid_len: torch.Tensor, *,
                     window: int = 0, blk_k: int = 512) -> torch.Tensor:
    """Single-token attention over a dense cache (K4), model layout.

    q (B,1,H,hd); caches (B,S,Hkv,hd); valid_len (B,) int32.  ``window >
    0`` means the cache is a ring buffer of that size: valid lengths are
    clamped to it.  Returns (B,1,H,hd) in q's dtype.  CUDA tensors launch
    K3's kernel (or raise); CPU tensors run the plain version.
    """
    name = "decode_attention"
    _check(name, q, k_cache, v_cache, None, valid_len)
    if q.ndim != 4 or q.shape[1] != 1 or k_cache.ndim != 4:
        raise ValueError(f"{name}: q must be (B,1,H,hd) and caches "
                         f"(B,S,Hkv,hd), got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}")
    b, _, h, hd = q.shape
    _, s, hkv, hd_k = k_cache.shape
    if hd_k != hd or k_cache.shape[0] != b or tuple(valid_len.shape) != (b,):
        raise ValueError(f"{name}: shapes disagree: q {tuple(q.shape)}, "
                         f"caches {tuple(k_cache.shape)}, valid_len "
                         f"{tuple(valid_len.shape)}")
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, valid_len,
                                    window=window, blk_k=blk_k)
    if window > 0:
        valid_len = torch.clamp(valid_len, max=window)
    out = torch.empty((b, 1, h, hd), dtype=q.dtype, device=q.device)
    ks = k_cache.stride()
    return _launch(name, q, k_cache, v_cache, _identity_table(b, q.device),
                   valid_len, out, b=b, h=h, hkv=hkv, hd=hd,
                   ps=dense_span(s, blk_k), q_s=(q.stride(0), q.stride(2)),
                   p_s=(ks[0], ks[1], ks[2]), o_s=(h * hd, hd),
                   v_s=(valid_len.stride(0), 0))


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid_len: torch.Tensor, *, blk_k: int = 512) -> torch.Tensor:
    """The reference kernel's layout: q (BH,1,hd); k/v (BHkv,S,hd);
    valid_len (BH,) int32, one per query head.  Returns (BH,1,hd).  Each
    KV head is launched as a sequence of its own, its n_rep query heads
    as that sequence's heads."""
    name = "flash_decode"
    _check(name, q, k, v, None, valid_len)
    if q.ndim != 3 or q.shape[1] != 1 or k.ndim != 3:
        raise ValueError(f"{name}: q must be (BH,1,hd) and k/v (BHkv,S,hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}")
    bh, _, hd = q.shape
    bhkv, s, hd_k = k.shape
    if hd_k != hd or bhkv == 0 or bh % bhkv or \
            tuple(valid_len.shape) != (bh,):
        raise ValueError(f"{name}: shapes disagree: q {tuple(q.shape)}, k/v "
                         f"{tuple(k.shape)}, valid_len "
                         f"{tuple(valid_len.shape)}")
    span = dense_span(s, blk_k)
    if q.device.type == "cpu":
        return flash_decode_ref(q, k[:, :span], v[:, :span], valid_len)
    n_rep = bh // bhkv
    out = torch.empty((bh, 1, hd), dtype=q.dtype, device=q.device)
    vs = valid_len.stride(0)
    return _launch(name, q, k, v, _identity_table(bhkv, q.device), valid_len,
                   out, b=bhkv, h=n_rep, hkv=1, hd=hd, ps=span,
                   q_s=(n_rep * q.stride(0), q.stride(0)),
                   p_s=(k.stride(0), k.stride(1), 0), o_s=(n_rep * hd, hd),
                   v_s=(n_rep * vs, vs))


def reset_launch_counts() -> None:
    paged_decode_attention.launches = 0
