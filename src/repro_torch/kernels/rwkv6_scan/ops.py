"""The RWKV-6 WKV scan through the hand-written CUDA kernel (K7).

:func:`rwkv6_scan` takes the reference kernel's layout (``repro.kernels.
rwkv6_scan.kernel``): r, k, log_decay ``(BH, S, dk)``, v ``(BH, S, dv)``,
u ``(BH, dk)``; :func:`wkv` the model layout (``repro.kernels.rwkv6_scan.
ops``): r, k, log_decay ``(B, S, H, dk)``, v ``(B, S, H, dv)``, u
``(H, dk)``.  Both return ``o`` in r's dtype and the final state in
float32.  Both check device, dtype, shape and strides, launch the CUDA
kernel (``csrc/rwkv6_scan.cu``) for CUDA tensors, counting each call that
launches in ``rwkv6_scan.launches`` (and by dtype in ``DTYPE_LAUNCHES``),
and run the plain chunked version
(``ref.rwkv6_scan_chunked_ref``) only for CPU tensors.  The kernel reads
both layouts through their strides: :func:`wkv` makes none of the
reference wrapper's ``(B, S, H, .) -> (BH, S, .)`` transpose copies.

The chunk rule is the reference kernel's: ``chunk = min(chunk, S)`` and
``S % chunk`` must be 0 (``ValueError`` otherwise); the model picks
``models.linear_scan.chunk_len(S, 16)``.  The kernel takes chunks of 1
to 32 tokens (its positive exponents fit float32 up to 16 at the
decay floor; see ``ref.py``).

The kernel cuts each row into segments (:func:`plan`): one segment per
row when the rows alone fill the card (one launch), else enough segments
of whole chunks to give every SM many blocks, walked in three launches
on the current stream (local segment states, the carry over segments,
the outputs; ``ref.rwkv6_scan_segmented_ref`` is the same in plain
PyTorch) with an fp32 workspace the wrapper allocates.  Its rows must
start 16-byte aligned and dk, dv fill whole 16-byte vectors
(``ValueError`` otherwise).

K7 has no backward, in either package: an input that requires a gradient
while grad mode is on raises (train through ``models.linear_scan.
chunked_linear_scan``, as the models' ``forward`` does).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from .. import _build
from .ref import rwkv6_scan_chunked_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "rwkv6_scan.cu"
MAX_CHUNK = 32
MAX_DK = 64
COLS = 64               # dv columns a block owns
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# launches by r's dtype, beside rwkv6_scan.launches (their sum)
DTYPE_LAUNCHES = {dtype: 0 for dtype in _DTYPES}
MIN_ROW_BLOCKS = 2      # rows alone give this many blocks per SM: no split
BLOCKS_PER_SM = 16      # what a split row aims at
MIN_SEG_CHUNKS = 2      # chunks a segment holds at least


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load(SOURCE)
    fn = lib.rwkv6_scan
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 \
        + [ctypes.c_int64] * 17 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan_segments(row_blocks: int, s: int, chunk: int, n_sm: int,
                   n_seg: Optional[int] = None) -> tuple:
    """``(n_seg, seg_len)`` for ``row_blocks`` blocks a segment (rows x
    column tiles) of ``s`` tokens in chunks of ``chunk``: one segment when
    the rows give ``MIN_ROW_BLOCKS`` blocks per SM, else as many as give
    ``BLOCKS_PER_SM`` blocks per SM, none shorter than ``MIN_SEG_CHUNKS``
    chunks.  ``n_seg`` asks for a count instead (clamped to the chunks
    and rounded so that every segment but the last holds as many).
    ``seg_len`` is a multiple of ``chunk``, and ``n_seg`` segments of it
    cover the row, the last one possibly shorter but never empty."""
    n_chunks = s // chunk
    if n_seg is None:
        if row_blocks >= MIN_ROW_BLOCKS * n_sm:
            n_seg = 1
        else:
            want = -(-BLOCKS_PER_SM * n_sm // max(row_blocks, 1))
            n_seg = n_chunks // max(MIN_SEG_CHUNKS,
                                    -(-n_chunks // want)) or 1
    per = -(-n_chunks // max(1, min(n_seg, n_chunks)))
    return -(-n_chunks // per), per * chunk


class Plan(NamedTuple):
    n_seg: int          # segments per row
    seg_len: int        # tokens per segment (the last may be shorter)
    blocks: int         # per walk launch: rows x column tiles x segments
    kernels: int        # launches per call: 1, or 3 with segments
    workspace_bytes: int


def plan(n_rows, s, chunk, dv, device, n_seg=None) -> Plan:
    """The launch plan for ``n_rows`` rows of ``s`` tokens in chunks of
    ``chunk`` on ``device`` (a CUDA device: the SM count is the card's);
    ``n_seg`` forces a segment count."""
    dev = torch.device(device)
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    row_blocks = n_rows * -(-dv // COLS)
    segs, seg_len = _plan_segments(row_blocks, s, chunk, _sm_count(index),
                                   n_seg)
    blocks = row_blocks * segs
    ws = 4 * blocks * (2 * MAX_DK * COLS + MAX_DK) if segs > 1 else 0
    return Plan(segs, seg_len, blocks, 1 if segs == 1 else 3, ws)


def _check(name, ins, want, chunk):
    """Devices, dtypes, shapes (``want``: name -> shape), the gradient
    rule and the chunk rule over ``S = want["r"][1]``; returns the
    chunk."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins.values()):
        raise RuntimeError(
            f"{name}: K7 has no backward (nor has the TPU kernel); an input "
            f"requires a gradient: train through models.linear_scan."
            f"chunked_linear_scan, or call this under torch.no_grad()")
    r = ins["r"]
    for tname, t in ins.items():
        if t.device != r.device:
            raise ValueError(f"{name}: {tname} is on {t.device}, expected "
                             f"{r.device}")
    if r.dtype not in _DTYPES or ins["log_decay"].dtype not in _DTYPES:
        raise ValueError(f"{name}: r and log_decay must be float32 or "
                         f"bfloat16, got {r.dtype}, {ins['log_decay'].dtype}")
    for tname in ("k", "v"):
        if ins[tname].dtype != r.dtype:
            raise ValueError(f"{name}: {tname} is {ins[tname].dtype}, r is "
                             f"{r.dtype}")
    if any(tuple(ins[n].shape) != tuple(want[n]) for n in want):
        raise ValueError(f"{name}: shapes disagree: " + ", ".join(
            f"{n} {tuple(ins[n].shape)}" for n in want))
    s = want["r"][1]
    if s < 1:
        raise ValueError(f"{name}: empty sequence")
    chunk = min(chunk, s)
    if chunk < 1 or s % chunk:
        raise ValueError(f"S {s} % chunk {chunk}")
    return chunk


def _launch(name, r, k, v, log_decay, u, *, n_rows, n_heads, s, dk, dv,
            chunk, strides, u_strides, o, state, segments=None):
    """``strides[x]`` = (batch, head, token) element strides of r, k, v,
    log_decay and o; rows are ``batch * n_heads + head``.  ``segments``
    forces the plan's segment count (tests only; the public wrappers have
    no such knob)."""
    if r.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {r.device}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"{name}: chunk {chunk} > {MAX_CHUNK}")
    if dk > MAX_DK:
        raise ValueError(f"{name}: dk {dk} > {MAX_DK}")
    for tname, t in (("r", r), ("k", k), ("v", v), ("log_decay", log_decay),
                     ("o", o)):
        n = dv if tname in ("v", "o") else dk
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {tname} must be contiguous in its "
                             f"channels, strides {tuple(t.stride())}")
        if (t.data_ptr() % 16 or (n * t.element_size()) % 16
                or any(x * t.element_size() % 16 for x in t.stride()[:-1])):
            raise ValueError(f"{name}: {tname} rows must start 16-byte "
                             f"aligned and hold whole 16-byte vectors: "
                             f"pointer {t.data_ptr()}, {n} channels, "
                             f"strides {tuple(t.stride())}")
    if n_rows >= 2 ** 31 or s >= 2 ** 31:
        raise ValueError(f"{name}: {n_rows} rows of {s} tokens is too large")
    pl = plan(n_rows, s, chunk, dv, r.device, segments)
    ws = torch.empty(pl.workspace_bytes // 4, dtype=torch.float32,
                     device=r.device) if pl.n_seg > 1 else None
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _kernel()(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                        log_decay.data_ptr(), u.data_ptr(), o.data_ptr(),
                        state.data_ptr(), None if ws is None else
                        ws.data_ptr(), _DTYPES[r.dtype],
                        _DTYPES[log_decay.dtype], n_rows, n_heads, s, dk, dv,
                        chunk, pl.n_seg, pl.seg_len,
                        *(x for n in ("r", "k", "v", "d", "o")
                          for x in strides[n]), *u_strides, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {err}")
    rwkv6_scan.launches += 1
    DTYPE_LAUNCHES[r.dtype] += 1
    return o, state


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               log_decay: torch.Tensor, u: torch.Tensor, *, chunk: int = 16):
    """The reference kernel's layout: r, k, log_decay (BH,S,dk); v
    (BH,S,dv); u (BH,dk).  Returns (o (BH,S,dv) in r's dtype, state
    (BH,dk,dv) float32).  CUDA tensors launch K7 (or raise); CPU tensors
    run the plain chunked version."""
    name = "rwkv6_scan"
    if r.ndim != 3 or v.ndim != 3:
        raise ValueError(f"{name}: r must be (BH,S,dk) and v (BH,S,dv), got "
                         f"{tuple(r.shape)}, {tuple(v.shape)}")
    bh, s, dk = r.shape
    dv = v.shape[-1]
    ins = {"r": r, "k": k, "v": v, "log_decay": log_decay, "u": u}
    chunk = _check(name, ins, {"r": (bh, s, dk), "k": (bh, s, dk),
                               "v": (bh, s, dv), "log_decay": (bh, s, dk),
                               "u": (bh, dk)}, chunk)
    if r.device.type == "cpu":
        return rwkv6_scan_chunked_ref(r, k, v, log_decay, u, chunk=chunk)
    o = torch.empty((bh, s, dv), dtype=r.dtype, device=r.device)
    state = torch.empty((bh, dk, dv), dtype=torch.float32, device=r.device)
    uf = u.to(torch.float32).contiguous()
    strides = {n: (t.stride(0), 0, t.stride(1)) for n, t in
               (("r", r), ("k", k), ("v", v), ("d", log_decay), ("o", o))}
    return _launch(name, r, k, v, log_decay, uf, n_rows=bh, n_heads=1, s=s,
                   dk=dk, dv=dv, chunk=chunk, strides=strides,
                   u_strides=(uf.stride(0), 0), o=o, state=state)


rwkv6_scan.launches = 0


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        log_decay: torch.Tensor, u: torch.Tensor, *, chunk: int = 16):
    """Model layout: r, k, log_decay (B,S,H,dk); v (B,S,H,dv); u (H,dk).
    Returns (o (B,S,H,dv) in r's dtype, state (B,H,dk,dv) float32).  CUDA
    tensors launch K7 on strided views (or raise); CPU tensors run the
    plain chunked version on the folded rows."""
    name = "wkv"
    if r.ndim != 4 or v.ndim != 4:
        raise ValueError(f"{name}: r must be (B,S,H,dk) and v (B,S,H,dv), "
                         f"got {tuple(r.shape)}, {tuple(v.shape)}")
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    ins = {"r": r, "k": k, "v": v, "log_decay": log_decay, "u": u}
    chunk = _check(name, ins, {"r": (b, s, h, dk), "k": (b, s, h, dk),
                               "v": (b, s, h, dv), "log_decay": (b, s, h, dk),
                               "u": (h, dk)}, chunk)
    if r.device.type == "cpu":
        def fold(x):
            return x.transpose(1, 2).reshape(b * h, s, -1)
        o, state = rwkv6_scan_chunked_ref(
            fold(r), fold(k), fold(v), fold(log_decay),
            u.expand(b, h, dk).reshape(b * h, dk), chunk=chunk)
        return (o.reshape(b, h, s, dv).transpose(1, 2),
                state.reshape(b, h, dk, dv))
    o = torch.empty((b, s, h, dv), dtype=r.dtype, device=r.device)
    state = torch.empty((b, h, dk, dv), dtype=torch.float32, device=r.device)
    uf = u.to(torch.float32).contiguous()
    strides = {n: (t.stride(0), t.stride(2), t.stride(1)) for n, t in
               (("r", r), ("k", k), ("v", v), ("d", log_decay), ("o", o))}
    return _launch(name, r, k, v, log_decay, uf, n_rows=b * h, n_heads=h,
                   s=s, dk=dk, dv=dv, chunk=chunk, strides=strides,
                   u_strides=(0, uf.stride(0)), o=o, state=state)


def reset_launch_counts() -> None:
    rwkv6_scan.launches = 0
    for dtype in DTYPE_LAUNCHES:
        DTYPE_LAUNCHES[dtype] = 0
