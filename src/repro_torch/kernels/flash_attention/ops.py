"""Flash attention through the hand-written CUDA kernels (K5, K6).

:func:`flash_attention` is the differentiable op of
``repro.kernels.flash_attention.ops`` in the model layout: q
``(B, Sq, H, hd)``, k/v ``(B, Sk, Hkv, hd)`` with ``H`` a multiple of
``Hkv`` (query head ``h`` reads KV head ``h // (H // Hkv)``).  It is a
``torch.autograd.Function``: the forward launches K5 and saves q, k, v,
o and the per-row logsumexp; the backward launches K6's dQ and dK/dV
kernels, the latter summing each GQA group itself.  It is
once-differentiable, as the reference's ``custom_vjp`` has no second
derivative either.  :func:`attention_fwd` and :func:`attention_bwd` are
the same two steps called directly.

:func:`flash_attention_fwd` and :func:`flash_attention_bwd` take the
reference kernel's layout (``(BH, S, hd)`` / ``(BHkv, S, hd)``), as
strided views onto the same launches, so that tests can hold them
against ``repro.kernels.flash_attention.kernel``.  Unlike the Pallas
``flash_attention_bwd``, which returns dK/dV per query head, this one
returns them summed over each group, ``(BHkv, Sk, hd)``.

Dispatch is by device, then by dtype: CPU tensors run the plain
versions (``ref.py``); CUDA tensors launch the kernels or raise, fp32
ones the SIMT kernels of ``csrc/flash_attention.cu`` and bf16 ones the
tensor-core kernels of ``csrc/flash_attention_sm90.cu``
(:data:`SOURCES`), each source its own library with the same C entry
point.  Every tensor is read through its strides, so the reference
wrapper's transposes into the kernel layout are not copied.
``blk_q``/``blk_k`` only set the contract: the reference computes
``Sq // blk_q`` query blocks after
clamping the block to the length and leaves rows past them unwritten,
so a length that is not a multiple of its block raises ``ValueError``.
The kernels use their own tiles.  The model-layout functions take
``kv_len``: keys at or past it are masked, so a non-causal call padded
with zero keys to whole blocks (``models.attention.pad_noncausal``)
computes the unpadded call.  Head dim 80 runs head dim 128's kernels on
zero columns, with the scale of 80.  Launches are counted in
:data:`LAUNCHES` (``fwd``, ``dq``, ``dkv``) and, by the source whose
library took them, in :data:`SOURCE_LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch
from torch.autograd.function import once_differentiable

from .. import _build
from .ref import flash_attention_bwd_ref, flash_attention_fwd_ref

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {torch.float32: _CSRC / "flash_attention.cu",
           torch.bfloat16: _CSRC / "flash_attention_sm90.cu"}
HEAD_DIMS = (32, 64, 80, 128, 256)     # 80 (stablelm-3b) on 128's tiles
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FWD, _DQ, _DKV = 0, 1, 2
LAUNCHES = {"fwd": 0, "dq": 0, "dkv": 0}
SOURCE_LAUNCHES = {src.name: 0 for src in SOURCES.values()}


@functools.lru_cache(maxsize=None)
def _kernel(source: Path):
    fn = _build.load(source).flash_attention
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_blocks(name, sq, sk, blk_q, blk_k):
    """The reference's floor divisions (kernel.py:89-92) leave rows past
    ``(Sq // blk_q)·blk_q`` unwritten; the port refuses such lengths."""
    for what, n, blk in (("Sq", sq, blk_q), ("Sk", sk, blk_k)):
        if blk <= 0 or n % min(blk, n):
            raise ValueError(f"{name}: {what}={n} is not a multiple of its "
                             f"block {min(blk, n)}: the reference leaves "
                             f"the rest of the output undefined")


def _check(name, q, k, v, extra=()):
    """Model layout: q (B,Sq,H,hd), k/v (B,Sk,Hkv,hd); ``extra`` are
    (name, tensor, shape) of further inputs."""
    if q.dtype not in _DTYPES:
        raise ValueError(f"{name}: q must be float32 or bfloat16, got "
                         f"{q.dtype}")
    if q.ndim != 4 or k.ndim != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"{name}: q must be (B,Sq,H,hd) and k, v "
                         f"(B,Sk,Hkv,hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or k.shape[2] == 0 or \
            h % k.shape[2]:
        raise ValueError(f"{name}: shapes disagree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}: need the same batch and "
                         f"head_dim, and H a multiple of Hkv")
    for tname, t, shape in (("k", k, None), ("v", v, None), *extra):
        if t.device != q.device:
            raise ValueError(f"{name}: {tname} is on {t.device}, expected "
                             f"{q.device}")
        want = torch.float32 if tname in ("lse", "delta") else q.dtype
        if t.dtype != want:
            raise ValueError(f"{name}: {tname} is {t.dtype}, expected "
                             f"{want}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {tname} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")


def _row_strides(t):
    """Element strides (batch, sequence, head) of a (B,S,H,hd) tensor; a
    dimension of size 1 is never stepped along, so its stride is given as
    0 (autograd hands over gradients whose size-1 batch dimension has
    stride 1, which ``contiguous()`` leaves as it is)."""
    return tuple(0 if t.shape[d] == 1 else t.stride(d) for d in range(3))


def _launch(name, which, q, k, v, *, do=None, lse=None, delta=None,
            out0=None, out1=None, causal, window, kv_len):
    """One kernel launch on model-layout (possibly strided) tensors; lse
    and delta are (B,H,Sq) views; keys at or past ``kv_len`` are
    masked."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} not in {HEAD_DIMS}")
    ept = 16 // q.element_size()
    rows = (("q", q), ("k", k), ("v", v), ("do", do), ("out0", out0),
            ("out1", out1))
    for tname, t in rows:
        if t is None:
            continue
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {tname} must be contiguous in "
                             f"head_dim, strides {tuple(t.stride())}")
        if t.data_ptr() % 16 or any(s % ept for s in _row_strides(t)):
            raise ValueError(f"{name}: {tname} rows must start 16-byte "
                             f"aligned: pointer {t.data_ptr()}, strides "
                             f"{tuple(t.stride())}")
    if max(b, sq, sk, h) >= 2 ** 31 or window >= 2 ** 31:
        raise ValueError(f"{name}: sizes too large")
    tensors = (q, k, v, do, lse, delta, out0, out1)   # Slot order
    strides = []
    for t in tensors:
        if t is None:
            strides += (0, 0, 0)
        elif t is lse or t is delta:                 # (batch, head, seq)
            strides += t.stride()
        else:
            strides += _row_strides(t)
    ptrs = (ctypes.c_void_p * 8)(*[None if t is None else t.data_ptr()
                                   for t in tensors])
    dims = (ctypes.c_int64 * 9)(b, h, hkv, sq, sk, hd, int(bool(causal)),
                                int(window), kv_len)
    flat = (ctypes.c_int64 * 24)(*strides)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel(SOURCES[q.dtype])(
            which, ctypes.cast(ptrs, ctypes.c_void_p),
            ctypes.cast(dims, ctypes.c_void_p),
            ctypes.cast(flat, ctypes.c_void_p), _DTYPES[q.dtype],
            1.0 / math.sqrt(hd), stream)
    if err < 0:     # the bf16 kernels' TMA descriptors
        raise RuntimeError(f"{name}: no tensor map: cuTensorMapEncodeTiled "
                           f"gave CUresult {-err} (999: not found)")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {err}")
    LAUNCHES[("fwd", "dq", "dkv")[which]] += 1
    SOURCE_LAUNCHES[SOURCES[q.dtype].name] += 1


def _kv_len(name, k, kv_len):
    """The count of valid keys: all of k's by default, else 1..Sk."""
    sk = k.shape[1]
    if kv_len is None:
        return sk
    if not 1 <= int(kv_len) <= sk:
        raise ValueError(f"{name}: kv_len={kv_len} is not in 1..Sk={sk}")
    return int(kv_len)


def _forward_into(name, q, k, v, o, lse, causal, window, kv_len):
    """Forward into o (B,Sq,H,hd) and lse (B,H,Sq), both possibly views."""
    if q.device.type == "cpu":
        o_ref, lse_ref = flash_attention_fwd_ref(q, k, v, causal=causal,
                                                 window=window, kv_len=kv_len)
        o.copy_(o_ref)
        lse.copy_(lse_ref)
        return
    _launch(name, _FWD, q, k, v, lse=lse, out0=o, causal=causal,
            window=window, kv_len=kv_len)


def _backward_into(name, q, k, v, o, lse, do, dq, dk, dv, causal, window,
                   kv_len):
    """Backward into dq (B,Sq,H,hd), dk and dv (B,Sk,Hkv,hd)."""
    if q.device.type == "cpu":
        for out, ref in zip((dq, dk, dv), flash_attention_bwd_ref(
                q, k, v, o, lse, do, causal=causal, window=window,
                kv_len=kv_len)):
            out.copy_(ref)
        return
    # delta = rowsum(o * do), one PyTorch reduction, as kernel.py:241
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2)   # (B,H,Sq)
    _launch(name, _DQ, q, k, v, do=do, lse=lse, delta=delta, out0=dq,
            causal=causal, window=window, kv_len=kv_len)
    _launch(name, _DKV, q, k, v, do=do, lse=lse, delta=delta, out0=dk,
            out1=dv, causal=causal, window=window, kv_len=kv_len)


def attention_fwd(q, k, v, *, causal=True, window=0, kv_len=None):
    """Model layout forward: returns o (B,Sq,H,hd) in q's dtype and lse
    (B,H,Sq) fp32.  Keys at or past ``kv_len`` (default: Sk) are masked.
    CUDA tensors launch K5; CPU tensors run the plain version."""
    name = "attention_fwd"
    _check(name, q, k, v)
    kv_len = _kv_len(name, k, kv_len)
    b, sq, h, hd = q.shape
    o = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _forward_into(name, q, k, v, o, lse, causal, window, kv_len)
    return o, lse


def attention_bwd(q, k, v, o, lse, do, *, causal=True, window=0,
                  kv_len=None):
    """Model layout backward from the forward's o and lse: returns dq
    (B,Sq,H,hd) and dk, dv (B,Sk,Hkv,hd) summed over each GQA group (zero
    at and past ``kv_len``).  CUDA tensors launch K6 (dQ, then dK/dV);
    CPU tensors run the plain version."""
    name = "attention_bwd"
    b, sq, h, hd = q.shape
    _check(name, q, k, v, (("o", o, q.shape), ("do", do, q.shape),
                           ("lse", lse, (b, h, sq))))
    kv_len = _kv_len(name, k, kv_len)
    dq = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _backward_into(name, q, k, v, o, lse, do, dq, dk, dv, causal, window,
                   kv_len)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, kv_len):
        o, lse = attention_fwd(q, k, v, causal=causal, window=window,
                               kv_len=kv_len)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.kv_len = causal, window, kv_len
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # autograd may hand over a broadcast (stride 0) gradient
        do = do.to(q.dtype).contiguous()
        dq, dk, dv = attention_bwd(q, k, v, o, lse, do, causal=ctx.causal,
                                   window=ctx.window, kv_len=ctx.kv_len)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal=True, window=0, blk_q=128, blk_k=128,
                    *, kv_len=None):
    """Differentiable flash attention, model layout: q (B,Sq,H,hd), k/v
    (B,Sk,Hkv,hd) -> (B,Sq,H,hd) in q's dtype.  The reference's positional
    signature without ``interpret``, plus ``kv_len``: keys at or past it
    are masked (default: none), so a call padded with zero keys to whole
    blocks computes attention over its first ``kv_len`` keys; their
    gradients past it are zero."""
    _check_blocks("flash_attention", q.shape[1], k.shape[1], blk_q, blk_k)
    return _FlashAttention.apply(q, k, v, bool(causal), int(window),
                                 _kv_len("flash_attention", k, kv_len))


def _n_rep(q, k):
    """Query heads per KV head of kernel-layout q (BH,Sq,hd), k (BHkv,Sk,hd)."""
    if q.ndim != 3 or k.ndim != 3 or k.shape[0] == 0 or \
            q.shape[0] % k.shape[0]:
        raise ValueError(f"kernel layout: q must be (BH,Sq,hd) and k/v "
                         f"(BHkv,Sk,hd) with BH a multiple of BHkv, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    return q.shape[0] // k.shape[0]


def _q_view(t, n_rep):
    """(BH,S,hd) as a model-layout view (BHkv, S, n_rep, hd)."""
    return t.reshape(-1, n_rep, t.shape[1], t.shape[2]).permute(0, 2, 1, 3)


def _kv_view(t):
    """(BHkv,S,hd) as a model-layout view (BHkv, S, 1, hd)."""
    return t[:, :, None, :]


def flash_attention_fwd(q, k, v, *, causal=True, window=0, blk_q=128,
                        blk_k=128):
    """Kernel layout: q (BH,Sq,hd), k/v (BHkv,Sk,hd) -> o (BH,Sq,hd) in
    q's dtype and lse (BH,Sq) fp32, as the Pallas kernel returns."""
    name = "flash_attention_fwd"
    n_rep = _n_rep(q, k)
    _check_blocks(name, q.shape[1], k.shape[1], blk_q, blk_k)
    qm, km, vm = _q_view(q, n_rep), _kv_view(k), _kv_view(v)
    _check(name, qm, km, vm)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _forward_into(name, qm, km, vm, _q_view(o, n_rep),
                  lse.view(k.shape[0], n_rep, q.shape[1]), causal, window,
                  k.shape[1])
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, window=0,
                        blk_q=128, blk_k=128):
    """Kernel layout backward: returns dq (BH,Sq,hd) and dk, dv
    (BHkv,Sk,hd), already summed over each GQA group."""
    name = "flash_attention_bwd"
    n_rep = _n_rep(q, k)
    _check_blocks(name, q.shape[1], k.shape[1], blk_q, blk_k)
    if tuple(lse.shape) != tuple(q.shape[:2]):
        raise ValueError(f"{name}: lse has shape {tuple(lse.shape)}, "
                         f"expected {tuple(q.shape[:2])}")
    qm, om, dom = (_q_view(t, n_rep) for t in (q, o, do))
    km, vm = _kv_view(k), _kv_view(v)
    lse_m = lse.reshape(k.shape[0], n_rep, q.shape[1])
    _check(name, qm, km, vm, (("o", om, qm.shape), ("do", dom, qm.shape),
                              ("lse", lse_m, None)))
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _backward_into(name, qm, km, vm, om, lse_m, dom, _q_view(dq, n_rep),
                   _kv_view(dk), _kv_view(dv), causal, window, k.shape[1])
    return dq, dk, dv


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, SOURCE_LAUNCHES):
        for key in counts:
            counts[key] = 0
