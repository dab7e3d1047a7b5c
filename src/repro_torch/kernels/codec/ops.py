"""Stochastic-rounding quantize-pack through the hand-written CUDA kernel.

:func:`quantize_pack` is the kernel's wrapper, with the contract of the
reference's ``kernels/codec/kernel.py::quantize_pack``: ``(R, P)``
float32 rows and uniforms in, ``(packed, scale)`` out.  It checks
device, dtype, shape and contiguity, launches the CUDA kernel
(``csrc/quantize_pack.cu``, two passes: row-chunk maxima, then quantize
and pack) for CUDA tensors, counting each call that launches in
``quantize_pack.launches``, and runs the plain version
(``ref.quantize_pack_ref``) only for CPU tensors.  An odd row at 4 bits
ends in a padded zero element, as the reference pads it; the kernel
writes that element's nibble itself, so no padded copy is made.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .. import _build
from .ref import INV_QMAX, quantize_pack_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "quantize_pack.cu"
CHUNK = 8192          # elements of one row per block (kChunk in the source)


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load(SOURCE)
    fn = lib.quantize_pack_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 2 \
        + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def quantize_pack(x: torch.Tensor, u: torch.Tensor, bits: int):
    """Quantize-pack rows of ``x`` with per-row absmax scales.

    ``x``, ``u``: ``(R, P)`` float32 (``u`` uniforms in ``[0, 1)``).
    Returns ``(packed, scale)``: ``(R, P)`` int8 for 8 bits or ``(R,
    ceil(P/2))`` uint8 for 4 bits, and ``(R,)`` float32 scales.  CUDA
    tensors launch the CUDA kernel (or raise); CPU tensors run the
    plain version.
    """
    if bits not in (8, 4):
        raise ValueError(f"quantize_pack: bits must be 8 or 4, got {bits}")
    if x.ndim != 2 or tuple(u.shape) != tuple(x.shape):
        raise ValueError(f"quantize_pack: x and u must be the same (R, P), "
                         f"got {tuple(x.shape)} and {tuple(u.shape)}")
    for name, t in (("x", x), ("u", u)):
        if t.dtype != torch.float32:
            raise ValueError(f"quantize_pack: {name} must be float32, got "
                             f"{t.dtype}")
        if t.device != x.device:
            raise ValueError(f"quantize_pack: {name} is on {t.device}, "
                             f"expected {x.device}")
    r, p = x.shape
    if p == 0:
        raise ValueError("quantize_pack: rows must not be empty")
    if x.device.type == "cpu":
        return quantize_pack_ref(x, u, bits)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_pack: no kernel for device {x.device}")
    if not (x.is_contiguous() and u.is_contiguous()):
        raise ValueError("quantize_pack: x and u must be contiguous")
    n_chunks = -(-p // CHUNK)
    if r * n_chunks >= 2 ** 31:
        raise ValueError(f"quantize_pack: {r} rows of {p} need more than "
                         f"2^31 - 1 blocks")
    cols, dtype = (p, torch.int8) if bits == 8 else ((p + 1) // 2,
                                                     torch.uint8)
    packed = torch.empty((r, cols), dtype=dtype, device=x.device)
    scale = torch.empty((r,), dtype=torch.float32, device=x.device)
    partial = torch.empty((r * n_chunks,), dtype=torch.float32,
                          device=x.device)
    if r == 0:
        return packed, scale
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(x.data_ptr(), u.data_ptr(), packed.data_ptr(),
                        scale.data_ptr(), partial.data_ptr(), r, p, bits,
                        INV_QMAX[bits], stream)
    if err != 0:
        raise RuntimeError(f"quantize_pack: CUDA kernel launch failed with "
                           f"cudaError {err}")
    quantize_pack.launches += 1
    return packed, scale


quantize_pack.launches = 0


def reset_launch_counts() -> None:
    quantize_pack.launches = 0
