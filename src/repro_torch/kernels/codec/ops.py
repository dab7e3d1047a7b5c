"""Stochastic-rounding quantize-pack through the hand-written CUDA kernel.

:func:`quantize_pack_group` is the kernel's wrapper: for a list of
leaves, each ``(R, P)`` float32 rows and uniforms, it returns each
leaf's ``(packed, scale)`` with the contract of the reference's
``kernels/codec/kernel.py::quantize_pack``, which the reference calls
once per leaf.  It checks every leaf's device, dtype, shape and
contiguity, launches the CUDA kernel (``csrc/quantize_pack.cu``: one
launch for up to :data:`MAX_LEAVES` leaves; rows of up to 8 chunks of
8192 read x once, longer rows twice, the second time mostly from L2)
for CUDA tensors, counting each launch in
``quantize_pack_group.launches``, and runs the plain version
(``ref.quantize_pack_group_ref``) only for CPU tensors.
:func:`quantize_pack` is one leaf, a group of one.  An odd row at 4
bits ends in a padded zero element, as the reference pads it; the
kernel writes that element's nibble itself, so no padded copy is made.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from .ref import INV_QMAX, quantize_pack_group_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "quantize_pack.cu"
CHUNK = 8192          # elements of one row a work item (kChunk)
MAX_LEAVES = 256      # leaves a launch (kMaxLeaves)
_ALIGN = 16           # bytes: each leaf's codes start 16-byte aligned
_F32 = torch.float32


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load(SOURCE)
    fn = lib.quantize_pack_group_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _fault(x, u, dev):
    """What is wrong with one leaf, or None."""
    if x.dim() != 2 or u.shape != x.shape:
        return (f"x and u must be the same (R, P), got {tuple(x.shape)} and "
                f"{tuple(u.shape)}")
    for name, t in (("x", x), ("u", u)):
        if t.dtype is not _F32:
            return f"{name} must be float32, got {t.dtype}"
        if t.device != dev:
            return f"{name} is on {t.device}, expected {dev}"
    if not x.shape[1]:
        return "rows must not be empty"
    if dev.type == "cuda" and not (x.is_contiguous() and u.is_contiguous()):
        return "x and u must be contiguous"
    return None


def _check(xs, us, bits):
    """Every leaf's shapes, dtypes, device and layout; returns the device
    (None for no leaves)."""
    if bits not in (8, 4):
        raise ValueError(f"quantize_pack: bits must be 8 or 4, got {bits}")
    if len(xs) != len(us):
        raise ValueError(f"quantize_pack: {len(xs)} x leaves but {len(us)} "
                         f"u leaves")
    if not xs:
        return None
    dev = xs[0].device
    for i, (x, u) in enumerate(zip(xs, us)):
        fault = _fault(x, u, dev)
        if fault:
            name = "quantize_pack" if len(xs) == 1 else \
                f"quantize_pack leaf {i}"
            raise ValueError(f"{name}: {fault}")
    return dev


def quantize_pack_group(xs: Sequence[torch.Tensor],
                        us: Sequence[torch.Tensor], bits: int
                        ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Quantize-pack the rows of every leaf ``xs[i]`` with uniforms
    ``us[i]`` and per-row absmax scales.

    ``xs[i]``, ``us[i]``: ``(R_i, P_i)`` float32 on one device.  Returns
    ``[(packed, scale)]`` in leaf order: ``(R_i, P_i)`` int8 for 8 bits
    or ``(R_i, ceil(P_i/2))`` uint8 for 4 bits, and ``(R_i,)`` float32
    scales.  CUDA tensors launch the CUDA kernel (or raise); CPU tensors
    run the plain version.
    """
    dev = _check(xs, us, bits)
    if dev is None:
        return []
    if dev.type == "cpu":
        return quantize_pack_group_ref(xs, us, bits)
    if dev.type != "cuda":
        raise ValueError(f"quantize_pack: no kernel for device {dev}")
    shapes = [tuple(x.shape) for x in xs]
    n_parts = sum(r * -(-p // CHUNK) for r, p in shapes)
    if n_parts >= 2 ** 30:
        raise ValueError(f"quantize_pack: {n_parts} row chunks of {CHUNK} "
                         f"are more than one launch takes")
    # every leaf's codes in one buffer, each leaf's start 16-byte aligned;
    # every scale in another
    cols, starts, end = [], [], 0
    for r, p in shapes:
        c = p if bits == 8 else (p + 1) // 2
        cols.append(c)
        starts.append(end)
        end += -(-r * c // _ALIGN) * _ALIGN
    codes = torch.empty(end, dtype=torch.int8 if bits == 8 else torch.uint8,
                        device=dev)
    packed = [codes.as_strided((r, c), (c, 1), o)
              for (r, _), c, o in zip(shapes, cols, starts)]
    rows = [r for r, _ in shapes]
    scale = torch.empty(sum(rows), dtype=torch.float32,
                        device=dev).split(rows)
    partial = torch.empty(max(n_parts, 1), dtype=torch.float32, device=dev)
    n_launches = -(-len(xs) // MAX_LEAVES)
    counters = torch.zeros(n_launches + sum(rows),
                           dtype=torch.int32, device=dev)
    desc = np.array([(x.data_ptr(), u.data_ptr(), c.data_ptr(),
                      s.data_ptr(), r, p) for x, u, c, s, (r, p) in
                     zip(xs, us, packed, scale, shapes)], dtype=np.int64)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        got = _kernel()(desc.ctypes.data, len(xs), bits, INV_QMAX[bits],
                        partial.data_ptr(), counters.data_ptr(), stream)
    if got < 0:
        raise RuntimeError(f"quantize_pack: CUDA kernel launch failed with "
                           f"cudaError {-got}")
    quantize_pack_group.launches += got
    return list(zip(packed, scale))


quantize_pack_group.launches = 0


def quantize_pack(x: torch.Tensor, u: torch.Tensor, bits: int):
    """Quantize-pack rows of ``x`` with per-row absmax scales: one leaf
    of :func:`quantize_pack_group`.

    ``x``, ``u``: ``(R, P)`` float32 (``u`` uniforms in ``[0, 1)``).
    Returns ``(packed, scale)``: ``(R, P)`` int8 for 8 bits or ``(R,
    ceil(P/2))`` uint8 for 4 bits, and ``(R,)`` float32 scales.
    """
    return quantize_pack_group([x], [u], bits)[0]


def reset_launch_counts() -> None:
    quantize_pack_group.launches = 0
