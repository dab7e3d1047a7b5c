"""Plain PyTorch version of the codec kernel, and the decode half.

``quantize_pack_ref`` is the function the CUDA kernel computes for one
leaf, op for op as the reference's ``kernels/codec/ref.py``, and
``quantize_pack_group_ref`` the same for a list of leaves, as the
kernel takes them: the wrapper runs it for CPU tensors, and
``chip_smoke.py`` holds the kernel to it bitwise on the card.  ``dequantize_unpack`` is the decode half used inside the
round step — cheap elementwise work, so it stays plain torch.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# float32 roundings of 1/qmax: the reference multiplies by the Python
# double 1.0/qmax, which JAX casts to float32 before the multiply
INV_QMAX = {8: float(np.float32(1.0 / 127.0)), 4: float(np.float32(1.0 / 7.0))}
QMAX = {8: 127.0, 4: 7.0}


def quantize_pack_ref(x: torch.Tensor, u: torch.Tensor, bits: int):
    """``(R, P)`` rows and uniforms -> ``(packed, scale)``.

    Per row: ``scale = absmax·(1/qmax)`` (a reciprocal multiply, as the
    reference), ``inv = 1/scale`` (0 where scale is 0), ``q =
    clip(floor(x·inv + u), ±qmax)`` with the multiply and the add
    rounded separately.  8 bits: ``(R, P)`` int8 codes; 4 bits: ``(R,
    ceil(P/2))`` uint8 nibble pairs ``(q0+8) | (q1+8)<<4`` (the element
    of even index in the low nibble; an odd row is padded with a 0
    element and a 0 uniform).
    """
    if bits not in (8, 4):
        raise ValueError(f"quantize_pack_ref: bits must be 8 or 4, got {bits}")
    qmax = QMAX[bits]
    if bits == 4 and x.shape[1] % 2:
        x = F.pad(x, (0, 1))
        u = F.pad(u, (0, 1))
    absmax = x.abs().amax(dim=1)
    scale = absmax * INV_QMAX[bits]
    inv = torch.where(scale > 0, 1.0 / scale, torch.zeros_like(scale))
    q = torch.clamp(torch.floor(x * inv[:, None] + u), -qmax, qmax)
    if bits == 8:
        return q.to(torch.int8), scale
    pairs = (q.to(torch.int32) + 8).reshape(x.shape[0], -1, 2)
    return (pairs[:, :, 0] | (pairs[:, :, 1] << 4)).to(torch.uint8), scale


def quantize_pack_group_ref(xs, us, bits: int):
    """``[(packed, scale)]`` of :func:`quantize_pack_ref` for each leaf
    ``(xs[i], us[i])``, in leaf order."""
    return [quantize_pack_ref(x, u, bits) for x, u in zip(xs, us)]


def dequantize_unpack(packed: torch.Tensor, scale: torch.Tensor, bits: int,
                      p: int) -> torch.Tensor:
    """Decode ``(packed, scale)`` back to ``(R, p)`` float32 rows."""
    if bits == 8:
        q = packed.float()
    else:
        lo = (packed & 0xF).to(torch.int32) - 8
        hi = (packed >> 4).to(torch.int32) - 8
        q = torch.stack([lo, hi], dim=-1).reshape(packed.shape[0], -1)
        q = q[:, :p].float()
    return q * scale[:, None]
