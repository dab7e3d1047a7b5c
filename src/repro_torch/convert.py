"""Parameter layout conversion between the JAX package and the port.

The reference keeps conv kernels HWIO (``(kh, kw, cin, cout)``); the
port keeps them OIHW (``(cout, cin, kh, kw)``), the layout
``torch.nn.functional.conv2d`` takes.  Every other leaf has the same
layout in both.  ``from_reference`` takes the reference's params as
numpy arrays (nested dicts, as ``jax.tree_util`` holds them) and returns
the port's flat tree; ``to_reference`` reverses it exactly.  A conv
kernel is a leaf named ``w`` under a ``conv<N>`` node (VGG16's
``conv0/w`` ...: :func:`is_conv_kernel`); leading dims beyond its four
(a client axis of stacked deltas) are kept as they are.  Every other
leaf passes through with its layout unchanged, whatever its rank: the
zoo transformer's stacked projections (``blocks/sub0/attn/wq`` of
``(n_macro, d, H, hd)``, ``attn/wo`` of ``(n_macro, H, hd, d)``) are not
conv kernels.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from .common import flatten, unflatten


_CONV_KERNEL = re.compile(r"conv\d+/w")


def is_conv_kernel(path: str) -> bool:
    """Whether the leaf at ``path`` is a conv kernel (HWIO <-> OIHW)."""
    return _CONV_KERNEL.fullmatch(path) is not None


def _lead(x) -> tuple:
    return tuple(range(x.ndim - 4))


def from_reference(np_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Reference params (numpy, nested) -> the port's flat CPU tree."""
    out = {}
    for path, leaf in flatten(np_params).items():
        x = np.asarray(leaf)
        if is_conv_kernel(path):                   # HWIO -> OIHW
            x = x.transpose(
                _lead(x) + tuple(x.ndim + a for a in (-1, -2, -4, -3)))
        out[path] = torch.tensor(np.ascontiguousarray(x))
    return out


def to_reference(params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's flat tree -> reference params (numpy, nested)."""
    out = {}
    for path, leaf in params.items():
        x = leaf.detach().cpu().numpy()
        if is_conv_kernel(path):                   # OIHW -> HWIO
            x = np.ascontiguousarray(x.transpose(
                _lead(x) + tuple(x.ndim + a for a in (-2, -1, -3, -4))))
        out[path] = x
    return unflatten(out)
