"""Parameter layout conversion between the JAX package and the port.

The reference keeps conv kernels HWIO (``(kh, kw, cin, cout)``); the
port keeps them OIHW (``(cout, cin, kh, kw)``), the layout
``torch.nn.functional.conv2d`` takes.  Every other leaf has the same
layout in both.  ``from_reference`` takes the reference's params as
numpy arrays (nested dicts, as ``jax.tree_util`` holds them) and returns
the port's flat tree; ``to_reference`` reverses it exactly.  Leaves of
four or more dims are conv kernels; leading dims beyond the four (a
client axis of stacked deltas) are kept as they are.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .common import flatten, unflatten


def _lead(x) -> tuple:
    return tuple(range(x.ndim - 4))


def from_reference(np_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Reference params (numpy, nested) -> the port's flat CPU tree."""
    out = {}
    for path, leaf in flatten(np_params).items():
        x = np.asarray(leaf)
        if x.ndim >= 4:                            # conv kernel: HWIO -> OIHW
            x = x.transpose(
                _lead(x) + tuple(x.ndim + a for a in (-1, -2, -4, -3)))
        out[path] = torch.tensor(np.ascontiguousarray(x))
    return out


def to_reference(params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's flat tree -> reference params (numpy, nested)."""
    out = {}
    for path, leaf in params.items():
        x = leaf.detach().cpu().numpy()
        if x.ndim >= 4:                            # conv kernel: OIHW -> HWIO
            x = np.ascontiguousarray(x.transpose(
                _lead(x) + tuple(x.ndim + a for a in (-2, -1, -3, -4))))
        out[path] = x
    return unflatten(out)
