"""Parameter layout conversion between the JAX package and the port.

The reference keeps conv kernels channels-last: HWIO (``(kh, kw, cin,
cout)``) for a conv2d, WIO (``(k, cin, cout)``) for a conv1d.  The port
keeps them as ``torch.nn.functional.conv2d`` / ``conv1d`` take them:
OIHW and OIW.  Every other leaf has the same layout in both.
``from_reference`` takes the reference's params as numpy arrays (nested
dicts, as ``jax.tree_util`` holds them) and returns the port's flat
tree; ``to_reference`` reverses it exactly.

bf16 leaves cross bitwise both ways: the reference holds them as
``ml_dtypes.bfloat16`` arrays, which torch cannot read, so their bits go
through a 16-bit integer view (:func:`_to_torch`, :func:`_to_numpy`);
``ml_dtypes`` is imported only when a bf16 tensor is converted back.
Every other dtype is converted as numpy and torch convert it.

A conv kernel is a leaf named ``w`` under a ``conv<N>`` node
(:func:`is_conv_kernel`).  Its spatial rank is the caller's to state —
``conv_spatial=2`` (VGG16, the default) or ``1`` (IMDB's conv1d) — and
is never read off the array: a client-stacked conv1d delta ``(C, k, cin,
cout)`` has as many axes as a conv2d kernel.  Leading axes beyond the
kernel's own (a client axis of stacked deltas) are kept as they are.
Every other leaf passes through whatever its rank: the zoo
transformer's stacked projections (``blocks/sub0/attn/wq`` of
``(n_macro, d, H, hd)``) are not conv kernels, and whisper's tree
(``enc_blocks/sub0/*``, ``blocks/sub0/xattn/*``, the MLP biases,
``embed/pos``, ``enc_embed/pos``, ``enc_final_norm``) has none.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from .common import flatten, unflatten


_CONV_KERNEL = re.compile(r"conv\d+/w")

# kernel axes, counted from the end, in the other package's order:
# channels-last -> (cout, cin, *spatial) and back
_TO_PORT = {1: (-1, -2, -3), 2: (-1, -2, -4, -3)}
_TO_REF = {1: (-1, -2, -3), 2: (-2, -1, -3, -4)}


def is_conv_kernel(path: str) -> bool:
    """Whether the leaf at ``path`` is a conv kernel."""
    return _CONV_KERNEL.fullmatch(path) is not None


def _transpose(x: np.ndarray, path: str, axes) -> np.ndarray:
    k = len(axes)
    if x.ndim < k:
        raise ValueError(
            f"{path}: a conv kernel of spatial rank {k - 2} has at least "
            f"{k} axes, got shape {x.shape}")
    return np.ascontiguousarray(x.transpose(
        tuple(range(x.ndim - k)) + tuple(x.ndim + a for a in axes)))


def _to_torch(x: np.ndarray) -> torch.Tensor:
    """A contiguous numpy array as a torch tensor; a bf16 array (named
    ``bfloat16`` by ``ml_dtypes``) through its 16-bit view."""
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.tensor(x)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as a numpy array; bf16 as ``ml_dtypes.bfloat16`` with
    the same bits."""
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.contiguous().view(torch.int16).numpy().view(
            ml_dtypes.bfloat16)
    return t.numpy()


def _spatial(conv_spatial: int) -> int:
    if conv_spatial not in _TO_PORT:
        raise ValueError(f"conv_spatial must be 1 or 2, got {conv_spatial}")
    return conv_spatial


def from_reference(np_params: Mapping[str, Any], *, conv_spatial: int = 2
                   ) -> Dict[str, torch.Tensor]:
    """Reference params (numpy, nested) -> the port's flat CPU tree."""
    axes = _TO_PORT[_spatial(conv_spatial)]
    out = {}
    for path, leaf in flatten(np_params).items():
        x = np.asarray(leaf)
        if is_conv_kernel(path):
            x = _transpose(x, path, axes)
        out[path] = _to_torch(np.ascontiguousarray(x))
    return out


def to_reference(params: Mapping[str, torch.Tensor], *,
                 conv_spatial: int = 2) -> Dict[str, Any]:
    """The port's flat tree -> reference params (numpy, nested)."""
    return unflatten(to_reference_flat(params, conv_spatial=conv_spatial))


def to_reference_flat(params: Mapping[str, torch.Tensor], *,
                      conv_spatial: int = 2) -> Dict[str, np.ndarray]:
    """The port's flat tree -> the reference's layout as a flat numpy
    tree, keyed by the same paths (what a checkpoint stores)."""
    axes = _TO_REF[_spatial(conv_spatial)]
    out = {}
    for path, leaf in params.items():
        x = _to_numpy(leaf.detach().cpu())
        if is_conv_kernel(path):
            x = _transpose(x, path, axes)
        out[path] = x
    return out


def reference_shape(path: str, shape, *, conv_spatial: int = 2) -> tuple:
    """The shape a port leaf of ``shape`` at ``path`` has in the
    reference's layout."""
    shape = tuple(shape)
    if not is_conv_kernel(path):
        return shape
    axes = _TO_REF[_spatial(conv_spatial)]
    k = len(axes)
    if len(shape) < k:
        raise ValueError(
            f"{path}: a conv kernel of spatial rank {k - 2} has at least "
            f"{k} axes, got shape {shape}")
    return shape[:len(shape) - k] + tuple(shape[a] for a in axes)
