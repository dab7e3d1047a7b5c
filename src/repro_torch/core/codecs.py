"""Uplink compression codecs — a plugin axis over packed slot deltas.

A **codec** is a lossy (or identity) transform applied to the packed
trained-slot deltas *before* they cross the WAN, composing a
compression factor on top of the paper's structural freeze factor.
Symmetric with the other axes: ``@register_codec`` + a literal
``name``, resolved from ``FLConfig.codec``, encode/decode run inside
the round step.

Contract (``build_codec_transform``):

* ``none`` resolves to **no transform at all** — the round step skips
  the codec branch, so its numbers are those of a codec-free round.
* Otherwise the transform maps the round's packed deltas to their
  **decoded round-trip** ``decode(encode(x))`` — the wire never exists
  as bytes in the simulation; byte accounting is analytic via
  :func:`codec_unit_bytes` (claimed == :func:`encoded_wire_bytes`).
* Wire format is per **slot row**: each stacked-leaf slot row (``P =
  prod(leaf.shape[1:])`` params) and each participating scalar leaf
  (``P = prod(leaf.shape)`` params) is one row, encoded independently
  with its own scale / top-k budget.  Pad slots (``valid == 0``) and
  non-participants ship nothing and decode to **exact zeros**.
* Stochastic codecs (``stochastic = True``) consume uniforms for
  stochastic rounding, drawn outside the kernel: the transform takes a
  ``uniform(i, shape)`` callable (``i`` the flattened leaf index), so a
  test can feed it the reference's own draws.  The ``Server`` passes
  draws from a generator on the round's device.
* The transform runs in two phases: it prepares leaves' rows, hands
  them to :meth:`Codec.rows_roundtrip`, then decodes, masks and updates
  the residual leaf by leaf.  A codec that overrides ``rows_roundtrip``
  gets every leaf in one call (the quantizing codecs encode the whole
  round in one grouped kernel call, drawing each leaf's uniforms in leaf
  order as the per-leaf path did); one that keeps the default gets one
  leaf a call, so it holds one leaf's prepared rows at a time.
* Stateful codecs (``stateful = True``, i.e. ``topk_ef``) thread a
  per-client error-feedback residual tree (leaves ``(C, *param)``,
  float32) through the round step: residual rows are gathered into
  slot space, added, the transmitted part subtracted, and the rows
  scattered back.  Dropped clients (``weights == 0``) keep their
  residual untouched — they never uploaded.  Checkpoints carry the
  residual (``ckpt/store.py``).  The async engine threads a ``decay``
  (C,) through the transform: a residual ages by the model versions
  since its client last transmitted.
"""
from __future__ import annotations

import math
from typing import (Callable, ClassVar, Dict, List, NamedTuple, Optional,
                    Type, Union)

import numpy as np
import torch

from ..common import flatten_with_paths
from ..kernels.codec.ops import quantize_pack, quantize_pack_group
from ..kernels.codec.ref import dequantize_unpack
from .masking import UnitAssignment
from .registry import unknown_name_message

# ``draw(shape) -> (R, P)`` float32 uniforms in [0, 1) on the rows' device
Draw = Callable[[tuple], torch.Tensor]


class Codec:
    """Base codec: per-row round-trip + per-row wire-byte formula."""

    name: ClassVar[str] = ""
    stateful: ClassVar[bool] = False    # carries per-client EF residual
    stochastic: ClassVar[bool] = False  # consumes uniforms

    def row_bytes(self, p: int, fl=None) -> int:
        """Wire bytes for one encoded row of ``p`` float32 params."""
        raise NotImplementedError

    def row_roundtrip(self, x2: torch.Tensor, draw: Optional[Draw],
                      fl=None) -> torch.Tensor:
        """decode(encode(x2)) for ``(R, P)`` float32 rows."""
        raise NotImplementedError

    def rows_roundtrip(self, xs: List[torch.Tensor],
                       draws: List[Optional[Draw]],
                       fl=None) -> List[torch.Tensor]:
        """decode(encode(x)) for each leaf's ``(R, P)`` float32 rows in
        ``xs``, ``draws[i]`` leaf i's uniforms (None for deterministic
        codecs).  The default runs :meth:`row_roundtrip` leaf by leaf."""
        return [self.row_roundtrip(x, d, fl) for x, d in zip(xs, draws)]


class UnknownCodecError(KeyError):
    pass


_REGISTRY: Dict[str, Codec] = {}


def register_codec(obj: Union[Type[Codec], Codec], *,
                   name: Optional[str] = None):
    """Register a codec class (instantiated with no args) or instance.
    Usable as a decorator."""
    codec = obj() if isinstance(obj, type) else obj
    key = name or codec.name
    if not key:
        raise ValueError(f"codec {obj!r} has no name")
    _REGISTRY[key] = codec
    return obj


def unregister_codec(name: str):
    _REGISTRY.pop(name, None)


def get_codec(name: str) -> Codec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise UnknownCodecError(unknown_name_message(
            "codec", name, _REGISTRY)) from None


def resolve_codec(spec: Union[str, Codec, None]) -> Codec:
    """Name / instance / None -> codec instance (None means ``none``)."""
    if spec is None:
        return _REGISTRY["none"]
    return get_codec(spec) if isinstance(spec, str) else spec


def available_codecs():
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# built-in codecs


@register_codec
class NoneCodec(Codec):
    """Identity codec: fp32 rows on the wire, no transform built."""

    name = "none"

    def row_bytes(self, p, fl=None):
        return 4 * p

    def row_roundtrip(self, x2, draw, fl=None):
        return x2


class _QuantCodec(Codec):
    """Shared per-slot-row absmax stochastic-rounding quantization,
    encoded by the quantize-pack kernel (K2)."""

    stochastic = True
    bits: ClassVar[int] = 8

    def row_roundtrip(self, x2, draw, fl=None):
        packed, scale = quantize_pack(x2, draw(tuple(x2.shape)), self.bits)
        return dequantize_unpack(packed, scale, self.bits, x2.shape[1])

    def rows_roundtrip(self, xs, draws, fl=None):
        # uniforms leaf by leaf in leaf order, then one grouped encode
        us = [d(tuple(x.shape)) for x, d in zip(xs, draws)]
        return [dequantize_unpack(packed, scale, self.bits, x.shape[1])
                for (packed, scale), x in
                zip(quantize_pack_group(xs, us, self.bits), xs)]


@register_codec
class QInt8(_QuantCodec):
    """int8 stochastic-rounding quantization: 1 byte/param + 4-byte
    per-row scale (absmax/127); round-trip error ≤ scale per element."""

    name = "qint8"
    bits = 8

    def row_bytes(self, p, fl=None):
        return p + 4


@register_codec
class QInt4(_QuantCodec):
    """int4 stochastic-rounding quantization: two nibbles per byte +
    4-byte per-row scale (absmax/7); round-trip error ≤ scale."""

    name = "qint4"
    bits = 4

    def row_bytes(self, p, fl=None):
        return (p + 1) // 2 + 4


@register_codec
class TopKEF(Codec):
    """Per-row top-k sparsification with per-client error feedback.

    Keeps the ``k = max(1, ceil(codec_topk * P))`` largest-magnitude
    entries of each slot row (4-byte value + 4-byte index each); the
    untransmitted remainder accumulates in the client's residual and is
    re-injected next round.  Deterministic — ties resolve to the lower
    index, as ``lax.top_k`` resolves them (a stable descending sort).
    """

    name = "topk_ef"
    stateful = True

    @staticmethod
    def k_for(p: int, fl=None) -> int:
        frac = getattr(fl, "codec_topk", 0.1) if fl is not None else 0.1
        return max(1, min(p, int(math.ceil(frac * p))))

    def row_bytes(self, p, fl=None):
        return 8 * self.k_for(p, fl)

    def row_roundtrip(self, x2, draw, fl=None):
        k = self.k_for(x2.shape[1], fl)
        idx = torch.sort(x2.abs(), dim=1, descending=True,
                         stable=True).indices[:, :k]
        return torch.zeros_like(x2).scatter_(1, idx, x2.gather(1, idx))


# ---------------------------------------------------------------------------
# byte math — claimed bytes == encoded wire bytes, structurally


def codec_unit_bytes(codec: Codec, assign: UnitAssignment, params,
                     fl=None) -> np.ndarray:
    """(U,) int64 — encoded uplink bytes per selected freeze unit.

    Mirrors ``masking.unit_param_counts``: a unit's bytes are the sum of
    its rows' :meth:`Codec.row_bytes` (one row per stacked macro index,
    one per member scalar leaf).  Because ``slot_plan`` marks exactly
    the selected units' rows valid, ``sel @ codec_unit_bytes`` equals
    :func:`encoded_wire_bytes`.  For ``none`` this is ``comm.unit_bytes``.
    """
    out = np.zeros(assign.n_units, np.int64)
    for path, leaf in flatten_with_paths(params):
        lu = assign.leaf_units[path]
        shape = tuple(leaf.shape)
        if lu.kind == "scalar":
            out[lu.base] += codec.row_bytes(int(np.prod(shape)), fl)
        else:
            per = codec.row_bytes(int(np.prod(shape[1:])), fl)
            for m in range(shape[0]):
                out[lu.base + lu.stride * m] += per
    return out


def encoded_wire_bytes(codec: Codec, assign: UnitAssignment, params,
                       valid, fl=None) -> float:
    """Actual encoded uplink bytes for one round, from the slot plan.

    Sums :meth:`Codec.row_bytes` over every *valid* row each client
    ships (client-stacked ``valid``: stacked ``(C, L)``, scalar
    ``(C,)``) — the ground truth the analytic ``sel @
    codec_unit_bytes`` claim is checked against.
    """
    total = 0.0
    for path, leaf in flatten_with_paths(params):
        shape = tuple(leaf.shape)
        p = int(np.prod(shape)) if assign.leaf_units[path].kind == "scalar" \
            else int(np.prod(shape[1:]))
        total += codec.row_bytes(p, fl) * float(valid[path].sum())
    return total


# ---------------------------------------------------------------------------
# error-feedback state


def init_codec_state(codec: Codec, params, n_clients: int):
    """Zero per-client residual tree (``(C, *leaf)`` float32 leaves on
    the params' devices), or None for stateless codecs."""
    if not codec.stateful:
        return None
    return {p: torch.zeros((n_clients,) + tuple(x.shape),
                           dtype=torch.float32, device=x.device)
            for p, x in flatten_with_paths(params)}


# ---------------------------------------------------------------------------
# the transform


def _expand(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """Reshape ``v`` to broadcast over ``ndim`` total dims."""
    return v.reshape(tuple(v.shape) + (1,) * (ndim - v.ndim))


def build_codec_transform(codec: Codec, assign: UnitAssignment, fl):
    """Codec -> round-trip transform, or None for ``none``.

    The transform signature is uniform across codecs::

        transform(pdeltas, rows, valid, weights, uniform, state=None,
                  decay=None) -> (decoded_pdeltas, new_state)

    ``pdeltas``/``rows``/``valid`` are the packed round's client-stacked
    trees (stacked leaves ``(C, L, ...)``, scalar leaves ``(C, ...)``);
    ``weights (C,)`` gates residual updates (dropped clients shipped
    nothing); ``uniform(i, shape)`` returns the stochastic-rounding
    uniforms of flattened leaf ``i`` (ignored by deterministic codecs);
    ``state`` is the EF residual tree (None for stateless codecs, and
    ``new_state`` is None back); ``decay (C,)`` scales the re-injected
    residual (ones when omitted, as on the synchronous path).
    """
    if codec.name == "none":
        return None

    def transform(pdeltas, rows, valid, weights, uniform=None, state=None,
                  decay=None):
        if codec.stochastic and uniform is None:
            raise ValueError(f"codec {codec.name!r} rounds stochastically: "
                             f"pass uniform(i, shape)")
        out, new_res = {}, {}

        def roundtrip(part, first):
            # prepare, one rows_roundtrip call, finish; ``first``: the
            # flattened index of part's first leaf
            leaves = [_leaf_prepare(
                assign.leaf_units[path].kind, d, rows[path], valid[path],
                None if state is None else state[path], decay)
                for path, d in part]
            draws = [(lambda shape, i=i: uniform(i, shape))
                     if codec.stochastic else None
                     for i in range(first, first + len(part))]
            xhs = codec.rows_roundtrip([lf.x2 for lf in leaves], draws, fl)
            for (path, _), lf, xh in zip(part, leaves, xhs):
                out[path], new_res[path] = _leaf_finish(
                    lf, xh, None if state is None else state[path], weights)

        flat = list(flatten_with_paths(pdeltas))
        # a codec with its own rows_roundtrip takes the round in one call;
        # the default takes one leaf a call, so one leaf's rows live at once
        step = 1 if type(codec).rows_roundtrip is Codec.rows_roundtrip \
            else max(len(flat), 1)
        for first in range(0, len(flat), step):
            roundtrip(flat[first:first + step], first)
        return out, (None if state is None else new_res)

    return transform


class _Leaf(NamedTuple):
    """One client-stacked leaf between the two phases of the transform."""
    x: torch.Tensor            # the signal, leaf-shaped, pads zeroed
    x2: torch.Tensor           # the same as (rows, P) for the codec
    vm: torch.Tensor           # validity, broadcast over the leaf
    rr: Optional[torch.Tensor]  # stacked + residual: its slot rows
    r: Optional[torch.Tensor]  # stacked + residual: the slot plan (C, L)


def _leaf_prepare(kind, d, r, v, res, decay) -> _Leaf:
    """The rows one client-stacked leaf ships: pads zeroed and, under a
    residual, the decayed residual added."""
    c = d.shape[0]
    dev = d.device
    vm = _expand(v.to(device=dev, dtype=d.dtype), d.ndim)   # (C[, L], 1...)
    decay_b = None if res is None else _expand(
        torch.ones(c, device=dev) if decay is None else decay.to(dev),
        d.ndim)
    if kind == "scalar":
        p = int(np.prod(d.shape[1:]))
        x = d * vm if res is None else (d + decay_b * res) * vm
        return _Leaf(x, x.reshape(c, p), vm, None, None)
    # stacked leaf: d (C, L, ...), r (C, L), v (C, L)
    l = d.shape[1]
    p = int(np.prod(d.shape[2:]))
    rr = None
    if res is not None:
        r = r.to(device=dev, dtype=torch.long)
        rr = res[torch.arange(c, device=dev)[:, None], r]   # (C, L, ...)
        x = (d + decay_b * rr) * vm
    else:
        x = d * vm
    return _Leaf(x, x.reshape(c * l, p), vm, rr, r)


def _leaf_finish(lf: _Leaf, xh, res, weights):
    """Decoded rows back to the leaf (pads exact 0) and, under a
    residual, the new residual; returns (decoded, new_res)."""
    x, vm = lf.x, lf.vm
    xh = xh.reshape(x.shape) * vm                           # pads: exact 0
    if res is None:
        return xh, None
    w = _expand(weights.float().to(x.device), x.ndim)
    ok = (vm > 0) & (w > 0)
    if lf.rr is None:                                       # scalar leaf
        return xh, torch.where(ok, x - xh, res)
    upd = torch.where(ok, x - xh, lf.rr)
    new_res = res.clone()
    ci = torch.arange(x.shape[0], device=x.device)[:, None]
    new_res[ci, lf.r] = upd           # rows of a client are distinct
    return xh, new_res


CODEC_KEY_TAG = 0xC0DEC
