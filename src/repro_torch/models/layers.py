"""Dense layer primitives of the model zoo, in PyTorch.

Mirrors ``repro.models.layers`` function for function, in the same
tensor layouts: fused attention projections are ``(d, H, hd)`` and
``(H, hd, d)``, MLP weights ``(d, ff)`` / ``(ff, d)``, the embedding
table ``(V_pad, d)``.  ``init_*`` draw from an explicit
``torch.Generator`` on the generator's device, with the reference's
distributions (the draws themselves differ: tests convert the
reference's params with ``convert.from_reference``).  The reference's
optional logits sharding constraint is left out: it does nothing off a
device mesh.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """Normal draws scaled by ``1/sqrt(fan_in)``, fan_in = ``shape[0]``."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    s = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(tuple(shape), generator=gen, device=gen.device)
    return (x * s).to(dtype)


def init_norm(kind: str, d: int, dtype, device) -> Params:
    if kind == "rmsnorm":
        return {"w": torch.ones((d,), dtype=dtype, device=device)}
    return {"w": torch.ones((d,), dtype=dtype, device=device),
            "b": torch.zeros((d,), dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def apply_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm (``p`` has ``w``) or LayerNorm (``w`` and ``b``), computed
    in fp32 and cast back to ``x``'s dtype."""
    xf = x.float()
    if "b" in p:
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["w"].float() + p["b"].float()
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["w"].float()
    return y.to(x.dtype)


def rms_norm_heads(w: torch.Tensor, x: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMSNorm over the trailing head_dim (qk_norm)."""
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def rope_freqs(head_dim: int, rope_pct: float, theta: float, device="cpu"):
    """Inverse frequencies for the rotated slice of the head dim.

    ``inv`` is the reference's numpy float32 expression, so the table is
    bitwise the reference's.  Cached per device (callers only read it):
    building it is a host-to-device copy, which would make every decode
    step wait for the host."""
    rot = int(head_dim * rope_pct)
    rot -= rot % 2
    if rot == 0:
        return None, 0
    inv = 1.0 / (theta ** (np.arange(0, rot, 2, dtype=np.float32) / rot))
    return torch.as_tensor(np.asarray(inv, np.float32), device=device), rot


def apply_rope(x: torch.Tensor, positions: torch.Tensor, inv_freq,
               rot: int) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  Pairs are
    interleaved, (0::2, 1::2), as in the reference."""
    if inv_freq is None or rot == 0:
        return x
    ang = positions[..., :, None].float() * inv_freq           # (...,S,rot/2)
    sin = torch.sin(ang)[..., :, None, :]
    cos = torch.cos(ang)[..., :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    out = torch.stack([r1, r2], dim=-1).reshape(xr.shape)
    return torch.cat([out, xp], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (gated or 2-matrix)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, ff: int, dtype,
             glu: bool = True, bias: bool = False) -> Params:
    p = {"w_up": dense_init(gen, (d, ff), dtype),
         "w_down": dense_init(gen, (ff, d), dtype)}
    if glu:
        p["w_gate"] = dense_init(gen, (d, ff), dtype)
    if bias:
        p["b_up"] = torch.zeros((ff,), dtype=dtype, device=gen.device)
        p["b_down"] = torch.zeros((d,), dtype=dtype, device=gen.device)
    return p


def _act(act: str):
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu if act == "silu" else (
        lambda h: F.gelu(h, approximate="tanh"))


def apply_mlp(p: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    a = _act(act)
    h = x @ p["w_up"]
    if "b_up" in p:
        h = h + p["b_up"]
    h = a(x @ p["w_gate"]) * h if "w_gate" in p else a(h)
    out = h @ p["w_down"]
    return out + p["b_down"] if "b_down" in p else out


# ---------------------------------------------------------------------------
# attention projections
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg, dtype,
                   cross: bool = False) -> Params:
    """Fused projections; ``cross`` (whisper's cross-attention) leaves out
    the qk norms, as the reference does."""
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dev = gen.device
    p = {
        "wq": dense_init(gen, (d, h, hd), dtype),
        "wk": dense_init(gen, (d, hkv, hd), dtype),
        "wv": dense_init(gen, (d, hkv, hd), dtype),
        "wo": dense_init(gen, (h, hd, d), dtype, scale=1.0 / math.sqrt(h * hd)),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((hkv, hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((hkv, hd), dtype=dtype, device=dev)
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
    return p


def qkv_project(p: Params, x: torch.Tensor, cfg, positions: torch.Tensor,
                rope):
    """x (B,S,d) -> q (B,S,H,hd), k/v (B,S,Hkv,hd), rope applied."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if "q_norm" in p:
        q = rms_norm_heads(p["q_norm"], q)
        k = rms_norm_heads(p["k_norm"], k)
    inv_freq, rot = rope
    q = apply_rope(q, positions, inv_freq, rot)
    k = apply_rope(k, positions, inv_freq, rot)
    return q, k, v


def out_project(p: Params, o: torch.Tensor) -> torch.Tensor:
    """o (B,S,H,hd) -> (B,S,d)."""
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------

def init_embed(gen: torch.Generator, vocab: int, d: int, dtype,
               max_position: int = 0) -> Params:
    """The token table and, with ``max_position``, learned positions
    ``pos`` (max_position, d) (whisper's decoder)."""
    x = torch.randn((vocab, d), generator=gen, device=gen.device)
    p = {"table": (x * 0.02).to(dtype)}
    if max_position:
        x = torch.randn((max_position, d), generator=gen, device=gen.device)
        p["pos"] = (x * 0.02).to(dtype)
    return p


def embed_tokens(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    """The table's rows at ``tokens``.  ``F.embedding``'s backward sums
    the gradients of repeated tokens in a fixed order; the backward of
    ``table[tokens]`` accumulates them in an order that changes from run
    to run with threads (CPU) or atomics (the card)."""
    return F.embedding(tokens.long(), p["table"])


def logits_head(params: Params, x: torch.Tensor, tie: bool) -> torch.Tensor:
    """``params`` is the flat model tree; tied heads read the embedding."""
    return x @ (params["embed/table"].T if tie else params["head/w"])


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy; logits (B,S,V), labels (B,S) int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = logz - ll
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
