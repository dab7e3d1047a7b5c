"""Plain PyTorch versions of flash attention, forward and backward.

:func:`flash_attention_fwd_ref` and :func:`flash_attention_bwd_ref` are
the functions the CUDA kernels (K5, K6) compute, in the model layout
``(B, S, H, hd)`` / ``(B, S, Hkv, hd)``: the wrappers in ``ops.py`` run
them for CPU tensors, and ``chip_smoke.py`` holds the kernels to them
on the card.  Both work in fp32 whatever the input dtype, as the Pallas
bodies cast their blocks to f32.  The backward is the recompute
backward written as dense tensor math, formula for formula the one of
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``
(``repro/kernels/flash_attention/kernel.py:135,179``), not autograd of
the forward, so the CPU tests exercise what the kernels implement.

:func:`flash_attention_ref` is the oracle in the reference kernel's
layout ``(BH, S, hd)`` / ``(BHkv, S, hd)``
(``repro.kernels.flash_attention.ref``); it delegates to the port's
``models.attention.attend_reference``.

A query row with no allowed key (possible only with a window, when
``Sq > Sk + window - 1``) gets the mean of V and ``lse = -1e30``, as the
dense softmax over ``NEG_INF`` scores gives; its gradient is 0.

``round_to=torch.bfloat16`` makes both functions round where the bf16
kernels (``csrc/flash_attention_sm90.cu``) round: the unnormalised P
before its product with V (the forward; its row sums stay fp32) and with
dO, and dS before its products with K and Q.  Everything else stays
fp32, so the kernels differ from it only in the order of their sums and
in P's rounding against the running rather than the final row maximum.
"""
from __future__ import annotations

import math

import torch

from ...models.attention import NEG_INF, _repeat_kv, attend_reference


def _mask(sq, sk, causal, window, device, kv_len=None):
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    if kv_len is not None:
        mask &= kpos < kv_len
    return mask


def _scores(q, k, causal, window, kv_len=None):
    """fp32 scaled scores (B,H,Sq,Sk) and the mask (Sq,Sk)."""
    hd = q.shape[-1]
    kf = _repeat_kv(k.float(), q.shape[2] // k.shape[2])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (1.0 / math.sqrt(hd))
    return s, _mask(q.shape[1], k.shape[1], causal, window, q.device, kv_len)


def _round(x, dtype):
    """x rounded to ``dtype`` and back to fp32 (``None``: x)."""
    return x if dtype is None else x.to(dtype).float()


def flash_attention_fwd_ref(q, k, v, *, causal=True, window=0,
                            round_to=None, kv_len=None):
    """q (B,Sq,H,hd), k/v (B,Sk,Hkv,hd) -> o (B,Sq,H,hd) in q's dtype and
    lse (B,H,Sq) fp32, ``lse = m + log(max(l, 1e-30))``.  Keys at or past
    ``kv_len`` (default: none) are masked as a causal or window mask
    masks."""
    s, mask = _scores(q, k, causal, window, kv_len)
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1).clamp_min(1e-30)
    vf = _repeat_kv(v.float(), q.shape[2] // v.shape[2])
    if round_to is None:
        o = torch.einsum("bhqk,bkhd->bqhd", p / l[..., None], vf)
    else:
        o = torch.einsum("bhqk,bkhd->bqhd", _round(p, round_to),
                         vf) / l.transpose(1, 2)[..., None]
    return o.to(q.dtype), m + torch.log(l)


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal=True, window=0,
                            round_to=None, kv_len=None):
    """The recompute backward from ``lse`` (B,H,Sq): returns dq
    (B,Sq,H,hd) and dk, dv (B,Sk,Hkv,hd), summed over each GQA group in
    fp32 and cast once to the inputs' dtype.

    ``p = where(mask, exp(s·scale − lse), 0)``, ``delta = rowsum(o·do)``,
    ``ds = p·(do·vᵀ − delta)·scale``; ``dq = ds·k``, ``dk = dsᵀ·q``,
    ``dv = pᵀ·do``; the rows of dk, dv at or past ``kv_len`` are zero."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    n_rep = h // hkv
    s, mask = _scores(q, k, causal, window, kv_len)
    p = torch.where(mask, torch.exp(s - lse[..., None]),
                    torch.zeros((), device=q.device))
    dof = do.float()
    delta = (o.float() * dof).sum(-1).transpose(1, 2)          # (B,H,Sq)
    vf = _repeat_kv(v.float(), n_rep)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * (1.0 / math.sqrt(hd))
    ds, pr = _round(ds, round_to), _round(p, round_to)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, _repeat_kv(k.float(), n_rep))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", pr, dof)
    dk = dk.reshape(b, sk, hkv, n_rep, hd).sum(3)
    dv = dv.reshape(b, sk, hkv, n_rep, hd).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def rounding_error_ratio(got, want):
    """How far bf16 kernel outputs ``got`` lie from ``want``, the plain
    version with ``round_to=torch.bfloat16``, as a share of the bar: the
    largest, over elements, of ``|got - want| / (2^-7·|want| + 2^-5·
    rms(want's row) + 2^-16·max|want|)``, a row being the last dimension
    (head_dim).  2^-7 covers the two outputs' own bf16 rounding (2^-8
    each); 2^-5 the order of the sums and P's rounding against the running
    row maximum, noise that scales with the row it is summed into; 2^-16
    fp32 cancellation in a row whose exact value is 0 (causal row 0's dq,
    where do·v = delta), 2^8 finer than bf16's own step at the largest
    value.  <= 1 passes; ``chip_smoke.py`` prints the kernels' share of
    this bar and that of planted wrong outputs."""
    got, want = got.float(), want.float()
    rms = want.square().mean(-1, keepdim=True).sqrt()
    bar = (2.0 ** -7 * want.abs() + 2.0 ** -5 * rms
           + 2.0 ** -16 * float(want.abs().max()))
    return float(((got - want).abs() / bar.clamp_min(1e-30)).max())


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """Kernel layout (BH,Sq,hd), (BHkv,Sk,hd) -> (BH,Sq,hd): each query
    head is its own sequence (B=BH, H=1) over its group's K/V."""
    n_rep = q.shape[0] // k.shape[0]
    kq = k.repeat_interleave(n_rep, dim=0)
    vq = v.repeat_interleave(n_rep, dim=0)
    o = attend_reference(q[:, :, None], kq[:, :, None], vq[:, :, None],
                         causal=causal, window=window)
    return o[:, :, 0]
