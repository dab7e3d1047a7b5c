"""Plain PyTorch versions of flash decode, paged (K3) and dense (K4).

:func:`paged_decode_ref` is the function the CUDA kernel (K3) computes,
in the model layout: gather each sequence's pages into a dense cache,
then dense single-token attention masked to ``valid_len``.  The wrapper
in ``ops.py`` runs it for CPU tensors, and ``chip_smoke.py`` holds the
kernel to it on the card.  Its dense math is op for op the one of
``models.attention.decode_attend``, so on the CPU a paged decode equals
the dense decode bitwise.

:func:`flash_decode_paged_ref` is the same function in the reference
kernel's layout (``repro.kernels.flash_decode.ref``), where each query
head carries its own valid length.

:func:`decode_attention_ref` is what the dense decode (K4, launched on
K3's kernel) computes, in the model layout: the reference wrapper's
window clamp, then only the first ``(S // blk_k)·blk_k`` cache positions
(the Pallas kernel's grid stops at ``S // blk_k`` blocks), then the
dense decode.  :func:`flash_decode_ref` is the dense oracle in the
reference kernel's layout (``repro.kernels.flash_decode.ref``).

:func:`split_decode_ref` is the kernel's split-and-combine written out
plainly: each split's partial ``(m, l, acc)`` with the ``-1e30`` mask,
merged in split order as the combine kernel merges them.

:func:`bf16_error_ratio` is the bar a bf16 kernel output is held to,
element by element, against the fp32 plain version on the same inputs.

At ``valid_len == 0`` every score is masked and the dense versions
above return the mean of V over the gathered positions, while the
kernel (as the TPU kernel) and :func:`split_decode_ref` return zeros; the model never passes 0 (it attends over
``steps + 1`` positions).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
BF16_REL = 2.0 ** -8    # bf16's round to nearest, relative to the value
BF16_ATOL = 2.0 ** -18  # fp32's order of sums and exp (chip readings)


def _dense_decode(q, k_cache, v_cache, valid_len):
    """q (B,1,H,hd) against caches (B,S,Hkv,hd) -> (B,1,H,hd)."""
    b, _, h, hd = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    n_rep = h // hkv
    if n_rep > 1:
        k_cache = k_cache[:, :, :, None, :].expand(
            b, s, hkv, n_rep, hd).reshape(b, s, h, hd)
        v_cache = v_cache[:, :, :, None, :].expand(
            b, s, hkv, n_rep, hd).reshape(b, s, h, hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k_cache).float()
    scores = scores / math.sqrt(hd)
    kpos = torch.arange(s, device=q.device)
    msk = kpos[None, :] < valid_len[:, None]
    scores = torch.where(msk[:, None, None, :], scores,
                         torch.full((), NEG_INF, device=q.device))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v_cache)


def _gather(pool, page_table):
    b, mp = page_table.shape
    _, ps, hkv, hd = pool.shape
    return pool[page_table.long()].reshape(b, mp * ps, hkv, hd)


def paged_decode_ref(q, k_pool, v_pool, page_table, valid_len):
    """Model layout: q (B,1,H,hd); pools (P, ps, Hkv, hd); page_table
    (B, MP) int32; valid_len (B,) -> (B,1,H,hd)."""
    return _dense_decode(q, _gather(k_pool, page_table),
                         _gather(v_pool, page_table), valid_len)


def flash_decode_paged_ref(q, k_pool, v_pool, page_table, valid_len):
    """Kernel layout: q (BH,1,hd); pools (Hkv,P,ps,hd); page_table
    (B,MP); valid_len (BH,) -> (BH,1,hd).

    Each query head becomes its own sequence with one KV head (its
    group's), so every head keeps its own valid length."""
    bh, _, hd = q.shape
    hkv, _, ps, _ = k_pool.shape
    b, mp = page_table.shape
    n_rep = bh // (b * hkv)

    def dense(pool):                                   # -> (BH, MP*ps, 1, hd)
        d = pool[:, page_table.long()].transpose(0, 1)  # (B,Hkv,MP,ps,hd)
        d = d.reshape(b, hkv, mp * ps, hd).repeat_interleave(n_rep, dim=1)
        return d.reshape(bh, mp * ps, 1, hd)

    o = _dense_decode(q[:, :, None], dense(k_pool), dense(v_pool), valid_len)
    return o[:, :, 0]


def decode_attention_ref(q, k_cache, v_cache, valid_len, *, window=0,
                         blk_k=512):
    """Model layout: q (B,1,H,hd); caches (B,S,Hkv,hd); valid_len (B,).
    ``window > 0`` clamps valid lengths to it (a ring cache); positions at
    or past ``(S // min(blk_k, S))·min(blk_k, S)`` are never read."""
    if window > 0:
        valid_len = torch.clamp(valid_len, max=window)
    span = dense_span(k_cache.shape[1], blk_k)
    return _dense_decode(q, k_cache[:, :span], v_cache[:, :span], valid_len)


def dense_span(s, blk_k):
    """Cache positions the reference's dense decode reads: whole blocks."""
    blk = min(blk_k, s)
    return (s // blk) * blk if blk > 0 else 0


def flash_decode_ref(q, k, v, valid_len):
    """Kernel layout (BH,1,hd), (BHkv,S,hd), valid_len (BH,) -> (BH,1,hd):
    each query head is its own sequence over its group's cache."""
    n_rep = q.shape[0] // k.shape[0]
    kq = k.repeat_interleave(n_rep, dim=0)[:, :, None]
    vq = v.repeat_interleave(n_rep, dim=0)[:, :, None]
    return _dense_decode(q[:, :, None], kq, vq, valid_len)[:, :, 0]


def split_decode_ref(q, k_pool, v_pool, page_table, valid_len, n_splits,
                     span=None):
    """Model layout: q (B,1,H,hd); pools (P, ps, Hkv, hd); page_table
    (B, MP); valid_len (B,), or (B, H) for one length per query head ->
    (B,1,H,hd) in q's dtype, computed in fp32.

    The table's ``MP * ps`` positions fall into spans of ``span`` tokens
    (the kernel's split plan, ``ops.plan``), or of ``ceil(MP * ps /
    n_splits)`` when ``span`` is None.  A split that starts at or past its
    (sequence, KV head) group's longest valid length is skipped, as the
    kernel's blocks skip it; the others give per query head ``m`` (the
    largest unmasked score, ``-1e30`` if none), ``l = sum p`` and ``acc =
    sum p v`` with ``p = exp(s - m)`` at unmasked positions and 0
    elsewhere (masked K and V rows are zeroed first, so NaN there never
    mixes in).  They merge in split order: ``M = max m``, ``L = sum l
    exp(m - M)``, ``A = sum acc exp(m - M)``, ``o = A / max(L, 1e-30)``,
    so ``valid_len == 0`` gives zeros."""
    b, _, h, hd = q.shape
    hkv = k_pool.shape[2]
    n_rep = h // hkv
    kd = _gather(k_pool, page_table).float().repeat_interleave(n_rep, dim=2)
    vd = _gather(v_pool, page_table).float().repeat_interleave(n_rep, dim=2)
    s = kd.shape[1]
    valid = valid_len.reshape(b, -1).expand(b, h).long()
    tmax = valid.reshape(b, hkv, n_rep).amax(-1).repeat_interleave(n_rep, 1)
    mask = torch.arange(s, device=q.device)[None, None] < valid[..., None]
    keep = mask.transpose(1, 2)[..., None]                   # (B, S, H, 1)
    kd = torch.where(keep, kd, torch.zeros((), device=q.device))
    vd = torch.where(keep, vd, torch.zeros((), device=q.device))
    scores = torch.einsum("bhd,bshd->bhs", q[:, 0].float(), kd) \
        * (1.0 / math.sqrt(hd))
    scores = torch.where(mask, scores, torch.full((), NEG_INF,
                                                  device=q.device))
    if span is None:
        span = -(-s // n_splits)
    parts = []
    for lo in range(0, s, span):
        sl = slice(lo, lo + span)
        m = scores[..., sl].amax(-1)                         # (B, H)
        p = torch.where(mask[..., sl], torch.exp(scores[..., sl]
                                                 - m[..., None]),
                        torch.zeros((), device=q.device))
        parts.append((lo < tmax, m, p.sum(-1),
                      torch.einsum("bhs,bshd->bhd", p, vd[:, sl])))
    neg = torch.full((b, h), NEG_INF, device=q.device)
    big = neg
    for work, m, _, _ in parts:
        big = torch.where(work, torch.maximum(big, m), big)
    tot_l = torch.zeros((b, h), device=q.device)
    tot_a = torch.zeros((b, h, hd), device=q.device)
    for work, m, l, a in parts:
        c = torch.where(work, torch.exp(m - big), torch.zeros_like(m))
        tot_l = tot_l + l * c
        tot_a = tot_a + a * c[..., None]
    o = tot_a / torch.clamp(tot_l, min=1e-30)[..., None]
    return o[:, None].to(q.dtype)


def bf16_error_ratio(got, want, atol=BF16_ATOL):
    """How far a bf16 kernel output ``got`` lies from ``want``, the plain
    version in fp32 on the same bf16 inputs, as a share of the bar: the
    largest, over elements, of ``|got - want| / (2^-8·|want| + atol)``.
    The kernel accumulates in fp32 as the plain version does, so the two
    differ by the output's own rounding to bf16 (at most 2^-8 of the
    value, rounding to nearest) and by the order of fp32 sums and the
    exponentials (``atol``, a few times the largest such difference read
    on the card).  <= 1 passes; NaN fails."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (BF16_REL * want.abs() + atol)).max())
