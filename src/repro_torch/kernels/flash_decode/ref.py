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

At ``valid_len == 0`` every score is masked and this version returns
the mean of V over the gathered positions, while the kernel (as the
TPU kernel) returns zeros; the model never passes 0 (it attends over
``steps + 1`` positions).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


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
