"""Plain PyTorch version of paged flash decode.

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
