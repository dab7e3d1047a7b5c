"""Attention for the dense transformer, in PyTorch.

Mirrors ``repro.models.attention``:

  * ``attend_reference`` — materializes the (S, S) score matrix; the
    serving engine and ``static_generate`` prefill with it.
  * ``attend`` — dispatch by implementation name.  The reference's
    ``chunked`` and ``windowed`` prefill variants are not ported yet:
    where ``attend`` would pick one, it raises ``NotPortedError``.
  * Decode-time single-token attention: ``decode_attend`` (full cache),
    ``decode_attend_ring`` (ring-buffer sliding-window cache) and
    ``decode_attend_paged`` (page-table indirection over the shared page
    pool of the serving engine).  The serving decode step calls
    ``kernels.flash_decode.ops.paged_decode_attention``, whose kernel
    (K3) computes what ``decode_attend_paged`` does.

Masked scores are ``NEG_INF = -1e30``, not ``-inf``, as in the
reference, and the softmax weights are cast to ``q``'s dtype before the
product with V.
"""
from __future__ import annotations

import math

import torch

from ..core.registry import NotPortedError

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B,S,Hkv,hd) -> (B,S,Hkv*n_rep,hd) for GQA."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def _softmax_pv(scores: torch.Tensor, v: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    w = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def attend_reference(q, k, v, *, causal: bool = True, window: int = 0,
                     q_offset: int = 0):
    """q (B,Sq,H,hd), k/v (B,Sk,Hkv,hd) -> (B,Sq,H,hd).

    ``q_offset`` is the absolute position of q[0] relative to k[0].
    """
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    k = _repeat_kv(k, h // hkv)
    v = _repeat_kv(v, h // hkv)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    scores = torch.where(mask[None, None], scores.float(),
                         torch.full((), NEG_INF, device=q.device))
    return _softmax_pv(scores, v, q.dtype)


def attend(q, k, v, *, impl: str = "chunked", causal: bool = True,
           window: int = 0, q_offset: int = 0, q_chunk: int = 1024,
           kv_chunk: int = 1024):
    """Dispatch by impl name (training/prefill path)."""
    if impl == "reference" or q.shape[1] <= max(q_chunk, 256) // 2:
        return attend_reference(q, k, v, causal=causal, window=window,
                                q_offset=q_offset)
    if window > 0:
        raise NotPortedError(
            "attend: the windowed prefill attention is not ported yet; "
            "use impl='reference'")
    if impl == "chunked":
        raise NotPortedError(
            "attend: the chunked prefill attention is not ported yet; "
            "use impl='reference'")
    raise ValueError(f"unknown attention impl {impl!r}")


# ---------------------------------------------------------------------------
# decode (single query token against a cache)
# ---------------------------------------------------------------------------

def cache_token_update(cache: torch.Tensor, new: torch.Tensor,
                       pos: torch.Tensor) -> torch.Tensor:
    """Write one token into a KV cache at position ``pos``.

    cache (B, A, Hkv, hd); new (B, 1, Hkv, hd); pos a scalar int tensor.
    Unlike the reference, which returns a new array, this writes into
    ``cache`` in place (one ``index_copy_``) and returns it.
    """
    return cache.index_copy_(1, pos.reshape(1).long(), new.to(cache.dtype))


def decode_attend(q, k_cache, v_cache, valid_len, *, window: int = 0):
    """q (B,1,H,hd) against caches (B,S,Hkv,hd); positions >= valid_len
    are masked.  Returns (B,1,H,hd)."""
    b, _, h, hd = q.shape
    s = k_cache.shape[1]
    hkv = k_cache.shape[2]
    k = _repeat_kv(k_cache, h // hkv)
    v = _repeat_kv(v_cache, h // hkv)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores / math.sqrt(hd)
    kpos = torch.arange(s, device=q.device)
    msk = kpos[None, :] < valid_len[:, None]                    # (B,S)
    if window > 0:
        msk &= kpos[None, :] >= valid_len[:, None] - window
    scores = torch.where(msk[:, None, None, :], scores,
                         torch.full((), NEG_INF, device=q.device))
    return _softmax_pv(scores, v, q.dtype)


def paged_gather(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Materialize each sequence's cache view from the shared page pool.

    pool (P, ps, Hkv, hd); page_table (B, MP) int32.  Returns
    (B, MP·ps, Hkv, hd), the dense layout ``decode_attend`` reads.
    """
    b, mp = page_table.shape
    _, ps, hkv, hd = pool.shape
    return pool[page_table.long()].reshape(b, mp * ps, hkv, hd)


def paged_token_update(pool: torch.Tensor, new: torch.Tensor,
                       pages: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Write one token per sequence into its current page.

    pool (P, ps, Hkv, hd); new (B, 1, Hkv, hd); pages/offs (B,) int —
    physical page id and in-page offset per sequence.  Unlike the
    reference, which returns a new array, this writes into ``pool`` in
    place (``index_put_``) and returns it.  Distinct active sequences own
    distinct pages; inactive slots all write the trash page 0 at offset
    0, whose contents are never read unmasked (with duplicate indices the
    winner of that write is unspecified on CUDA).
    """
    return pool.index_put_((pages.long(), offs.long()),
                           new[:, 0].to(pool.dtype))


def decode_attend_paged(q, k_pool, v_pool, page_table, valid_len):
    """Single-token attention through a page table (plain gather + dense).

    q (B,1,H,hd); pools (P, ps, Hkv, hd); page_table (B, MP);
    valid_len (B,).  Ring (sliding-window) callers pre-clamp valid_len
    to the ring allocation.
    """
    k = paged_gather(k_pool, page_table)
    v = paged_gather(v_pool, page_table)
    return decode_attend(q, k, v, valid_len)


def decode_attend_ring(q, k_ring, v_ring, step, *, window: int):
    """Sliding-window decode against a ring buffer of size ``window``.

    ``step`` (B,) int — tokens already written; all slots
    < min(step, window) are valid.
    """
    b, _, h, hd = q.shape
    hkv = k_ring.shape[2]
    k = _repeat_kv(k_ring, h // hkv)
    v = _repeat_kv(v_ring, h // hkv)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores / math.sqrt(hd)
    slot = torch.arange(window, device=q.device)
    valid = slot[None, :] < torch.clamp(step, max=window)[:, None]
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full((), NEG_INF, device=q.device))
    return _softmax_pv(scores, v, q.dtype)
