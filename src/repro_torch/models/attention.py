"""Attention for the dense transformer, in PyTorch.

Mirrors ``repro.models.attention``.  Three implementations share one
signature; ``attend`` picks one per layer as the reference does:

  * ``attend_reference`` — materializes the (S, S) score matrix; short
    sequences, the serving engine's and ``static_generate``'s prefill.
  * ``attend_chunked`` — the reference's flash-structured blockwise
    attention with an online softmax over (q block, kv block) pairs.
  * ``attend_windowed`` — sliding-window attention over a gathered KV
    slab of ``window + q_chunk`` positions per q block.

On CUDA tensors the chunked and windowed branches of ``attend`` run
kernels K5 (forward) and K6 (backward) through
``kernels.flash_attention.ops.flash_attention``, which computes the
same function in one launch per direction; ``q_chunk`` and ``kv_chunk``
only change the rounding order of the reference's sums, and the kernels
ignore them.  On CPU tensors those branches run the plain versions
above.  The card route pads a causal call to a multiple of the kernel's
128-row block (a padded key sits after every real query, so the padding
is exact), and a non-causal call at any lengths through
``pad_noncausal``: zero rows to whole blocks, the padded keys masked by
the kernels' ``kv_len``, the output sliced back (whisper's 1,500-frame
encoder and its cross-attention).  It refuses what no caller passes: an
unaligned causal call with Sq != Sk, a non-zero ``q_offset``, a dtype
other than fp32 or bf16.

Decode-time single-token attention: ``decode_attend`` (full cache),
``decode_attend_ring`` (ring-buffer sliding-window cache) and
``decode_attend_paged`` (page-table indirection over the shared page
pool of the serving engine).  The serving decode step calls
``kernels.flash_decode.ops.paged_decode_attention``, whose kernel (K3)
computes what ``decode_attend_paged`` does.

Masked scores are ``NEG_INF = -1e30``, not ``-inf``, as in the
reference, and the softmax weights are cast to ``q``'s dtype before the
product with V.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30
FLASH_BLOCK = 128       # kernels/flash_attention/ops.py refuses other lengths


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


# ---------------------------------------------------------------------------
# chunked (flash-structured blockwise attention)
# ---------------------------------------------------------------------------

def _fit_chunk(s: int, c: int) -> int:
    """Largest divisor of s that is <= c (handles 1500-frame encoders)."""
    c = min(c, s)
    while s % c:
        c -= 1
    return c


def attend_chunked(q, k, v, *, causal: bool = True, window: int = 0,
                   q_chunk: int = 1024, kv_chunk: int = 1024,
                   q_offset: int = 0):
    """Online-softmax blockwise attention over every (q block, kv block)
    pair, masked pairs included, in the reference's order of updates.

    Autograd keeps each block pair's probabilities (the reference
    checkpoints its inner step instead): the plain version serves CPU
    tensors at test sizes, where the S^2 memory is small.
    """
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    hkv = k.shape[2]
    q_chunk = _fit_chunk(sq, q_chunk)
    kv_chunk = _fit_chunk(sk, kv_chunk)
    nq, nk = sq // q_chunk, sk // kv_chunk
    n_rep = h // hkv
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    neg = torch.full((), NEG_INF, device=dev)
    outs = []
    for qi in range(nq):
        q_blk = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        qpos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((b, h, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((b, h, q_chunk), device=dev)
        acc = torch.zeros((b, h, q_chunk, hd), device=dev)
        for kj in range(nk):
            sl = slice(kj * kv_chunk, (kj + 1) * kv_chunk)
            k_r = _repeat_kv(k[:, sl], n_rep)
            v_r = _repeat_kv(v[:, sl], n_rep)
            s = torch.einsum("bqhd,bkhd->bhqk", q_blk, k_r).float()
            s = s * scale
            kpos = kj * kv_chunk + torch.arange(kv_chunk, device=dev)
            msk = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                             device=dev)
            if causal:
                msk &= kpos[None, :] <= qpos[:, None]
            if window > 0:
                msk &= kpos[None, :] > qpos[:, None] - window
            s = torch.where(msk[None, None], s, neg)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(q.dtype), v_r).float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.transpose(1, 2).to(q.dtype))       # (B, qc, H, hd)
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# sliding window via KV slab gather (sub-quadratic)
# ---------------------------------------------------------------------------

def attend_windowed(q, k, v, *, window: int, q_chunk: int = 1024,
                    q_offset: int = 0):
    """Causal sliding-window attention in O(S · window).

    For each q block, slice the KV slab [qstart - window, qstart + qc)
    (clamped into the keys) and run dense attention against it.
    """
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    hkv = k.shape[2]
    n_rep = h // hkv
    q_chunk = _fit_chunk(sq, q_chunk)
    nq = sq // q_chunk
    slab = window + q_chunk
    width = min(slab, sk)
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    neg = torch.full((), NEG_INF, device=dev)
    outs = []
    for qi in range(nq):
        q_blk = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        qstart = q_offset + qi * q_chunk
        start = min(max(qstart - window, 0), max(sk - slab, 0))
        k_r = _repeat_kv(k[:, start:start + width], n_rep)
        v_r = _repeat_kv(v[:, start:start + width], n_rep)
        s = torch.einsum("bqhd,bkhd->bhqk", q_blk, k_r).float() * scale
        qpos = qstart + torch.arange(q_chunk, device=dev)
        kpos = start + torch.arange(width, device=dev)
        msk = (kpos[None, :] <= qpos[:, None]) & \
              (kpos[None, :] > qpos[:, None] - window)
        s = torch.where(msk[None, None], s, neg)
        outs.append(_softmax_pv(s, v_r, q.dtype))
    return torch.cat(outs, dim=1)


def _pad_rows(x, n: int):
    """x (B,S,H,hd) with zero rows appended up to a multiple of n."""
    return F.pad(x, (0, 0, 0, 0, 0, -x.shape[1] % n))


def pad_noncausal(q, k, v):
    """Non-causal attention of q (B,Sq,H,hd) over k/v (B,Sk,Hkv,hd) at
    any Sq and Sk through ``flash_attention`` (K5/K6 on CUDA tensors, the
    plain ``kv_len`` versions on CPU ones): q, k and v padded with zero
    rows to whole ``FLASH_BLOCK`` blocks, the padded keys masked by
    ``kv_len = Sk``, the output sliced back to Sq rows.  The padded query
    rows get a zero gradient through the slice, so they add nothing to
    dK/dV."""
    from ..kernels.flash_attention.ops import flash_attention
    sq, sk = q.shape[1], k.shape[1]
    qp, kp, vp = (_pad_rows(x, FLASH_BLOCK) for x in (q, k, v))
    return flash_attention(qp, kp, vp, False, 0, kv_len=sk)[:, :sq]


def _attend_kernel(q, k, v, *, causal: bool, window: int, q_offset: int):
    """The chunked / windowed branch on the card: K5 forward, K6 backward
    (``flash_attention``); a causal call padded to whole 128-row blocks
    at the end and sliced back, a non-causal one through
    ``pad_noncausal``."""
    from ..kernels.flash_attention.ops import flash_attention
    if q_offset:
        raise ValueError(f"attend: q_offset={q_offset} has no kernel route "
                         f"on {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"attend: {q.dtype} has no kernel route on "
                         f"{q.device} (float32 or bfloat16)")
    sq, sk = q.shape[1], k.shape[1]
    if not (sq % FLASH_BLOCK or sk % FLASH_BLOCK):
        return flash_attention(q, k, v, causal, window)
    if not causal:
        return pad_noncausal(q, k, v)
    if sq != sk:
        raise ValueError(f"attend: Sq={sq}, Sk={sk} are not multiples of "
                         f"{FLASH_BLOCK}: a causal call is padded on "
                         f"{q.device} only as a self-attention")
    qp, kp, vp = (_pad_rows(x, FLASH_BLOCK) for x in (q, k, v))
    return flash_attention(qp, kp, vp, causal, window)[:, :sq]


def attend(q, k, v, *, impl: str = "chunked", causal: bool = True,
           window: int = 0, q_offset: int = 0, q_chunk: int = 1024,
           kv_chunk: int = 1024):
    """Dispatch by impl name (training/prefill path), as the reference:
    short sequences and ``impl='reference'`` materialize the scores;
    otherwise a window picks the windowed branch and ``chunked`` the
    chunked one, which CUDA tensors run on K5/K6."""
    if impl == "reference" or q.shape[1] <= max(q_chunk, 256) // 2:
        return attend_reference(q, k, v, causal=causal, window=window,
                                q_offset=q_offset)
    if window > 0 or impl == "chunked":
        # the dry run's meta tensors stand for the card: its route
        if q.device.type in ("cuda", "meta"):
            return _attend_kernel(q, k, v, causal=causal or window > 0,
                                  window=window, q_offset=q_offset)
        if window > 0:
            return attend_windowed(q, k, v, window=window, q_chunk=q_chunk,
                                   q_offset=q_offset)
        return attend_chunked(q, k, v, causal=causal, window=window,
                              q_chunk=q_chunk, kv_chunk=kv_chunk,
                              q_offset=q_offset)
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
