"""Chunked linear-recurrence (gated linear attention) substrate.

The port of ``repro.models.linear_scan``, shared by the RWKV-6 (Finch)
time-mix and, once ported, the hymba SSM branch.  Both are instances of
the recurrence over a per-head state matrix ``S (dk, dv)``:

  k-decay (RWKV-6):  S_t = diag(w_t) S_{t-1} + k_t v_t^T
                     o_t = q_t^T S_{t-1} + (q_t . (u*k_t)) v_t
  v-decay (SSD/mamba-style):
                     S_t = S_{t-1} diag(w_t) + k_t v_t^T
                     o_t = q_t^T S_t

The chunked form processes ``chunk`` tokens with matrix products instead
of a per-token loop; it is differentiable and is what the models' training
``forward`` runs.  The v-decay form computes what does not read the
carried state for every chunk at once, and carries the state in a loop
of one multiply-add a chunk.  The serving prefill of rwkv6 runs the same
recurrence through ``kernels.rwkv6_scan`` (kernel K7 on the card).

Numerics: decay work happens in log space, against the chunk-final
cumulative sum.  The per-token log-decay is floored at
``LOG_DECAY_FLOOR`` (a token with log-decay -5 retains 0.7% after one
step).  In the k-decay form ``q̂ = q·exp(c_{s-1} - c_last)`` has a
*positive* exponent, up to ``-LOG_DECAY_FLOOR · (chunk - 1)``: e^75 at
chunk 16, inside float32's e^88.7.  So chunks stay at 16 or below where
decays can reach the floor; every other exponent is <= 0.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

LOG_DECAY_FLOOR = -5.0


def chunk_len(s: int, chunk: int) -> int:
    """The chunk the scan uses over ``s`` tokens: the largest divisor of
    ``s`` that is <= ``chunk`` (odd prompt lengths take smaller chunks;
    a prime length takes 1)."""
    c = min(chunk, s)
    while s % c:
        c -= 1
    return c


def _chunk(x: torch.Tensor, n: int, c: int) -> torch.Tensor:
    return x.reshape(x.shape[0], n, c, *x.shape[2:])


def chunked_linear_scan(q, k, v, log_decay, *, decay_on: str,
                        bonus: Optional[torch.Tensor] = None,
                        state0: Optional[torch.Tensor] = None,
                        chunk: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """q,k (B,S,H,dk); v (B,S,H,dv); log_decay (B,S,H,dk|dv) (<=0).

    decay_on: "k" (RWKV) or "v" (mamba/SSD).  bonus: (H, dk) RWKV u-term
    (output includes the current token via the bonus; the v-decay
    variant includes the current token in the state first).
    Returns (outputs (B,S,H,dv) in q's dtype, final_state (B,H,dk,dv)
    float32).
    """
    if decay_on not in ("k", "v"):
        raise ValueError(decay_on)
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    c = chunk_len(s, chunk)
    n = s // c
    f32 = torch.float32
    ld = torch.clamp(log_decay.to(f32), LOG_DECAY_FLOOR, 0.0)
    qc, kc, vc, dc = (_chunk(x, n, c).transpose(0, 1) for x in
                      (q.to(f32), k.to(f32), v.to(f32), ld))  # (n,B,c,H,.)
    state = torch.zeros((b, h, dk, dv), dtype=f32, device=q.device) \
        if state0 is None else state0.to(f32)
    ones = torch.ones((c, c), dtype=f32, device=q.device)
    if decay_on == "v":
        out, state = _v_decay_chunks(qc, kc, vc, dc, state, torch.tril(ones))
        return out.transpose(0, 1).reshape(b, s, h, dv).to(q.dtype), state
    causal_strict = torch.tril(ones, diagonal=-1)
    outs = []
    for qb, kb, vb, db in zip(qc, kc, vc, dc):  # (B, c, H, ...)
        cum = torch.cumsum(db, dim=1)          # c_r, r = 1..c
        total = cum[:, -1:]                    # c_last
        # q̂_s = q_s exp(c_{s-1} - c_last); k̂_r = k_r exp(c_last - c_r)
        cum_prev = cum - db
        qh = qb * torch.exp(cum_prev - total)
        kh = kb * torch.exp(total - cum)
        att = torch.einsum("bshi,brhi->bhsr", qh, kh) * causal_strict
        intra = torch.einsum("bhsr,brhj->bshj", att, vb)
        if bonus is not None:
            diag = torch.einsum("bshi,bshi->bsh", qb,
                                bonus.to(f32)[None, None] * kb)
            intra = intra + diag[..., None] * vb
        inter = torch.einsum("bshi,bhij->bshj", qb * torch.exp(cum_prev),
                             state)
        outs.append(inter + intra)
        # S_c = diag(exp(c_last)) S_0 + sum_r diag(exp(c_last-c_r)) k_r v_r^T
        state = torch.exp(total[:, 0, :, :, None]) * state + \
            torch.einsum("brhi,brhj->bhij", kh, vb)
    outs = torch.stack(outs, dim=1).reshape(b, s, h, dv)
    return outs.to(q.dtype), state


def _v_decay_chunks(qc, kc, vc, dc, state, causal_incl):
    """The v-decay form over chunks (n, B, c, H, .): every term that does
    not read the carried state (the intra-chunk products, each chunk's
    k v^T contribution and its decay) for all chunks at once, then the
    state carried chunk to chunk (one multiply-add each), then every
    chunk's read of the state entering it at once.  Per chunk the
    arithmetic of the one-chunk-at-a-time loop; the ~20 launches a chunk
    of that loop become ~2, which is what a host-bound step pays for."""
    cum = torch.cumsum(dc, dim=2)                    # c_r, r = 1..c
    total = cum[:, :, -1:]                           # c_last
    att = torch.einsum("nbshi,nbrhi->nbhsr", qc, kc) * causal_incl
    vh = vc * torch.exp(total - cum)                 # v_r exp(c_last - c_r)
    intra = torch.einsum("nbhsr,nbrhj->nbshj", att, vh) * \
        torch.exp(cum - total)                       # exp(c_s - c_last)
    kv = torch.einsum("nbrhi,nbrhj->nbhij", kc, vh)
    decay = torch.exp(total[:, :, 0, :, None, :])    # (n, B, H, 1, dv)
    entering = []
    for i in range(qc.shape[0]):
        entering.append(state)
        state = state * decay[i] + kv[i]
    inter = torch.einsum("nbshi,nbhij->nbshj", qc, torch.stack(entering)) \
        * torch.exp(cum)
    return inter + intra, state


def linear_scan_decode(q, k, v, log_decay, state, *, decay_on: str,
                       bonus: Optional[torch.Tensor] = None):
    """Single-token step.  q,k (B,H,dk), v (B,H,dv), log_decay (B,H,ddim),
    state (B,H,dk,dv) -> (out (B,H,dv) in q's dtype, new_state)."""
    f32 = torch.float32
    qf, kf, vf = q.to(f32), k.to(f32), v.to(f32)
    ld = torch.clamp(log_decay.to(f32), LOG_DECAY_FLOOR, 0.0)
    kv = torch.einsum("bhi,bhj->bhij", kf, vf)
    if decay_on == "k":
        out = torch.einsum("bhi,bhij->bhj", qf, state)
        if bonus is not None:
            out = out + torch.einsum("bhi,bhi->bh", qf, bonus.to(f32)[None]
                                     * kf)[..., None] * vf
        new_state = torch.exp(ld)[..., None] * state + kv
    elif decay_on == "v":
        new_state = state * torch.exp(ld)[:, :, None, :] + kv
        out = torch.einsum("bhi,bhij->bhj", qf, new_state)
    else:
        raise ValueError(decay_on)
    return out.to(q.dtype), new_state


def reference_linear_scan(q, k, v, log_decay, *, decay_on: str,
                          bonus=None, state0=None):
    """Per-token oracle (slow, exact) the tests hold the chunked form to."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    f32 = torch.float32
    state = torch.zeros((b, h, dk, dv), dtype=f32, device=q.device) \
        if state0 is None else state0.to(f32)
    outs = []
    for t in range(s):
        out, state = linear_scan_decode(q[:, t].to(f32), k[:, t].to(f32),
                                        v[:, t].to(f32), log_decay[:, t],
                                        state, decay_on=decay_on, bonus=bonus)
        outs.append(out)
    return torch.stack(outs, dim=1).to(q.dtype), state
