"""Plain PyTorch versions of the RWKV-6 WKV scan (K7), kernel layout:
r, k, log_decay ``(BH, S, dk)``, v ``(BH, S, dv)``, u ``(BH, dk)``.

:func:`rwkv6_scan_chunked_ref` is the function K7 computes, in the same
math as the TPU kernel's body (``_wkv_kernel`` in
``repro.kernels.rwkv6_scan.kernel``): per chunk of ``chunk`` tokens,
with ``cum`` the inclusive cumulative sum of the clipped log-decay,
``total`` its last row and ``cum_prev = cum - d``,

    qh = r·exp(cum_prev - total),   kh = k·exp(total - cum)
    o  = (r·exp(cum_prev)) S + tril_strict(qh khᵀ) v + (Σ r·u·k) v
    S ← exp(total)ᵀ ⊙ S + khᵀ v

in float32 from a zero state.  The upper triangle is selected away (never
multiplied by a mask): its entries may overflow.  The wrapper in
``ops.py`` runs it for CPU tensors, and ``chip_smoke.py`` holds the
kernel to it on the card.

:func:`rwkv6_scan_segmented_ref` is the same function computed as the
CUDA kernel computes it: each row cut into segments, every segment
walked from a zero state (:func:`segment_states`), a scan over segment
states (:func:`carry`), and every segment walked again from its incoming
state (:func:`segment_outputs`).  The carried state re-associates the
recurrence, so it agrees with the chunked version to fp32 rounding.
:func:`bf16_error_ratio` is the bar a bf16 kernel output is held to,
element by element, against the fp32 plain version on the same inputs.

:func:`rwkv6_scan_ref` is the reference's per-token oracle
(``repro.kernels.rwkv6_scan.ref``), the exact recurrence.
"""
from __future__ import annotations

import torch

# the kernel's own copy of models.linear_scan.LOG_DECAY_FLOOR, as the TPU
# kernel keeps one; the models package imports this module, so the import
# cannot go the other way
LOG_DECAY_FLOOR = -5.0
BF16_REL = 2.0 ** -8   # bf16's rounding to nearest, relative
# fp32's order of sums: above the fp32 bar (1e-4) plus 2^-8 of it
BF16_ATOL = 2.0 ** -13


def _f32(*xs):
    return tuple(x.to(torch.float32) for x in xs)


def _walk(rf, kf, vf, d, uf, state, chunk):
    """The chunked recurrence over whole chunks of fp32 rows (BH, S, .)
    with clipped log-decay ``d`` and ``uf`` (BH, 1, dk), from ``state``
    (BH, dk, dv); returns (o fp32, final state)."""
    strict = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=rf.device).tril(-1)
    zero = torch.zeros((), dtype=torch.float32, device=rf.device)
    outs = []
    for t0 in range(0, rf.shape[1], chunk):
        rc, kc, vc, dc = (x[:, t0:t0 + chunk] for x in (rf, kf, vf, d))
        cum = torch.cumsum(dc, dim=1)
        total = cum[:, -1:]
        cum_prev = cum - dc
        qh = rc * torch.exp(cum_prev - total)
        kh = kc * torch.exp(total - cum)
        att = torch.where(strict, qh @ kh.transpose(1, 2), zero)
        intra = att @ vc + (rc * uf * kc).sum(-1, keepdim=True) * vc
        inter = (rc * torch.exp(cum_prev)) @ state
        outs.append(inter + intra)
        state = torch.exp(total).transpose(1, 2) * state + \
            kh.transpose(1, 2) @ vc
    return torch.cat(outs, dim=1), state


def _prepared(r, k, v, log_decay, u):
    rf, kf, vf, uf = _f32(r, k, v, u)
    d = torch.clamp(log_decay.to(torch.float32), LOG_DECAY_FLOOR, 0.0)
    return rf, kf, vf, d, uf[:, None, :]


def rwkv6_scan_chunked_ref(r, k, v, log_decay, u, *, chunk: int):
    """Returns (o (BH,S,dv) in r's dtype, state (BH,dk,dv) float32);
    ``S % chunk == 0``."""
    rf, kf, vf, d, uf = _prepared(r, k, v, log_decay, u)
    bh, dk, dv = r.shape[0], r.shape[2], v.shape[2]
    state = torch.zeros((bh, dk, dv), dtype=torch.float32, device=r.device)
    o, state = _walk(rf, kf, vf, d, uf, state, chunk)
    return o.to(r.dtype), state


def _segments(x, n_seg, segment):
    """(BH, S, c) -> (BH * n_seg, segment, c), the last segment padded
    with zeros (a zero token: no decay, no k or v, so it moves no state)."""
    bh, s, ch = x.shape
    pad = n_seg * segment - s
    if pad:
        x = torch.cat([x, x.new_zeros((bh, pad, ch))], dim=1)
    return x.reshape(bh * n_seg, segment, ch)


def segment_states(r, k, v, log_decay, u, *, chunk: int, segment: int):
    """Pass 1 of the segmented scan: each segment of ``segment`` tokens
    walked from a zero state.  Returns (S_loc (BH, n_seg, dk, dv), A (BH,
    n_seg, dk) = exp of the segment's summed clipped log-decay)."""
    rf, kf, vf, d, uf = _prepared(r, k, v, log_decay, u)
    bh, s, dk = r.shape
    n_seg = -(-s // segment)
    segs = [_segments(x, n_seg, segment) for x in (rf, kf, vf, d)]
    state = torch.zeros((bh * n_seg, dk, v.shape[2]), dtype=torch.float32,
                        device=r.device)
    _, loc = _walk(*segs, uf.repeat_interleave(n_seg, 0), state, chunk)
    a = torch.exp(segs[3].sum(1))
    return loc.reshape(bh, n_seg, dk, -1), a.reshape(bh, n_seg, dk)


def carry(loc, a):
    """Pass 2: ``S_in[0] = 0``, ``S_in[s] = A[s-1] ⊙ S_in[s-1] +
    S_loc[s-1]``, in segment order.  Returns S_in, shaped as ``loc``."""
    outs, state = [], torch.zeros_like(loc[:, 0])
    for s in range(loc.shape[1]):
        outs.append(state)
        state = a[:, s, :, None] * state + loc[:, s]
    return torch.stack(outs, dim=1)


def segment_outputs(r, k, v, log_decay, u, s_in, *, chunk: int,
                    segment: int):
    """Pass 3: each segment walked from its incoming state ``s_in`` (BH,
    n_seg, dk, dv).  Returns (o (BH,S,dv) in r's dtype, the last
    segment's final state)."""
    rf, kf, vf, d, uf = _prepared(r, k, v, log_decay, u)
    bh, s, dk = r.shape
    n_seg = s_in.shape[1]
    segs = [_segments(x, n_seg, segment) for x in (rf, kf, vf, d)]
    o, state = _walk(*segs, uf.repeat_interleave(n_seg, 0),
                     s_in.reshape(bh * n_seg, dk, -1), chunk)
    o = o.reshape(bh, n_seg * segment, -1)[:, :s]
    return o.to(r.dtype), state.reshape(bh, n_seg, dk, -1)[:, -1]


def rwkv6_scan_segmented_ref(r, k, v, log_decay, u, *, chunk: int,
                             segment: int):
    """The function the CUDA kernel computes (``csrc/rwkv6_scan.cu``):
    each row cut into segments of ``segment`` tokens (a multiple of
    ``chunk``; the last may be shorter), pass 1 (:func:`segment_states`),
    the carry over segments (:func:`carry`), pass 3
    (:func:`segment_outputs`).  With one segment covering the row it is
    :func:`rwkv6_scan_chunked_ref`, bitwise.  Returns (o (BH,S,dv) in r's
    dtype, state (BH,dk,dv) float32)."""
    if segment % chunk or r.shape[1] % chunk:
        raise ValueError(f"segment {segment} and S {r.shape[1]} must be "
                         f"multiples of chunk {chunk}")
    if segment >= r.shape[1]:
        return rwkv6_scan_chunked_ref(r, k, v, log_decay, u, chunk=chunk)
    loc, a = segment_states(r, k, v, log_decay, u, chunk=chunk,
                            segment=segment)
    return segment_outputs(r, k, v, log_decay, u, carry(loc, a),
                           chunk=chunk, segment=segment)


def rwkv6_scan_ref(r, k, v, log_decay, u):
    """Per-token oracle.  Returns (o (BH,S,dv) in r's dtype, state
    (BH,dk,dv) float32)."""
    bh, s, dk = r.shape
    dv = v.shape[-1]
    rf, kf, vf, uf = _f32(r, k, v, u)
    d = torch.clamp(log_decay.to(torch.float32), LOG_DECAY_FLOOR, 0.0)
    state = torch.zeros((bh, dk, dv), dtype=torch.float32, device=r.device)
    outs = []
    for t in range(s):
        rt, kt, vt, dt = rf[:, t], kf[:, t], vf[:, t], d[:, t]
        out = torch.einsum("bi,bij->bj", rt, state)
        out = out + torch.einsum("bi,bi->b", rt, uf * kt)[:, None] * vt
        state = torch.exp(dt)[..., None] * state + \
            torch.einsum("bi,bj->bij", kt, vt)
        outs.append(out)
    return torch.stack(outs, dim=1).to(r.dtype), state


def bf16_error_ratio(got, want, atol=BF16_ATOL):
    """How far a bf16 output ``got`` lies from ``want``, the plain version
    in fp32 on the same bf16 inputs, as a share of the bar: the largest,
    over elements, of ``|got - want| / (2^-8·|want| + atol)``.  The
    kernel accumulates in fp32, so the two differ by the output's own
    rounding to bf16 (at most 2^-8 of the value) and by the order of fp32
    sums, which the fp32 kernel holds within 1e-4 of the plain version
    (``atol`` = 2^-13 covers that and its rounding).  <= 1 passes; NaN
    fails."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (BF16_REL * want.abs() + atol)).max())
