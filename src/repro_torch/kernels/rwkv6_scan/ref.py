"""Plain PyTorch versions of the RWKV-6 WKV scan (K7), kernel layout:
r, k, log_decay ``(BH, S, dk)``, v ``(BH, S, dv)``, u ``(BH, dk)``.

:func:`rwkv6_scan_chunked_ref` is the function the CUDA kernel computes,
in the same math as the TPU kernel's body (``_wkv_kernel`` in
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

:func:`rwkv6_scan_ref` is the reference's per-token oracle
(``repro.kernels.rwkv6_scan.ref``), the exact recurrence.
"""
from __future__ import annotations

import torch

# the kernel's own copy of models.linear_scan.LOG_DECAY_FLOOR, as the TPU
# kernel keeps one; the models package imports this module, so the import
# cannot go the other way
LOG_DECAY_FLOOR = -5.0


def _f32(*xs):
    return tuple(x.to(torch.float32) for x in xs)


def rwkv6_scan_chunked_ref(r, k, v, log_decay, u, *, chunk: int):
    """Returns (o (BH,S,dv) in r's dtype, state (BH,dk,dv) float32);
    ``S % chunk == 0``."""
    bh, s, dk = r.shape
    dv = v.shape[-1]
    rf, kf, vf, uf = _f32(r, k, v, u)
    d = torch.clamp(log_decay.to(torch.float32), LOG_DECAY_FLOOR, 0.0)
    uf = uf[:, None, :]
    state = torch.zeros((bh, dk, dv), dtype=torch.float32, device=r.device)
    strict = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=r.device).tril(-1)
    zero = torch.zeros((), dtype=torch.float32, device=r.device)
    outs = []
    for t0 in range(0, s, chunk):
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
    return torch.cat(outs, dim=1).to(r.dtype), state


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
