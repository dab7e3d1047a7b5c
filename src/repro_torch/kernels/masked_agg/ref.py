"""Plain PyTorch version of the fused masked aggregation.

``masked_agg_ref`` is the tile-level function the CUDA kernel computes:
the wrapper runs it for CPU tensors, and ``chip_smoke.py`` holds the
kernel to it on the card.  The tree-level oracle is
``core.aggregation.masked_fedavg``.
"""
from __future__ import annotations

import torch


def masked_agg_ref(g_t: torch.Tensor, d_t: torch.Tensor,
                   w_t: torch.Tensor) -> torch.Tensor:
    """global (T, tile); deltas (C, T, tile); weights (T, C) -> (T, tile).

    ``out[t] = g[t] + Σ_c w[t,c]·Δ[c,t] / max(Σ_c w[t,c], 1e-9)``, or
    ``g[t]`` where the denominator is ≤ 0; fp32 accumulation.
    """
    w = w_t.float()
    denom = w.sum(dim=1, keepdim=True)                       # (T, 1)
    num = torch.einsum("tc,ctk->tk", w, d_t.float())
    upd = torch.where(denom > 0, num / torch.clamp(denom, min=1e-9),
                      torch.zeros_like(num))
    return (g_t.float() + upd).to(g_t.dtype)
