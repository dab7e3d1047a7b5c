"""Plain PyTorch version of the fused masked aggregation.

``masked_agg_ref`` is the tile-level function the CUDA kernel computes:
the wrapper runs it for CPU tensors, and ``chip_smoke.py`` holds the
kernel to it on the card (``ops.check_kernel``).  The tree-level oracle
is ``core.aggregation.masked_fedavg``.  ``draw_selection`` and
``k1_bytes`` give the card's measurements their inputs and bounds.
"""
from __future__ import annotations

import numpy as np
import torch


def masked_agg_ref(g_t: torch.Tensor, d_t: torch.Tensor,
                   sel_cu: torch.Tensor, w_c: torch.Tensor,
                   row_unit: torch.Tensor) -> torch.Tensor:
    """global (T, tile); deltas (C, T, tile); selection (C, U); client
    weights (C,); row -> unit table (T,) -> (T, tile).

    With ``w[c, t] = sel[c, unit(t)]·w_c[c]``: ``out[t] = g[t] + Σ_c
    w[c,t]·Δ[c,t] / max(Σ_c w[c,t], 1e-9)``, or ``g[t]`` where the
    denominator is ≤ 0; fp32 accumulation, clients in ascending order.
    The numerator takes a client's row only where it selected the row's
    unit (``sel != 0``), so a non-finite value in a plane the client did
    not select never reaches the output; a selected plane of weight 0
    still does (0·NaN), as in the reference.
    """
    sel_t = sel_cu.float()[:, row_unit.long()]                # (C, T)
    w = sel_t * w_c.float()[:, None]                          # (C, T)
    num = torch.zeros(g_t.shape, dtype=torch.float32, device=g_t.device)
    ru = row_unit.cpu().numpy()
    live = (sel_cu != 0).cpu().numpy()                        # (C, U)
    cuts = np.flatnonzero(np.diff(ru)) + 1                    # runs of a unit
    for a, b in zip(np.r_[0, cuts], np.r_[cuts, len(ru)]) if len(ru) else ():
        for c in np.flatnonzero(live[:, ru[a]]):
            num[a:b] += w[c, a] * d_t[c, a:b].float()
    denom = w.sum(dim=0)[:, None]                             # (T, 1)
    upd = torch.where(denom > 0, num / torch.clamp(denom, min=1e-9),
                      torch.zeros_like(num))
    return (g_t.float() + upd).to(g_t.dtype)


def draw_selection(n_clients: int, n_units: int, n_train: int,
                   seed: int) -> torch.Tensor:
    """(C, U) float32: the ``uniform`` strategy's draw for one round."""
    from ...core.strategies import SelectionContext, Uniform
    gen = torch.Generator().manual_seed(seed)
    return Uniform().select(gen, SelectionContext(n_clients, n_units,
                                                  n_train))


def k1_bytes(row_unit: np.ndarray, sel_cu: torch.Tensor, tile: int
             ) -> dict:
    """K1's bytes at a plan: every client plane read (the previous
    design's work), and the live planes only (this design's work: the
    global tiles, the planes whose unit the client selected, the (C, U)
    selection, the C weights and the row table read once, the output
    written once); ``live`` is the mean of live planes a row."""
    t, (c, u) = len(row_unit), tuple(sel_cu.shape)
    live = float((sel_cu.cpu().numpy()[:, row_unit] != 0).sum()) / t
    return {"live": live, "planes": c,
            "all": 4 * (t * tile * (c + 2) + t * c),
            "live_bytes": 4 * t * tile * (2 + live) + 4 * (c * u + c + t)}
