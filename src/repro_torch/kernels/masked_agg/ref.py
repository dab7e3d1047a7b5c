"""Plain PyTorch version of the fused masked aggregation.

``masked_agg_ref`` is the tile-level function the CUDA kernel computes:
the wrapper runs it for CPU tensors, and ``chip_smoke.py`` holds the
kernel to it on the card (``ops.check_kernel``).  It takes fp32 or bf16
tiles alike: sums in fp32, one cast to the global's dtype at the end, as
the Pallas body does.  The tree-level oracle is
``core.aggregation.masked_fedavg``.  ``draw_selection`` and
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


def bf16_agrees(got: torch.Tensor, want: torch.Tensor, g: torch.Tensor
                ) -> torch.Tensor:
    """Elementwise: bf16 ``got`` agrees with the plain version's bf16
    ``want`` for global tiles ``g``.  Both sum in fp32 and round once, in
    another order (the kernel's FMAs against the plain version's products
    and sums), so they may round to neighbouring bf16 values: one bf16
    step.  Where the update cancels the global value, the result is far
    smaller than its operands and the fp32 sums' own rounding (a few fp32
    steps of |g| and |update|) can span many bf16 steps of it (an H100
    run: g 0.0298, the update -0.0298, the kernel 1.86e-8, the plain
    version 1.68e-8, float64 1.73e-8); such an element agrees within
    2^-20 (|g| + |update|)."""
    def ordered(x):         # bf16 bits in value order, +0 and -0 alike
        i = x.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -32768 - i, i)

    steps = (ordered(got) - ordered(want)).abs()
    x, y, g = got.float(), want.float(), g.float()
    near = (x - y).abs() <= 2.0 ** -20 * (g.abs() + (y - g).abs())
    return (steps <= 1) | near


def draw_selection(n_clients: int, n_units: int, n_train: int,
                   seed: int) -> torch.Tensor:
    """(C, U) float32: the ``uniform`` strategy's draw for one round."""
    from ...core.strategies import SelectionContext, Uniform
    gen = torch.Generator().manual_seed(seed)
    return Uniform().select(gen, SelectionContext(n_clients, n_units,
                                                  n_train))


def k1_bytes(row_unit: np.ndarray, sel_cu: torch.Tensor, tile: int,
             esz: int = 4) -> dict:
    """K1's bytes at a plan of ``esz``-byte tiles (4 fp32, 2 bf16): every
    client plane read (the previous design's work, with its (T, C) fp32
    weight table), and the live planes only (this design's work: the
    global tiles, the planes whose unit the client selected, the (C, U)
    selection, the C weights and the row table read once, the output
    written once); ``live`` is the mean of live planes a row."""
    t, (c, u) = len(row_unit), tuple(sel_cu.shape)
    live = float((sel_cu.cpu().numpy()[:, row_unit] != 0).sum()) / t
    return {"live": live, "planes": c,
            "all": esz * t * tile * (c + 2) + 4 * t * c,
            "live_bytes": esz * t * tile * (2 + live)
            + 4 * (c * u + c + t)}
