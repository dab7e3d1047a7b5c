"""Server-side aggregation — the plain versions.

* ``fedavg``        — Eq. (1), unchanged from McMahan et al.
* ``masked_fedavg`` — participation-weighted per-unit FedAvg: when
  clients ship disjoint layer subsets, each unit averages only over the
  clients that trained it.  Units nobody trained keep the global value.

Both take client deltas stacked along a leading client axis.  The fused
CUDA aggregation (``kernels/masked_agg``) is held to ``masked_fedavg``;
the packed and hierarchical variants wait for later slices.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..common import flatten_with_paths
from .masking import UnitAssignment, leaf_unit_ids

Tree = Dict[str, torch.Tensor]


def fedavg(global_params: Tree, deltas: Tree,
           weights: torch.Tensor) -> Tree:
    """deltas: tree with leading client dim C; weights (C,) data sizes."""
    w = weights.float()
    w = w / torch.clamp(w.sum(), min=1e-9)
    out = {}
    for path, g in flatten_with_paths(global_params):
        wd = torch.tensordot(w.to(g.device), deltas[path].float(),
                             dims=([0], [0]))
        out[path] = (g.float() + wd).to(g.dtype)
    return out


def masked_fedavg(global_params: Tree, deltas: Tree, sel: torch.Tensor,
                  weights: torch.Tensor, assign: UnitAssignment) -> Tree:
    """Participation-weighted per-unit FedAvg.

    sel (C, U) 0/1; for each unit u:
        new_u = global_u + sum_c w_c sel_cu delta_cu / sum_c w_c sel_cu
    Units with zero participation keep the global value exactly.
    """
    out = {}
    for path, g in flatten_with_paths(global_params):
        dev = g.device
        lu = assign.leaf_units[path]
        idx = torch.as_tensor(leaf_unit_ids(lu, g.shape))
        m = sel[:, idx].float().to(dev)                      # (C, nm|1)
        if lu.kind == "scalar":
            m = m[:, 0]                                      # (C,)
        wf = weights.float().to(dev)
        wm = m * wf.reshape((-1,) + (1,) * (m.ndim - 1))
        denom = wm.sum(0)
        d = deltas[path].float()
        if m.ndim == 1:
            num = torch.tensordot(wm, d, dims=([0], [0]))
        else:
            num = torch.einsum("cm,cm...->m...", wm, d)
        denom_b = denom.reshape(tuple(denom.shape) +
                                (1,) * (num.ndim - denom.ndim))
        upd = torch.where(denom_b > 0,
                          num / torch.clamp(denom_b, min=1e-9),
                          torch.zeros_like(num))
        out[path] = (g.float() + upd).to(g.dtype)
    return out
