"""Server-side aggregation — the plain versions.

* ``fedavg``        — Eq. (1), unchanged from McMahan et al.
* ``masked_fedavg`` — participation-weighted per-unit FedAvg: when
  clients ship disjoint layer subsets, each unit averages only over the
  clients that trained it.  Units nobody trained keep the global value.

* ``masked_fedavg_packed`` — the same average computed from **packed
  slot buffers** (DESIGN.md §7): each client contributes only its
  ``(n_slots, ...)`` trained rows plus a ``(C, L)`` slot->row index,
  and the combiner accumulates client uploads one by one in client
  order.  It is composed from ``packed_acc_init`` /
  ``packed_accumulate`` / ``packed_finalize`` (hub forms; the
  per-edge forms wait for the hierarchical topology).

All take client deltas stacked along a leading client axis.  The fused
CUDA aggregation (``kernels/masked_agg``) is held to ``masked_fedavg``;
the packed path does not use it, as in the reference.
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


def packed_acc_init(assign: UnitAssignment, global_params) -> Tree:
    """Zero float32 numerator carry (one ``g.shape`` buffer per leaf)
    for the packed accumulate; denominators are functions of
    ``sel``/``weights`` alone and live in :func:`packed_finalize`."""
    return {p: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for p, g in flatten_with_paths(global_params)}


def packed_accumulate(assign: UnitAssignment, acc: Tree, packed_deltas: Tree,
                      rows: Tree, valid: Tree, weights: torch.Tensor) -> Tree:
    """Accumulate a block of packed client uploads into ``acc`` (in
    place; ``acc`` is the carry :func:`packed_acc_init` made).

    Clients land strictly in their stacked order (the FEDn server
    accumulating uploads one by one).  Stacked-leaf entries are ``(K,
    L, ...)`` slot deltas with ``rows``/``valid (K, L)``: each client's
    rows are distinct, so its weighted rows are added to exactly those
    numerator rows and copied back with ``index_copy`` — no atomic
    ``index_add_``, so a run is repeatable on the card.  Scalar leaves
    carry dense ``(K, ...)`` deltas with ``valid (K,)`` participation.
    """
    for path, num in flatten_with_paths(acc):
        lu = assign.leaf_units[path]
        dev = num.device
        d = packed_deltas[path].float()
        v = valid[path].float().to(dev)
        wf = weights.float().to(dev)
        if lu.kind == "scalar":
            wm = v * wf                                       # (K,)
            for c in range(d.shape[0]):
                num.add_(wm[c] * d[c])
            continue
        wv = v * wf[:, None]                                  # (K, L)
        r = rows[path].to(device=dev, dtype=torch.long)
        for c in range(d.shape[0]):
            w_c = wv[c].reshape((-1,) + (1,) * (d.ndim - 2))
            num.index_copy_(0, r[c], num.index_select(0, r[c]) + w_c * d[c])
    return acc


def packed_finalize(assign: UnitAssignment, global_params, acc: Tree,
                    sel: torch.Tensor, weights: torch.Tensor) -> Tree:
    """Combine accumulated packed numerators into new global params.

    ``sel (C, U)`` / ``weights (C,)`` cover every client whose upload
    was accumulated, so the per-unit denominators are the dense path's
    own expressions.  Units with zero participation keep the global
    value exactly.
    """
    out = {}
    for path, g in flatten_with_paths(global_params):
        dev = g.device
        lu = assign.leaf_units[path]
        num = acc[path]
        idx = torch.as_tensor(leaf_unit_ids(lu, g.shape))
        wm = sel[:, idx].float().to(dev) * \
            weights.float().to(dev)[:, None]                  # (C, nm|1)
        denom = wm.sum(0)
        if lu.kind == "scalar":
            denom = denom[0]
        den_b = denom.reshape(tuple(denom.shape) +
                              (1,) * (num.ndim - denom.ndim))
        upd = torch.where(den_b > 0, num / torch.clamp(den_b, min=1e-9),
                          torch.zeros_like(num))
        out[path] = (g.float() + upd).to(g.dtype)
    return out


def masked_fedavg_packed(global_params: Tree, packed_deltas: Tree,
                         rows: Tree, valid: Tree, sel: torch.Tensor,
                         weights: torch.Tensor, assign: UnitAssignment
                         ) -> Tree:
    """Participation-weighted FedAvg over packed slot buffers (§7).

    ``packed_deltas`` stacked-leaf entries are ``(C, L, ...)`` slot
    deltas with ``rows (C, L)`` macro indices and ``valid (C, L)`` slot
    masks (``slot_plan`` per client, stacked); scalar leaves carry dense
    ``(C, ...)`` deltas with ``valid (C,)``.  The reduce only reads a
    client's trained rows.  Composed from :func:`packed_acc_init` /
    :func:`packed_accumulate` / :func:`packed_finalize`.
    """
    acc = packed_acc_init(assign, global_params)
    acc = packed_accumulate(assign, acc, packed_deltas, rows, valid, weights)
    return packed_finalize(assign, global_params, acc, sel, weights)
