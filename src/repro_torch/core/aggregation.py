"""Server-side aggregation — the plain versions.

* ``fedavg``        — Eq. (1), unchanged from McMahan et al.
* ``masked_fedavg`` — participation-weighted per-unit FedAvg: when
  clients ship disjoint layer subsets, each unit averages only over the
  clients that trained it.  Units nobody trained keep the global value.

* ``hierarchical_masked_fedavg`` — the same average in two stages:
  per-edge partial numerator/denominator sums (each edge aggregator
  reduces its own clients), then a hub combine over edges.
  ``hierarchical_edge_partials`` is stage 1 on its own (per-edge
  partial means and weight mass), so the hub combine can run through
  the fused CUDA kernel (``core/topology._fused_hier_aggregate``).
* ``masked_fedavg_packed`` / ``hierarchical_masked_fedavg_packed`` —
  the same averages computed from **packed slot buffers** (DESIGN.md
  §7): each client contributes only its ``(n_slots, ...)`` trained rows
  plus a ``(C, L)`` slot->row index, and the combiner accumulates
  client uploads one by one in client order (into its edge's partial
  under hierarchical).  Both are composed from ``packed_acc_init`` /
  ``packed_accumulate`` / ``packed_finalize``, which the async flush and
  the chunk-streamed cohort round also run.
* ``gate_packed_updates`` — the validation gate of the fault axis
  (DESIGN.md §14): quarantines non-finite or oversized packed uploads
  before the accumulate sees them.

All take client deltas stacked along a leading client axis and an
``(E, C)`` 0/1 edge membership where they are per edge.  The fused CUDA
aggregation (``kernels/masked_agg``) is held to ``masked_fedavg`` and,
as the hub combine, to ``hierarchical_masked_fedavg``; the packed path
does not use it, as in the reference.  The port holds packed against
dense within 2e-5, not bitwise.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

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


def packed_acc_init(assign: UnitAssignment, global_params,
                    n_edges: Optional[int] = None) -> Tree:
    """Zero float32 numerator carry for the packed accumulate: one
    ``g.shape`` buffer per leaf for the hub, ``(n_edges,) + g.shape``
    when the per-edge stage-1 partials are kept apart (hierarchical).
    Denominators are functions of ``sel``/``weights`` alone and live in
    :func:`packed_finalize`."""
    lead = () if n_edges is None else (int(n_edges),)
    return {p: torch.zeros(lead + tuple(g.shape), dtype=torch.float32,
                           device=g.device)
            for p, g in flatten_with_paths(global_params)}


def packed_accumulate(assign: UnitAssignment, acc: Tree, packed_deltas: Tree,
                      rows: Tree, valid: Tree, weights: torch.Tensor,
                      edge_idx: Optional[torch.Tensor] = None) -> Tree:
    """Accumulate a block of packed client uploads into ``acc`` (in
    place; ``acc`` is the carry :func:`packed_acc_init` made).

    Clients land strictly in their stacked order (the FEDn server
    accumulating uploads one by one).  Stacked-leaf entries are ``(K,
    L, ...)`` slot deltas with ``rows``/``valid (K, L)``: each client's
    rows are distinct, so its weighted rows are added to exactly those
    numerator rows and copied back with ``index_copy`` — no atomic
    ``index_add_``, so a run is repeatable on the card.  Scalar leaves
    carry dense ``(K, ...)`` deltas with ``valid (K,)`` participation.
    With ``edge_idx (K,)`` each client lands in its edge's stage-1
    partial (``acc`` from ``packed_acc_init(..., n_edges=E)``) instead
    of the hub numerator.
    """
    edges = None if edge_idx is None else \
        [int(e) for e in torch.as_tensor(edge_idx).tolist()]
    for path, acc_leaf in flatten_with_paths(acc):
        lu = assign.leaf_units[path]
        dev = acc_leaf.device
        d = packed_deltas[path].float()
        v = valid[path].float().to(dev)
        wf = weights.float().to(dev)

        def num_of(c):
            return acc_leaf if edges is None else acc_leaf[edges[c]]

        if lu.kind == "scalar":
            wm = v * wf                                       # (K,)
            for c in range(d.shape[0]):
                num_of(c).add_(wm[c] * d[c])
            continue
        wv = v * wf[:, None]                                  # (K, L)
        r = rows[path].to(device=dev, dtype=torch.long)
        for c in range(d.shape[0]):
            w_c = wv[c].reshape((-1,) + (1,) * (d.ndim - 2))
            num = num_of(c)
            num.index_copy_(0, r[c], num.index_select(0, r[c]) + w_c * d[c])
    return acc


def packed_finalize(assign: UnitAssignment, global_params, acc: Tree,
                    sel: torch.Tensor, weights: torch.Tensor,
                    membership: Optional[torch.Tensor] = None) -> Tree:
    """Combine accumulated packed numerators into new global params.

    ``sel (C, U)`` / ``weights (C,)`` cover every client whose upload
    was accumulated, so the per-unit denominators are the dense path's
    own expressions.  With ``membership (E, C)`` the ``E`` stage-1
    partials are summed at the hub first (hierarchical stage 2).  Units
    with zero participation keep the global value exactly.
    """
    out = {}
    for path, g in flatten_with_paths(global_params):
        dev = g.device
        lu = assign.leaf_units[path]
        num = acc[path]
        idx = torch.as_tensor(leaf_unit_ids(lu, g.shape))
        wm = sel[:, idx].float().to(dev) * \
            weights.float().to(dev)[:, None]                  # (C, nm|1)
        if membership is None:
            denom = wm.sum(0)
        else:
            num = num.sum(0)
            denom = (membership.float().to(dev) @ wm).sum(0)
        if lu.kind == "scalar":
            denom = denom[0]
        den_b = denom.reshape(tuple(denom.shape) +
                              (1,) * (num.ndim - denom.ndim))
        upd = torch.where(den_b > 0, num / torch.clamp(den_b, min=1e-9),
                          torch.zeros_like(num))
        out[path] = (g.float() + upd).to(g.dtype)
    return out


def gate_packed_updates(assign: UnitAssignment, packed_deltas: Tree,
                        valid: Tree, weights: torch.Tensor,
                        max_norm: float = 0.0
                        ) -> Tuple[Tree, torch.Tensor, torch.Tensor]:
    """Packed-delta validation gate (DESIGN.md §14): quarantine hostile
    uploads *before* the accumulate sees them.

    A client is quarantined when any element of its **valid** slot rows
    is non-finite, or (``max_norm > 0``) when its valid-slot delta
    sqnorm exceeds ``max_norm**2`` across all leaves.  Returns
    ``(clean_deltas, gated_weights, quarantined)``:

    * ``clean_deltas`` — quarantined clients' rows zeroed, and every
      non-finite element zeroed everywhere: the accumulate adds padding
      rows and non-participating scalar leaves with weight 0, and
      ``0 * NaN`` would still poison the numerator;
    * ``gated_weights`` — ``weights * ok`` (on ``weights``' device):
      quarantined clients leave the per-unit denominators, so surviving
      weights renormalize exactly as if the client had never uploaded;
    * ``quarantined`` — (C,) float32 0/1 per client, on ``weights``'
      device.

    Fault-free inputs make every select take its first branch
    (``where(True, d, 0) == d``; ``w * 1.0 == w``), so an
    enabled-but-untripped gate is BITWISE transparent.
    """
    ok, sq = None, None
    for path, d in flatten_with_paths(packed_deltas):
        if not d.is_floating_point():
            continue
        c = d.shape[0]
        v = valid[path].to(d.device)
        vb = (v != 0).reshape(tuple(v.shape) + (1,) * (d.ndim - v.ndim))
        fin = torch.isfinite(d)
        # client health is judged on valid rows only: garbage in
        # weight-0 padding does not incriminate the upload
        finite = (fin | ~vb).reshape(c, -1).all(dim=1)
        df = torch.where(vb & fin, d.float(), torch.zeros((), device=d.device))
        s = (df * df).reshape(c, -1).sum(dim=1)
        ok = finite if ok is None else ok & finite
        sq = s if sq is None else sq + s
    if ok is None:
        ok = torch.ones(weights.shape[0], dtype=torch.bool)
        sq = torch.zeros(weights.shape[0])
    if max_norm > 0.0:
        ok = ok & (sq <= torch.tensor(max_norm, dtype=torch.float32) ** 2)
    cleaned = {}
    for path, d in flatten_with_paths(packed_deltas):
        if not d.is_floating_point():
            cleaned[path] = d
            continue
        keep = ok.to(d.device).reshape((d.shape[0],) + (1,) * (d.ndim - 1))
        cleaned[path] = torch.where(keep & torch.isfinite(d), d,
                                    torch.zeros_like(d))
    okf = ok.to(device=weights.device, dtype=torch.float32)
    return cleaned, weights * okf, 1.0 - okf


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


def hierarchical_masked_fedavg_packed(global_params: Tree,
                                      packed_deltas: Tree, rows: Tree,
                                      valid: Tree, sel: torch.Tensor,
                                      weights: torch.Tensor,
                                      assign: UnitAssignment,
                                      membership: torch.Tensor) -> Tree:
    """Two-stage (edge -> hub) FedAvg over packed slot buffers.

    Stage 1 accumulates each client's slots into its edge's partial
    (per-edge ``(E, nm, ...)`` buffers, clients in upload order); stage 2
    sums the ``E`` partials at the hub — the staging of
    :func:`hierarchical_masked_fedavg`, reading only trained slots.
    """
    mem = membership.float()
    edge_of = mem.argmax(0)                                   # (C,)
    acc = packed_acc_init(assign, global_params, n_edges=mem.shape[0])
    acc = packed_accumulate(assign, acc, packed_deltas, rows, valid,
                            weights, edge_idx=edge_of)
    return packed_finalize(assign, global_params, acc, sel, weights,
                           membership=mem)


def _edge_sums(wm: torch.Tensor, d: torch.Tensor, edges, n_edges: int):
    """Per-edge ``Σ_c wm_c·d_c`` over ``d (C, ...)``, clients landing in
    upload order (``wm (C,)``, ``edges[c]`` the edge of client c)."""
    num = d.new_zeros((n_edges,) + tuple(d.shape[1:]))
    for c, e in enumerate(edges):
        num[e].add_(wm[c] * d[c])
    return num


def hierarchical_edge_partials(deltas: Tree, sel: torch.Tensor,
                               weights: torch.Tensor,
                               assign: UnitAssignment,
                               membership: torch.Tensor
                               ) -> Tuple[Tree, torch.Tensor]:
    """Stage 1 of the two-stage masked FedAvg, on its own.

    Returns ``(edge_means, e_den)``: per-edge partial *means* (a tree
    with a leading E axis; zero where an edge had no participant) and
    the per-edge per-unit weight mass ``e_den (E, U)`` (on ``sel``'s
    device).  Any flat combiner fed these with ``wsel = e_den`` — the
    fused kernel's ``masked_combine_packed`` in particular — reproduces
    the hub combine: ``Σ_e e_den·mean / Σ_e e_den = Σ_e num / Σ_e den``.
    """
    wf = weights.float().to(sel.device)
    mem = membership.float().to(sel.device)
    e_den = mem @ (sel.float() * wf[:, None])                 # (E, U)
    means = {}
    for path, d in flatten_with_paths(deltas):
        dev = d.device
        lu = assign.leaf_units[path]
        idx = torch.as_tensor(leaf_unit_ids(lu, d.shape[1:]))
        wm = (sel[:, idx].float() * wf[:, None]).to(dev)      # (C, nm|1)
        m = mem.to(dev)
        df = d.float()
        if lu.kind == "scalar":
            e_num = torch.einsum("ec,c,c...->e...", m, wm[:, 0], df)
        else:
            e_num = torch.einsum("ec,cm,cm...->em...", m, wm, df)
        den = e_den[:, idx].to(dev)
        if lu.kind == "scalar":
            den = den[:, 0]
        den_b = den.reshape(tuple(den.shape) +
                            (1,) * (e_num.ndim - den.ndim))
        means[path] = torch.where(
            den_b > 0, e_num / torch.clamp(den_b, min=1e-9),
            torch.zeros_like(e_num))
    return means, e_den


def hierarchical_masked_fedavg(global_params: Tree, deltas: Tree,
                               sel: torch.Tensor, weights: torch.Tensor,
                               assign: UnitAssignment,
                               membership: torch.Tensor) -> Tree:
    """Two-stage participation-weighted FedAvg (edge aggregators -> hub).

    ``membership (E, C)`` 0/1: client c belongs to edge e (each client
    to exactly one edge).  Stage 1 computes, per edge, the partial
    weighted numerator and denominator over that edge's clients (a
    scalar leaf's clients land in upload order, as in the packed
    accumulate); stage 2 combines the E partials at the hub.  Units with
    zero participation anywhere keep the global value exactly, as in
    ``masked_fedavg``.
    """
    mem = membership.float()
    edges = [int(e) for e in mem.argmax(0).tolist()]
    out = {}
    for path, g in flatten_with_paths(global_params):
        dev = g.device
        lu = assign.leaf_units[path]
        idx = torch.as_tensor(leaf_unit_ids(lu, g.shape))
        m = sel[:, idx].float().to(dev)                       # (C, nm|1)
        wm = m * weights.float().to(dev)[:, None]
        md = mem.to(dev)
        d = deltas[path].float()
        if lu.kind == "scalar":
            e_num = _edge_sums(wm[:, 0], d, edges, mem.shape[0])
            e_den = md @ wm[:, 0]                             # (E,)
        else:
            e_num = torch.einsum("ec,cm,cm...->em...", md, wm, d)
            e_den = md @ wm                                   # (E, nm)
        num, denom = e_num.sum(0), e_den.sum(0)
        denom_b = denom.reshape(tuple(denom.shape) +
                                (1,) * (num.ndim - denom.ndim))
        upd = torch.where(denom_b > 0,
                          num / torch.clamp(denom_b, min=1e-9),
                          torch.zeros_like(num))
        out[path] = (g.float() + upd).to(g.dtype)
    return out
