"""Freeze-unit assignment over parameter trees.

A **freeze unit** is the granularity of the paper's layer selection: one
conv/dense layer for the paper's own models.  Every param leaf maps to
one unit — either wholly (``scalar`` leaves) or per-index along its
leading macro dim (``stacked`` leaves: the toy MLP's block stacks here,
the zoo models' scanned blocks once they are ported).

Given a 0/1 selection vector ``sel (U,)``, ``mask_tree`` materializes a
tree of broadcastable masks: a 0-dim mask for a scalar leaf, ``(n_macro,)``
for a stacked one.  ``slot_plan`` / ``slot_gather`` / ``slot_merge``
lay out the packed round path's slot buffers (DESIGN.md §7), and
``unit_sqnorm`` / ``unit_sqnorm_packed`` reduce the scored selection's
gradient-norm telemetry (DESIGN.md §11).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..common import flatten_with_paths, tree_map_with_path


class LeafUnit(NamedTuple):
    kind: str        # "scalar" | "stacked"
    base: int        # unit id (scalar) or unit of macro index 0 (stacked)
    stride: int      # units advanced per macro index (stacked only)


class UnitAssignment(NamedTuple):
    n_units: int
    leaf_units: Dict[str, LeafUnit]   # path -> LeafUnit, in leaf order
    unit_names: Tuple[str, ...]


def build_units_flat(params, unit_order: Sequence[str]) -> UnitAssignment:
    """Unit map for the paper models: each top-level key is one unit."""
    order = {k: i for i, k in enumerate(unit_order)}

    def assign(path: str, leaf) -> LeafUnit:
        top = path.split("/")[0]
        if top not in order:
            raise ValueError(f"param {path} not in unit order {unit_order}")
        return LeafUnit("scalar", order[top], 0)

    leaf_units = tree_map_with_path(assign, params)
    return UnitAssignment(len(unit_order), leaf_units, tuple(unit_order))


def leaf_unit_ids(lu: LeafUnit, shape) -> np.ndarray:
    """Unit id of every macro row of a leaf (one id for a scalar leaf)."""
    if lu.kind == "scalar":
        return np.asarray([lu.base])
    return lu.base + lu.stride * np.arange(shape[0])


def mask_tree(assign: UnitAssignment, sel: torch.Tensor, params):
    """sel (U,) 0/1 -> tree of float32 masks broadcastable to params.

    The masks live on ``sel``'s device.
    """
    sel = sel.float()

    def one(path, p):
        lu = assign.leaf_units[path]
        if lu.kind == "scalar":
            return sel[lu.base]
        idx = torch.as_tensor(leaf_unit_ids(lu, p.shape), device=sel.device)
        return sel[idx]

    return tree_map_with_path(one, params)


def apply_mask(mask, tree):
    """Elementwise tree * mask with trailing broadcast."""
    return {p: x * mask[p].reshape(
                tuple(mask[p].shape) + (1,) * (x.ndim - mask[p].ndim)
            ).to(device=x.device, dtype=x.dtype)
            for p, x in flatten_with_paths(tree)}


def unit_param_counts(assign: UnitAssignment, params) -> np.ndarray:
    """(U,) int64 — parameters per freeze unit (comm accounting)."""
    counts = np.zeros(assign.n_units, np.int64)
    for path, leaf in flatten_with_paths(params):
        lu = assign.leaf_units[path]
        shape = tuple(leaf.shape)
        if lu.kind == "scalar":
            counts[lu.base] += int(np.prod(shape))
        else:
            per = int(np.prod(shape[1:]))
            for u in leaf_unit_ids(lu, shape):
                counts[u] += per
    return counts


# ---------------------------------------------------------------------------
# slot packing (DESIGN.md §7 — the sparse round step)
#
# With a static per-round trained-unit budget ``n_slots`` the selected
# macro rows of every *stacked* leaf are gathered into fixed-shape
# ``(L, ...)`` slot buffers (L = min(n_macro, n_slots)), so optimizer
# moments, weight deltas and the cross-client reduce only ever touch the
# trained slice of the model.  Scalar leaves participate as whole units
# and are carried dense.


def slot_plan(assign: UnitAssignment, sel_row: torch.Tensor, n_slots: int,
              params) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
    """Per-leaf slot layout for one client's packed round.

    Returns ``(rows, valid)``, two trees keyed like ``params`` on
    ``sel_row``'s device:

    * stacked leaf: ``rows (L,)`` int64 macro indices with the selected
      rows first (stable order) and *distinct* unselected pad rows after
      (the argsort is a permutation, so pad slots never alias a selected
      row); ``valid (L,)`` float32 is 1 on selected slots, 0 on pads.
    * scalar leaf: ``rows`` is an empty int64 sentinel and ``valid`` is
      the leaf's participation scalar ``sel_row[unit]`` — the value
      ``mask_tree`` gives, so ``valid`` doubles as the grad / optimizer
      mask tree of the packed representation.
    """
    sel_row = sel_row.float()
    rows, valid = {}, {}
    for path, p in flatten_with_paths(params):
        lu = assign.leaf_units[path]
        if lu.kind == "scalar":
            rows[path] = torch.zeros((0,), dtype=torch.int64,
                                     device=sel_row.device)
            valid[path] = sel_row[lu.base]
            continue
        ids = torch.as_tensor(leaf_unit_ids(lu, p.shape),
                              device=sel_row.device)
        leaf_sel = sel_row[ids]
        n_keep = min(p.shape[0], n_slots)
        # stable: selected rows first, each group in index order
        order = torch.argsort(-leaf_sel, stable=True)
        rows[path] = order[:n_keep]
        valid[path] = leaf_sel[rows[path]]
    return rows, valid


def cohort_slot_plans(assign: UnitAssignment, sel: torch.Tensor,
                      n_slots: int, params):
    """:func:`slot_plan` of every client row of ``sel (K, U)``, stacked
    along a leading client axis: ``(rows, valid)`` trees of ``(K, L)``
    (stacked leaves) or ``(K, 0)`` / ``(K,)`` (scalar leaves) on
    ``sel``'s device — the packed local training's input."""
    plans = [slot_plan(assign, s, n_slots, params) for s in sel]
    paths = [p for p, _ in flatten_with_paths(params)]
    return ({p: torch.stack([r[p] for r, _ in plans]) for p in paths},
            {p: torch.stack([v[p] for _, v in plans]) for p in paths})


def slot_gather(assign: UnitAssignment, tree, rows):
    """Stacked leaves -> their ``(L, ...)`` slot rows; scalar leaves whole."""
    return {p: x if assign.leaf_units[p].kind == "scalar"
            else x.index_select(0, rows[p])
            for p, x in flatten_with_paths(tree)}


def slot_merge(assign: UnitAssignment, base, packed, rows):
    """Inverse of :func:`slot_gather`: write slot rows into ``base``.

    Out of place: stacked leaves scatter their packed rows into a copy
    of the full-shape base leaf (rows are distinct by construction, so
    a plain copy is exact — pad slots rewrite their own unchanged
    value); scalar leaves pass through from ``packed``.  With a detached
    ``base`` no gradient reaches the frozen stacked rows.
    """
    return {p: packed[p] if assign.leaf_units[p].kind == "scalar"
            else b.index_copy(0, rows[p], packed[p])
            for p, b in flatten_with_paths(base)}


# ---------------------------------------------------------------------------
# gradient-norm telemetry (DESIGN.md §11 — scored selection)
#
# The scored selection engine needs per-unit gradient norms out of the
# round step: they are reduced from the (masked) gradients local training
# has already computed and accumulated into one (U,) float32 vector per
# client.  Leaves that take no gradient (frozen for the whole round)
# contribute nothing, so a frozen unit's bin stays exactly 0.0.  On a card
# the whole-leaf norms of a step are one multi-tensor reduction
# (``torch._foreach_norm``) and the per-unit sums a fixed-order reduction
# over a cached unit-by-leaf 0/1 matrix: no atomics, so the telemetry is
# bitwise repeatable.


class NormHook(NamedTuple):
    """Per-step gradient-norm accumulator of local training:
    ``fn(grads) -> (n_units,)`` float32 per-unit squared-norm
    contributions on the gradients' device."""
    n_units: int
    fn: Callable


def _unit_sums(assign: UnitAssignment, units, sq: torch.Tensor,
               cache=None) -> torch.Tensor:
    """(U,) sums of the per-leaf squares ``sq`` (L,) into their units."""
    key = (tuple(units), sq.device)
    onehot = None if cache is None else cache.get(key)
    if onehot is None:
        m = np.zeros((assign.n_units, len(units)), np.float32)
        m[np.asarray(units), np.arange(len(units))] = 1.0
        onehot = torch.as_tensor(m).to(sq.device)
        if cache is not None:
            cache[key] = onehot
    return (onehot * sq).sum(1)


def _scalar_sq(grads, paths) -> torch.Tensor:
    """(L,) float32 squared norms of whole leaves."""
    norms = torch._foreach_norm([grads[p].float() for p in paths])
    return torch.stack(norms).square()


def unit_sqnorm(assign: UnitAssignment, grads, cache=None) -> torch.Tensor:
    """(U,) float32 per-unit squared norms of a (masked) gradient tree;
    ``grads`` may hold any subset of the leaves (those local training
    differentiates).  Frozen units' bins stay exactly 0.0."""
    return unit_sqnorm_packed(assign, grads, None, cache)


def unit_sqnorm_packed(assign: UnitAssignment, grads, rows,
                       cache=None) -> torch.Tensor:
    """Packed-path twin of :func:`unit_sqnorm`: stacked leaves hold
    ``(L, ...)`` slot gradients and each slot's squared norm goes to its
    macro row's unit (``rows`` from ``slot_plan``; pad slots carry
    masked-zero gradients).  With ``rows=None`` stacked leaves are
    full-shape (the dense path)."""
    paths = [p for p, _ in flatten_with_paths(grads)]
    dev = grads[paths[0]].device if paths else torch.device("cpu")
    scalar = [p for p in paths if assign.leaf_units[p].kind == "scalar"]
    acc = torch.zeros((assign.n_units,), dtype=torch.float32, device=dev)
    if scalar:
        acc = acc + _unit_sums(assign, [assign.leaf_units[p].base
                                        for p in scalar],
                               _scalar_sq(grads, scalar), cache)
    for p in paths:
        lu = assign.leaf_units[p]
        if lu.kind == "scalar":
            continue
        g = grads[p].float()
        rows_sq = torch.square(g).reshape(g.shape[0], -1).sum(1)
        macro = torch.arange(g.shape[0], device=dev) if rows is None \
            else rows[p].to(device=dev, dtype=torch.long)
        # distinct macro rows: one write per unit, no accumulation order
        idx = lu.base + lu.stride * macro
        acc[idx] += rows_sq
    return acc


def dense_norm_hook(assign: UnitAssignment) -> NormHook:
    cache: dict = {}
    return NormHook(assign.n_units,
                    lambda g: unit_sqnorm(assign, g, cache))


def packed_norm_hook(assign: UnitAssignment, rows, cache=None) -> NormHook:
    """``rows`` is one client's slot plan."""
    return NormHook(assign.n_units,
                    lambda g: unit_sqnorm_packed(assign, g, rows, cache))
