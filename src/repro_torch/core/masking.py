"""Freeze-unit assignment over parameter trees.

A **freeze unit** is the granularity of the paper's layer selection: one
conv/dense layer for the paper's own models.  Every param leaf maps to
one unit — either wholly (``scalar`` leaves) or per-index along its
leading macro dim (``stacked`` leaves; the zoo models' scanned block
stacks, which wait for a later slice).

Given a 0/1 selection vector ``sel (U,)``, ``mask_tree`` materializes a
tree of broadcastable masks: a 0-dim mask for a scalar leaf, ``(n_macro,)``
for a stacked one.  Slot packing (the packed round path) waits for its
own slice.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

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
