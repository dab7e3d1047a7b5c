"""Parameter-tree utilities shared across the port.

Params are flat ``dict``s of tensors keyed by "/"-joined leaf paths
(``conv0/w``, ``dense0/b``) — the same paths ``repro.common.pytree``
renders for the JAX package, so unit assignments, aggregation plans
and comparisons key identically in both packages.

JAX flattens a dict in **sorted key order** at every level (``conv10``
before ``conv2``).  Every tree built here keeps that order, so leaf and
unit order match the reference wherever they reach output.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

Tree = Dict[str, Any]


def path_key(path: str) -> Tuple[str, ...]:
    """Sort key that reproduces JAX's nested sorted-dict leaf order."""
    return tuple(path.split("/"))


def sorted_tree(tree: Mapping[str, Any]) -> Tree:
    """A new flat tree with its leaves in JAX leaf order."""
    return {p: tree[p] for p in sorted(tree, key=path_key)}


def flatten(nested: Mapping[str, Any], prefix: str = "") -> Tree:
    """Nested dicts -> flat ``{"a/b": leaf}`` in JAX leaf order."""
    out: Tree = {}
    for k in sorted(nested):
        path = f"{prefix}{k}"
        v = nested[k]
        if isinstance(v, Mapping):
            out.update(flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def unflatten(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """Flat ``{"a/b": leaf}`` -> nested dicts."""
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        node = out
        *parents, last = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def tree_paths(tree: Mapping[str, Any]) -> Tuple[str, ...]:
    return tuple(sorted(tree, key=path_key))


def flatten_with_paths(tree: Mapping[str, Any]) -> Iterator[Tuple[str, Any]]:
    for p in tree_paths(tree):
        yield p, tree[p]


def tree_map(fn: Callable, tree: Mapping[str, Any], *rest) -> Tree:
    """``fn(leaf, *matching_leaves)`` over the paths of ``tree``."""
    return {p: fn(x, *(r[p] for r in rest))
            for p, x in flatten_with_paths(tree)}


def tree_map_with_path(fn: Callable[[str, Any], Any],
                       tree: Mapping[str, Any]) -> Tree:
    return {p: fn(p, x) for p, x in flatten_with_paths(tree)}


def param_count(tree: Mapping[str, Any]) -> int:
    return sum(int(np.prod(tuple(x.shape))) for x in tree.values())


def param_bytes(tree: Mapping[str, Any],
                bytes_per_elem: int | None = None) -> int:
    total = 0
    for x in tree.values():
        n = int(np.prod(tuple(x.shape)))
        total += n * (bytes_per_elem if bytes_per_elem is not None
                      else x.element_size())
    return total


def tree_add(a: Mapping[str, Any], b: Mapping[str, Any]) -> Tree:
    return tree_map(torch.add, a, b)


def tree_sub(a: Mapping[str, Any], b: Mapping[str, Any]) -> Tree:
    return tree_map(torch.sub, a, b)


def tree_stack(trees) -> Tree:
    """Stack identically keyed trees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)
