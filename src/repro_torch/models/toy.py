"""Tiny stacked-block residual MLP for round-step tests.

Not a paper model: its job is to exercise BOTH leaf kinds of the unit
assignment — scalar input/head leaves plus *stacked* block leaves
applied one block after another — at a size where the dense-masked and
packed round steps can be compared quickly on a CPU host.  Every VGG16
leaf is a scalar unit, so this model is the only way the port's tests
reach the stacked branches of slot packing, the packed aggregation and
the codecs.  Unit layout mirrors the zoo models: unit 0 = input
projection, units 1..n_blocks = one per block, unit n_blocks+1 = head.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..common import Device, resolve_device, sorted_tree
from ..core.masking import LeafUnit, UnitAssignment


def init_toy_mlp(gen: torch.Generator, *, n_blocks: int = 8, d: int = 32,
                 hidden: int = 64, out: int = 8) -> Dict[str, torch.Tensor]:
    """Random toy params on the CPU, drawn from ``gen``."""
    return sorted_tree({
        "inp/w": torch.randn((d, d), generator=gen) / math.sqrt(d),
        "blocks/w1": torch.randn((n_blocks, d, hidden), generator=gen)
        / math.sqrt(d),
        "blocks/b1": torch.zeros((n_blocks, hidden)),
        "blocks/w2": torch.randn((n_blocks, hidden, d), generator=gen)
        / math.sqrt(hidden),
        "head/w": torch.randn((d, out), generator=gen) / math.sqrt(d),
        "head/b": torch.zeros((out,)),
    })


def toy_units(params) -> UnitAssignment:
    """One unit per block (stacked) + scalar input / head units."""
    n_blocks = params["blocks/w1"].shape[0]
    head_unit = n_blocks + 1

    def unit(path: str) -> LeafUnit:
        top = path.split("/")[0]
        if top == "inp":
            return LeafUnit("scalar", 0, 0)
        if top == "blocks":
            return LeafUnit("stacked", 1, 1)
        return LeafUnit("scalar", head_unit, 0)

    leaf_units = {p: unit(p) for p in sorted_tree(params)}
    names = (("inp",) + tuple(f"block{i}" for i in range(n_blocks))
             + ("head",))
    return UnitAssignment(n_blocks + 2, leaf_units, names)


def toy_apply(params, x, *, device: Device = "cuda") -> torch.Tensor:
    """x (B, d) -> (B, out) on ``device``: the blocks run in order, as
    the reference's ``lax.scan`` over the stacked block leaves."""
    dev = resolve_device(device)
    h = torch.as_tensor(x, device=dev) @ params["inp/w"]
    for w1, b1, w2 in zip(params["blocks/w1"], params["blocks/b1"],
                          params["blocks/w2"]):
        h = h + torch.tanh(h @ w1 + b1) @ w2
    return h @ params["head/w"] + params["head/b"]


def toy_loss(params, batch, *, device: Device = "cuda"
             ) -> Tuple[torch.Tensor, Dict]:
    pred = toy_apply(params, batch["x"], device=device)
    y = torch.as_tensor(batch["y"], device=pred.device)
    return torch.mean(torch.square(pred - y)), {}


def toy_batches(gen: torch.Generator, *, n_clients: int, steps: int,
                batch: int, d: int, out: int) -> Dict[str, torch.Tensor]:
    """(C, steps, b, ...) synthetic regression batches on the CPU."""
    return {"x": torch.randn((n_clients, steps, batch, d), generator=gen),
            "y": torch.randn((n_clients, steps, batch, out), generator=gen)}
