"""The paper's VGG16-CIFAR (Table 1) in PyTorch.

13 conv (+BN) + 1 dense = 14 trainable layers, **14,736,714 parameters
exactly** at ``width_mult=1.0`` (conv/dense weights+biases plus 4
parameters per BN channel — the moving-statistic leaves are kept for
the count and never read).  Each conv/dense layer is one freeze unit,
the BN belonging to its conv's unit.

Layout: images stay ``(B, 32, 32, 3)`` at the public surface, as in the
reference, and become NCHW inside.  Conv weights are ``(cout, cin, 3,
3)`` (torch's OIHW; ``convert.from_reference`` transposes the
reference's HWIO), the dense weight stays ``(cin, classes)``.

The IMDB CNN-LSTM and CASA LSTM are not ported yet.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from ..common import Device, resolve_device, sorted_tree

# (convs, out_channels) per VGG16 stage; pools after each stage
VGG_STAGES: Tuple[Tuple[int, int], ...] = (
    (2, 64), (2, 128), (3, 256), (3, 512), (3, 512))


def _conv_init(gen, cin, cout, dtype, k=3):
    s = 1.0 / math.sqrt(k * k * cin)
    return {
        "w": (torch.randn((cout, cin, k, k), generator=gen) * s).to(dtype),
        "b": torch.zeros((cout,), dtype=dtype),
        # BN: gamma, beta trainable; moving stats counted but frozen
        "bn_g": torch.ones((cout,), dtype=dtype),
        "bn_b": torch.zeros((cout,), dtype=dtype),
        "bn_mu": torch.zeros((cout,), dtype=dtype),
        "bn_var": torch.ones((cout,), dtype=dtype),
    }


def init_vgg16(gen: torch.Generator, num_classes: int = 10,
               dtype=torch.float32, width_mult: float = 1.0
               ) -> Dict[str, torch.Tensor]:
    """Random VGG16 params on the CPU, drawn from ``gen``.

    width_mult=0.5 is the paper's Jetson-Nano 'lighter' variant.
    """
    params: Dict[str, torch.Tensor] = {}
    cin = 3
    idx = 0
    for n_convs, cout in VGG_STAGES:
        cout = max(8, int(cout * width_mult))
        for _ in range(n_convs):
            for k, v in _conv_init(gen, cin, cout, dtype).items():
                params[f"conv{idx}/{k}"] = v
            cin = cout
            idx += 1
    params["dense0/w"] = (torch.randn((cin, num_classes), generator=gen)
                          * (1.0 / math.sqrt(cin))).to(dtype)
    params["dense0/b"] = torch.zeros((num_classes,), dtype=dtype)
    return sorted_tree(params)


def _bn(params, name, x, eps=1e-3):
    # batch-statistics BN with the population variance (ddof=0), as the
    # reference's stateless _bn; bn_mu/bn_var are never consulted
    mu = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), correction=0, keepdim=True)
    inv = torch.rsqrt(var + eps)
    g = params[f"{name}/bn_g"].view(1, -1, 1, 1)
    b = params[f"{name}/bn_b"].view(1, -1, 1, 1)
    return (x - mu) * inv * g + b


def vgg16_apply(params, images, *, device: Device = "cuda") -> torch.Tensor:
    """images (B, 32, 32, 3) -> logits (B, num_classes) on ``device``,
    computed in the params' dtype."""
    dev = resolve_device(device)
    x = torch.as_tensor(images, device=dev,
                        dtype=params["conv0/w"].dtype).permute(0, 3, 1, 2)
    idx = 0
    for n_convs, _ in VGG_STAGES:
        for _ in range(n_convs):
            name = f"conv{idx}"
            x = F.conv2d(x, params[f"{name}/w"], padding=1)   # 3x3 "SAME"
            x = x + params[f"{name}/b"].view(1, -1, 1, 1)
            x = F.relu(_bn(params, name, x))
            idx += 1
        x = F.max_pool2d(x, 2, 2)
    x = x.mean(dim=(2, 3))                           # global average pool
    return x @ params["dense0/w"] + params["dense0/b"]


def vgg16_units(params) -> List[str]:
    """Freeze units in forward order: conv0..conv12, dense0 (14 units)."""
    tops = {p.split("/")[0] for p in params}
    return sorted(tops, key=_unit_order)


def _unit_order(k: str) -> Tuple[int, int]:
    if k.startswith("conv"):
        return (0, int(k[4:]))
    return (1, 0)


def xent_loss(logits, labels) -> torch.Tensor:
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    ll = lf.gather(-1, labels.long()[:, None])[:, 0]
    return (logz - ll).mean()


def accuracy(logits, labels) -> torch.Tensor:
    return (logits.argmax(-1) == labels).float().mean()


def vgg16_loss(params, batch, *, device: Device = "cuda"):
    """The federated loss of the VGG16 runs: ``(loss, aux)``."""
    logits = vgg16_apply(params, batch["x"], device=device)
    return xent_loss(logits, torch.as_tensor(batch["y"],
                                             device=logits.device)), {}
