"""The paper's three models in PyTorch.

* VGG16-CIFAR (Table 1): 13 conv (+BN) + 1 dense = 14 trainable
  layers, **14,736,714 parameters exactly** at ``width_mult=1.0``
  (conv/dense weights+biases plus 4 parameters per BN channel — the
  moving-statistic leaves are kept for the count and never read).  The
  BN belongs to its conv's unit.
* IMDB sentiment CNN-LSTM (Table 2): embedding (20,000 x 128) ->
  conv1d (k 5, 64 filters, "SAME") -> max-pool 4 -> LSTM (70) -> dense
  (2); 2,638,966 parameters in 4 units.
* CASA HAR LSTM: LSTM (100) over 100 steps of 36 features, then dense
  layers of 96, 32, 24 and 16 with ReLU and 10 logits; 68,962
  parameters in 6 units.

Each conv/dense/LSTM layer (and the embedding) is one freeze unit.

Layout: images stay ``(B, 32, 32, 3)`` at the public surface, as in the
reference, and become NCHW inside.  Conv weights are torch's ``(cout,
cin, *kernel)``: OIHW for VGG16, OIW for IMDB's conv1d
(``convert.from_reference`` transposes the reference's HWIO / WIO when
told the conv's spatial rank).  Dense weights stay ``(cin, cout)``.

The LSTM keeps the reference's parameters — ``wx (d_in, 4h)``, ``wh (h,
4h)`` and one bias ``b (4h,)``, gates in (i, f, g, o) order, PyTorch's
own order — and runs on ``torch._VF.lstm`` (cuDNN on the card) with
``weight_ih = wx.T``, ``weight_hh = wh.T``, ``b_ih = b`` and ``b_hh = 0``.
The reference computes it as a scan of matmuls; there is no TPU kernel
to port.
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


# ---------------------------------------------------------------------------
# LSTM (shared by the IMDB and CASA models)

def _lstm_init(gen, d_in, d_h, dtype):
    return {
        "b": torch.zeros((4 * d_h,), dtype=dtype),
        "wh": (torch.randn((d_h, 4 * d_h), generator=gen)
               * (1.0 / math.sqrt(d_h))).to(dtype),
        "wx": (torch.randn((d_in, 4 * d_h), generator=gen)
               * (1.0 / math.sqrt(d_in))).to(dtype),
    }


def lstm_apply(p, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, d_in) -> the last hidden state (B, d_h).

    One cuDNN LSTM call on the card (``torch._VF.lstm`` in training
    mode, which its backward needs); ``b_hh`` is a zero constant, so the
    reference's single bias takes the whole gradient."""
    wx, wh, b = p["wx"], p["wh"], p["b"]
    d_h = wh.shape[0]
    h0 = x.new_zeros((1, x.shape[0], d_h))
    # cuDNN takes each weight as one contiguous block; it copies them
    # into its own flat buffer on every call (38-55k floats here)
    weights = [wx.t().contiguous(), wh.t().contiguous(), b,
               torch.zeros_like(b)]
    _, h, _ = torch._VF.lstm(x.contiguous(), (h0, h0), weights, True, 1,
                             0.0, True, False, True)
    return h[0]


def _sub(params, name):
    return {k.split("/", 1)[1]: v for k, v in params.items()
            if k.split("/", 1)[0] == name}


# ---------------------------------------------------------------------------
# IMDB sentiment CNN-LSTM (Table 2)

IMDB_VOCAB, IMDB_MAXLEN, IMDB_EMBED = 20000, 100, 128


def init_imdb(gen: torch.Generator, dtype=torch.float32,
              vocab: int = IMDB_VOCAB) -> Dict[str, torch.Tensor]:
    """Random IMDB params on the CPU, drawn from ``gen``."""
    params = {
        "embed_small/table": (torch.randn((vocab, IMDB_EMBED), generator=gen)
                              * 0.05).to(dtype),
        "conv0/w": (torch.randn((64, IMDB_EMBED, 5), generator=gen)
                    * (1.0 / math.sqrt(5 * IMDB_EMBED))).to(dtype),
        "conv0/b": torch.zeros((64,), dtype=dtype),
    }
    params.update({f"lstm0/{k}": v
                   for k, v in _lstm_init(gen, 64, 70, dtype).items()})
    params["dense0/w"] = (torch.randn((70, 2), generator=gen)
                          * (1.0 / math.sqrt(70))).to(dtype)
    params["dense0/b"] = torch.zeros((2,), dtype=dtype)
    return sorted_tree(params)


def imdb_apply(params, tokens, *, device: Device = "cuda") -> torch.Tensor:
    """tokens (B, 100) int -> logits (B, 2) on ``device``.

    ``F.embedding`` gathers the table (its backward on the card is not an
    atomic scatter); the pool is a max over groups of 4 steps of the
    first ``(S // 4) * 4``, as ``amax``, whose gradient splits ties
    evenly as JAX's ``max`` does."""
    dev = resolve_device(device)
    tok = torch.as_tensor(tokens, device=dev).long()
    x = F.embedding(tok, params["embed_small/table"])       # (B, S, E)
    x = F.conv1d(x.transpose(1, 2), params["conv0/w"], padding=2)
    x = F.relu(x + params["conv0/b"].view(1, -1, 1)).transpose(1, 2)
    b, s, c = x.shape
    x = x[:, :(s // 4) * 4].reshape(b, s // 4, 4, c).amax(dim=2)
    h = lstm_apply(_sub(params, "lstm0"), x)
    return h @ params["dense0/w"] + params["dense0/b"]


def imdb_units(params) -> List[str]:
    return ["embed_small", "conv0", "lstm0", "dense0"]


def imdb_loss(params, batch, *, device: Device = "cuda"):
    """The federated loss of the IMDB runs: ``(loss, aux)``."""
    logits = imdb_apply(params, batch["x"], device=device)
    return xent_loss(logits, torch.as_tensor(batch["y"],
                                             device=logits.device)), {}


# ---------------------------------------------------------------------------
# CASA HAR LSTM (6 trainable layers)

CASA_FEATURES, CASA_SEQ, CASA_CLASSES = 36, 100, 10
_CASA_DENSE = (96, 32, 24, 16)


def init_casa(gen: torch.Generator, dtype=torch.float32
              ) -> Dict[str, torch.Tensor]:
    """Random CASA params on the CPU, drawn from ``gen``."""
    params = {f"lstm0/{k}": v for k, v in
              _lstm_init(gen, CASA_FEATURES, 100, dtype).items()}
    d_in = 100
    for i, d in enumerate(_CASA_DENSE + (CASA_CLASSES,)):
        params[f"dense{i}/w"] = (torch.randn((d_in, d), generator=gen)
                                 * (1.0 / math.sqrt(d_in))).to(dtype)
        params[f"dense{i}/b"] = torch.zeros((d,), dtype=dtype)
        d_in = d
    return sorted_tree(params)


def casa_apply(params, x, *, device: Device = "cuda") -> torch.Tensor:
    """x (B, 100, 36) float -> logits (B, 10) on ``device``, computed in
    the params' dtype."""
    dev = resolve_device(device)
    h = torch.as_tensor(x, device=dev, dtype=params["lstm0/wx"].dtype)
    h = lstm_apply(_sub(params, "lstm0"), h)
    for i in range(len(_CASA_DENSE)):
        h = F.relu(h @ params[f"dense{i}/w"] + params[f"dense{i}/b"])
    i = len(_CASA_DENSE)
    return h @ params[f"dense{i}/w"] + params[f"dense{i}/b"]


def casa_units(params) -> List[str]:
    return ["lstm0", "dense0", "dense1", "dense2", "dense3", "dense4"]


def casa_loss(params, batch, *, device: Device = "cuda"):
    """The federated loss of the CASA runs: ``(loss, aux)``."""
    logits = casa_apply(params, batch["x"], device=device)
    return xent_loss(logits, torch.as_tensor(batch["y"],
                                             device=logits.device)), {}


# ---------------------------------------------------------------------------
# classification loss / accuracy shared by the paper tasks

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
