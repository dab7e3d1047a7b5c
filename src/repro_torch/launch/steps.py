"""Step builders: the functions the launchers and ``chip_smoke.py`` run.

The port of ``repro.launch.steps``:

* ``make_train_step``   — fwd+bwd+masked-Adam (remat per macro-block)
* ``make_prefill_step`` — prefill with last-token logits + KV cache build
* ``make_decode_step``  — ONE new token against a seq_len KV cache
* ``make_fl_round_step``— the paper's federated round (core.federation)

They run eagerly on the device of the tensors they are given, where the
reference returns functions for ``jax.jit`` to lower onto a mesh.  With
``default_loss_kwargs`` attention takes the chunked implementation,
which the card runs on kernels K5/K6 (``models.attention.attend``).
``make_fl_round_step`` reads the leaf shapes of params built on the
``meta`` device (no memory), where the reference uses
``jax.eval_shape``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..common import Device
from ..configs.base import ArchConfig
from ..core.federation import FLConfig, build_round_step
from ..core.masking import build_units_zoo
from ..models import _FAMILY, get_model
from ..optim.masked import adam_step
from .shapes import InputShape


class _MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` is ``meta``: ``init_params``
    places its draws on ``gen.device``, so this one yields shapes only."""

    @property
    def device(self):
        return torch.device("meta")


def default_loss_kwargs(cfg: ArchConfig, shape: Optional[InputShape] = None,
                        *, remat: bool = True,
                        unroll: bool = False) -> Dict[str, Any]:
    # unroll is the reference's switch for its dry-run cost accounting;
    # the port's layer loop is always unrolled and ignores it
    kw: Dict[str, Any] = {"remat": remat, "unroll": unroll}
    if cfg.family != "ssm":
        kw["attn_impl"] = "chunked"
        kw["q_chunk"] = 1024
    return kw


def make_train_step(cfg: ArchConfig, *, lr: float = 3e-4,
                    remat: bool = True, loss_kwargs: Optional[Dict] = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    loss)`` with ``opt_state = optim.masked.adam_init(params)``.  The
    step writes into its inputs: the params and moment dicts it was given
    hold the new values afterwards (``optim.masked``), so a step needs no
    second copy of the model."""
    model = get_model(cfg)
    kw = loss_kwargs if loss_kwargs is not None else \
        default_loss_kwargs(cfg, remat=remat)

    def train_step(params, opt_state, batch):
        with torch.enable_grad():
            leaves = {p: x.detach().requires_grad_(True)
                      for p, x in params.items()}
            loss, _ = model.loss_fn(leaves, batch, **kw)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        with torch.no_grad():
            grads = {p: torch.zeros_like(x) if g is None else g
                     for (p, x), g in zip(leaves.items(), grads)}
            del leaves
            params, opt_state = adam_step(grads, opt_state, params, lr=lr)
        return params, opt_state, loss.detach()

    return train_step


def make_prefill_step(cfg: ArchConfig, shape: InputShape,
                      loss_kwargs: Optional[Dict] = None):
    model = get_model(cfg)
    kw = dict(loss_kwargs or {})
    kw.pop("remat", None)
    if cfg.family == "ssm":
        kw.pop("attn_impl", None)
        kw.pop("q_chunk", None)

    def prefill_step(params, batch):
        extra = {}
        if cfg.family == "vlm":
            extra["patches"] = batch["patches"]
        if cfg.family == "audio":
            extra["frames"] = batch["frames"]
        with torch.no_grad():
            return model.prefill(params, batch["tokens"],
                                 max_len=shape.seq_len, last_only=True,
                                 **extra, **kw)

    return prefill_step


def make_decode_step(cfg: ArchConfig, *, unroll: bool = False):
    """``unroll`` is accepted for the reference's signature and changes
    nothing (the port's layer loop is unrolled)."""
    if cfg.family not in _FAMILY:
        get_model(cfg)                      # raises NotPortedError
    mod = _FAMILY[cfg.family]

    def decode_step(params, cache, token):
        with torch.no_grad():
            return mod.decode_step(cfg, params, cache, token)

    return decode_step


def make_fl_round_step(cfg: ArchConfig, *, n_clients: int,
                       train_fraction: float = 0.5,
                       strategy: str = "uniform",
                       synchronized: bool = False, lr: float = 3e-4,
                       topology: str = "hub",
                       n_edges: Optional[int] = None,
                       loss_kwargs: Optional[Dict] = None,
                       device: Device = "cuda"):
    """The paper's technique on one zoo model: one federated round step
    on ``device``, with its unit assignment and FLConfig.

    ``topology`` picks the registered federation topology; hierarchical
    gets ``n_edges`` edge aggregators (default ~sqrt of the clients).
    """
    model = get_model(cfg)
    params_shape = model.init_params(_MetaGenerator(),
                                     getattr(torch, cfg.lowering_dtype))
    assign = build_units_zoo(cfg, params_shape)
    from ..core.freezing import n_train_from_fraction
    fl = FLConfig(
        n_clients=n_clients,
        n_train_units=n_train_from_fraction(assign.n_units, train_fraction),
        strategy=strategy, synchronized=synchronized, lr=lr,
        topology=topology, n_edges=n_edges)
    kw = loss_kwargs if loss_kwargs is not None else \
        default_loss_kwargs(cfg, remat=True)
    return build_round_step(model.loss_fn, assign, fl, loss_kwargs=kw,
                            device=device), assign, fl
