"""Input shapes + placements for every (arch × shape).

The port of ``repro.launch.specs``.  ``batch_specs``, ``params_sds`` and
``cache_sds`` give every model input, parameter and cache as a shape and
dtype without allocating: ``TensorSpec``s for the batch, and the model's
own ``init_params`` / ``init_cache`` on the ``meta`` device for the rest
(the reference's ``jax.eval_shape``).  ``*_shardings`` resolve DTensor
placements (one per mesh dim, ``sharding.placements``) on a given mesh
for params, optimizer state, batches, KV caches and the decode token,
by the reference's rules.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..common.pytree import TensorSpec, Tree
from ..configs.base import ArchConfig
from ..models import get_model
from ..models.transformer import vit_width
from ..sharding import layout_for, params_shardings, placements
from ..sharding.rules import axis_sizes
from .shapes import InputShape

I32 = torch.int32


def _dtype(cfg: ArchConfig, dtype) -> torch.dtype:
    return dtype or getattr(torch, cfg.lowering_dtype)


def batch_specs(cfg: ArchConfig, shape: InputShape, dtype=None
                ) -> Dict[str, TensorSpec]:
    """Training/prefill batch stand-ins (tokens/labels [+frontend stubs])."""
    dtype = _dtype(cfg, dtype)
    b, s = shape.global_batch, shape.seq_len
    out: Dict[str, TensorSpec] = {}
    if cfg.family == "vlm":
        s_text = s - cfg.n_patches
        out["tokens"] = TensorSpec((b, s_text), I32)
        out["labels"] = TensorSpec((b, s_text), I32)
        out["patches"] = TensorSpec((b, cfg.n_patches, vit_width(cfg)),
                                    dtype)
    elif cfg.family == "audio":
        out["tokens"] = TensorSpec((b, s), I32)
        out["labels"] = TensorSpec((b, s), I32)
        out["frames"] = TensorSpec((b, cfg.enc_seq, cfg.d_model), dtype)
    else:
        out["tokens"] = TensorSpec((b, s), I32)
        out["labels"] = TensorSpec((b, s), I32)
    return out


def params_sds(cfg: ArchConfig, dtype=None) -> Tree:
    """The params on the ``meta`` device: shapes and dtypes only."""
    from .steps import _MetaGenerator
    return get_model(cfg).init_params(_MetaGenerator(), _dtype(cfg, dtype))


def cache_sds(cfg: ArchConfig, shape: InputShape, dtype=None) -> Tree:
    return get_model(cfg).init_cache(shape.global_batch, shape.seq_len,
                                     _dtype(cfg, dtype), device="meta")


def _dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))


def _dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return int(np.prod([sizes[a] for a in _dp_axes(mesh)]))


def batch_shardings(cfg, shape, mesh, layout: Optional[str] = None) -> Any:
    sizes = axis_sizes(mesh)
    dp = _dp_axes(mesh)
    if layout == "fsdp_only" and "model" in sizes:
        dp = dp + ("model",)      # pure-DP layout: batch over every axis
    b = shape.global_batch
    size = int(np.prod([sizes[a] for a in dp]))
    lead = dp if b % size == 0 else (dp[:-1] if b % int(
        np.prod([sizes[a] for a in dp[:-1]] or [1])) == 0 and dp[:-1]
        else None)
    return {path: placements((lead,) + (None,) * (len(leaf.shape) - 1),
                             mesh)
            for path, leaf in batch_specs(cfg, shape).items()}


def param_shardings(cfg, mesh, params, layout: Optional[str] = None):
    return params_shardings(params, layout or layout_for(cfg), mesh)


def opt_shardings(param_sh, mesh):
    """AdamState(mu, nu, count): moments follow params; count replicated."""
    from ..optim.masked import AdamState
    return AdamState(mu=param_sh, nu=param_sh, count=placements((), mesh))


def cache_shardings(cfg, shape, mesh, cache) -> Any:
    """Shard KV caches: batch over data axes, kv-heads or head dim over
    model; states: batch only."""
    dp = _dp_axes(mesh)
    dp_n = _dp_size(mesh)
    model_n = axis_sizes(mesh).get("model", 1)

    def spec(path, leaf):
        name = path.split("/")[-1]
        if leaf.ndim == 0:
            return ()
        axes: list = [None] * leaf.ndim
        if name in ("k", "v", "xk", "xv"):           # (nm, B, A, hkv, hd)
            bdim, hkv, hd = leaf.shape[1], leaf.shape[3], leaf.shape[4]
            if bdim % dp_n == 0:
                axes[1] = dp
            # model axis goes on kv-heads (matches the TP q sharding with
            # zero resharding) or head_dim; NEVER the seq dim — a
            # head-sharded q against a seq-sharded cache would gather the
            # whole cache onto every rank.
            if hkv % model_n == 0:
                axes[3] = "model"
            elif hd % model_n == 0:
                axes[4] = "model"
        else:                                        # states: shard batch only
            if leaf.ndim >= 2 and leaf.shape[1] % dp_n == 0:
                axes[1] = dp
        return tuple(axes)

    return {p: placements(spec(p, x), mesh) for p, x in cache.items()}


def token_shardings(cfg, shape, mesh):
    """(B, 1) decode token."""
    dp = _dp_axes(mesh)
    lead = dp if shape.global_batch % _dp_size(mesh) == 0 else None
    return placements((lead, None), mesh)
