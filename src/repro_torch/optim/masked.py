"""Masked optimizers.

The paper's client semantics (Alg. 2): frozen layers receive no gradient
and are never touched by the optimizer.  ``mask`` is a tree of 0/1
float masks broadcastable to the params (built by ``core.masking``); a
masked step leaves both the frozen params AND their optimizer state
bit-exact (tested).

Clients re-initialize optimizer state every round (the paper trains each
round from the fresh global model with a fresh ADAM), so ``init`` is
cheap and called per round.  The arithmetic follows the reference term
by term in float32.

A step writes its results into the ``params`` and state dicts it was
given, leaf by leaf, and returns those dicts: each old leaf is released
as soon as its new value exists, so a step holds one leaf's temporaries
beyond the model, not a second copy of params and moments (a client
training qwen3-1.7b at full width needs this to fit the card).  The
tensors themselves are never written in place.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..common import flatten_with_paths

Tree = Dict[str, torch.Tensor]


class AdamState(NamedTuple):
    mu: Tree
    nu: Tree
    count: int


def adam_init(params: Tree) -> AdamState:
    def zeros():
        return {p: torch.zeros_like(x, dtype=torch.float32)
                for p, x in flatten_with_paths(params)}

    return AdamState(mu=zeros(), nu=zeros(), count=0)


def _bmask(mask: Optional[Tree], path: str, p: torch.Tensor):
    if mask is None:
        return None
    k = mask[path].to(device=p.device, dtype=torch.float32)
    return k.reshape(tuple(k.shape) + (1,) * (p.ndim - k.ndim))


def adam_step(grads: Tree, state: AdamState, params: Tree, *,
              lr: float = 1e-2, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8, mask: Optional[Tree] = None
              ) -> Tuple[Tree, AdamState]:
    count = state.count + 1
    # bias corrections in float32, as the reference computes them
    tf = np.float32(count)
    c1 = float(np.float32(1.0) - np.float32(b1) ** tf)
    c2 = float(np.float32(1.0) - np.float32(b2) ** tf)
    p_out, mu, nu = params, state.mu, state.nu
    for path, p in flatten_with_paths(params):
        m, v = state.mu[path], state.nu[path]
        gf = grads[path].float()
        k = _bmask(mask, path, p)
        if k is not None:
            gf = gf * k
        m_new = b1 * m + (1 - b1) * gf
        v_new = b2 * v + (1 - b2) * gf * gf
        step = lr * (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
        p_new = (p.float() - step).to(p.dtype)
        if k is not None:
            # frozen entries: param and state bit-exact unchanged
            live = k > 0
            m_new = torch.where(live, m_new, m)
            v_new = torch.where(live, v_new, v)
            p_new = torch.where(live, p_new, p)
        p_out[path], mu[path], nu[path] = p_new, m_new, v_new
    return p_out, AdamState(mu=mu, nu=nu, count=count)


class SGDState(NamedTuple):
    momentum: Tree
    count: int


def sgd_init(params: Tree) -> SGDState:
    return SGDState(momentum={p: torch.zeros_like(x, dtype=torch.float32)
                              for p, x in flatten_with_paths(params)},
                    count=0)


def sgd_step(grads: Tree, state: SGDState, params: Tree, *,
             lr: float = 1e-2, momentum: float = 0.0,
             mask: Optional[Tree] = None) -> Tuple[Tree, SGDState]:
    p_out, mom = params, state.momentum
    for path, p in flatten_with_paths(params):
        m = state.momentum[path]
        gf = grads[path].float()
        k = _bmask(mask, path, p)
        if k is not None:
            gf = gf * k
        m_new = momentum * m + gf
        p_new = (p.float() - lr * m_new).to(p.dtype)
        if k is not None:
            live = k > 0
            m_new = torch.where(live, m_new, m)
            p_new = torch.where(live, p_new, p)
        p_out[path], mom[path] = p_new, m_new
    return p_out, SGDState(momentum=mom, count=state.count + 1)
