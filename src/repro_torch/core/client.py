"""ClientUpdate (paper Alg. 2): one client's masked local training.

``local_update`` runs ``local_steps`` masked optimizer steps over the
client's batch stream and returns the weight *delta* (exact zeros for
frozen units).  The optimizer is freshly initialized each round,
matching the paper's per-round client setup.

Leaves whose mask is zero everywhere are frozen for the whole round:
they take no gradient and never enter the optimizer, which is what the
reference's masked step computes for them (the param and its moments
stay bit-unchanged) without paying for their weight gradients.

FedProx (``prox_mu > 0``) pulls only the round's *trained* (unmasked)
layers toward the global model.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..common import flatten_with_paths
from ..optim.masked import adam_init, adam_step, sgd_init, sgd_step
from .masking import apply_mask

Tree = Dict[str, torch.Tensor]


def local_update(loss_fn: Callable, global_params: Tree,
                 mask: Optional[Tree], batches: Dict[str, torch.Tensor], *,
                 lr: float = 1e-2, optimizer: str = "adam",
                 prox_mu: float = 0.0, loss_kwargs: Optional[Dict] = None
                 ) -> Tuple[Tree, Dict[str, torch.Tensor]]:
    """One client's round.  ``batches`` leaves have a leading (steps,) dim.

    ``mask`` is a tree of 0/1 masks (``core.masking.mask_tree``), or
    None for unmasked (dense) training.  Returns ``(delta, metrics)``
    where delta = trained - global (exact zeros on frozen units).
    """
    loss_kwargs = loss_kwargs or {}
    opt_init, opt_step = ((adam_init, adam_step) if optimizer == "adam"
                          else (sgd_init, sgd_step))
    paths = [p for p, _ in flatten_with_paths(global_params)]
    if mask is None:
        live = paths
        dmask = None
    else:
        live = [p for p in paths if bool(mask[p].any())]
        dmask = {p: mask[p].to(global_params[p].device) for p in live}
    trained = {p: global_params[p] for p in live}
    opt_state = opt_init(trained)
    n_steps = next(iter(batches.values())).shape[0]
    losses = []
    for s in range(n_steps):
        batch = {k: v[s] for k, v in batches.items()}
        with torch.enable_grad():
            leaves = {p: trained[p].detach().requires_grad_(True)
                      for p in live}
            params = {p: leaves.get(p, global_params[p]) for p in paths}
            loss, _ = loss_fn(params, batch, **loss_kwargs)
            if prox_mu > 0.0:
                # prox pulls TRAINED layers only: mask the diffs so
                # frozen layers contribute neither loss nor gradient
                diffs = {p: (leaves[p] - global_params[p]).float()
                         for p in live}
                if dmask is not None:
                    diffs = apply_mask(dmask, diffs)
                loss = loss + 0.5 * prox_mu * sum(
                    torch.sum(torch.square(d)) for d in diffs.values())
            grads = torch.autograd.grad(loss, [leaves[p] for p in live],
                                        allow_unused=True)
        with torch.no_grad():
            # leaves the loss never reads (BN moving stats) get zeros,
            # as JAX's gradient gives them
            grads = {p: torch.zeros_like(leaves[p]) if g is None else g
                     for p, g in zip(live, grads)}
            if dmask is not None:
                grads = apply_mask(dmask, grads)
            trained, opt_state = opt_step(grads, opt_state, trained, lr=lr,
                                          mask=dmask)
        losses.append(loss.detach())
    with torch.no_grad():
        delta = {p: trained[p] - x if p in trained else torch.zeros_like(x)
                 for p, x in flatten_with_paths(global_params)}
    return delta, {"loss_mean": torch.stack(losses).mean()}
