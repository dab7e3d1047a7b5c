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

``local_update_packed`` is the packed round path's client (DESIGN.md
§7): it trains only the client's slot rows of every stacked leaf and
returns slot deltas; ``packed_cohort_fn`` runs it for a client-stacked
cohort as an ordered loop over clients.

``norm_hook`` (DESIGN.md §11) accumulates per-unit squared gradient
norms over the local steps — the scored selection's live telemetry —
from the masked gradients (prox term included) the step already has.
With ``norm_hook=None`` nothing of it runs.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..common import flatten_with_paths, tree_stack
from ..optim.masked import adam_init, adam_step, sgd_init, sgd_step
from .masking import NormHook, UnitAssignment, apply_mask, packed_norm_hook

Tree = Dict[str, torch.Tensor]


def local_update(loss_fn: Callable, global_params: Tree,
                 mask: Optional[Tree], batches: Dict[str, torch.Tensor], *,
                 lr: float = 1e-2, optimizer: str = "adam",
                 prox_mu: float = 0.0, loss_kwargs: Optional[Dict] = None,
                 norm_hook: Optional[NormHook] = None
                 ) -> Tuple[Tree, Dict[str, torch.Tensor]]:
    """One client's round.  ``batches`` leaves have a leading (steps,) dim.

    ``mask`` is a tree of 0/1 masks (``core.masking.mask_tree``), or
    None for unmasked (dense) training.  Returns ``(delta, metrics)``
    where delta = trained - global (exact zeros on frozen units).  With
    ``norm_hook``, metrics also carries ``unit_sqnorm``: (U,) float32
    per-unit squared gradient norms summed over the local steps, on the
    params' device (frozen units: exact zeros).
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
    nacc = _norm_acc(norm_hook, global_params)
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
            # the step's views of the pre-step params go, so that the
            # optimizer step (which writes into ``trained``) releases them
            # leaf by leaf
            del leaves, params
            if dmask is not None:
                grads = apply_mask(dmask, grads)
            if norm_hook is not None and grads:
                nacc = nacc + norm_hook.fn(grads)
            trained, opt_state = opt_step(grads, opt_state, trained, lr=lr,
                                          mask=dmask)
            del grads
        losses.append(loss.detach())
    del opt_state
    with torch.no_grad():
        delta = {p: trained[p] - x if p in trained else torch.zeros_like(x)
                 for p, x in flatten_with_paths(global_params)}
    metrics = {"loss_mean": torch.stack(losses).mean()}
    if norm_hook is not None:
        metrics["unit_sqnorm"] = nacc
    return delta, metrics


def _norm_acc(norm_hook: Optional[NormHook], global_params: Tree):
    """The zero (U,) telemetry accumulator on the params' device."""
    if norm_hook is None:
        return None
    dev = next(iter(global_params.values())).device
    return torch.zeros((norm_hook.n_units,), dtype=torch.float32,
                       device=dev)


def packed_cohort_fn(loss_fn: Callable, assign: UnitAssignment, fl,
                     loss_kwargs: Optional[Dict] = None, *,
                     scoring: bool = False) -> Callable:
    """The packed local-training stage of the round step.

    Returns ``cohort(global_params, rows, valid, batches) -> (pdeltas,
    metrics)``: ``rows``/``valid`` are client-stacked slot plans
    (leading client axis), and the clients train one after another in
    their stacked order, as the dense round's loop does.  ``pdeltas``
    and ``metrics["loss_mean"]`` carry a leading client axis, and with
    ``scoring`` ``metrics["unit_sqnorm"]`` is the (C, U) telemetry of
    each client's packed norm hook.
    """
    cache: dict = {}

    def cohort(global_params, rows, valid, batches):
        deltas, losses, norms = [], [], []
        for c in range(next(iter(batches.values())).shape[0]):
            rows_c = {p: r[c] for p, r in rows.items()}
            d, m = local_update_packed(
                loss_fn, global_params, assign, rows_c,
                {p: v[c] for p, v in valid.items()},
                {k: v[c] for k, v in batches.items()}, lr=fl.lr,
                optimizer=fl.optimizer, prox_mu=fl.prox_mu,
                loss_kwargs=loss_kwargs,
                norm_hook=packed_norm_hook(assign, rows_c, cache)
                if scoring else None)
            deltas.append(d)
            losses.append(m["loss_mean"])
            if scoring:
                norms.append(m["unit_sqnorm"])
        metrics = {"loss_mean": torch.stack(losses)}
        if scoring:
            metrics["unit_sqnorm"] = torch.stack(norms)
        return tree_stack(deltas), metrics

    return cohort


def local_update_packed(loss_fn: Callable, global_params: Tree,
                        assign: UnitAssignment, rows: Tree, valid: Tree,
                        batches: Dict[str, torch.Tensor], *,
                        lr: float = 1e-2, optimizer: str = "adam",
                        prox_mu: float = 0.0,
                        loss_kwargs: Optional[Dict] = None,
                        norm_hook: Optional[NormHook] = None
                        ) -> Tuple[Tree, Dict[str, torch.Tensor]]:
    """Packed variant of :func:`local_update` (DESIGN.md §7).

    ``rows``/``valid`` come from ``masking.slot_plan``: the client's
    trained macro rows of every stacked leaf, gathered into fixed-shape
    ``(L, ...)`` slot buffers.  The trained state — packed params plus
    freshly initialized optimizer moments — holds only those slots, so
    frozen stacked rows cost no optimizer memory; the loss sees the full
    model rebuilt by scattering the slots into a detached copy of the
    global leaf, so no gradient flows into frozen rows.  Scalar leaves
    are carried whole with masked grads, as on the dense path.  Leaves
    with no valid slot take no gradient at all (their delta is zeros,
    as the reference's masked step leaves them).

    Returns ``(packed_delta, metrics)``: stacked leaves carry ``(L,
    ...)`` slot deltas (exact zeros on pad slots), scalar leaves
    full-shape masked deltas.  ``norm_hook`` (a ``packed_norm_hook`` of
    this client's rows) reduces the packed gradients, as
    :func:`local_update`'s does the dense ones.
    """
    loss_kwargs = loss_kwargs or {}
    opt_init, opt_step = ((adam_init, adam_step) if optimizer == "adam"
                          else (sgd_init, sgd_step))
    paths = [p for p, _ in flatten_with_paths(global_params)]
    stacked = {p for p in paths if assign.leaf_units[p].kind == "stacked"}
    live = [p for p in paths if bool(valid[p].any())]
    dev = {p: global_params[p].device for p in paths}
    drows = {p: rows[p].to(device=dev[p], dtype=torch.long)
             for p in live if p in stacked}
    dvalid = {p: valid[p].to(dev[p]) for p in live}
    packed0 = {p: global_params[p].index_select(0, drows[p])
               if p in stacked else global_params[p] for p in live}
    trained = dict(packed0)
    opt_state = opt_init(trained)
    nacc = _norm_acc(norm_hook, global_params)
    n_steps = next(iter(batches.values())).shape[0]
    losses = []
    for s in range(n_steps):
        batch = {k: v[s] for k, v in batches.items()}
        with torch.enable_grad():
            leaves = {p: trained[p].detach().requires_grad_(True)
                      for p in live}
            params = {}
            for p in paths:
                if p not in leaves:
                    params[p] = global_params[p]
                elif p in stacked:
                    params[p] = global_params[p].detach().index_copy(
                        0, drows[p], leaves[p])
                else:
                    params[p] = leaves[p]
            loss, _ = loss_fn(params, batch, **loss_kwargs)
            if prox_mu > 0.0:
                # prox over the packed representation: trained slots only
                diffs = apply_mask(dvalid, {
                    p: (leaves[p] - packed0[p]).float() for p in live})
                loss = loss + 0.5 * prox_mu * sum(
                    torch.sum(torch.square(d)) for d in diffs.values())
            grads = torch.autograd.grad(loss, [leaves[p] for p in live],
                                        allow_unused=True)
        with torch.no_grad():
            grads = {p: torch.zeros_like(leaves[p]) if g is None else g
                     for p, g in zip(live, grads)}
            del leaves, params
            grads = apply_mask(dvalid, grads)
            if norm_hook is not None and grads:
                nacc = nacc + norm_hook.fn(grads)
            trained, opt_state = opt_step(grads, opt_state, trained, lr=lr,
                                          mask=dvalid)
            del grads
        losses.append(loss.detach())
    del opt_state
    with torch.no_grad():
        delta = {}
        for p, x in flatten_with_paths(global_params):
            if p in trained:
                delta[p] = trained[p] - packed0[p]
            elif p in stacked:
                delta[p] = x.new_zeros((rows[p].shape[0],)
                                       + tuple(x.shape[1:]))
            else:
                delta[p] = torch.zeros_like(x)
    metrics = {"loss_mean": torch.stack(losses).mean()}
    if norm_hook is not None:
        metrics["unit_sqnorm"] = nacc
    return delta, metrics
