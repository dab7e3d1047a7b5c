"""Token-choice top-k MoE with capacity-bounded dispatch.

The port of ``repro.models.moe``.  A softmax over the fp32 router logits
picks each token's ``top_k`` experts, whose weights are renormalised to
sum to one; the switch-style aux loss is ``coef · E · Σ_e f_e P_e``.
Each token copy's rank within its expert comes from a *stable* sort of
the flat expert ids (copies keep token-major order), and copies ranked
at or past the capacity ``cap`` are dropped: they contribute exactly
zero, as in the reference.  Whether a copy is dropped therefore depends
on the other tokens of the same call.

The expert buffer ``(E·C, d)`` is built by a **gather**: each slot names
its source token, or a zero row.  Its backward (``_Dispatch``) gathers
each copy's slot gradient and sums a token's ``k`` copies in a fixed
order, and the combine sums a token's copies with a reduction over a
``(T, k, d)`` view, so no step adds into a row from several threads: the
forward and the backward are bitwise repeatable on the card.  The three
expert products are batched matmuls over the experts, as the reference's
``einsum``s (no Pallas kernel computes them there either).

Every call adds its dropped copies to a counter on the device
(:func:`dropped_copies`, :func:`reset_dropped`), so no call syncs the
host; under ``remat`` the recompute counts again.  While
:func:`trace_routing` is active each call also records its routing.

``apply_moe_sharded`` is the expert-parallel dispatch over a device mesh
(a ``torch.distributed.device_mesh.DeviceMesh`` with a ``model`` axis):
every rank holds the replicated tokens and router and ``E / model`` of
the experts, runs the copies routed to its own experts
(``apply_moe_tp_local``), and the partial outputs are summed over
``model``; with ``data`` (and ``pod``) axes each data group takes its
block of the batch.  See its docstring for the backward.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd.profiler import record_function

from . import layers as L

Tree = Dict[str, torch.Tensor]

# apply_moe's profiler ranges, by the part of the dispatch each covers
RANGES = {"moe/route": "router", "moe/sort_rank": "sort and rank",
          "moe/gather_scatter": "gather and scatter",
          "moe/expert_bmm": "expert bmm"}
# dropped token copies, one counter per device (int64 on that device)
_DROPPED: Dict[torch.device, torch.Tensor] = {}
# the routing records of trace_routing(), or None
_TRACE: Optional[List[Dict[str, torch.Tensor]]] = None


def _span(name: str):
    """A profiler range named ``name`` while a profiler records (how
    ``profile_serve.py`` tells the dispatch's kernels apart), else
    nothing."""
    return record_function(name) if torch.autograd._profiler_enabled() \
        else contextlib.nullcontext()


def capacity_for(num_tokens: int, num_experts: int, top_k: int,
                 capacity_factor: float = 1.25) -> int:
    c = math.ceil(num_tokens * top_k / num_experts * capacity_factor)
    return max(4 * math.ceil(c / 4), top_k)


def init_moe(gen: torch.Generator, d: int, mcfg, dtype) -> Tree:
    """The reference's shapes and scales, drawn from ``gen`` on its
    device: router ``(d, E)`` at 0.02, ``w_gate``/``w_up`` ``(E, d, ff)``
    at ``1/sqrt(d)``, ``w_down`` ``(E, ff, d)`` at ``1/sqrt(ff)``."""
    e, ff = mcfg.num_experts, mcfg.expert_d_ff
    s = 1.0 / math.sqrt(d)
    return {
        "router": L.dense_init(gen, (d, e), dtype, scale=0.02),
        "w_gate": L.dense_init(gen, (e, d, ff), dtype, scale=s),
        "w_up": L.dense_init(gen, (e, d, ff), dtype, scale=s),
        "w_down": L.dense_init(gen, (e, ff, d), dtype,
                               scale=1.0 / math.sqrt(ff)),
    }


def _counts(keys: torch.Tensor, n_keys: int) -> torch.Tensor:
    """Occurrences of each key in ``0..n_keys-1`` (int64; integer adds, so
    the order of the device's atomics cannot change the result, and unlike
    ``torch.bincount`` it never reads the largest key back to the host)."""
    return torch.zeros(n_keys, dtype=torch.int64, device=keys.device) \
        .scatter_add_(0, keys, torch.ones_like(keys))


def _rank_within(keys: torch.Tensor, n_keys: int) -> torch.Tensor:
    """Rank of each element among the elements with its key, in order of
    position (a stable sort by key; O(n) memory).  int64."""
    n = keys.shape[0]
    order = torch.argsort(keys, stable=True)
    counts = _counts(keys, n_keys)
    start = torch.cumsum(counts, 0) - counts         # first sorted position
    rank_sorted = torch.arange(n, device=keys.device) - start[keys[order]]
    return torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)


class _Dispatch(torch.autograd.Function):
    """``xf (T, d)`` into the expert buffer: slot i holds token ``src[i]``
    (``T``: a zero row).  The backward gathers each copy's slot gradient
    (``slot``; the discard row ``E·C`` reads zero) and sums a token's
    ``k`` copies, instead of adding into token rows from many slots."""

    @staticmethod
    def forward(ctx, xf, src, slot, k):
        ctx.save_for_backward(slot)
        ctx.k = k
        return torch.cat([xf, xf.new_zeros(1, xf.shape[1])])[src]

    @staticmethod
    def backward(ctx, g):
        slot, = ctx.saved_tensors
        gz = torch.cat([g, g.new_zeros(1, g.shape[1])])
        return gz[slot].view(-1, ctx.k, g.shape[1]).sum(1), None, None, None


def _count_dropped(keep: torch.Tensor, routed=None) -> None:
    """Adds the copies ``routed`` here (all of them when None) that
    ``keep`` drops."""
    acc = _DROPPED.get(keep.device)
    if acc is None:
        acc = _DROPPED[keep.device] = torch.zeros(
            (), dtype=torch.int64, device=keep.device)
    acc += (keep.numel() if routed is None else routed.sum()) - keep.sum()


def dropped_copies() -> int:
    """Token copies dropped at capacity since the last reset, over every
    device (reads the counters: syncs)."""
    return sum(int(x) for x in _DROPPED.values())


def reset_dropped() -> None:
    _DROPPED.clear()


@contextlib.contextmanager
def trace_routing():
    """Record every ``apply_moe`` call made inside the block: yields a list
    that gains, per call, ``{"topi" (T, k) int64, "keep" (T·k,) bool,
    "gap" (T,) float32}`` on the call's device, where ``gap`` is the k-th
    router probability less the (k+1)-th (inf when k = E): how far each
    token is from choosing another expert set."""
    global _TRACE
    before, _TRACE = _TRACE, []
    try:
        yield _TRACE
    finally:
        _TRACE = before


def apply_moe(p: Tree, x: torch.Tensor, mcfg, *, act: str = "silu",
              capacity_factor=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) -> (out (B,S,d), aux_loss scalar)."""
    b, s, d = x.shape
    e, k = mcfg.num_experts, mcfg.top_k
    t = b * s
    if capacity_factor is None:
        capacity_factor = getattr(mcfg, "capacity_factor", 1.25)
    cap = capacity_for(t, e, k, capacity_factor)
    xf = x.reshape(t, d)

    with _span("moe/route"):
        logits = (xf @ p["router"]).float()                  # (T, E)
        probs = torch.softmax(logits, dim=-1)
        topw, topi = torch.topk(probs, k, dim=-1)            # (T, k)
        topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)
        flat_e = topi.reshape(-1)                            # (T*k,)
        # load-balance aux (switch-style): E * sum_e f_e * P_e
        f_e = _counts(flat_e, e).float() / (t * k)
        aux = mcfg.load_balance_coef * e * torch.sum(f_e * probs.mean(0))

    with _span("moe/sort_rank"):
        rank = _rank_within(flat_e, e)
        keep = rank < cap
        slot = torch.where(keep, flat_e * cap + rank,
                           torch.full_like(rank, e * cap))   # discard row
        tok = torch.arange(t, device=x.device).repeat_interleave(k)
        # slot -> source token (t: the zero row); the discard row's entry
        # is overwritten by every dropped copy and cut off
        src = torch.full((e * cap + 1,), t, dtype=torch.int64,
                         device=x.device).scatter_(0, slot, tok)[:e * cap]
    _count_dropped(keep)
    if _TRACE is not None:
        with torch.no_grad():
            top = torch.topk(probs, min(k + 1, e), dim=-1).values
            gap = top[:, k - 1] - top[:, k] if k < e else \
                torch.full((t,), math.inf, device=x.device)
        _TRACE.append({"topi": topi, "keep": keep, "gap": gap})

    with _span("moe/gather_scatter"):
        eb = _Dispatch.apply(xf, src, slot, k).view(e, cap, d)
    with _span("moe/expert_bmm"):
        a = L._act(act)
        h = a(torch.bmm(eb, p["w_gate"])) * torch.bmm(eb, p["w_up"])
        out_e = torch.bmm(h, p["w_down"])                    # (E, C, d)
    with _span("moe/gather_scatter"):
        flat_out = torch.cat([out_e.reshape(e * cap, d),
                              out_e.new_zeros(1, d)])
        w = topw.reshape(-1).to(x.dtype) * keep.to(x.dtype)
        y = (flat_out[slot] * w[:, None]).view(t, k, d).sum(1)
    return y.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# the expert-parallel dispatch over a device mesh
#
# Activations are replicated over the ``model`` axis, so each model rank
# already holds every token of its data group: it masks the copies routed
# to its own expert shard, runs them, and the per-token combine is one
# all-reduce over ``model`` — no token moves for the dispatch (the
# reference's TP-local schedule under shard_map).
#
# Every rank computes the same loss from the replicated output, so the
# collectives' backwards are Megatron's pairs: the output's sum over
# ``model`` passes its gradient through unchanged, and the replicated
# inputs (tokens, router) sum their gradients over ``model`` (each rank
# saw only its own experts' share).  An all-reduce whose backward
# all-reduced again would scale every gradient by the world size.
# ---------------------------------------------------------------------------

def _all_reduce(t: torch.Tensor, groups) -> torch.Tensor:
    import torch.distributed as dist
    for g in groups:
        dist.all_reduce(t, group=g)
    return t


def _gather_rows(t: torch.Tensor, groups) -> torch.Tensor:
    """Blocks of dim 0 all-gathered over ``groups`` (major to minor: the
    minor axis first, so that blocks land in row-major order)."""
    import torch.distributed as dist
    for g in reversed(groups):
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(g))]
        dist.all_gather(parts, t.contiguous(), group=g)
        t = torch.cat(parts)
    return t


class _TokenBlock(torch.autograd.Function):
    """Replicated ``x`` -> this data group's rows ``[lo, hi)``.  Backward:
    the block's gradient summed over ``model`` (each rank's experts saw
    their own copies), then gathered over the data axes."""

    @staticmethod
    def forward(ctx, x, lo, hi, model_groups, data_groups):
        ctx.groups = (model_groups, data_groups)
        return x[lo:hi].clone()

    @staticmethod
    def backward(ctx, g):
        model_groups, data_groups = ctx.groups
        g = _all_reduce(g.contiguous().clone(), model_groups)
        return _gather_rows(g, data_groups), None, None, None, None


class _Combine(torch.autograd.Function):
    """This rank's partial output -> the replicated output: summed over
    ``model``, gathered over the data axes.  Backward: this data group's
    rows of the (replicated) gradient, unchanged."""

    @staticmethod
    def forward(ctx, y, lo, hi, model_groups, data_groups):
        ctx.block = (lo, hi)
        y = _all_reduce(y.contiguous().clone(), model_groups)
        return _gather_rows(y, data_groups)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.block
        return g[lo:hi].contiguous(), None, None, None, None


class _ExpertShard(torch.autograd.Function):
    """A replicated expert leaf ``(E, ...)`` -> this rank's experts
    ``[lo, hi)``.  Backward: summed over the data axes (each data group
    routed its own tokens), gathered over ``model`` into ``(E, ...)``."""

    @staticmethod
    def forward(ctx, w, lo, hi, model_groups, data_groups):
        ctx.groups = (model_groups, data_groups)
        return w[lo:hi].clone()

    @staticmethod
    def backward(ctx, g):
        model_groups, data_groups = ctx.groups
        g = _all_reduce(g.contiguous().clone(), data_groups)
        return _gather_rows(g, model_groups), None, None, None, None


class _Replicated(torch.autograd.Function):
    """Identity; the backward sums the gradient over ``groups``."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.groups), None


class _DataMean(torch.autograd.Function):
    """The mean over ``n`` data groups (the reference's ``pmean``).  Every
    rank holds the same loss, so the backward only scales by ``1/n``."""

    @staticmethod
    def forward(ctx, v, groups, n):
        ctx.n = n
        return _all_reduce(v.contiguous().clone(), groups) / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


class _GradScale(torch.autograd.Function):
    """Identity; the backward scales by ``s``."""

    @staticmethod
    def forward(ctx, v, s):
        ctx.s = s
        return v.view_as(v)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def apply_moe_tp_local(p: Tree, x: torch.Tensor, mcfg, *, act: str = "silu",
                       capacity_factor=None, expert_base: int = 0,
                       data_mean=None, data_shards: int = 1):
    """One rank's share of the expert-parallel dispatch.  ``x (B_loc, S,
    d)`` are this data group's tokens, ``p['w_*'] (E_loc, ...)`` this
    rank's experts ``expert_base .. expert_base + E_loc - 1``, ``p['router']
    (d, E)`` the whole router.  Returns ``(y_partial (B_loc, S, d), aux)``:
    the output of the copies routed to these experts only (the caller
    sums it over ``model``) and the aux loss, whose ``f_e`` and ``p_e``
    ``data_mean`` averages over the data groups when it is given.

    ``data_shards`` is the number of data groups the batch is split
    over: the per-expert capacity is budgeted from the GLOBAL token count
    so a data shard never drops a token the unsharded ``apply_moe``
    keeps (the buffers scale with the global batch, as the reference's)."""
    b, s, d = x.shape
    e, k = mcfg.num_experts, mcfg.top_k
    e_loc = p["w_up"].shape[0]
    t = b * s
    if capacity_factor is None:
        capacity_factor = getattr(mcfg, "capacity_factor", 1.25)
    cap = capacity_for(t * data_shards, e, k, capacity_factor)
    xf = x.reshape(t, d)

    logits = (xf @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, k, dim=-1)
    topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = topi.reshape(-1)
    f_e = _counts(flat_e, e).float() / (t * k)
    p_e = probs.mean(0)
    if data_mean is not None:   # x is the local token shard: GLOBAL f_e, p_e
        f_e, p_e = data_mean(f_e), data_mean(p_e)
    aux = mcfg.load_balance_coef * e * torch.sum(f_e * p_e)

    local_e = flat_e - expert_base
    is_local = (local_e >= 0) & (local_e < e_loc)
    rank = _rank_within(torch.where(is_local, local_e,
                                    torch.full_like(local_e, e_loc)),
                        e_loc + 1)
    keep = is_local & (rank < cap)
    slot = torch.where(keep, local_e * cap + rank,
                       torch.full_like(rank, e_loc * cap))
    tok = torch.arange(t, device=x.device).repeat_interleave(k)
    src = torch.full((e_loc * cap + 1,), t, dtype=torch.int64,
                     device=x.device).scatter_(0, slot, tok)[:e_loc * cap]
    _count_dropped(keep, is_local)

    eb = _Dispatch.apply(xf, src, slot, k).view(e_loc, cap, d)
    a = L._act(act)
    h = a(torch.bmm(eb, p["w_gate"])) * torch.bmm(eb, p["w_up"])
    out_e = torch.bmm(h, p["w_down"])
    flat_out = torch.cat([out_e.reshape(e_loc * cap, d),
                          out_e.new_zeros(1, d)])
    w = topw.reshape(-1).to(x.dtype) * keep.to(x.dtype)
    y = (flat_out[slot] * w[:, None]).view(t, k, d).sum(1)
    return y.reshape(b, s, d), aux


def apply_moe_sharded(p: Tree, x: torch.Tensor, mcfg, *, act: str = "silu",
                      mesh, capacity_factor=None):
    """Expert-parallel dispatch over ``mesh``'s ``model`` axis, tokens
    over its data axes (``pod``, ``data``) when they divide the batch; the
    plain ``apply_moe`` when ``mesh`` is None, as the reference falls back.

    SPMD: every rank of the mesh calls this with the same replicated
    ``p`` and ``x`` and gets the same replicated ``(y, aux)``; rank
    ``(.., m)`` computes experts ``m·E/model ..`` on its data group's
    rows.  Gradients reach ``p`` and ``x`` whole and replicated, equal to
    ``apply_moe``'s up to the order of the float sums.  Dropped copies
    count on the rank whose expert dropped them."""
    if mesh is None:
        return apply_moe(p, x, mcfg, act=act, capacity_factor=capacity_factor)
    from ..sharding.rules import axis_sizes
    sizes = axis_sizes(mesh)
    if "model" not in sizes:
        raise ValueError(f"apply_moe_sharded: the mesh {sizes} has no "
                         f"'model' axis to shard the experts over")
    n_model, e = sizes["model"], mcfg.num_experts
    if e % n_model:
        raise ValueError(f"apply_moe_sharded: {e} experts do not divide "
                         f"over a model axis of {n_model}")
    names = list(sizes)
    coord = mesh.get_coordinate()
    at = dict(zip(names, coord))
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    n_dp = int(math.prod(sizes[a] for a in dp))
    sharded = x.shape[0] % n_dp == 0
    data_groups = [mesh.get_group(a) for a in dp] if sharded else []
    model_groups = [mesh.get_group("model")]
    d_idx = 0
    for a in dp:
        d_idx = d_idx * sizes[a] + at[a]
    b_loc = x.shape[0] // n_dp if sharded else x.shape[0]
    lo, hi = (d_idx * b_loc, (d_idx + 1) * b_loc) if sharded \
        else (0, x.shape[0])
    e_loc = e // n_model
    e_lo = at["model"] * e_loc
    local = {n: _ExpertShard.apply(p[n], e_lo, e_lo + e_loc, model_groups,
                                   data_groups)
             for n in ("w_gate", "w_up", "w_down")}
    local["router"] = _Replicated.apply(p["router"],
                                        model_groups + data_groups)
    xs = _TokenBlock.apply(x, lo, hi, model_groups, data_groups)
    y, aux = apply_moe_tp_local(
        local, xs, mcfg, act=act, capacity_factor=capacity_factor,
        expert_base=e_lo,
        data_mean=(lambda v: _DataMean.apply(v, data_groups, n_dp))
        if data_groups else None,
        data_shards=n_dp if sharded else 1)
    # aux is replicated over ``model``: its share of the router's and the
    # tokens' gradient is summed there, so each rank passes 1/model of it
    return (_Combine.apply(y, lo, hi, model_groups, data_groups),
            _GradScale.apply(aux, 1.0 / n_model))


def moe_param_count(d: int, mcfg) -> int:
    e, ff = mcfg.num_experts, mcfg.expert_d_ff
    return d * e + 3 * e * d * ff


def moe_active_param_count(d: int, mcfg) -> int:
    """Params touched per token (for MODEL_FLOPS = 6·N_active·D)."""
    ff = mcfg.expert_d_ff
    return d * mcfg.num_experts + 3 * mcfg.top_k * d * ff
