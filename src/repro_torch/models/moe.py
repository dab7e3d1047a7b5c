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
The expert-parallel dispatch over a device mesh (``apply_moe_sharded``
with a mesh) is not ported and raises ``NotPortedError``.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd.profiler import record_function

from ..core.registry import NotPortedError
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


def _count_dropped(keep: torch.Tensor) -> None:
    acc = _DROPPED.get(keep.device)
    if acc is None:
        acc = _DROPPED[keep.device] = torch.zeros(
            (), dtype=torch.int64, device=keep.device)
    acc += keep.numel() - keep.sum()


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


def apply_moe_sharded(p: Tree, x: torch.Tensor, mcfg, *, act: str = "silu",
                      mesh, capacity_factor=None):
    """``apply_moe`` when ``mesh`` is None, as the reference falls back;
    the expert-parallel dispatch over a mesh is not ported."""
    if mesh is None:
        return apply_moe(p, x, mcfg, act=act, capacity_factor=capacity_factor)
    raise NotPortedError("apply_moe_sharded: the expert-parallel dispatch "
                         "over a device mesh is not ported to repro_torch")


def moe_param_count(d: int, mcfg) -> int:
    e, ff = mcfg.num_experts, mcfg.expert_d_ff
    return d * e + 3 * e * d * ff


def moe_active_param_count(d: int, mcfg) -> int:
    """Params touched per token (for MODEL_FLOPS = 6·N_active·D)."""
    ff = mcfg.expert_d_ff
    return d * mcfg.num_experts + 3 * mcfg.top_k * d * ff
