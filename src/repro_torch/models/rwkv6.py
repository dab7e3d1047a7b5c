"""RWKV-6 "Finch" (arXiv:2404.05892) — attention-free RNN LM.

The port of ``repro.models.rwkv6``.  Data-dependent per-channel decay
via a LoRA on the shifted input drives the WKV state recurrence.
Token-shift interpolation uses static per-projection mu vectors
(RWKV-5 style, as in the reference).

Params are a flat dict keyed by the reference's leaf paths
(``blocks/sub0/wkv/wr`` of shape ``(n_layers, d, H, hd)``, ...); the
reference's ``lax.scan`` over layers is a Python loop over per-layer
views.  Where the recurrence runs:

* ``forward`` / ``loss_fn`` (training): ``linear_scan.
  chunked_linear_scan``, differentiable, as the reference runs it;
* ``prefill`` (serving, no gradient): ``kernels.rwkv6_scan.ops.wkv``,
  kernel K7 on the card, with the reference's chunk rule;
* the decode steps: ``linear_scan.linear_scan_decode``, one token.

Decode state is O(1) in sequence length: per layer the last input of
each mix (for the shifts) plus the (H, dk, dv) WKV state.  Caches are
flat dicts: ``{"step", "subs/sub0/x_tmix", "subs/sub0/x_cmix",
"subs/sub0/wkv"}`` for the dense cache and ``{"state/sub0/..."}`` for
the serving engine's slot-major state, whose rows are the engine's
slots.  The decode steps and ``commit_prefill`` write into them in
place and return them.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from ..common import sorted_tree
from ..kernels.rwkv6_scan.ops import wkv
from . import layers as L
from .linear_scan import chunk_len, chunked_linear_scan, linear_scan_decode
from .transformer import _dtype, _group, _layer

Tree = Dict[str, torch.Tensor]
DECAY_LORA = 64
_STATE = ("x_tmix", "x_cmix", "wkv")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(cfg, gen: torch.Generator, dtype) -> Tree:
    d, h, hd, ff = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    dev = gen.device
    s = 1.0 / math.sqrt(d)

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=dev)

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=dev) * scale) \
            .to(dtype)

    p = {f"ln1/{k}": v for k, v in
         L.init_norm(cfg.norm, d, dtype, dev).items()}
    p.update({
        "wkv/mu_r": full((d,), 0.5), "wkv/mu_k": full((d,), 0.5),
        "wkv/mu_v": full((d,), 0.5), "wkv/mu_w": full((d,), 0.5),
        "wkv/mu_g": full((d,), 0.5),
        "wkv/wr": normal((d, h, hd), s), "wkv/wk": normal((d, h, hd), s),
        "wkv/wv": normal((d, h, hd), s), "wkv/wg": normal((d, h, hd), s),
        "wkv/wo": normal((h, hd, d), 1.0 / math.sqrt(h * hd)),
        # data-dependent decay: log_w = -exp(base + tanh(x w1) w2)
        "wkv/decay_base": full((h, hd), 0.0),
        "wkv/decay_w1": normal((d, DECAY_LORA), s),
        "wkv/decay_w2": normal((DECAY_LORA, h, hd),
                               1.0 / math.sqrt(DECAY_LORA)),
        "wkv/u": full((h, hd), 0.0),
        "wkv/ln_w": full((h, hd), 1.0),     # per-head groupnorm on wkv out
        "wkv/ln_b": full((h, hd), 0.0),
    })
    p.update({f"ln2/{k}": v for k, v in
              L.init_norm(cfg.norm, d, dtype, dev).items()})
    p.update({
        "cmix/mu_k": full((d,), 0.5), "cmix/mu_r": full((d,), 0.5),
        "cmix/wr": normal((d, d), s), "cmix/wk": normal((d, ff), s),
        "cmix/wv": normal((ff, d), 1.0 / math.sqrt(ff)),
    })
    return p


def init_params(cfg, gen: torch.Generator, dtype=None) -> Tree:
    """Random params drawn from ``gen`` on the generator's device, with
    the reference's distributions and leaf paths, in JAX leaf order."""
    dtype = _dtype(cfg, dtype)
    dev = gen.device
    params: Tree = {"embed/table": L.init_embed(
        gen, cfg.padded_vocab, cfg.d_model, dtype)["table"]}
    blocks = [_init_block(cfg, gen, dtype) for _ in range(cfg.n_layers)]
    for k in list(blocks[0]):      # each layer's leaf freed once stacked
        params[f"blocks/sub0/{k}"] = torch.stack([blk.pop(k)
                                                  for blk in blocks])
    for k, v in L.init_norm(cfg.norm, cfg.d_model, dtype, dev).items():
        params[f"final_norm/{k}"] = v
    if not cfg.tie_embeddings:
        params["head/w"] = L.dense_init(gen, (cfg.d_model, cfg.padded_vocab),
                                        dtype)
    return sorted_tree(params)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _head_groupnorm(p: Tree, o: torch.Tensor, eps: float = 64e-5):
    """Per-head normalisation of the WKV output over head_dim, in fp32."""
    of = o.float()
    mu = of.mean(-1, keepdim=True)
    var = ((of - mu) ** 2).mean(-1, keepdim=True)
    y = (of - mu) * torch.rsqrt(var + eps)
    return (y * p["ln_w"].float() + p["ln_b"].float()).to(o.dtype)


def _shift(x: torch.Tensor) -> torch.Tensor:
    """x (B,S,d) -> previous token per position (zeros at t=0).  The
    reference's carried ``x_last`` has no caller in either package."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _projections(p: Tree, x, prev, eq: str):
    """r, k, v, silu(g) and the log-decay (fp32) of the time mix; ``eq``
    contracts d with a ``(d, H, hd)`` weight."""
    def lerp(mu):
        return x + (prev - x) * mu
    r = torch.einsum(eq, lerp(p["mu_r"]), p["wr"])
    k = torch.einsum(eq, lerp(p["mu_k"]), p["wk"])
    v = torch.einsum(eq, lerp(p["mu_v"]), p["wv"])
    g = F.silu(torch.einsum(eq, lerp(p["mu_g"]), p["wg"]))
    lora = torch.tanh(lerp(p["mu_w"]) @ p["decay_w1"])
    lora_eq = eq.replace("d", "l")          # the LoRA rank in d's place
    log_w = -torch.exp(p["decay_base"].float() + torch.einsum(
        lora_eq, lora, p["decay_w2"]).float())
    return r, k, v, g, log_w


def _time_mix_seq(p: Tree, x, chunk: int, kernel: bool):
    """Time mix over a sequence; returns (out (B,S,d), final WKV state).
    ``kernel`` routes the scan through ``wkv`` (K7 on the card)."""
    r, k, v, g, log_w = _projections(p, x, _shift(x), "bsd,dhk->bshk")
    if kernel:
        o, state = wkv(r, k, v, log_w, p["u"],
                       chunk=chunk_len(x.shape[1], chunk))
    else:
        o, state = chunked_linear_scan(r, k, v, log_w, decay_on="k",
                                       bonus=p["u"], chunk=chunk)
    o = _head_groupnorm(p, o) * g
    return torch.einsum("bshk,hkd->bsd", o, p["wo"]), state


def _channel_mix(p: Tree, x):
    prev = _shift(x)
    xk = x + (prev - x) * p["mu_k"]
    xr = x + (prev - x) * p["mu_r"]
    kk = torch.square(torch.relu(xk @ p["wk"]))
    return torch.sigmoid(xr @ p["wr"]) * (kk @ p["wv"])


def _run_seq(cfg, params: Tree, tokens, chunk: int, kernel: bool,
             states=None):
    """Embed and run every layer; ``states`` (a dict of lists) collects
    each layer's decode state when given."""
    x = L.embed_tokens(_group(params, "embed"), tokens)
    for m in range(cfg.n_layers):
        p = _layer(params, 0, m)
        h = L.apply_norm(p["ln1"], x)
        tm, state = _time_mix_seq(p["wkv"], h, chunk, kernel)
        x = x + tm
        h2 = L.apply_norm(p["ln2"], x)
        x = x + _channel_mix(p["cmix"], h2)
        if states is not None:
            states["x_tmix"].append(h[:, -1])
            states["x_cmix"].append(h2[:, -1])
            states["wkv"].append(state)
    return x


def forward(cfg, params: Tree, tokens: torch.Tensor, *, chunk: int = 16,
            **_):
    """tokens (B, S) -> (logits (B,S,V), aux_loss 0, None).  The scan is
    the differentiable ``chunked_linear_scan``."""
    x = _run_seq(cfg, params, tokens, chunk, kernel=False)
    x = L.apply_norm(_group(params, "final_norm"), x)
    logits = L.logits_head(params, x, cfg.tie_embeddings)
    return logits, torch.zeros((), device=tokens.device), None


def loss_fn(cfg, params: Tree, batch, *, chunk: int = 16, **_):
    logits, aux, _ = forward(cfg, params, batch["tokens"], chunk=chunk)
    loss = L.softmax_xent(logits, batch["labels"], batch.get("loss_mask"))
    return loss, {"xent": loss, "aux": aux}


# ---------------------------------------------------------------------------
# O(1) decode state
# ---------------------------------------------------------------------------

def init_cache(cfg, batch_size: int, max_len: int = 0, dtype=None,
               device="cuda") -> Tree:
    dtype = _dtype(cfg, dtype)
    n, d, h, hd = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "subs/sub0/x_tmix": torch.zeros((n, batch_size, d), dtype=dtype,
                                            device=device),
            "subs/sub0/x_cmix": torch.zeros((n, batch_size, d), dtype=dtype,
                                            device=device),
            "subs/sub0/wkv": torch.zeros((n, batch_size, h, hd, hd),
                                         dtype=torch.float32, device=device)}


def prefill(cfg, params: Tree, tokens, *, max_len: int = 0, chunk: int = 16,
            last_only: bool = False, **_):
    """The serving prefill: the time-mix scan runs through ``wkv`` (K7 on
    the card) with the largest chunk <= ``chunk`` that divides the prompt
    length.  Extra keywords (``attn_impl``, ...) are ignored."""
    states = {k: [] for k in _STATE}
    x = _run_seq(cfg, params, tokens, chunk, kernel=True, states=states)
    if last_only:
        x = x[:, -1:]
    x = L.apply_norm(_group(params, "final_norm"), x)
    logits = L.logits_head(params, x, cfg.tie_embeddings)
    cache = {"step": torch.tensor(tokens.shape[1], dtype=torch.int32,
                                  device=tokens.device)}
    cache.update({f"subs/sub0/{k}": torch.stack(v) for k, v in states.items()})
    return logits, cache


def init_paged_cache(cfg, n_slots: int, n_pages: int = 0, page_size: int = 0,
                     dtype=None, device="cuda") -> Tree:
    """Serving-engine state: the RWKV decode state is constant-size per
    sequence, so its 'pages' are slot rows (one implicit page per slot,
    no page table).  Admit/evict are row writes."""
    cache = init_cache(cfg, n_slots, dtype=dtype, device=device)
    return {f"state/sub0/{k}": cache[f"subs/sub0/{k}"] for k in _STATE}


def commit_prefill(cfg, paged: Tree, cache: Tree, slots, page_tables=None, *,
                   page_size: int = 0) -> Tree:
    """Write a prefill group's states into the admitted slot rows, in
    place; returns ``paged``.  ``slots``: the group's slot ids."""
    idx = torch.as_tensor(slots, dtype=torch.long,
                          device=paged["state/sub0/wkv"].device)
    for k in _STATE:
        dst = paged[f"state/sub0/{k}"]
        dst[:, idx] = cache[f"subs/sub0/{k}"].to(dst.dtype)
    return paged


def _decode_core(cfg, params: Tree, state: Tree, prefix: str, token):
    """One token through every layer; the layers' states under
    ``prefix`` are updated in place.  Returns the final-normed x (B,d)."""
    x = L.embed_tokens(_group(params, "embed"), token)[:, 0]     # (B,d)
    x_tmix, x_cmix = state[f"{prefix}/x_tmix"], state[f"{prefix}/x_cmix"]
    wkv_state = state[f"{prefix}/wkv"]
    for m in range(cfg.n_layers):
        p = _layer(params, 0, m)
        w, cm = p["wkv"], p["cmix"]
        h = L.apply_norm(p["ln1"], x)
        r, k, v, g, log_w = _projections(w, h, x_tmix[m], "bd,dhk->bhk")
        o, new_wkv = linear_scan_decode(r, k, v, log_w, wkv_state[m],
                                        decay_on="k", bonus=w["u"])
        o = _head_groupnorm(w, o) * g
        x = x + torch.einsum("bhk,hkd->bd", o, w["wo"])
        h2 = L.apply_norm(p["ln2"], x)
        prev2 = x_cmix[m]
        xk = h2 + (prev2 - h2) * cm["mu_k"]
        xr = h2 + (prev2 - h2) * cm["mu_r"]
        kk = torch.square(torch.relu(xk @ cm["wk"]))
        x = x + torch.sigmoid(xr @ cm["wr"]) * (kk @ cm["wv"])
        x_tmix[m] = h
        x_cmix[m] = h2
        wkv_state[m] = new_wkv
    return L.apply_norm(_group(params, "final_norm"), x)


def decode_step_paged(cfg, params: Tree, paged: Tree, token, steps=None,
                      page_tables=None, *, page_size: int = 0, **_):
    """Continuous-batching decode step: the math of ``decode_step`` (the
    recurrence never reads the step counter), state slot-major, updated
    in place.  Returns (logits (B,1,V), paged)."""
    x = _decode_core(cfg, params, paged, "state/sub0", token)
    return L.logits_head(params, x[:, None], cfg.tie_embeddings), paged


def decode_step(cfg, params: Tree, cache: Tree, token):
    """One decode step.  token (B, 1) int; the cache's states are updated
    in place.  Returns (logits, cache) with ``step`` advanced."""
    x = _decode_core(cfg, params, cache, "subs/sub0", token)
    logits = L.logits_head(params, x[:, None], cfg.tie_embeddings)
    return logits, {**cache, "step": cache["step"] + 1}
