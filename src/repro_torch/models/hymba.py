"""Hymba-1.5B (arXiv:2411.13676) — hybrid parallel attention + SSM heads.

The port of ``repro.models.hymba``.  Every block runs a GQA attention
branch and a Mamba-style SSM branch **in parallel** on the same normed
input; the branch outputs are RMS-normed and averaged (the paper's head
fusion).  Most layers use sliding-window attention; every
``global_every``-th layer is global.  The SSM branch is the SSD
(Mamba-2 style) scalar-per-head data-dependent decay, run through the
plain ``linear_scan.chunked_linear_scan(decay_on="v")`` everywhere —
training, prefill and decode (one token with ``chunk=1``), as the
reference runs it: the reference has no kernel for it.  Meta-tokens and
cross-layer KV sharing are left out, as in the reference.

Params are a flat dict keyed by the reference's leaf paths
(``blocks/sub0/ssm/w_in`` of shape ``(n_macro, d, H, P)``, ...).  The
reference's ``lax.scan`` over macro blocks is a Python loop over the
stacked leaves' macro rows, each leaf split once with ``unbind``.
Attention takes ``attention.attend`` (K5/K6 on the card past 512
tokens at ``attn_impl="chunked"``) and, in the serving decode step,
``paged_decode_attention`` (K3 on the card).

Caches are flat dicts: ``{"step", "subs/sub0/k", "subs/sub0/v",
"subs/sub0/conv", "subs/sub0/ssm", ...}`` for the dense cache, and for
the serving engine ``{"pool/k", "pool/v"}`` (the shared page pool: ring
pages for the sliding-window subs once ``max_len`` passes the window,
growing pages for the global ones) plus ``{"state/sub0/conv",
"state/sub0/ssm", ...}``, the O(1) conv and SSM states as slot rows
``(n_macro, n_slots, ...)``.  The SSM state is float32 whatever the
params' dtype.  The decode steps and ``commit_prefill`` write into them
in place and return them.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..common import sorted_tree
from ..kernels.flash_decode.ops import paged_decode_attention
from . import layers as L
from . import transformer
from .attention import (attend, cache_token_update, decode_attend,
                        decode_attend_ring, paged_token_update)
from .linear_scan import chunked_linear_scan
from .transformer import (SubSpec, _cache_from_prefill, _dtype, _group,
                          _layers, block_layout, cache_alloc, n_macro,
                          paged_addresses)

Tree = Dict[str, torch.Tensor]


def ssm_dims(cfg):
    """(heads H, head width P, state N, conv width W) of the SSM branch."""
    h = cfg.n_heads
    d_inner = cfg.ssm.expand * cfg.d_model
    p = d_inner // h
    return h, p, cfg.ssm.state_dim, cfg.ssm.conv_width


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_ssm(cfg, gen: torch.Generator, dtype) -> Tree:
    h, p, n, w = ssm_dims(cfg)
    d = cfg.d_model
    dev = gen.device

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=dev) * scale) \
            .to(dtype)

    s = 1.0 / math.sqrt(d)
    out = {
        "w_in": normal((d, h, p), s),
        "conv_w": normal((h, p, w), 1.0 / math.sqrt(w)),
        "w_b": normal((h, p, n), 1.0 / math.sqrt(p)),
        "w_c": normal((h, p, n), 1.0 / math.sqrt(p)),
        "w_dt": normal((h, p), 1.0 / math.sqrt(p)),
    }
    out.update({
        "dt_bias": torch.full((h,), -2.0, dtype=dtype, device=dev),
        "a_log": torch.zeros((h,), dtype=dtype, device=dev),  # A = -exp
        "d_skip": torch.full((h, p), 0.1, dtype=dtype, device=dev),
        "w_out": normal((h, p, d), 1.0 / math.sqrt(h * p)),
    })
    return out


def _init_block(cfg, gen: torch.Generator, spec: SubSpec, dtype) -> Tree:
    d, dev = cfg.d_model, gen.device
    p = {f"ln1/{k}": v for k, v in L.init_norm(cfg.norm, d, dtype,
                                               dev).items()}
    p.update({f"attn/{k}": v for k, v in
              L.init_attention(gen, cfg, dtype).items()})
    p.update({f"ssm/{k}": v for k, v in _init_ssm(cfg, gen, dtype).items()})
    for name, kind in (("attn_norm", "rmsnorm"), ("ssm_norm", "rmsnorm"),
                       ("ln2", cfg.norm)):
        p.update({f"{name}/{k}": v for k, v in
                  L.init_norm(kind, d, dtype, dev).items()})
    p.update({f"mlp/{k}": v for k, v in
              L.init_mlp(gen, d, cfg.d_ff, dtype, glu=cfg.glu).items()})
    return p


def init_params(cfg, gen: torch.Generator, dtype=None) -> Tree:
    """Random params drawn from ``gen`` on the generator's device, with
    the reference's distributions and leaf paths, in JAX leaf order."""
    dtype = _dtype(cfg, dtype)
    nm = n_macro(cfg)
    dev = gen.device
    params: Tree = {"embed/table": L.init_embed(
        gen, cfg.padded_vocab, cfg.d_model, dtype)["table"]}
    for si, spec in enumerate(block_layout(cfg)):
        subs = [_init_block(cfg, gen, spec, dtype) for _ in range(nm)]
        for k in list(subs[0]):    # each macro's leaf freed once stacked
            params[f"blocks/sub{si}/{k}"] = torch.stack([s.pop(k)
                                                         for s in subs])
    for k, v in L.init_norm(cfg.norm, cfg.d_model, dtype, dev).items():
        params[f"final_norm/{k}"] = v
    if not cfg.tie_embeddings:
        params["head/w"] = L.dense_init(gen, (cfg.d_model, cfg.padded_vocab),
                                        dtype)
    return sorted_tree(params)


# ---------------------------------------------------------------------------
# the SSM branch
# ---------------------------------------------------------------------------

def _causal_conv(u, conv_w, conv_state=None):
    """Depthwise causal conv + SiLU.  u (B,S,H,P), conv_w (H,P,W).  On a
    prompt the input is zero-padded; on decode ``conv_state`` (B, W-1, H,
    P) holds the previous inputs.  Returns (out, the last W-1 inputs)."""
    w = conv_w.shape[-1]
    if conv_state is None:
        up = F.pad(u, (0, 0, 0, 0, w - 1, 0))
    else:
        up = torch.cat([conv_state.to(u.dtype), u], dim=1)
    s = u.shape[1]
    out = 0
    for i in range(w):          # the reference's sum, in its order
        out = out + up[:, i:i + s] * conv_w[None, None, :, :, i]
    return F.silu(out), up[:, -(w - 1):]


def _ssm_branch_seq(cfg, p: Tree, x, conv_state=None, ssm_state=None,
                    chunk: int = 16):
    """x (B,S,d) -> (out (B,S,d), conv state (B,W-1,H,P), SSM state
    (B,H,N,P) float32)."""
    u = torch.einsum("bsd,dhp->bshp", x, p["w_in"])
    u, new_conv = _causal_conv(u, p["conv_w"], conv_state)
    bb = torch.einsum("bshp,hpn->bshn", u, p["w_b"])
    cc = torch.einsum("bshp,hpn->bshn", u, p["w_c"])
    dt = F.softplus(torch.einsum("bshp,hp->bsh", u, p["w_dt"]) +
                    p["dt_bias"].float())
    log_decay = -torch.exp(p["a_log"].float()) * dt            # (B,S,H)
    v = u * dt[..., None].to(u.dtype)
    ld = log_decay[..., None].expand(v.shape)     # a per-head scalar over P
    y, state = chunked_linear_scan(cc, bb, v, ld, decay_on="v",
                                   state0=ssm_state, chunk=chunk)
    y = y + u * p["d_skip"][None, None]
    return torch.einsum("bshp,hpd->bsd", y, p["w_out"]), new_conv, state


def _fuse(cfg, p: Tree, x, a_out, s_out):
    """Head fusion (the branches' norms averaged) and the MLP."""
    x = x + 0.5 * (L.apply_norm(p["attn_norm"], a_out) +
                   L.apply_norm(p["ssm_norm"], s_out))
    h2 = L.apply_norm(p["ln2"], x)
    return x + L.apply_mlp(p["mlp"], h2, cfg.act)


# ---------------------------------------------------------------------------
# forward (training / prefill)
# ---------------------------------------------------------------------------

def _apply_block(cfg, p: Tree, spec: SubSpec, x, positions, rope, attn_impl,
                 q_chunk: int, chunk: int = 16):
    """One sub-layer over a sequence: returns (x, (k, v, conv state, SSM
    state))."""
    h = L.apply_norm(p["ln1"], x)
    q, k, v = L.qkv_project(p["attn"], h, cfg, positions, rope)
    o = attend(q, k, v, impl=attn_impl, causal=True, window=spec.window,
               q_chunk=q_chunk)
    s_out, conv, ssm = _ssm_branch_seq(cfg, p["ssm"], h, chunk=chunk)
    return _fuse(cfg, p, x, L.out_project(p["attn"], o), s_out), \
        (k, v, conv, ssm)


def _run(cfg, params: Tree, tokens, *, attn_impl, q_chunk: int, chunk: int,
         remat: bool = False, states=None):
    """Embed and run every macro block; ``states`` (a dict of lists) takes
    each sub's (k, v, conv, ssm) per macro block when given."""
    layout = block_layout(cfg)
    dev = tokens.device
    rope = L.rope_freqs(cfg.head_dim, cfg.rope_pct, cfg.rope_theta, dev)
    x = L.embed_tokens(_group(params, "embed"), tokens)
    b, s, _ = x.shape
    positions = torch.arange(s, device=dev).expand(b, s)
    nm = n_macro(cfg)
    subs = [_layers(params, si, nm) for si in range(len(layout))]

    def body(x, m):
        outs = []
        for si, spec in enumerate(layout):
            x, st = _apply_block(cfg, subs[si][m], spec, x, positions, rope,
                                 attn_impl, q_chunk, chunk)
            outs.append(st if states is not None else None)
        return x, outs

    for m in range(nm):
        if remat and torch.is_grad_enabled():
            x, outs = checkpoint(body, x, m, use_reentrant=False)
        else:
            x, outs = body(x, m)
        if states is not None:
            for si, st in enumerate(outs):
                states.setdefault(si, []).append(st)
        del outs
    return x


def forward(cfg, params: Tree, tokens: torch.Tensor, *,
            attn_impl="chunked", q_chunk: int = 1024, remat: bool = False,
            unroll: bool = False, **_):
    """tokens (B, S) -> (logits (B,S,V), aux 0, None).  ``remat``
    checkpoints each macro block; ``unroll`` changes nothing (the loop
    over macro blocks is always unrolled).  The serving caches come from
    ``prefill``."""
    x = _run(cfg, params, tokens, attn_impl=attn_impl, q_chunk=q_chunk,
             chunk=16, remat=remat)
    x = L.apply_norm(_group(params, "final_norm"), x)
    logits = L.logits_head(params, x, cfg.tie_embeddings)
    return logits, torch.zeros((), device=tokens.device), None


def loss_fn(cfg, params: Tree, batch, *, attn_impl="chunked",
            q_chunk: int = 1024, remat: bool = False, unroll: bool = False,
            **_):
    logits, aux, _ = forward(cfg, params, batch["tokens"],
                             attn_impl=attn_impl, q_chunk=q_chunk,
                             remat=remat, unroll=unroll)
    loss = L.softmax_xent(logits, batch["labels"], batch.get("loss_mask"))
    return loss, {"xent": loss, "aux": aux}


def _slabs(cfg, states, s: int, max_len: int) -> Tree:
    """The dense cache of a prefill from its per-sub states: KV slabs
    (rings for the windowed subs past their window), conv, SSM."""
    cache: Tree = {}
    for si, spec in enumerate(block_layout(cfg)):
        rows = [_cache_from_prefill(spec, k, v, s, max_len)
                for k, v, _, _ in states[si]]
        cache[f"subs/sub{si}/k"] = torch.stack([r["k"] for r in rows])
        cache[f"subs/sub{si}/v"] = torch.stack([r["v"] for r in rows])
        cache[f"subs/sub{si}/conv"] = torch.stack([st[2] for st in states[si]])
        cache[f"subs/sub{si}/ssm"] = torch.stack([st[3] for st in states[si]])
    return cache


def prefill(cfg, params: Tree, tokens, *, max_len: int, attn_impl="chunked",
            q_chunk: int = 1024, chunk: int = 16, last_only: bool = False,
            unroll: bool = False, **_):
    """Prompt -> (logits, dense cache) with the KV slabs, conv and SSM
    states of every layer."""
    states: Dict[int, list] = {}
    x = _run(cfg, params, tokens, attn_impl=attn_impl, q_chunk=q_chunk,
             chunk=chunk, states=states)
    if last_only:
        x = x[:, -1:]
    x = L.apply_norm(_group(params, "final_norm"), x)
    logits = L.logits_head(params, x, cfg.tie_embeddings)
    s = tokens.shape[1]
    cache = {"step": torch.tensor(s, dtype=torch.int32, device=tokens.device)}
    cache.update(_slabs(cfg, states, s, max_len))
    return logits, cache


# ---------------------------------------------------------------------------
# decode: ring/full KV per layout + O(1) conv & SSM state
# ---------------------------------------------------------------------------

def _state_shapes(cfg, rows: int):
    h, p, n, w = ssm_dims(cfg)
    nm = n_macro(cfg)
    return (nm, rows, w - 1, h, p), (nm, rows, h, n, p)


def init_cache(cfg, batch_size: int, max_len: int, dtype=None,
               device="cuda") -> Tree:
    dtype = _dtype(cfg, dtype)
    nm = n_macro(cfg)
    conv, ssm = _state_shapes(cfg, batch_size)
    cache: Tree = {"step": torch.zeros((), dtype=torch.int32, device=device)}
    for si, spec in enumerate(block_layout(cfg)):
        a = cache_alloc(cfg, spec, max_len)
        kv = (nm, batch_size, a, cfg.n_kv_heads, cfg.head_dim)
        cache[f"subs/sub{si}/k"] = torch.zeros(kv, dtype=dtype, device=device)
        cache[f"subs/sub{si}/v"] = torch.zeros(kv, dtype=dtype, device=device)
        cache[f"subs/sub{si}/conv"] = torch.zeros(conv, dtype=dtype,
                                                  device=device)
        cache[f"subs/sub{si}/ssm"] = torch.zeros(ssm, dtype=torch.float32,
                                                 device=device)
    return cache


def init_paged_cache(cfg, n_slots: int, n_pages: int, page_size: int,
                     dtype=None, device="cuda") -> Tree:
    """Hybrid paging: attention KV in the shared page pool (ring pages for
    sliding-window subs, growing pages for the global ones); the O(1)
    conv and SSM states as slot rows, one implicit constant-size page
    per slot, like rwkv6."""
    dtype = _dtype(cfg, dtype)
    paged = transformer.init_paged_cache(cfg, n_slots, n_pages, page_size,
                                         dtype, device)
    conv, ssm = _state_shapes(cfg, n_slots)
    for si in range(len(block_layout(cfg))):
        paged[f"state/sub{si}/conv"] = torch.zeros(conv, dtype=dtype,
                                                   device=device)
        paged[f"state/sub{si}/ssm"] = torch.zeros(ssm, dtype=torch.float32,
                                                  device=device)
    return paged


def commit_prefill(cfg, paged: Tree, cache: Tree, slots,
                   page_tables: Dict[str, torch.Tensor], *,
                   page_size: int) -> Tree:
    """KV slabs scatter into the admitted pages; conv / SSM states into
    the admitted slot rows; in place, returns ``paged``."""
    transformer.commit_prefill(cfg, paged, cache, slots, page_tables,
                               page_size=page_size)
    idx = torch.as_tensor(slots, dtype=torch.long,
                          device=paged["pool/k"].device)
    for si in range(len(block_layout(cfg))):
        for kind in ("conv", "ssm"):
            dst = paged[f"state/sub{si}/{kind}"]
            dst[:, idx] = cache[f"subs/sub{si}/{kind}"].to(dst.dtype)
    return paged


def _decode_block(cfg, p: Tree, x, positions, rope,
                  attn: Callable, conv: torch.Tensor, ssm: torch.Tensor):
    """One sub-layer on one token.  ``attn(q, k, v)`` writes the token's
    K/V into its cache and returns the attention output; ``conv`` and
    ``ssm`` (this sub's rows of the states) are updated in place."""
    h = L.apply_norm(p["ln1"], x)
    q, k, v = L.qkv_project(p["attn"], h, cfg, positions, rope)
    o = attn(q, k, v)
    s_out, new_conv, new_ssm = _ssm_branch_seq(
        cfg, p["ssm"], h, conv_state=conv, ssm_state=ssm, chunk=1)
    x = _fuse(cfg, p, x, L.out_project(p["attn"], o), s_out)
    conv.copy_(new_conv)
    ssm.copy_(new_ssm)
    return x


def decode_step_paged(cfg, params: Tree, paged: Tree, token, steps,
                      page_tables: Dict[str, torch.Tensor], *,
                      page_size: int):
    """Continuous-batching decode step: ``decode_step``'s arithmetic with
    paged KV addressing (``paged_decode_attention``, kernel K3 on the
    card) and per-slot step counters.  token (B,1); steps (B,) int32;
    page_tables {sub: (B, MP_sub) int32}.  Returns (logits, paged), the
    pool and states updated in place; the rows of idle slots are updated
    too and overwritten at admission, as in the reference."""
    layout = block_layout(cfg)
    rope = L.rope_freqs(cfg.head_dim, cfg.rope_pct, cfg.rope_theta,
                        token.device)
    x = L.embed_tokens(_group(params, "embed"), token)   # (B,1,d)
    positions = steps[:, None]
    addr = paged_addresses(layout, page_tables, steps, page_size)
    nm = n_macro(cfg)
    subs = [_layers(params, si, nm) for si in range(len(layout))]
    for m in range(nm):
        kp, vp = paged["pool/k"][m], paged["pool/v"][m]
        for si in range(len(layout)):
            page, off, valid = addr[si]
            table = page_tables[f"sub{si}"]

            def attn(q, k, v):
                paged_token_update(kp, k, page, off)
                paged_token_update(vp, v, page, off)
                return paged_decode_attention(q, kp, vp, table, valid)

            x = _decode_block(cfg, subs[si][m], x, positions, rope, attn,
                              paged[f"state/sub{si}/conv"][m],
                              paged[f"state/sub{si}/ssm"][m])
    x = L.apply_norm(_group(params, "final_norm"), x)
    return L.logits_head(params, x, cfg.tie_embeddings), paged


def decode_step(cfg, params: Tree, cache: Tree, token):
    """One decode step.  token (B, 1) int; cache from init_cache/prefill.
    Writes K/V at ``cache['step']`` (ring slots on the sliding-window
    subs) and the conv / SSM states, in place.  Returns (logits, cache)
    with ``step`` advanced."""
    layout = block_layout(cfg)
    rope = L.rope_freqs(cfg.head_dim, cfg.rope_pct, cfg.rope_theta,
                        token.device)
    step = cache["step"]
    x = L.embed_tokens(_group(params, "embed"), token)   # (B,1,d)
    b = x.shape[0]
    positions = step.expand(b, 1)
    nxt = (step + 1).expand(b)
    nm = n_macro(cfg)
    subs = [_layers(params, si, nm) for si in range(len(layout))]
    for m in range(nm):
        for si, spec in enumerate(layout):
            kc = cache[f"subs/sub{si}/k"][m]
            vc = cache[f"subs/sub{si}/v"][m]
            a = kc.shape[1]

            def attn(q, k, v):
                if spec.window > 0:
                    slot = step % a
                    cache_token_update(kc, k, slot)
                    cache_token_update(vc, v, slot)
                    return decode_attend_ring(q, kc, vc, nxt, window=a)
                cache_token_update(kc, k, step)
                cache_token_update(vc, v, step)
                return decode_attend(q, kc, vc, nxt)

            x = _decode_block(cfg, subs[si][m], x, positions, rope, attn,
                              cache[f"subs/sub{si}/conv"][m],
                              cache[f"subs/sub{si}/ssm"][m])
    x = L.apply_norm(_group(params, "final_norm"), x)
    logits = L.logits_head(params, x, cfg.tie_embeddings)
    return logits, {**cache, "step": step + 1}
