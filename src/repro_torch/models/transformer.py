"""Decoder-only dense transformer (full and sliding-window attention).

Mirrors the dense and windowed subset of ``repro.models.transformer``:
architectures are a repeated **macro-block** (gemma3: sliding-window
layers closed by a global one; plain dense: a macro of 1) whose params
are stacked along a leading ``n_macro`` dim.  The reference's
``lax.scan`` over macro blocks is a Python loop over that dim, on
per-layer views of the stacked params and of the KV cache or page pool.

Params are a flat dict keyed by the reference's leaf paths
(``blocks/sub0/attn/wq`` of shape ``(n_macro, d, H, hd)``, ...).  KV
caches are flat dicts too: ``{"step", "subs/sub0/k", "subs/sub0/v"}``
for the dense cache and ``{"pool/k", "pool/v"}`` for the paged pool.
The decode steps write the new token's K/V into the cache or pool in
place (the reference returns new arrays) and return it.  ``forward`` and
``loss_fn`` take the reference's ``remat`` (a checkpoint per macro
block) and ``unroll``; attention at ``attn_impl="chunked"`` runs the
kernels K5/K6 on the card (``attention.attend``).

MoE blocks (``SubSpec.moe``: granite's every layer, llama4's last
sub-layer of each macro block of 2) run ``moe.apply_moe`` in place of the
dense MLP, plus the always-on shared MLP (``shared/*``) where
``moe.shared_d_ff`` is set; ``forward`` sums their aux losses over
sub-layers and macro blocks, and the decode steps run ``apply_moe`` over
all B rows, idle slots included, as the reference does.  The ``vlm``
family (internvl2-26b) projects its stub frontend's patch embeddings
(``projector/w``, ``projector/b``) and puts them before the text tokens;
its loss reads the text positions only, and its caches count the
patches.  The sharded MoE dispatch (``moe_mesh``) is not ported yet and
raises ``NotPortedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..common import sorted_tree
from ..core.registry import NotPortedError
from ..kernels.flash_decode.ops import paged_decode_attention
from . import layers as L
from . import moe as M
from .attention import (attend, cache_token_update, decode_attend,
                        decode_attend_ring, paged_token_update)

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SubSpec:
    window: int      # 0 = full causal attention
    moe: bool        # MoE MLP instead of dense MLP


def block_layout(cfg) -> Tuple[SubSpec, ...]:
    if cfg.moe is not None and cfg.moe.interleave > 1:
        macro = cfg.moe.interleave
        return tuple(SubSpec(window=cfg.sliding_window if cfg.global_every
                             else 0, moe=(i == macro - 1))
                     for i in range(macro))
    if cfg.global_every:
        macro = cfg.global_every
        # L ... L G — the last layer of each macro is global
        return tuple(SubSpec(window=0 if i == macro - 1 else cfg.sliding_window,
                             moe=cfg.moe is not None) for i in range(macro))
    if cfg.sliding_window:
        return (SubSpec(window=cfg.sliding_window, moe=cfg.moe is not None),)
    return (SubSpec(window=0, moe=cfg.moe is not None),)


def n_macro(cfg) -> int:
    macro = len(block_layout(cfg))
    if cfg.n_layers % macro:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} % macro {macro}")
    return cfg.n_layers // macro


def _dtype(cfg, dtype) -> torch.dtype:
    return dtype or getattr(torch, cfg.param_dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_sub(cfg, gen, spec: SubSpec, dtype) -> Tree:
    dev = gen.device
    p = {f"ln1/{k}": v for k, v in
         L.init_norm(cfg.norm, cfg.d_model, dtype, dev).items()}
    p.update({f"attn/{k}": v for k, v in
              L.init_attention(gen, cfg, dtype).items()})
    p.update({f"ln2/{k}": v for k, v in
              L.init_norm(cfg.norm, cfg.d_model, dtype, dev).items()})
    if spec.moe:
        p.update({f"moe/{k}": v for k, v in
                  M.init_moe(gen, cfg.d_model, cfg.moe, dtype).items()})
        if cfg.moe.shared_d_ff:
            p.update({f"shared/{k}": v for k, v in
                      L.init_mlp(gen, cfg.d_model, cfg.moe.shared_d_ff,
                                 dtype, glu=cfg.glu).items()})
    else:
        p.update({f"mlp/{k}": v for k, v in
                  L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype,
                             glu=cfg.glu).items()})
    return p


def init_params(cfg, gen: torch.Generator, dtype=None) -> Tree:
    """Random params drawn from ``gen`` on the generator's device, with
    the reference's distributions and leaf paths, in JAX leaf order."""
    dtype = _dtype(cfg, dtype)
    layout = block_layout(cfg)
    nm = n_macro(cfg)
    dev = gen.device
    params: Tree = {"embed/table": L.init_embed(
        gen, cfg.padded_vocab, cfg.d_model, dtype)["table"]}
    for si, spec in enumerate(layout):
        # each layer's draws go straight into its row of the stacked leaf,
        # so that the card holds the stack and one layer, not two stacks
        for m in range(nm):
            for k, v in _init_sub(cfg, gen, spec, dtype).items():
                path = f"blocks/sub{si}/{k}"
                if m == 0:
                    params[path] = v.new_empty((nm,) + tuple(v.shape))
                params[path][m] = v
    for k, v in L.init_norm(cfg.norm, cfg.d_model, dtype, dev).items():
        params[f"final_norm/{k}"] = v
    if not cfg.tie_embeddings:
        params["head/w"] = L.dense_init(gen, (cfg.d_model, cfg.padded_vocab),
                                        dtype)
    if cfg.n_patches:     # VLM projector: stub ViT feature width -> d_model
        params["projector/w"] = L.dense_init(
            gen, (vit_width(cfg), cfg.d_model), dtype)
        params["projector/b"] = torch.zeros((cfg.d_model,), dtype=dtype,
                                            device=dev)
    return sorted_tree(params)


def vit_width(cfg) -> int:
    """Feature width of the stub vision frontend's patch embeddings."""
    return min(1024, cfg.d_model)


def _group(params: Tree, prefix: str) -> Tree:
    """The leaves under ``prefix/``, keyed by the rest of their path."""
    n = len(prefix) + 1
    return {p[n:]: v for p, v in params.items() if p.startswith(prefix + "/")}


def _layer(params: Tree, si: int, m: int) -> Dict[str, Tree]:
    """Per-layer views of sub ``si`` in macro ``m``: {"attn": {...}, ...}."""
    prefix = f"blocks/sub{si}/"
    out: Dict[str, Tree] = {}
    for path, leaf in params.items():
        if path.startswith(prefix):
            group, name = path[len(prefix):].split("/", 1)
            out.setdefault(group, {})[name] = leaf[m]
    return out


def _layers(params: Tree, si: int, nm: int, stack: str = "blocks"):
    """Per-layer views of sub ``si`` of ``stack`` for every macro block
    (whisper's encoder is the stack ``enc_blocks``), each stacked leaf
    split once with ``unbind``: its backward stacks the layers' gradients
    in one tensor, where one ``leaf[m]`` per layer would add up ``nm``
    zero-padded full-size gradients."""
    prefix = f"{stack}/sub{si}/"
    out = [{} for _ in range(nm)]
    for path, leaf in params.items():
        if path.startswith(prefix):
            group, name = path[len(prefix):].split("/", 1)
            for m, view in enumerate(leaf.unbind(0)):
                out[m].setdefault(group, {})[name] = view
    return out


# ---------------------------------------------------------------------------
# forward (training / prefill)
# ---------------------------------------------------------------------------

def _apply_ffn(cfg, p, spec: SubSpec, h):
    """The sub-layer's MLP on the normed ``h``: (y, aux).  A MoE sub-layer
    runs ``apply_moe`` plus the shared MLP where there is one."""
    if not spec.moe:
        return L.apply_mlp(p["mlp"], h, cfg.act), None
    y, aux = M.apply_moe(p["moe"], h, cfg.moe, act=cfg.act)
    if "shared" in p:
        y = y + L.apply_mlp(p["shared"], h, cfg.act)
    return y, aux


def _apply_sub(cfg, p, spec: SubSpec, x, positions, rope, attn_impl,
               q_chunk: int):
    h = L.apply_norm(p["ln1"], x)
    q, k, v = L.qkv_project(p["attn"], h, cfg, positions, rope)
    o = attend(q, k, v, impl=attn_impl, causal=True, window=spec.window,
               q_chunk=q_chunk)
    x = x + L.out_project(p["attn"], o)
    y, aux = _apply_ffn(cfg, p, spec, L.apply_norm(p["ln2"], x))
    return x + y, aux, (k, v)


def _embed_inputs(cfg, params: Tree, tokens, patches):
    """Token embeddings, after the projected patches on a VLM: the
    product in the projector's dtype, plus the bias, cast to the
    embeddings' dtype (the reference's order)."""
    x = L.embed_tokens(_group(params, "embed"), tokens)
    if cfg.n_patches:
        if patches is None:
            raise ValueError(f"{cfg.name} requires patch embeddings")
        w, b = params["projector/w"], params["projector/b"]
        px = patches.to(w.dtype) @ w + b
        x = torch.cat([px.to(x.dtype), x], dim=1)
    return x


def forward(cfg, params: Tree, tokens: torch.Tensor, *, patches=None,
            attn_impl="chunked", q_chunk: int = 1024,
            build_cache: bool = False, cache_len: int = 0,
            remat: bool = False, last_only: bool = False,
            unroll: bool = False, moe_mesh=None):
    """tokens (B, S_text) [+ patches (B, n_patches, vit_width)] ->
    (logits (B,S,V), aux_loss, cache_or_None), S = n_patches + S_text.

    ``remat=True`` checkpoints each macro-block while autograd records
    (``torch.utils.checkpoint``, non-reentrant): its activations are
    recomputed in the backward pass, the forward's values and gradients
    unchanged bit for bit.  ``unroll`` is the reference's switch between
    a rolled and an unrolled ``lax.scan``; the port's loop over macro
    blocks is always unrolled, so it changes nothing here.
    """
    layout = block_layout(cfg)
    if moe_mesh is not None:
        raise NotPortedError("forward: moe_mesh is not ported")
    dev = tokens.device
    rope = L.rope_freqs(cfg.head_dim, cfg.rope_pct, cfg.rope_theta, dev)
    x = _embed_inputs(cfg, params, tokens, patches)
    b, s, _ = x.shape
    positions = torch.arange(s, device=dev).expand(b, s)

    nm = n_macro(cfg)
    subs = [_layers(params, si, nm) for si in range(len(layout))]

    def body(x, m):
        kvs, auxes = [], []
        for si, spec in enumerate(layout):
            x, aux, kv = _apply_sub(cfg, subs[si][m], spec, x, positions,
                                    rope, attn_impl, q_chunk)
            kvs.append(kv)
            if aux is not None:
                auxes.append(aux)
        return x, (torch.stack(auxes).sum() if auxes
                   else torch.zeros((), device=dev)), kvs

    caches: Dict[str, list] = {}
    aux_blocks = []
    for m in range(nm):
        if remat and torch.is_grad_enabled():
            x, aux, kvs = checkpoint(body, x, m, use_reentrant=False)
        else:
            x, aux, kvs = body(x, m)
        aux_blocks.append(aux)
        if build_cache:
            for si, (spec, (k, v)) in enumerate(zip(layout, kvs)):
                c = _cache_from_prefill(spec, k, v, s, cache_len)
                caches.setdefault(f"sub{si}/k", []).append(c["k"])
                caches.setdefault(f"sub{si}/v", []).append(c["v"])
        del kvs
    if last_only:
        x = x[:, -1:]
    x = L.apply_norm(_group(params, "final_norm"), x)
    logits = L.logits_head(params, x, cfg.tie_embeddings)
    cache = None
    if build_cache:
        cache = {"step": torch.tensor(s, dtype=torch.int32, device=dev)}
        cache.update({f"subs/{k}": torch.stack(v) for k, v in caches.items()})
    return logits, torch.stack(aux_blocks).sum(), cache


def loss_fn(cfg, params: Tree, batch, *, attn_impl="chunked",
            q_chunk: int = 1024, remat: bool = False, unroll: bool = False,
            moe_mesh=None):
    logits, aux, _ = forward(cfg, params, batch["tokens"],
                             patches=batch.get("patches"),
                             attn_impl=attn_impl, q_chunk=q_chunk,
                             remat=remat, unroll=unroll, moe_mesh=moe_mesh)
    if cfg.n_patches:     # the loss reads the text positions only
        logits = logits[:, cfg.n_patches:]
    loss = L.softmax_xent(logits, batch["labels"], batch.get("loss_mask"))
    return loss + aux, {"xent": loss, "aux": aux}


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------

def cache_alloc(cfg, spec: SubSpec, max_len: int) -> int:
    return min(spec.window, max_len) if spec.window > 0 else max_len


def init_cache(cfg, batch_size: int, max_len: int, dtype=None,
               device="cuda") -> Tree:
    dtype = _dtype(cfg, dtype)
    nm = n_macro(cfg)
    cache: Tree = {"step": torch.zeros((), dtype=torch.int32, device=device)}
    for si, spec in enumerate(block_layout(cfg)):
        a = cache_alloc(cfg, spec, max_len)
        shape = (nm, batch_size, a, cfg.n_kv_heads, cfg.head_dim)
        cache[f"subs/sub{si}/k"] = torch.zeros(shape, dtype=dtype,
                                               device=device)
        cache[f"subs/sub{si}/v"] = torch.zeros(shape, dtype=dtype,
                                               device=device)
    return cache


def _cache_from_prefill(spec: SubSpec, k, v, s: int, cache_len: int) -> Tree:
    """Build a cache slab from prefill K/V (B,S,Hkv,hd)."""
    a = min(spec.window, cache_len) if spec.window > 0 else cache_len
    b, _, hkv, hd = k.shape
    if spec.window > 0 and s >= a:
        # ring layout: ring[(s + j) % a] = kv[s - a + j]
        slots = (s + torch.arange(a, device=k.device)) % a
        kr = torch.zeros((b, a, hkv, hd), dtype=k.dtype, device=k.device)
        vr = torch.zeros((b, a, hkv, hd), dtype=v.dtype, device=v.device)
        kr[:, slots] = k[:, s - a:]
        vr[:, slots] = v[:, s - a:]
        return {"k": kr, "v": vr}
    pad = a - s
    if pad < 0:
        raise ValueError(f"cache_len {cache_len} < prefill len {s}")
    return {"k": torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)),
            "v": torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))}


def prefill(cfg, params: Tree, tokens, *, patches=None, max_len: int,
            attn_impl="chunked", q_chunk: int = 1024,
            last_only: bool = False, **_):
    logits, _, cache = forward(cfg, params, tokens, patches=patches,
                               attn_impl=attn_impl, q_chunk=q_chunk,
                               build_cache=True, cache_len=max_len,
                               last_only=last_only)
    return logits, cache


def init_paged_cache(cfg, n_slots: int, n_pages: int, page_size: int,
                     dtype=None, device="cuda") -> Tree:
    """Shared physical KV page pool of the serving engine: one pool of
    ``(n_macro, n_pages, page_size, Hkv, hd)`` serves every sub-layer
    stack.  Page 0 is the reserved trash page."""
    dtype = _dtype(cfg, dtype)
    shape = (n_macro(cfg), n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return {"pool/k": torch.zeros(shape, dtype=dtype, device=device),
            "pool/v": torch.zeros(shape, dtype=dtype, device=device)}


def commit_prefill(cfg, paged: Tree, cache: Tree, slots,
                   page_tables: Dict[str, torch.Tensor], *,
                   page_size: int) -> Tree:
    """Scatter a dense prefill cache into the admitted sequences' pages,
    in place; returns ``paged``.  ``page_tables[sub] (g, MP_sub)`` rows
    are the admitted slots' tables; unallocated entries (0) land in the
    trash page."""
    k_pool, v_pool = paged["pool/k"], paged["pool/v"]
    ps = page_size
    for si in range(len(block_layout(cfg))):
        pt = page_tables[f"sub{si}"].long()
        for kind, pool in (("k", k_pool), ("v", v_pool)):
            c = cache[f"subs/sub{si}/{kind}"]
            nm, g, a, hkv, hd = c.shape
            pool[:, pt] = c.reshape(nm, g, a // ps, ps, hkv, hd).to(pool.dtype)
    return paged


def paged_addresses(layout, page_tables: Dict[str, torch.Tensor], steps,
                    page_size: int):
    """Per sub: ``(page, offset, valid)`` of the decode step's new token,
    each (B,): the physical page and in-page offset its K/V go to, and
    the attended length (int32), clamped to the ring allocation on a
    sliding-window sub (ring slot = step % allocation)."""
    out = []
    for si, spec in enumerate(layout):
        a = page_tables[f"sub{si}"].shape[1] * page_size
        if spec.window > 0:
            pos = steps % a                         # ring slot per seq
            valid = torch.clamp(steps + 1, max=a)
        else:
            pos = steps
            valid = steps + 1
        page = page_tables[f"sub{si}"].gather(
            1, (pos // page_size)[:, None].long())
        out.append((page[:, 0], pos % page_size, valid.to(torch.int32)))
    return out


def decode_step_paged(cfg, params: Tree, paged: Tree, token, steps,
                      page_tables: Dict[str, torch.Tensor], *,
                      page_size: int):
    """One continuous-batching decode step over the paged pool.

    token (B,1) int; steps (B,) int32 — per-slot token counts;
    page_tables {sub: (B, MP_sub) int32}.  Returns (logits, paged), the
    pool updated in place.  Mirrors ``decode_step`` op for op except for
    the cache addressing, and its attention is
    ``paged_decode_attention`` (kernel K3 on the card).
    """
    layout = block_layout(cfg)
    rope = L.rope_freqs(cfg.head_dim, cfg.rope_pct, cfg.rope_theta,
                        token.device)
    x = L.embed_tokens(_group(params, "embed"), token)   # (B,1,d)
    positions = steps[:, None]
    addr = paged_addresses(layout, page_tables, steps, page_size)
    for m in range(n_macro(cfg)):
        kp, vp = paged["pool/k"][m], paged["pool/v"][m]
        for si in range(len(layout)):
            p = _layer(params, si, m)
            h = L.apply_norm(p["ln1"], x)
            q, k, v = L.qkv_project(p["attn"], h, cfg, positions, rope)
            page, off, valid = addr[si]
            paged_token_update(kp, k, page, off)
            paged_token_update(vp, v, page, off)
            o = paged_decode_attention(q, kp, vp, page_tables[f"sub{si}"],
                                       valid)
            x = x + L.out_project(p["attn"], o)
            x = x + _apply_ffn(cfg, p, layout[si],
                               L.apply_norm(p["ln2"], x))[0]
    x = L.apply_norm(_group(params, "final_norm"), x)
    return L.logits_head(params, x, cfg.tie_embeddings), paged


def decode_step(cfg, params: Tree, cache: Tree, token):
    """One decode step.  token (B, 1) int; cache from init_cache/prefill.

    Writes K/V at position ``cache['step']`` (in place; the step counts
    every cached position, a VLM's patches included) and attends over
    everything written so far (ring semantics for sliding-window
    layers).  Returns (logits, cache) with ``step`` advanced.
    """
    layout = block_layout(cfg)
    rope = L.rope_freqs(cfg.head_dim, cfg.rope_pct, cfg.rope_theta,
                        token.device)
    step = cache["step"]
    x = L.embed_tokens(_group(params, "embed"), token)   # (B,1,d)
    b = x.shape[0]
    positions = step.expand(b, 1)
    nxt = (step + 1).expand(b)
    for m in range(n_macro(cfg)):
        for si, spec in enumerate(layout):
            p = _layer(params, si, m)
            kc = cache[f"subs/sub{si}/k"][m]
            vc = cache[f"subs/sub{si}/v"][m]
            h = L.apply_norm(p["ln1"], x)
            q, k, v = L.qkv_project(p["attn"], h, cfg, positions, rope)
            a = kc.shape[1]
            if spec.window > 0:
                slot = step % a
                cache_token_update(kc, k, slot)
                cache_token_update(vc, v, slot)
                o = decode_attend_ring(q, kc, vc, nxt, window=a)
            else:
                cache_token_update(kc, k, step)
                cache_token_update(vc, v, step)
                o = decode_attend(q, kc, vc, nxt)
            x = x + L.out_project(p["attn"], o)
            x = x + _apply_ffn(cfg, p, spec, L.apply_norm(p["ln2"], x))[0]
    x = L.apply_norm(_group(params, "final_norm"), x)
    logits = L.logits_head(params, x, cfg.tie_embeddings)
    return logits, {**cache, "step": step + 1}
