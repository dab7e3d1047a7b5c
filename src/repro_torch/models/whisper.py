"""Whisper-medium (arXiv:2212.04356) — encoder-decoder transformer.

The port of ``repro.models.whisper``.  The mel-spectrogram + conv1d
frontend is stubbed, as in the reference: ``frames`` carries
precomputed frame embeddings (B, enc_seq, d_model).  Encoder: non-causal
self-attention blocks over the frames.  Decoder: causal self-attention,
cross-attention over the encoder's output, a 2-matrix GELU MLP with
biases, LayerNorm, learned absolute positions (clipped to the table's
``max_position`` rows, as the reference's ``_dec_positions``), tied
embeddings.

Params are a flat dict keyed by the reference's leaf paths
(``enc_blocks/sub0/attn/wq`` of shape ``(n_enc_layers, d, H, hd)``,
``blocks/sub0/xattn/wq``, ``embed/pos``, ``enc_embed/pos``, ...); the
reference's ``lax.scan`` over layers is a Python loop over the stacked
leaves' rows, each leaf split once with ``unbind``.  ``forward`` takes
the reference's ``remat`` (a checkpoint per decoder block; the encoder
has none there either).  Attention in training and prefill is
``attention.attend`` (past ``q_chunk // 2`` rows at
``attn_impl="chunked"``: K5/K6 on the card, the 1,500-frame encoder and
the cross-attention through the padded non-causal route).  Caches are
flat dicts ``{"step", "subs/sub0/k", "subs/sub0/v", "subs/sub0/xk",
"subs/sub0/xv"}``, each ``(n_layers, B, len, Hkv, hd)``; ``decode_step``
writes the new token's K/V into the self cache in place and returns it.
Its attention over the self cache (``step + 1`` positions) and the
cross cache (all ``enc_seq``) is K4 (``flash_decode.ops.decode_attention``,
with ``blk_k`` the cache's length so that every position is read) on
CUDA tensors and ``attention.decode_attend`` on CPU tensors.  The paged
serving engine refuses this family, as the reference's does.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..common import sorted_tree
from ..kernels.flash_decode.ops import decode_attention
from . import layers as L
from .attention import attend, cache_token_update, decode_attend
from .transformer import _dtype, _group, _layers

Tree = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _prefixed(prefix: str, p: Tree) -> Tree:
    return {f"{prefix}/{k}": v for k, v in p.items()}


def _init_block(cfg, gen: torch.Generator, dtype, cross: bool) -> Tree:
    """One encoder block (``cross=False``) or decoder block."""
    dev = gen.device
    p = _prefixed("ln1", L.init_norm(cfg.norm, cfg.d_model, dtype, dev))
    p.update(_prefixed("attn", L.init_attention(gen, cfg, dtype)))
    if cross:
        p.update(_prefixed("lnx", L.init_norm(cfg.norm, cfg.d_model, dtype,
                                              dev)))
        p.update(_prefixed("xattn", L.init_attention(gen, cfg, dtype,
                                                     cross=True)))
    p.update(_prefixed("ln2", L.init_norm(cfg.norm, cfg.d_model, dtype, dev)))
    p.update(_prefixed("mlp", L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype,
                                         glu=cfg.glu, bias=True)))
    return p


def init_params(cfg, gen: torch.Generator, dtype=None) -> Tree:
    """Random params drawn from ``gen`` on the generator's device, with
    the reference's distributions and leaf paths, in JAX leaf order (the
    head is tied)."""
    dtype = _dtype(cfg, dtype)
    dev = gen.device
    params: Tree = _prefixed("embed", L.init_embed(
        gen, cfg.padded_vocab, cfg.d_model, dtype,
        max_position=cfg.max_position))
    pos = torch.randn((cfg.enc_seq, cfg.d_model), generator=gen, device=dev)
    params["enc_embed/pos"] = (pos * 0.02).to(dtype)
    for stack, n, cross in (("enc_blocks", cfg.n_enc_layers, False),
                            ("blocks", cfg.n_layers, True)):
        blocks = [_init_block(cfg, gen, dtype, cross) for _ in range(n)]
        for k in blocks[0]:
            params[f"{stack}/sub0/{k}"] = torch.stack([b[k] for b in blocks])
    for name in ("enc_final_norm", "final_norm"):
        params.update(_prefixed(name, L.init_norm(cfg.norm, cfg.d_model,
                                                  dtype, dev)))
    return sorted_tree(params)


# ---------------------------------------------------------------------------
# encoder / decoder
# ---------------------------------------------------------------------------

def _self_qkv(p: Tree, h: torch.Tensor, cfg):
    """Fused q/k/v projections without rope (learned positions)."""
    zeros = torch.zeros(h.shape[:2], dtype=torch.int32, device=h.device)
    return L.qkv_project(p, h, cfg, zeros, (None, 0))


def _cross_q(p: Tree, h: torch.Tensor) -> torch.Tensor:
    """The cross-attention's query: the reference projects q, k and v
    from ``h`` and keeps q (no bias, norm or rope in this family)."""
    return torch.einsum("bsd,dhk->bshk", h, p["wq"])


def _cross_kv(p: Tree, enc: torch.Tensor):
    """The cross-attention's K and V from the encoder output."""
    return (torch.einsum("bsd,dhk->bshk", enc, p["wk"]),
            torch.einsum("bsd,dhk->bshk", enc, p["wv"]))


def encode(cfg, params: Tree, frames: torch.Tensor, *,
           attn_impl="chunked", q_chunk: int = 512) -> torch.Tensor:
    """frames (B, enc_seq, d) -> the encoder's output (B, enc_seq, d)."""
    x = frames + params["enc_embed/pos"][None, :frames.shape[1]]
    for p in _layers(params, 0, cfg.n_enc_layers, "enc_blocks"):
        q, k, v = _self_qkv(p["attn"], L.apply_norm(p["ln1"], x), cfg)
        o = attend(q, k, v, impl=attn_impl, causal=False, q_chunk=q_chunk)
        x = x + L.out_project(p["attn"], o)
        x = x + L.apply_mlp(p["mlp"], L.apply_norm(p["ln2"], x), cfg.act)
    return L.apply_norm(_group(params, "enc_final_norm"), x)


def _dec_positions(params: Tree, positions: torch.Tensor) -> torch.Tensor:
    table = params["embed/pos"]
    return F.embedding(torch.clamp(positions, 0, table.shape[0] - 1).long(),
                       table)


def _dec_embed(params: Tree, tokens: torch.Tensor, positions) -> torch.Tensor:
    return L.embed_tokens(_group(params, "embed"), tokens) + \
        _dec_positions(params, positions)


def _dec_block(cfg, p: Tree, x, enc, attn_impl, q_chunk: int):
    """One decoder block over the whole sequence: (x, k, v, ek, ev)."""
    q, k, v = _self_qkv(p["attn"], L.apply_norm(p["ln1"], x), cfg)
    o = attend(q, k, v, impl=attn_impl, causal=True, q_chunk=q_chunk)
    x = x + L.out_project(p["attn"], o)
    q2 = _cross_q(p["xattn"], L.apply_norm(p["lnx"], x))
    ek, ev = _cross_kv(p["xattn"], enc)
    o2 = attend(q2, ek, ev, impl=attn_impl, causal=False, q_chunk=q_chunk)
    x = x + L.out_project(p["xattn"], o2)
    x = x + L.apply_mlp(p["mlp"], L.apply_norm(p["ln2"], x), cfg.act)
    return x, k, v, ek, ev


def forward(cfg, params: Tree, tokens: torch.Tensor, *, frames,
            attn_impl="chunked", q_chunk: int = 1024, remat: bool = False,
            unroll: bool = False, **_):
    """tokens (B, S), frames (B, enc_seq, d) -> (logits (B,S,V), 0, None).

    ``remat=True`` checkpoints each decoder block while autograd records;
    ``unroll`` changes nothing (the port's layer loop is unrolled)."""
    enc = encode(cfg, params, frames, attn_impl=attn_impl)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = _dec_embed(params, tokens, positions)

    def body(x, p):
        return _dec_block(cfg, p, x, enc, attn_impl, q_chunk)[0]

    for p in _layers(params, 0, cfg.n_layers):
        if remat and torch.is_grad_enabled():
            x = checkpoint(body, x, p, use_reentrant=False)
        else:
            x = body(x, p)
    x = L.apply_norm(_group(params, "final_norm"), x)
    return (L.logits_head(params, x, tie=True),
            torch.zeros((), device=tokens.device), None)


def loss_fn(cfg, params: Tree, batch, *, attn_impl="chunked",
            q_chunk: int = 1024, remat: bool = False, unroll: bool = False,
            **_):
    logits, aux, _ = forward(cfg, params, batch["tokens"],
                             frames=batch["frames"], attn_impl=attn_impl,
                             q_chunk=q_chunk, remat=remat, unroll=unroll)
    loss = L.softmax_xent(logits, batch["labels"], batch.get("loss_mask"))
    return loss, {"xent": loss, "aux": aux}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch_size: int, max_len: int, dtype=None,
               device="cuda") -> Tree:
    dtype = _dtype(cfg, dtype)
    hkv, hd, nm = cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    cache: Tree = {"step": torch.zeros((), dtype=torch.int32, device=device)}
    for name, n in (("k", max_len), ("v", max_len), ("xk", cfg.enc_seq),
                    ("xv", cfg.enc_seq)):
        cache[f"subs/sub0/{name}"] = torch.zeros(
            (nm, batch_size, n, hkv, hd), dtype=dtype, device=device)
    return cache


def prefill(cfg, params: Tree, tokens, *, frames, max_len: int,
            attn_impl="chunked", q_chunk: int = 1024,
            last_only: bool = False, **_):
    """Encode, then run the decoder over the prompt, building the self
    caches (padded to ``max_len``) and the cross caches."""
    enc = encode(cfg, params, frames, attn_impl=attn_impl)
    b, s = tokens.shape
    if max_len < s:
        raise ValueError(f"max_len {max_len} < prefill len {s}")
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = _dec_embed(params, tokens, positions)
    kvs = {"k": [], "v": [], "xk": [], "xv": []}
    for p in _layers(params, 0, cfg.n_layers):
        x, k, v, ek, ev = _dec_block(cfg, p, x, enc, attn_impl, q_chunk)
        pad = (0, 0, 0, 0, 0, max_len - s)
        for name, t in (("k", F.pad(k, pad)), ("v", F.pad(v, pad)),
                        ("xk", ek), ("xv", ev)):
            kvs[name].append(t)
    if last_only:
        x = x[:, -1:]
    x = L.apply_norm(_group(params, "final_norm"), x)
    logits = L.logits_head(params, x, tie=True)
    cache = {"step": torch.tensor(s, dtype=torch.int32, device=tokens.device)}
    cache.update({f"subs/sub0/{n}": torch.stack(t) for n, t in kvs.items()})
    return logits, cache


def _decode_attend(q, k_cache, v_cache, valid_len):
    """One query token over a dense cache's first ``valid_len`` positions:
    K4 on CUDA tensors (``blk_k`` the cache's length, so that
    ``dense_span`` covers it), the plain ``decode_attend`` on CPU ones."""
    if q.device.type == "cuda":
        return decode_attention(q, k_cache, v_cache, valid_len,
                                blk_k=k_cache.shape[1])
    return decode_attend(q, k_cache, v_cache, valid_len)


def decode_step(cfg, params: Tree, cache: Tree, token):
    """One decode step.  token (B, 1) int; cache from init_cache/prefill.

    Writes K/V at position ``cache['step']`` (in place) and attends over
    the ``step + 1`` positions written so far and over every cross-cache
    position.  Returns (logits, cache) with ``step`` advanced."""
    step = cache["step"]
    b = token.shape[0]
    dev = token.device
    positions = step.expand(b, 1)
    x = _dec_embed(params, token, positions)
    nxt = (step + 1).expand(b)
    enc_len = torch.full((b,), cache["subs/sub0/xk"].shape[2],
                         dtype=torch.int32, device=dev)
    for m, p in enumerate(_layers(params, 0, cfg.n_layers)):
        kc, vc = cache["subs/sub0/k"][m], cache["subs/sub0/v"][m]
        q, k, v = _self_qkv(p["attn"], L.apply_norm(p["ln1"], x), cfg)
        cache_token_update(kc, k, step)
        cache_token_update(vc, v, step)
        o = _decode_attend(q, kc, vc, nxt)
        x = x + L.out_project(p["attn"], o)
        q2 = _cross_q(p["xattn"], L.apply_norm(p["lnx"], x))
        o2 = _decode_attend(q2, cache["subs/sub0/xk"][m],
                            cache["subs/sub0/xv"][m], enc_len)
        x = x + L.out_project(p["xattn"], o2)
        x = x + L.apply_mlp(p["mlp"], L.apply_norm(p["ln2"], x), cfg.act)
    x = L.apply_norm(_group(params, "final_norm"), x)
    logits = L.logits_head(params, x, tie=True)
    return logits, {**cache, "step": step + 1}
