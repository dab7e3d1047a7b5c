"""The serving path's workload, defined once: a model at full width
under one of two traffic mixes.

The model is ``ARCH``, qwen3-1.7b (28 layers, d_model 2,048, 16 query
heads over 8 KV heads of 128, vocab 151,936, qk-norm, rope theta 1e6,
tied embeddings), unless the caller names another, as ``rwkv6-3b`` (32
layers, d_model 2,560, 40 WKV heads of 64, d_ff 8,960, vocab 65,536,
untied head; the prefill's scan runs on kernel K7) or ``hymba-1.5b``
(32 layers in 4 macro blocks of 7 windowed (1,024) and 1 global
sub-layers, d_model 1,600, 25 query heads over 5 KV heads of 64 beside
25 SSM heads of 128, vocab 32,001 padded to 32,128, untied head) or
``granite-moe-1b-a400m`` (24 layers, d_model 1,024, 16 query heads over
8 KV heads of 64, every layer's MLP a MoE of 32 experts of 512 with top
8 at capacity factor 1.25, vocab 49,155 padded to 49,280, tied
embeddings).  Weights are random from ``seed``, in the dtype of the
reference's switch ``param_dtype`` (fp32 by default; the KV page pool
and rwkv6's slot rows follow it, rwkv6's WKV state stays fp32).
:func:`cast` turns a built workload into its twin in another dtype, leaf
by leaf, so that a model served in fp32 can be served again in bf16 on
the same weights without holding both copies (the bf16 draw equals the
fp32 draw cast).

The traffic (``TRAFFIC``) is the continuous-batching ``DecodeEngine``
over 16-token pages, greedy:

* ``serving`` (the default, every model): 8 decode slots, 16 requests
  of 128 prompt tokens, request i generating ``32 + i % 16`` tokens, so
  two waves of requests share the slots and finish at staggered steps;
  the prefill on the plain attention (``attn_impl="reference"``).
* ``long``: 4 slots, 4 requests of 1,536 prompt tokens generating 64
  each, the prefill on ``attn_impl="chunked"`` (kernel K5 on the card):
  past hymba's window of 1,024, so its windowed sub-layers' caches are
  rings that wrap.

On the MoE family a copy is dropped at capacity depending on the other
tokens of the same call: a prefill group of 8 x 128 tokens has 320 slots
an expert, a 4 x 1,536 one 1,920, and a decode step over 8 slots 8 (no
copy can drop: each token sends at most one copy to an expert).

``chip_smoke.py`` drives it and ``profile_serve.py`` profiles it.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .common import Device, resolve_device
from .configs.base import ArchConfig, get_config
from .models import get_model
from .serve.engine import DecodeEngine, ServeConfig

ARCH = "qwen3-1.7b"
N_SLOTS = 8
PAGE_SIZE = 16
N_REQUESTS = 16
PROMPT_LEN = 128
GEN = 32
GEN_SPREAD = 16


class Traffic(NamedTuple):
    n_slots: int
    n_requests: int
    prompt_len: int
    gen: int                     # request i generates gen + i % gen_spread
    gen_spread: int
    attn_impl: str               # the prefill's attention


TRAFFIC = {
    "serving": Traffic(N_SLOTS, N_REQUESTS, PROMPT_LEN, GEN, GEN_SPREAD,
                       "reference"),
    "long": Traffic(4, 4, 1536, 64, 1, "chunked"),
}


class Workload(NamedTuple):
    cfg: ArchConfig
    params: dict
    prompts: np.ndarray          # (n_requests, prompt_len) int32
    gens: List[int]
    serve: ServeConfig
    device: torch.device
    traffic: Traffic


def _check_dtype(cfg: ArchConfig, params: dict) -> None:
    want = getattr(torch, cfg.param_dtype)
    wrong = [p for p, x in params.items() if x.dtype != want]
    if wrong:
        raise ValueError(f"{cfg.name} with param_dtype {cfg.param_dtype}: "
                         f"params {wrong[:3]} are "
                         f"{params[wrong[0]].dtype}")


def build(device: Device = "cuda", *, arch: str = ARCH, seed: int = 0,
          traffic: str = "serving", params=None,
          param_dtype: Optional[str] = None, **serve_overrides) -> Workload:
    """``arch``'s params on ``device`` in ``param_dtype`` (by default the
    config's own, fp32): drawn there from ``seed``, or ``params`` when
    given, which must all be of that dtype (``ValueError`` otherwise);
    prompts from a CPU generator seeded ``seed + 1``, and the engine's
    ``ServeConfig`` for ``TRAFFIC[traffic]`` (``serve_overrides`` replace
    its fields)."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if param_dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=param_dtype)
    t = TRAFFIC[traffic]
    if params is None:
        params = get_model(cfg).init_params(
            torch.Generator(device=dev).manual_seed(seed))
    _check_dtype(cfg, params)
    prompts = torch.randint(0, cfg.vocab, (t.n_requests, t.prompt_len),
                            generator=torch.Generator().manual_seed(seed + 1),
                            dtype=torch.int32).numpy()
    gens = [t.gen + i % t.gen_spread for i in range(t.n_requests)]
    serve = dataclasses.replace(
        ServeConfig(n_slots=t.n_slots, max_len=t.prompt_len + max(gens) + 8,
                    page_size=PAGE_SIZE, attn_impl=t.attn_impl),
        **serve_overrides)
    return Workload(cfg, params, prompts, gens, serve, dev, t)


def cast(w: Workload, param_dtype: str = "bfloat16") -> Workload:
    """``w``'s twin with its params cast to ``param_dtype`` (and the
    config's switch set to it): the same prompts, lengths and traffic.
    The leaves move out of ``w.params`` one at a time, each cast and its
    old copy freed before the next (``w.params`` is left empty), so the
    card never holds more than the old copy and one cast leaf."""
    dtype = getattr(torch, param_dtype)
    params = {}
    for p in list(w.params):
        params[p] = w.params.pop(p).to(dtype)
    return w._replace(cfg=dataclasses.replace(w.cfg, param_dtype=param_dtype),
                      params=params)


def engine(w: Workload, n_requests: Optional[int] = None, gen=None,
           **serve_overrides) -> DecodeEngine:
    """A fresh engine over ``w``'s params with its first ``n_requests``
    requests (all by default) submitted (``gen`` replaces every request's
    length)."""
    eng = DecodeEngine(w.cfg, w.params,
                       dataclasses.replace(w.serve, **serve_overrides),
                       device=w.device)
    for i in range(len(w.gens) if n_requests is None else n_requests):
        eng.submit(w.prompts[i], w.gens[i] if gen is None else gen)
    return eng
