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
embeddings).  Weights are fp32 (the config's ``param_dtype``), random
from ``seed``.

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


def build(device: Device = "cuda", *, arch: str = ARCH, seed: int = 0,
          traffic: str = "serving", params=None,
          **serve_overrides) -> Workload:
    """``arch``'s params on ``device`` (drawn there from ``seed``, or
    ``params`` when given), prompts from a CPU generator seeded ``seed +
    1``, and the engine's ``ServeConfig`` for ``TRAFFIC[traffic]``
    (``serve_overrides`` replace its fields)."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    t = TRAFFIC[traffic]
    if params is None:
        params = get_model(cfg).init_params(
            torch.Generator(device=dev).manual_seed(seed))
    prompts = torch.randint(0, cfg.vocab, (t.n_requests, t.prompt_len),
                            generator=torch.Generator().manual_seed(seed + 1),
                            dtype=torch.int32).numpy()
    gens = [t.gen + i % t.gen_spread for i in range(t.n_requests)]
    serve = dataclasses.replace(
        ServeConfig(n_slots=t.n_slots, max_len=t.prompt_len + max(gens) + 8,
                    page_size=PAGE_SIZE, attn_impl=t.attn_impl),
        **serve_overrides)
    return Workload(cfg, params, prompts, gens, serve, dev, t)


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
