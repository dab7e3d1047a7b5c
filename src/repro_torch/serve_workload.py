"""The serving path's workload, defined once: a model at full width
under one traffic mix.

The model is ``ARCH``, qwen3-1.7b (28 layers, d_model 2,048, 16 query
heads over 8 KV heads of 128, vocab 151,936, qk-norm, rope theta 1e6,
tied embeddings), unless the caller names another, as ``rwkv6-3b`` (32
layers, d_model 2,560, 40 WKV heads of 64, d_ff 8,960, vocab 65,536,
untied head; the prefill's scan runs on kernel K7).  Weights are fp32
(the config's ``param_dtype``), random from ``seed``.  The traffic is
the same for every model: the continuous-batching ``DecodeEngine`` with
8 decode slots over 16-token pages, 16 requests of 128 prompt tokens,
request i generating ``32 + i % 16`` tokens, greedy, so two waves of
requests share the slots and finish at staggered steps.
``chip_smoke.py`` drives it and ``profile_serve.py`` profiles it.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple

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


class Workload(NamedTuple):
    cfg: ArchConfig
    params: dict
    prompts: np.ndarray          # (N_REQUESTS, PROMPT_LEN) int32
    gens: List[int]
    serve: ServeConfig
    device: torch.device


def build(device: Device = "cuda", *, arch: str = ARCH, seed: int = 0,
          **serve_overrides) -> Workload:
    """``arch``'s params on ``device`` (drawn there from ``seed``),
    prompts from a CPU generator seeded ``seed + 1``, and the engine's
    ``ServeConfig`` (``serve_overrides`` replace its fields)."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    params = get_model(cfg).init_params(
        torch.Generator(device=dev).manual_seed(seed))
    prompts = torch.randint(0, cfg.vocab, (N_REQUESTS, PROMPT_LEN),
                            generator=torch.Generator().manual_seed(seed + 1),
                            dtype=torch.int32).numpy()
    gens = [GEN + i % GEN_SPREAD for i in range(N_REQUESTS)]
    serve = dataclasses.replace(
        ServeConfig(n_slots=N_SLOTS, max_len=PROMPT_LEN + max(gens) + 8,
                    page_size=PAGE_SIZE), **serve_overrides)
    return Workload(cfg, params, prompts, gens, serve, dev)


def engine(w: Workload, n_requests: int = N_REQUESTS, gen=None,
           **serve_overrides) -> DecodeEngine:
    """A fresh engine over ``w``'s params with its first ``n_requests``
    requests submitted (``gen`` replaces every request's length)."""
    eng = DecodeEngine(w.cfg, w.params,
                       dataclasses.replace(w.serve, **serve_overrides),
                       device=w.device)
    for i in range(n_requests):
        eng.submit(w.prompts[i], w.gens[i] if gen is None else gen)
    return eng
