"""Models of the port: the paper's own (VGG16, the IMDB CNN-LSTM and the
CASA LSTM, ``paper_models``), the toy stacked-block MLP the round-step
tests use (``toy``), and the zoo's dense transformer family
(``transformer``, which also runs the ``moe`` family's blocks through
``moe`` and the ``vlm`` family's patch projector), RWKV-6 (``rwkv6``,
the ``ssm`` family), hymba (``hymba``, the ``hybrid`` family) and
whisper (``whisper``, the ``audio`` family), one API across families as
in ``repro.models``.

``get_model(cfg)`` dispatches on ``cfg.family``: every family of the
reference is ported, and an unknown one raises ``NotPortedError``.  The
paged serving entries are None for a family without them (whisper), as
in the reference; the ``vlm`` family has them, and the serving engine
refuses it all the same (``serve.paged_cache.build_layout``), as the
reference's does.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

from ..core.registry import NotPortedError
from . import hymba, rwkv6, transformer, whisper


class ModelApi(NamedTuple):
    init_params: Callable
    forward: Callable
    loss_fn: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable
    # paged serving contract — None for families without it
    init_paged_cache: Optional[Callable] = None
    commit_prefill: Optional[Callable] = None
    decode_step_paged: Optional[Callable] = None


_FAMILY = {"dense": transformer, "moe": transformer, "vlm": transformer,
           "ssm": rwkv6, "hybrid": hymba, "audio": whisper}


def get_model(cfg) -> ModelApi:
    if cfg.family not in _FAMILY:
        raise NotPortedError(f"{cfg.name}: the {cfg.family!r} model family is "
                             f"not ported yet (ported: {sorted(_FAMILY)})")
    mod = _FAMILY[cfg.family]
    paged = {}
    if hasattr(mod, "decode_step_paged"):
        paged = dict(
            init_paged_cache=lambda n_slots, n_pages, page_size, dtype=None,
            device="cuda": mod.init_paged_cache(
                cfg, n_slots, n_pages, page_size, dtype, device),
            commit_prefill=lambda paged_c, cache, slots, page_tables,
            page_size: mod.commit_prefill(cfg, paged_c, cache, slots,
                                          page_tables, page_size=page_size),
            decode_step_paged=lambda params, paged_c, token, steps,
            page_tables, page_size: mod.decode_step_paged(
                cfg, params, paged_c, token, steps, page_tables,
                page_size=page_size))
    return ModelApi(
        init_params=lambda gen, dtype=None: mod.init_params(cfg, gen, dtype),
        forward=lambda params, tokens, **kw: mod.forward(
            cfg, params, tokens, **kw),
        loss_fn=lambda params, batch, **kw: mod.loss_fn(
            cfg, params, batch, **kw),
        init_cache=lambda batch_size, max_len, dtype=None, device="cuda":
            mod.init_cache(cfg, batch_size, max_len, dtype, device),
        prefill=lambda params, tokens, **kw: mod.prefill(
            cfg, params, tokens, **kw),
        decode_step=lambda params, cache, token: mod.decode_step(
            cfg, params, cache, token),
        **paged,
    )
