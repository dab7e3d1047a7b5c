"""Continuous-batching decode engine over the paged KV cache.

The port of ``repro.serve.engine``.  Three device functions run per
scheduling point, as in the reference:

* **prefill** — the model's dense prefill (``last_only=True``) plus the
  first-token sample, one batched call per admission group;
* **commit**  — the scatter of the dense prefill cache into the admitted
  sequences' pages;
* **decode**  — one ``decode_step_paged`` + sample over the engine's
  fixed slot count.  Every dynamic quantity (token, per-slot steps, page
  tables) is a fixed-shape tensor, so admitting and evicting sequences
  mid-flight never changes the decode step's input signature: the step
  is a ``CompileGuard`` with a budget of one signature (shapes, dtypes
  and devices), which ``decode_cache_size`` reads — the contract a CUDA
  graph of the step will need.  The prefill and the commit are guards
  with no budget (one signature per prompt length), and the static
  loop's prefill and decode steps one signature each.

A decode micro-run chains several steps device to device (the sampled
token feeds the next step without leaving the card) and syncs with the
host once at its end.

Sampling at temperature > 0 is ``argmax(logits / T + g)`` with ``g`` a
row of Gumbel noise for the (request, token index) — the formula of
``jax.random.categorical``.  The rows come from an injected callable
``gumbel(rids, gidx, vocab) -> (B, vocab)``: by default
:func:`gumbel_rows`, a function of ``(seed, rid, gidx)`` only, so
continuous batching reproduces the static loop's streams exactly and a
preempted request continues its stream; tests inject the reference's own
Gumbel rows to reproduce its sampled streams.  Greedy decoding
(temperature ≤ 0) is the argmax over the padded vocab.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..analysis.compileguard import CompileGuard
from ..common import Device, resolve_device
from ..models import get_model
from .paged_cache import PageAllocator, PagedTables, build_layout
from .scheduler import Request, Scheduler

GumbelFn = Callable[[np.ndarray, np.ndarray, int], torch.Tensor]


def gumbel_rows(seed: int, rids, gidx, vocab: int, *,
                device: Device = "cpu") -> torch.Tensor:
    """The port's default Gumbel noise: ``(B, vocab)`` float32 on
    ``device``, row i drawn from a generator seeded by ``(seed, rids[i],
    gidx[i])`` alone (``numpy.random.SeedSequence``).  These are not the
    reference's threefry draws."""
    tiny = torch.finfo(torch.float32).tiny
    rows = []
    for r, g in zip(np.asarray(rids).tolist(), np.asarray(gidx).tolist()):
        state = np.random.SeedSequence([seed, r, g]).generate_state(
            1, np.uint64)[0]
        gen = torch.Generator(device=device).manual_seed(int(state))
        rows.append(torch.rand((vocab,), generator=gen, device=device))
    u = torch.stack(rows).clamp_min(tiny)
    return -torch.log(-torch.log(u))


def sample_tokens(logits: torch.Tensor, gumbel: Optional[torch.Tensor], *,
                  temperature: float) -> torch.Tensor:
    """logits (B, V) -> (B,) int32.  Greedy at temperature <= 0;
    otherwise ``argmax(gumbel + logits / temperature)`` with the rows'
    Gumbel noise ``gumbel (B, V)``."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return torch.argmax(gumbel + logits / temperature, dim=-1).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    n_slots: int
    max_len: int                 # rounded up to a page multiple internally
    page_size: int = 16
    n_pages: int = 0             # 0 = auto: no oversubscription + trash page
    temperature: float = 0.0
    seed: int = 0
    eos_id: int = -1             # -1 = disabled
    attn_impl: str = "reference"
    record_logits: bool = False  # keep per-request logits rows (tests)


def _attn_kw(cfg, attn_impl: str) -> Dict[str, str]:
    """The prefill's attention keyword: none for the attention-free
    ``ssm`` family, as in the reference."""
    return {"attn_impl": attn_impl} if cfg.family != "ssm" else {}


class DecodeEngine:
    """Continuous-batching serving loop for one model.

    ``params`` must lie on ``device`` (the card unless the caller passes
    ``"cpu"``).  ``gumbel`` replaces the default sampling noise (see the
    module docstring).
    """

    def __init__(self, cfg, params, serve: ServeConfig, *,
                 device: Device = "cuda", gumbel: Optional[GumbelFn] = None):
        # torch.device("cuda") names the current card: make it explicit,
        # as the params' own devices are
        self.device = torch.empty(0, device=resolve_device(device)).device
        wrong = [p for p, x in params.items() if x.device != self.device]
        if wrong:
            raise ValueError(f"DecodeEngine: params {wrong[:3]} are not on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.serve = serve
        self.model = get_model(cfg)
        self.layout = build_layout(cfg, serve.page_size, serve.max_len)
        n_pages = serve.n_pages or (
            serve.n_slots * self.layout.pages_per_seq + 1)
        self.allocator = PageAllocator(max(n_pages, 2))
        self.tables = PagedTables(self.layout, serve.n_slots, self.allocator,
                                  self.device)
        self.scheduler = Scheduler(self.layout, self.tables, serve.n_slots)
        self.paged = self.model.init_paged_cache(
            serve.n_slots, self.allocator.n_pages, serve.page_size,
            device=self.device)
        self.gumbel = gumbel or functools.partial(
            gumbel_rows, serve.seed, device=self.device)

        self._next_rid = 0
        self.logits_rows: Dict[int, List[np.ndarray]] = {}
        self.n_decode_steps = 0
        self.n_prefill_calls = 0
        self.decode_seconds = 0.0    # host wall time of decode micro-runs
        self._prefill = CompileGuard(self._prefill_fn, name="serve_prefill",
                                     max_programs=None)
        self._commit = CompileGuard(self.model.commit_prefill,
                                    name="serve_commit", max_programs=None)
        self._decode = CompileGuard(self._decode_fn, name="serve_decode",
                                    max_programs=1)
        self._tables_cache = None
        self._tables_version = -1

    # -- public API ---------------------------------------------------------

    def submit(self, prompt, max_gen: int, eos_id: Optional[int] = None) -> int:
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=np.asarray(prompt, np.int32),
                      max_gen=max_gen,
                      eos_id=self.serve.eos_id if eos_id is None else eos_id,
                      t_submit=time.perf_counter())
        self.scheduler.submit(req)
        if self.serve.record_logits:
            self.logits_rows[rid] = []
        return rid

    @torch.no_grad()
    def run(self) -> Dict[int, np.ndarray]:
        """Drain the queue; returns {rid: generated tokens (int32 array)}."""
        sched = self.scheduler
        while sched.has_work():
            admitted = self._admit_all()
            if not sched.running_slots():
                if sched.queue and not admitted:
                    raise RuntimeError("queue stalled: nothing running and "
                                       "nothing admissible")
                continue
            self._decode_one_step()
        return {rid: np.asarray(r.generated, np.int32)
                for rid, r in sched.requests.items()}

    def stats(self) -> Dict[str, Any]:
        reqs = [r for r in self.scheduler.requests.values()
                if r.t_finish >= 0]
        lat = np.asarray([r.t_finish - r.t_submit for r in reqs]) \
            if reqs else np.zeros((0,))
        total = sum(len(r.generated) for r in reqs)
        span = (max(r.t_finish for r in reqs) -
                min(r.t_submit for r in reqs)) if reqs else 0.0
        ttft = np.asarray([r.t_first_token - r.t_submit for r in reqs])
        steps = self.n_decode_steps
        return {
            "n_requests": len(reqs),
            "total_tokens": int(total),
            "wall_s": float(span),
            "tokens_per_sec": float(total / span) if span > 0 else 0.0,
            "latency_p50_s": float(np.percentile(lat, 50)) if reqs else 0.0,
            "latency_p99_s": float(np.percentile(lat, 99)) if reqs else 0.0,
            "ttft_p50_s": float(np.percentile(ttft, 50)) if reqs else 0.0,
            "ttft_p99_s": float(np.percentile(ttft, 99)) if reqs else 0.0,
            "decode_ms_per_step": (1e3 * self.decode_seconds / steps
                                   if steps else 0.0),
            "n_preemptions": self.scheduler.n_preemptions,
            "n_decode_steps": steps,
            "n_prefill_calls": self.n_prefill_calls,
            "peak_pages": self.allocator.peak_in_use,
            "n_pages": self.allocator.n_pages,
        }

    @property
    def decode_cache_size(self) -> int:
        """Distinct input signatures the decode step has seen (must stay 1
        across admit/evict/preempt)."""
        return self._decode.cache_size

    # -- device functions ---------------------------------------------------

    def _sample(self, row, rids, gidx):
        t = self.serve.temperature
        noise = None if t <= 0 else self.gumbel(rids, gidx, row.shape[-1])
        return sample_tokens(row, noise, temperature=t)

    def _prefill_fn(self, tokens, rids, gidx):
        self.n_prefill_calls += 1
        logits, cache = self.model.prefill(
            self.params, tokens, max_len=self.layout.max_len, last_only=True,
            **_attn_kw(self.cfg, self.serve.attn_impl))
        row = logits[:, -1]
        return self._sample(row, rids, gidx), row, cache

    def _decode_fn(self, token, steps, tables, rids, gidx):
        logits, self.paged = self.model.decode_step_paged(
            self.params, self.paged, token, steps, tables,
            self.serve.page_size)
        row = logits[:, -1]
        return self._sample(row, rids, gidx), row

    # -- internals ----------------------------------------------------------

    def _admit_all(self) -> bool:
        sched, admitted = self.scheduler, False
        while True:
            group = sched.admit_group()
            if not group:
                return admitted
            admitted = True
            slots = [s for s, _ in group]
            reqs = [r for _, r in group]
            toks = torch.as_tensor(np.stack([r.prefill_tokens for r in reqs]),
                                   device=self.device)
            rids = np.asarray([r.rid for r in reqs], np.int32)
            gidx = np.asarray([len(r.generated) for r in reqs], np.int32)
            tok, row, cache = self._prefill(toks, rids, gidx)
            self.paged = self._commit(
                self.paged, cache, slots, self.tables.rows(slots),
                self.serve.page_size)
            tok_np = tok.cpu().numpy()
            row_np = row.cpu().numpy() if self.serve.record_logits else None
            now = time.perf_counter()
            for i, (slot, req) in enumerate(group):
                if req.resume_pending is not None:
                    continue   # token already sampled pre-preemption
                if req.t_first_token < 0:
                    req.t_first_token = now
                req.generated.append(int(tok_np[i]))
                if row_np is not None:
                    self.logits_rows[req.rid].append(row_np[i])
                if req.done:
                    sched.finish(slot, now)

    def _device_tables(self):
        if self._tables_version != self.tables.version:
            self._tables_cache = self.tables.device_tables()
            self._tables_version = self.tables.version
        return self._tables_cache

    def _micro_run_len(self) -> int:
        """How many decode steps can run back to back on the device before
        the host must intervene: until the earliest finish (a slot frees
        for admission) or page-boundary crossing (a slot needs a fresh
        page).  EOS must inspect every token, so it pins the run to 1."""
        sched, lay = self.scheduler, self.layout
        k = 1 << 30
        for slot in sched.running_slots():
            info = sched.slots[slot]
            req = sched.requests[info.rid]
            if req.eos_id >= 0:
                return 1
            k = min(k, req.max_gen - len(req.generated))
            for s in lay.subs:
                pos = info.step % s.alloc if s.ring else info.step
                k = min(k, lay.page_size - pos % lay.page_size)
        return max(1, k)

    def _decode_one_step(self) -> None:
        """One scheduling point: grow pages, then a multi-step decode
        micro-run — K steps chained on the device, one host sync at the
        end for the bookkeeping."""
        sched = self.scheduler
        sched.ensure_growth()
        running = sched.running_slots()
        tokens, steps, rids, gidx = sched.step_arrays()
        k = self._micro_run_len()
        tables = self._device_tables()
        t0 = time.perf_counter()
        tok_d = torch.as_tensor(tokens[:, None], device=self.device)
        steps_d = torch.as_tensor(steps, device=self.device)
        toks, rows = [], []
        for j in range(k):
            tok, row = self._decode(tok_d, steps_d + j, tables, rids,
                                    gidx + j)
            toks.append(tok)
            if self.serve.record_logits:
                rows.append(row)
            tok_d = tok[:, None]
            self.n_decode_steps += 1
        tok_np = torch.stack(toks).cpu().numpy()              # (k, n_slots)
        row_np = torch.stack(rows).cpu().numpy() if rows else None
        now = time.perf_counter()
        self.decode_seconds += now - t0
        for j in range(k):
            for slot in running:
                if sched.slots[slot] is None:                # finished early
                    continue
                req = sched.requests[sched.slots[slot].rid]
                sched.advance(slot, tok_np[j, slot])
                if row_np is not None:
                    self.logits_rows[req.rid].append(row_np[j, slot])
                if req.done:
                    sched.finish(slot, now)


# ---------------------------------------------------------------------------
# static-batch reference loop
# ---------------------------------------------------------------------------

@torch.no_grad()
def static_generate(cfg, params, prompts, gen: int, *, max_len: int,
                    temperature: float = 0.0, seed: int = 0,
                    attn_impl: str = "reference", collect_logits: bool = False,
                    rids=None, device: Device = "cuda",
                    gumbel: Optional[GumbelFn] = None, extra=None):
    """Fixed-batch prefill + decode over the dense cache: the engine's
    oracle and the launcher's ``--engine static`` path (the only one of
    the ``audio`` and ``vlm`` families).  ``extra`` holds their frontend's
    inputs, ``{"frames": ...}`` or ``{"patches": ...}``, which go to the
    prefill, moved to ``device``; a VLM's cache then counts the patches,
    so ``max_len`` must cover them.

    Every token — including the first — is sampled with the
    per-(request, token-index) noise, so streams are comparable with the
    continuous engine's when ``rids`` matches the engine's request ids
    (default: 0..B-1 in batch order).  ``params`` must lie on ``device``.

    Returns generated tokens (B, gen) int32, plus the per-step logits rows
    [(B, V)] * gen when ``collect_logits`` (float32: numpy has no bf16).
    """
    dev = resolve_device(device)
    model = get_model(cfg)
    prompts = torch.as_tensor(np.asarray(prompts), device=dev)
    b = prompts.shape[0]
    rids = np.arange(b, dtype=np.int32) if rids is None \
        else np.asarray(rids, np.int32)
    noise = gumbel or functools.partial(gumbel_rows, seed, device=dev)

    def sample(row, t):
        g = None if temperature <= 0 else noise(
            rids, np.full((b,), t, np.int32), row.shape[-1])
        return sample_tokens(row, g, temperature=temperature)

    extra = {k: torch.as_tensor(v, device=dev) for k, v in
             (extra or {}).items()}
    prefill = CompileGuard(functools.partial(
        model.prefill, max_len=max_len, last_only=True,
        **_attn_kw(cfg, attn_impl)), name="static_prefill", max_programs=1)
    decode = CompileGuard(model.decode_step, name="static_decode",
                          max_programs=1)
    logits, cache = prefill(params, prompts, **extra)
    row = logits[:, -1]
    tok = sample(row, 0)
    toks, rows = [tok], [row]
    for t in range(1, gen):
        logits, cache = decode(params, cache, tok[:, None])
        row = logits[:, -1]
        tok = sample(row, t)
        toks.append(tok)
        if collect_logits:
            rows.append(row)
    out = torch.stack(toks, dim=1).cpu().numpy().astype(np.int32)
    if collect_logits:
        return out, [r.float().cpu().numpy() for r in rows]
    return out


@torch.no_grad()
def slotted_generate(cfg, params, prompts, gens, *, n_slots: int,
                     max_len: int, device: Device = "cuda"):
    """Greedy generation batched as ``DecodeEngine`` batches it, without
    the engine's scheduler, page tables or paged cache: the engine's
    oracle at its own batch shapes, for a state-space model (``ssm``
    family, whose decode never reads a position, so rows at different
    steps share one dense cache).

    Requests are admitted first come, first served into the lowest free
    slots; those admitted at one point with one prompt length are
    prefilled as one batch and their states written into their slot rows
    of an ``n_slots``-row cache.  Every decode step then runs over all
    ``n_slots`` rows (a free row decodes token 0; rows never mix), and a
    request that has its ``gens[i]`` tokens frees its slot for the next
    admission.  On the card a row's numbers depend on the batch shapes,
    not on the other rows, so this reproduces the engine's.  No EOS, no
    preemption (the engine runs none on a slot-row state).

    Returns ``(tokens, rows)``: per request its generated tokens (int32)
    and its logits rows, one (V,) array per token.
    """
    if cfg.family != "ssm":
        raise ValueError(f"slotted_generate: {cfg.family} family: its dense "
                         f"cache keeps one position for every row")
    dev = resolve_device(device)
    model = get_model(cfg)
    prompts = [np.asarray(x, np.int32) for x in prompts]
    cache = model.init_cache(n_slots, max_len, device=dev)
    queue = list(range(len(gens)))
    slots: List[Optional[int]] = [None] * n_slots
    toks = [[] for _ in gens]
    rows = [[] for _ in gens]

    def take(i, tok, row):
        toks[i].append(int(tok))
        rows[i].append(row)
        return len(toks[i]) >= gens[i]

    while queue or any(r is not None for r in slots):
        while queue and None in slots:           # admission, as admit_group
            plen = len(prompts[queue[0]])
            group = []
            while queue and None in slots and len(prompts[queue[0]]) == plen:
                slot = slots.index(None)
                slots[slot] = queue.pop(0)
                group.append(slot)
            req = [slots[s] for s in group]
            logits, pre = model.prefill(
                params, torch.as_tensor(np.stack([prompts[i] for i in req]),
                                        device=dev),
                max_len=max_len, last_only=True, **_attn_kw(cfg, "reference"))
            idx = torch.as_tensor(group, dtype=torch.long, device=dev)
            for key, x in cache.items():
                if key != "step":
                    x[:, idx] = pre[key].to(x.dtype)
            row = logits[:, -1]
            tok = sample_tokens(row, None, temperature=0.0).cpu().numpy()
            row = row.cpu().numpy()
            for j, s in enumerate(group):
                if take(slots[s], tok[j], row[j]):
                    slots[s] = None
        if not any(r is not None for r in slots):
            continue
        last = np.zeros((n_slots, 1), np.int32)
        for s, i in enumerate(slots):
            if i is not None:
                last[s, 0] = toks[i][-1]
        logits, cache = model.decode_step(params, cache,
                                          torch.as_tensor(last, device=dev))
        row = logits[:, -1]
        tok = sample_tokens(row, None, temperature=0.0).cpu().numpy()
        row = row.cpu().numpy()
        for s, i in enumerate(slots):
            if i is not None and take(i, tok[s], row[s]):
                slots[s] = None
    return ([np.asarray(t, np.int32) for t in toks],
            [np.stack(r) for r in rows])
