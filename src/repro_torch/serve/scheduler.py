"""Continuous-batching scheduler: request lifecycle over decode slots.

The port's copy of ``repro.serve.scheduler``: host logic, verbatim.

Requests move WAITING → RUNNING → FINISHED.  The scheduler admits queued
requests into free decode slots mid-flight (FCFS; equal-prompt-length
runs admit as one batched prefill), evicts finished sequences (EOS /
max-gen) returning their pages to the pool, and **preempts** when the
page pool runs dry: the most recently admitted other sequence is
recompute-preempted (vLLM-style) — its pages are freed and it re-queues
at the front with its generated prefix folded into the prompt, so its
token stream continues exactly where it stopped (sampling keys are
per-(request, token-index), independent of batch composition).

All decisions are host-side numpy/list operations; the device only ever
sees fixed-shape arguments, so the engine's decode step has one input
signature.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from .paged_cache import PagedLayout, PagedTables

WAITING, RUNNING, FINISHED = "WAITING", "RUNNING", "FINISHED"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (S,) int32 — the original prompt
    max_gen: int
    eos_id: int = -1                 # -1 = disabled
    state: str = WAITING
    generated: List[int] = dataclasses.field(default_factory=list)
    # recompute-preemption: token already sampled but not yet fed back
    resume_pending: Optional[int] = None
    n_preempt: int = 0
    # metrics (engine wall clock)
    t_submit: float = 0.0
    t_first_token: float = -1.0
    t_finish: float = -1.0

    @property
    def prefill_tokens(self) -> np.ndarray:
        """What to prefill on (re-)admission: the original prompt plus any
        generated prefix whose KV must be reconstructed.  The last
        generated token (if any) is still pending — it is fed to the
        first decode step, not prefetched into the cache."""
        if not self.generated:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.generated[:-1], np.int32)])

    @property
    def done(self) -> bool:
        if len(self.generated) >= self.max_gen:
            return True
        return (self.eos_id >= 0 and len(self.generated) > 0
                and self.generated[-1] == self.eos_id)


@dataclasses.dataclass
class SlotInfo:
    rid: int
    step: int            # cache positions written so far
    admit_seq: int       # monotone admission counter (preemption order)


class Scheduler:
    """Owns the queue, the slot map, and the paged tables."""

    def __init__(self, layout: PagedLayout, tables: PagedTables,
                 n_slots: int):
        self.layout = layout
        self.tables = tables
        self.n_slots = n_slots
        self.queue: Deque[Request] = deque()
        self.requests: Dict[int, Request] = {}
        self.slots: List[Optional[SlotInfo]] = [None] * n_slots
        self.n_preemptions = 0
        self._admit_seq = 0

    # -- submission ---------------------------------------------------------

    def submit(self, req: Request) -> None:
        if len(req.prompt) + req.max_gen > self.layout.max_len:
            raise ValueError(
                f"request {req.rid}: prompt {len(req.prompt)} + max_gen "
                f"{req.max_gen} exceeds max_len {self.layout.max_len}")
        worst = self.layout.pages_per_seq
        if worst > self.tables.allocator.n_pages - 1:
            raise ValueError(
                f"page pool ({self.tables.allocator.n_pages} pages) cannot "
                f"hold one full sequence ({worst} pages + trash page)")
        self.requests[req.rid] = req
        self.queue.append(req)

    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    def running_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    # -- admission ----------------------------------------------------------

    def admit_group(self) -> List[Tuple[int, Request]]:
        """Admit the longest FCFS prefix of equal-prefill-length requests
        that fits the free slots and the page pool.  Returns
        [(slot, request)] — one batched prefill for the engine."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        group: List[Tuple[int, Request]] = []
        glen = -1
        while self.queue and free:
            req = self.queue[0]
            plen = len(req.prefill_tokens)
            if glen >= 0 and plen != glen:
                break
            slot = free[0]
            if not self.tables.admit(slot, plen):
                break                      # pool dry — decode drains first
            glen = plen
            free.pop(0)
            self.queue.popleft()
            req.state = RUNNING
            self.slots[slot] = SlotInfo(rid=req.rid, step=plen,
                                        admit_seq=self._admit_seq)
            self._admit_seq += 1
            group.append((slot, req))
        return group

    # -- growth & preemption ------------------------------------------------

    def ensure_growth(self) -> List[int]:
        """Before a decode step: make sure every running slot has a page
        for its next write position, preempting the most recently
        admitted *other* slot when the pool runs dry.  Returns the slots
        preempted this round."""
        preempted: List[int] = []
        for slot in sorted(self.running_slots(),
                           key=lambda i: self.slots[i].admit_seq):
            info = self.slots[slot]
            if info is None:             # preempted later in this loop
                continue
            while not self.tables.grow(slot, info.step):
                victim = self._pick_victim(exclude=slot)
                if victim is None:
                    raise RuntimeError(
                        f"page pool too small: slot {slot} cannot grow and "
                        f"no other sequence is preemptible")
                self.preempt(victim)
                preempted.append(victim)
        return preempted

    def _pick_victim(self, exclude: int) -> Optional[int]:
        running = [i for i in self.running_slots() if i != exclude]
        if not running:
            return None
        return max(running, key=lambda i: self.slots[i].admit_seq)

    def preempt(self, slot: int) -> None:
        info = self.slots[slot]
        req = self.requests[info.rid]
        self.tables.release(slot)
        self.slots[slot] = None
        req.state = WAITING
        req.n_preempt += 1
        self.n_preemptions += 1
        if req.generated:
            req.resume_pending = req.generated[-1]
        self.queue.appendleft(req)       # FCFS with progress preserved

    # -- eviction -----------------------------------------------------------

    def finish(self, slot: int, t_now: float) -> Request:
        info = self.slots[slot]
        req = self.requests[info.rid]
        self.tables.release(slot)
        self.slots[slot] = None
        req.state = FINISHED
        req.t_finish = t_now
        return req

    # -- decode-step views --------------------------------------------------

    def step_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
        """(tokens, steps, req_ids, gen_idx) — fixed (n_slots,) views of
        the running state; inactive slots carry zeros and write to the
        trash page."""
        tokens = np.zeros((self.n_slots,), np.int32)
        steps = np.zeros((self.n_slots,), np.int32)
        rids = np.zeros((self.n_slots,), np.int32)
        gidx = np.zeros((self.n_slots,), np.int32)
        for i, info in enumerate(self.slots):
            if info is None:
                continue
            req = self.requests[info.rid]
            tokens[i] = (req.resume_pending if req.resume_pending is not None
                         else req.generated[-1])
            steps[i] = info.step
            rids[i] = info.rid
            gidx[i] = len(req.generated)
        return tokens, steps, rids, gidx

    def advance(self, slot: int, token: int) -> None:
        """Record one decoded token for a running slot."""
        info = self.slots[slot]
        req = self.requests[info.rid]
        req.resume_pending = None
        req.generated.append(int(token))
        info.step += 1
