"""Paged KV cache: fixed-size pages, per-sequence page tables, free list.

The port's copy of ``repro.serve.paged_cache``: host-side numpy and list
logic, verbatim, except that ``PagedTables`` hands the engine int32
torch tensors on its device.

The serving engine replaces the dense per-sequence ``max_len`` ring-buffer
caches with a single physical **page pool** shared by every decode slot.
A page holds ``page_size`` consecutive cache positions of one sub-layer
stack (across all ``n_macro`` layers at once, matching the models'
stacked-block cache layout).  Each slot maps logical page j to a physical
page through its **page table**; pages are allocated on demand as a
sequence grows and returned to the free list on eviction — decode memory
is bounded by the pool, not by ``n_slots × max_len`` (the serving-side
analogue of the packed slot buffers that bound training memory,
DESIGN.md §7).

The abstraction covers all three cache species:

* attention KV (gemma3):  full-attention subs page a growing prefix;
  sliding-window subs page the ring allocation (ring slot = pos % window
  — page-aligned, so ``window % page_size == 0`` is required);
* constant-size SSM state (rwkv6): one implicit page per slot — slot
  rows, no table;
* hybrid (hymba): paged KV + slot-row conv/SSM states.

Physical page 0 is the reserved **trash page**: unallocated page-table
entries point at it, inactive slots write to it, and every read through
it is masked before the softmax — so admit/evict touch only host-side
numpy tables and the decode step always sees the same input shapes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.transformer import block_layout, cache_alloc


@dataclasses.dataclass(frozen=True)
class SubPaging:
    """Paging spec for one sub-layer stack's KV cache."""
    name: str            # "sub0", ...
    alloc: int           # logical token capacity A (ring: window; else max_len)
    ring: bool           # sliding-window ring semantics


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Family-aware paging plan: which subs page KV, page counts, state."""
    page_size: int
    max_len: int                     # rounded up to a page multiple
    subs: Tuple[SubPaging, ...]      # attention-bearing subs ((), for ssm)
    has_state: bool                  # slot-row states (ssm / hybrid)

    def sub_pages(self, sub: SubPaging) -> int:
        return sub.alloc // self.page_size

    @property
    def pages_per_seq(self) -> int:
        """Worst-case pages one sequence can hold (its full allocation)."""
        return sum(self.sub_pages(s) for s in self.subs)

    def prompt_pages(self, sub: SubPaging, prompt_len: int) -> int:
        """Pages a freshly-admitted prompt occupies in ``sub``."""
        covered = min(prompt_len, sub.alloc) if sub.ring else prompt_len
        return -(-covered // self.page_size)


def build_layout(cfg, page_size: int, max_len: int) -> PagedLayout:
    """Derive the paging plan from an architecture config.

    ``max_len`` is rounded up to a page multiple (the engine uses the
    rounded value as the dense prefill ``max_len`` too, so paged and
    dense allocations coincide and greedy decode is bitwise-equal).
    """
    if cfg.family in ("vlm", "audio"):
        raise ValueError(
            f"{cfg.name}: the serving engine does not cover the "
            f"{cfg.family} family (patch/frame frontends); use the static "
            f"loop")
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    max_len = -(-max_len // page_size) * page_size
    subs: List[SubPaging] = []
    if cfg.family != "ssm":
        for si, spec in enumerate(block_layout(cfg)):
            a = cache_alloc(cfg, spec, max_len)
            ring = spec.window > 0 and a == spec.window
            if a % page_size:
                raise ValueError(
                    f"{cfg.name} sub{si}: allocation {a} is not a multiple "
                    f"of page_size {page_size} (ring buffers must be "
                    f"page-aligned)")
            subs.append(SubPaging(name=f"sub{si}", alloc=a, ring=ring))
    return PagedLayout(page_size=page_size, max_len=max_len,
                       subs=tuple(subs),
                       has_state=cfg.family in ("ssm", "hybrid"))


class PageAllocator:
    """Free-list over the physical page pool.  Page 0 is reserved as the
    trash page and never handed out."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError(f"pool needs >= 2 pages (1 is the trash "
                             f"page), got {n_pages}")
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self.peak_in_use = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_in_use(self) -> int:
        return (self.n_pages - 1) - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop n pages, or None (and take nothing) if the pool is dry."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self.peak_in_use = max(self.peak_in_use, self.n_in_use)
        return pages

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if not 0 < p < self.n_pages:
                raise ValueError(f"freeing out-of-range page {p}")
            self._free.append(p)


class PagedTables:
    """Host-side page tables: numpy mirrors of the decode step's tables.

    One (n_slots, MP_sub) int32 table per attention sub; entry 0 means
    "unallocated → trash page".  The engine caches the device copies and
    re-pushes only when ``version`` moved (admit/grow/release); shapes
    are static, so the decode step sees the same input shapes across
    admit/evict.  Device copies are int32 tensors on ``device``.
    """

    def __init__(self, layout: PagedLayout, n_slots: int,
                 allocator: PageAllocator, device="cpu"):
        self.device = torch.device(device)
        self.layout = layout
        self.n_slots = n_slots
        self.allocator = allocator
        self.tables: Dict[str, np.ndarray] = {
            s.name: np.zeros((n_slots, layout.sub_pages(s)), np.int32)
            for s in layout.subs}
        self._held: List[List[int]] = [[] for _ in range(n_slots)]
        # bumped on every mutation so the engine can cache device copies
        self.version = 0

    def pages_held(self, slot: int) -> int:
        return len(self._held[slot])

    def admit(self, slot: int, prompt_len: int) -> bool:
        """Allocate the pages a prompt's cache occupies.  All-or-nothing:
        on a dry pool nothing is taken and False is returned."""
        need = [(s, self.layout.prompt_pages(s, prompt_len))
                for s in self.layout.subs]
        pages = self.allocator.alloc(sum(n for _, n in need))
        if pages is None:
            return False
        self._held[slot].extend(pages)
        it = iter(pages)
        for s, n in need:
            for j in range(n):
                self.tables[s.name][slot, j] = next(it)
        self.version += 1
        return True

    def grow(self, slot: int, step: int) -> bool:
        """Ensure the page holding write position ``step`` exists in every
        sub.  Returns False (allocating nothing further) on a dry pool."""
        ps = self.layout.page_size
        for s in self.layout.subs:
            pos = step % s.alloc if s.ring else step
            if pos >= s.alloc:
                raise ValueError(
                    f"slot {slot} step {step} exceeds {s.name} allocation "
                    f"{s.alloc} (max_len {self.layout.max_len})")
            j = pos // ps
            if self.tables[s.name][slot, j] == 0:
                got = self.allocator.alloc(1)
                if got is None:
                    return False
                self.tables[s.name][slot, j] = got[0]
                self._held[slot].append(got[0])
                self.version += 1
        return True

    def release(self, slot: int) -> None:
        """Evict: return the slot's pages and reset its tables to trash."""
        self.allocator.free(self._held[slot])
        self._held[slot] = []
        for s in self.layout.subs:
            self.tables[s.name][slot, :] = 0
        self.version += 1

    def device_tables(self) -> Dict[str, torch.Tensor]:
        """int32 device copies of the tables, keyed like the models expect."""
        return {name: torch.as_tensor(t, device=self.device)
                for name, t in self.tables.items()}

    def rows(self, slots: List[int]) -> Dict[str, torch.Tensor]:
        """int32 device table rows for an admitted group (commit_prefill)."""
        return {name: torch.as_tensor(t[slots], device=self.device)
                for name, t in self.tables.items()}
