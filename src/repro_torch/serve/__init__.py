"""Serving engine of the port: paged KV cache, continuous-batching
scheduler and decode engine (``repro.serve``'s modules).

``paged_cache``  — page pool layout, free-list allocator, page tables
``scheduler``    — request lifecycle: admit / grow / evict / preempt
``engine``       — the decode loop + the static-batch baseline
"""
from . import engine, paged_cache, scheduler  # noqa: F401
