"""The device kernels of a ``torch.profiler`` profile, read one way.

``device_kernels(prof)`` reads the profiler's raw events (its Python
event tree takes minutes to build for a round of ~10^6 launches) and
returns the device's kernels, memcpys and memsets in start order, each
with its device start on the profile's clock.  The
profiler ranges of ``models/moe.py`` also appear on the device's
timeline, spanning their kernels: they are not kernels and are left
out.  ``profile_serve.py``, ``profile_round.py`` and ``chip_smoke.py``
read their profiles through it.  ``device_ms(fn)`` is the device time
of one call, L2 flushed, that ``profile_masked_agg.py`` and
``chip_smoke.py`` time kernels with.
"""
from __future__ import annotations

import bisect
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .models import moe

FLUSH_FLOATS = 16 << 20          # 64 MB: more than the H100's 50 MB L2


class Kernel(NamedTuple):
    name: str
    us: float               # device time
    span: Optional[str]     # the moe.RANGES kind the launching op ran in
    start_ns: int           # on the profile's clock, as its host events


def device_kernels(prof) -> List[Kernel]:
    """``prof``'s device events in start order.  ``span`` is the kind
    (``moe.RANGES``) of the MoE range that held the host op launching the
    kernel, matched through the raw events' correlation ids; None outside
    the ranges, or when the profile holds no host events."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    host = [e for e in events if e.device_type() != cuda]
    spans = sorted((e.start_ns(), e.end_ns(), moe.RANGES[e.name()])
                   for e in host if e.name() in moe.RANGES)
    starts = [a for a, _, _ in spans]
    op_start = {e.correlation_id(): e.start_ns() for e in host
                if e.linked_correlation_id() == 0} if spans else {}
    dev = sorted((e for e in events if e.device_type() == cuda
                  and e.name() not in moe.RANGES), key=lambda e: e.start_ns())
    out = []
    for e in dev:
        span = None
        t = op_start.get(e.linked_correlation_id())
        if t is not None:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                span = spans[i][2]
        out.append(Kernel(e.name(), e.duration_ns() / 1e3, span,
                          e.start_ns()))
    return out


def device_ms(fn, iters=20, warmup=3) -> float:
    """Median device time of ``fn`` with L2 flushed before each call.

    The host enqueues every (flush, event, call, event) behind a GPU sleep,
    so the window between the events holds the device work of ``fn``
    alone, not the host's enqueue."""
    flush = torch.empty(FLUSH_FLOATS, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(100_000_000)
    for a, b in evs:
        flush.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in evs]))
