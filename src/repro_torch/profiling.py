"""The device kernels of a ``torch.profiler`` profile, read one way.

``device_kernels(prof)`` reads the profiler's raw events (its Python
event tree takes minutes to build for a round of ~10^6 launches) and
returns the device's kernels, memcpys and memsets in start order.  The
profiler ranges of ``models/moe.py`` also appear on the device's
timeline, spanning their kernels: they are not kernels and are left
out.  ``profile_serve.py``, ``profile_round.py`` and ``chip_smoke.py``
read their profiles through it.
"""
from __future__ import annotations

import bisect
from typing import List, NamedTuple, Optional

import torch

from .models import moe


class Kernel(NamedTuple):
    name: str
    us: float               # device time
    span: Optional[str]     # the moe.RANGES kind the launching op ran in


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
        out.append(Kernel(e.name(), e.duration_ns() / 1e3, span))
    return out
