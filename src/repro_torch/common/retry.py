"""Jittered exponential backoff (crash-resilient client handling).

The cohort engine resamples crashed clients with bounded retries
(DESIGN.md §14); real deployments would also sleep between transport
attempts.  Both want the same schedule: exponential growth, a cap, and
*deterministic* jitter — every delay is a pure function of
``(seed, token, attempt)`` (a numpy ``SeedSequence`` draw, the
reference's own), so simulated runs replay bit-exactly and two callers
backing off for different tokens decorrelate.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class Backoff:
    """Jittered exponential backoff schedule.

    ``delay(attempt)`` grows ``base * factor**attempt`` up to
    ``max_delay``, then jitters *downward* by up to ``jitter`` of the
    value (full value at jitter=0) — the "equal jitter" variant: the
    cap is respected, retries never synchronize.
    """
    attempts: int = 3
    base: float = 0.05
    factor: float = 2.0
    max_delay: float = 2.0
    jitter: float = 0.5
    seed: int = 0

    def __post_init__(self):
        if self.attempts < 0:
            raise ValueError(f"attempts must be >= 0, got {self.attempts}")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")

    def delay(self, attempt: int,
              token: Union[int, Sequence[int]] = 0) -> float:
        """The ``attempt``-th delay for ``token`` (any int tuple — e.g.
        ``(round, position)`` — decorrelates concurrent backoffs)."""
        d = min(self.base * self.factor ** int(attempt), self.max_delay)
        if self.jitter <= 0.0:
            return d
        toks = (token,) if isinstance(token, (int, np.integer)) else \
            tuple(int(t) for t in token)
        rng = np.random.default_rng(np.random.SeedSequence(
            (int(self.seed), 0xBACC0FF) + toks + (int(attempt),)))
        return d * (1.0 - self.jitter * float(rng.random()))


def retry_call(fn: Callable[[int], "object"], *, backoff: Backoff,
               retry_on: Tuple[type, ...] = (Exception,),
               token: Union[int, Sequence[int]] = 0,
               sleep: Optional[Callable[[float], None]] = time.sleep):
    """Call ``fn(attempt)`` with up to ``backoff.attempts`` retries.

    Sleeps ``backoff.delay(attempt, token)`` between attempts (pass
    ``sleep=None`` for simulated time — no real waiting).  Raises the
    last exception when every attempt fails.
    """
    last: Optional[BaseException] = None
    for attempt in range(max(1, backoff.attempts)):
        try:
            return fn(attempt)
        except retry_on as e:           # noqa: PERF203 (bounded loop)
            last = e
            if attempt + 1 < backoff.attempts and sleep is not None:
                sleep(backoff.delay(attempt, token))
    assert last is not None
    raise last
