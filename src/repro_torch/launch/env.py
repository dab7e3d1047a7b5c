"""Opt-in production launch profile: allocator settings + tcmalloc.

The port of ``repro.launch.env``.  The training CLI is tuned for
debuggability by default (no allocator overrides, default malloc).  For
long fleet-scale runs ``--prod-env`` re-execs the launcher under the
profile below: the CUDA caching allocator's expandable segments, so
rounds whose working set changes from one cohort chunk or model to the
next grow their segments in place instead of fragmenting the card's
memory, and tcmalloc, which avoids glibc-malloc arena contention when
the host streams cohort chunks from many loader threads.

The reference's XLA flags (latency-hiding scheduler, all-reduce combine
threshold) configure a compiler the port does not run; their
counterpart here is ``PYTORCH_CUDA_ALLOC_CONF``, merged key by key the
way the reference merges ``XLA_FLAGS``: a key the user already set wins.

``LD_PRELOAD`` cannot take effect in an already-running interpreter,
so ``--prod-env`` re-execs the launcher under the built environment
(guarded by ``REPRO_PROD_ENV`` so the exec happens exactly once).
"""
from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional, Sequence

# ``key:value`` entries of PYTORCH_CUDA_ALLOC_CONF (comma-separated)
PROD_ALLOC_CONF: Sequence[str] = (
    "expandable_segments:True",
)

# Debian/Ubuntu spellings, most specific first.  Only an existing path
# is ever placed in LD_PRELOAD: preloading a missing .so makes the
# dynamic linker print a warning per exec'd child, including every
# subprocess the benchmarks spawn.
TCMALLOC_PATHS: Sequence[str] = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/libtcmalloc_minimal.so.4",
    "/usr/lib/libtcmalloc.so.4",
)

# Guard variable: set in the child environment by reexec_under_prod_env
# so the re-exec'd launcher recognises the profile is already applied.
GUARD_VAR = "REPRO_PROD_ENV"


def _find_tcmalloc() -> Optional[str]:
    for path in TCMALLOC_PATHS:
        if os.path.exists(path):
            return path
    return None


def _merge_alloc_conf(existing: str, extra: Sequence[str]) -> str:
    """Append ``extra`` to a PYTORCH_CUDA_ALLOC_CONF string without
    clobbering.

    A key the user already set wins over the profile's value —
    ``--prod-env`` tunes defaults, it does not override explicit
    operator choices.
    """
    merged: List[str] = [f.strip() for f in existing.split(",") if f.strip()]
    have = {f.split(":", 1)[0] for f in merged}
    for entry in extra:
        if entry.split(":", 1)[0] not in have:
            merged.append(entry)
    return ",".join(merged)


def production_env(base: Optional[Dict[str, str]] = None, *,
                   tcmalloc: bool = True) -> Dict[str, str]:
    """Build the production environment dict (pure; no process mutation).

    Starts from ``base`` (default: a copy of ``os.environ``) and layers
    the profile on top.  User-set allocator keys are preserved; an
    existing LD_PRELOAD keeps its entries with tcmalloc appended.
    """
    env = dict(os.environ if base is None else base)
    env["PYTORCH_CUDA_ALLOC_CONF"] = _merge_alloc_conf(
        env.get("PYTORCH_CUDA_ALLOC_CONF", ""), PROD_ALLOC_CONF)
    if tcmalloc:
        so = _find_tcmalloc()
        if so is not None:
            preload = [p for p in env.get("LD_PRELOAD", "").split(":") if p]
            if so not in preload:
                preload.append(so)
            env["LD_PRELOAD"] = ":".join(preload)
            # Silence tcmalloc's large-alloc warnings: chunked cohort
            # streaming intentionally makes multi-GB host allocations.
            env.setdefault("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD",
                           "60000000000")
    env[GUARD_VAR] = "1"
    return env


def reexec_under_prod_env(module: str, argv: Sequence[str], *,
                          tcmalloc: bool = True) -> None:
    """Replace this process with ``python -m module argv`` under the
    production environment.  No-op when the guard variable shows the
    profile is already active (the re-exec'd child lands here again
    with the same --prod-env flag on its command line)."""
    if os.environ.get(GUARD_VAR):
        return
    env = production_env(tcmalloc=tcmalloc)
    os.execve(sys.executable,
              [sys.executable, "-m", module, *argv], env)
