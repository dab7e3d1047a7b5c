"""Where the time of a serving decode step goes on the GPU.

    PYTHONPATH=src python -m repro_torch.profile_serve [--arch ARCH]
        [--traffic serving|long] [--out FILE]

Builds the serving workload (``serve_workload.build``: qwen3-1.7b, or
``--arch`` such as rwkv6-3b, hymba-1.5b or granite-moe-1b-a400m, at full
width in fp32, under
``--traffic``: by default 8 slots, 16 requests of 128 prompt tokens;
``long``, 4 requests of 1,536; the ones ``chip_smoke.py`` drives) and,
after a warm-up, runs it through ``DecodeEngine`` once without and once
under ``torch.profiler``, recording every prefill call the engine makes (its
tokens and keywords).  It then replays those prefill calls alone (each
with its greedy first-token argmax), once without and once under the
profiler.  The full run's device time less the replay's, divided by the
decode steps, gives per decode step: the device time, by kernel kind,
and the kernel launches; the device's busy share is that device time
over the host time of a decode step in the full run without the
profiler.  The replay's device time, by kind, is the prefills'.  What
the replay leaves out (the prefill states' commits into the slot rows or
pages, and host-side sampling) counts toward the decode steps.

A kernel's kind comes from its name, except on the MoE family: a kernel
launched by an op inside one of ``models/moe.py``'s profiler ranges
counts toward that range's kind (``moe: router``, ``moe: sort and
rank``, ``moe: gather and scatter``, ``moe: expert bmm``), matched
through the profiler's raw events (``profiling.device_kernels``: each
kernel's correlation id names the op that launched it).  Prints one
JSON object; needs a GPU.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import subprocess
import time

import torch

from . import serve_workload as sw
from .configs.base import list_configs
from .models import get_model
from .profiling import device_kernels


def _kind(name: str) -> str:
    if "paged_decode" in name:       # split and combine kernels
        return "flash_decode_paged (K3)"
    if "walk_kernel" in name or "carry_kernel" in name:   # K7's passes
        return "rwkv6_scan (K7)"
    if "fwd_kernel" in name:         # the chunked prefill's attention
        return "flash_attention_fwd (K5)"
    if any(k in name for k in ("gemm", "gemv", "cutlass", "xmma", "sm90_",
                               "splitK", "dot_kernel")):
        return "matmul"
    if "Memcpy" in name or "Memset" in name:
        return "memcpy / memset"
    return "elementwise / reduction"


def _profiled(fn, profile: bool) -> dict:
    """Run ``fn`` (synchronised) and, under the profiler, sum its device
    kernels: total, launches, by kind and the top ten."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts) if profile else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with prof or contextlib.nullcontext():
        ret = fn()
        torch.cuda.synchronize()
    out = {"wall_s": time.perf_counter() - t0, "ret": ret}
    if prof is not None:
        kernels = [(k.name, k.us, f"moe: {k.span}" if k.span
                    else _kind(k.name)) for k in device_kernels(prof)]
        out["device_us"] = sum(us for _, us, _ in kernels)
        out["launches"] = len(kernels)
        kinds: dict = collections.defaultdict(float)
        by_name: dict = collections.defaultdict(lambda: [0, 0.0])
        for name, us, kind in kernels:
            kinds[kind] += us
            by_name[name][0] += 1
            by_name[name][1] += us
        out["kinds_us"] = dict(kinds)
        out["top"] = [{"name": n[:80], "count": c, "device_ms": us * 1e-3}
                      for n, (c, us) in sorted(by_name.items(),
                                               key=lambda x: -x[1][1])[:10]]
    return out


def _serve(w, calls: list):
    """The workload through a fresh engine whose prefill calls are
    appended to ``calls``; returns the engine's stats."""
    eng = sw.engine(w)
    inner = eng.model.prefill

    def prefill(params, tokens, **kw):
        calls.append((tokens.clone(), kw))
        return inner(params, tokens, **kw)

    eng.model = eng.model._replace(prefill=prefill)
    eng.run()
    return eng.stats()


@torch.no_grad()
def _replay(w, calls: list) -> None:
    model = get_model(w.cfg)
    for tokens, kw in calls:
        logits, _ = model.prefill(w.params, tokens, **kw)
        torch.argmax(logits[:, -1], dim=-1)


def profile(arch: str = sw.ARCH, traffic: str = "serving") -> dict:
    w = sw.build("cuda", arch=arch, traffic=traffic)
    sw.engine(w, n_requests=2, gen=3).run()                 # warm-up
    calls: list = []
    full = _profiled(lambda: _serve(w, calls), False)
    pfull = _profiled(lambda: _serve(w, []), True)
    pre = _profiled(lambda: _replay(w, calls), False)
    ppre = _profiled(lambda: _replay(w, calls), True)
    stats = full["ret"]
    steps = stats["n_decode_steps"]
    kinds = {k: (pfull["kinds_us"].get(k, 0.0)
                 - ppre["kinds_us"].get(k, 0.0)) * 1e-3 / steps
             for k in pfull["kinds_us"]}
    dev_ms = (pfull["device_us"] - ppre["device_us"]) * 1e-3 / steps
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return {
        "card": smi, "torch": torch.__version__,
        "config": {"arch": arch, "traffic": traffic,
                   "page_size": sw.PAGE_SIZE, **w.traffic._asdict()},
        "decode_steps": steps,
        "prefill_calls": len(calls),
        "tokens_per_sec": stats["tokens_per_sec"],
        "decode_ms_per_step_host": stats["decode_ms_per_step"],
        "wall_s": {"full": full["wall_s"], "prefill_replay": pre["wall_s"],
                   "full_profiled": pfull["wall_s"],
                   "prefill_replay_profiled": ppre["wall_s"]},
        "prefill_device_ms": ppre["device_us"] * 1e-3,
        "prefill_device_ms_by_kind": {k: v * 1e-3 for k, v in
                                      ppre["kinds_us"].items()},
        "device_ms_per_decode_step": dev_ms,
        "device_ms_per_decode_step_by_kind": kinds,
        "launches_per_decode_step":
            (pfull["launches"] - ppre["launches"]) / steps,
        # device time of a step over its host time without the profiler
        # (the profiler's own cost, ~20 us a launch, inflates its wall)
        "decode_busy_share": dev_ms / stats["decode_ms_per_step"],
        "top_device_full_run": pfull["top"],
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=sw.ARCH, choices=list_configs())
    ap.add_argument("--traffic", default="serving",
                    choices=sorted(sw.TRAFFIC))
    ap.add_argument("--out", default=None, help="also write the JSON here")
    a = ap.parse_args(argv)
    text = json.dumps(profile(a.arch, a.traffic), indent=1)
    print(text)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
