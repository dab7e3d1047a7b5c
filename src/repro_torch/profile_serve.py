"""Where the time of a serving decode step goes on the GPU.

    PYTHONPATH=src python -m repro_torch.profile_serve [--out FILE]

Builds the serving workload (``serve_workload.build``: qwen3-1.7b at full
width in fp32, 8 slots, 16 requests of 128 prompt tokens, the one
``chip_smoke.py`` drives) and runs it through ``DecodeEngine`` after a
warm-up, twice without and twice under ``torch.profiler``: once in full
and once with every request cut to its first token, which runs the same
prefills and no decode step.  The differences divided by the full run's
decode steps give, per decode step: the device time, by kernel kind, and
the kernel launches; the device's busy share is that device time over
the host time of a decode step in the full run without the profiler.
Prints one JSON object; needs a GPU.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import time

import torch

from . import serve_workload as sw
from .profile_round import _device_us


def _kind(name: str) -> str:
    if "paged_decode_kernel" in name:
        return "flash_decode_paged (K3)"
    if any(k in name for k in ("gemm", "gemv", "cutlass", "xmma", "sm90_",
                               "splitK", "dot_kernel")):
        return "matmul"
    if "Memcpy" in name or "Memset" in name:
        return "memcpy / memset"
    return "elementwise / reduction"


def _run(w, gen=None, profile=False) -> dict:
    eng = sw.engine(w, gen=gen)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts) if profile else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with prof or contextlib.nullcontext():
        eng.run()
        torch.cuda.synchronize()
    out = {"wall_s": time.perf_counter() - t0, "stats": eng.stats()}
    if prof is not None:
        device = [e for e in prof.key_averages()
                  if e.self_cpu_time_total == 0 and _device_us(e) > 0]
        out["device_us"] = sum(_device_us(e) for e in device)
        out["launches"] = sum(e.count for e in device)
        kinds: dict = {}
        for e in device:
            kinds[_kind(e.key)] = kinds.get(_kind(e.key), 0.0) + _device_us(e)
        out["kinds_us"] = kinds
        out["top"] = [{"name": e.key[:80], "count": e.count,
                       "device_ms": _device_us(e) * 1e-3}
                      for e in sorted(device, key=_device_us,
                                      reverse=True)[:10]]
    return out


def profile() -> dict:
    w = sw.build("cuda")
    sw.engine(w, n_requests=2, gen=3).run()                 # warm-up
    full, pre = _run(w), _run(w, gen=1)
    pfull, ppre = _run(w, profile=True), _run(w, gen=1, profile=True)
    steps = full["stats"]["n_decode_steps"]
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
        "config": {"arch": sw.ARCH, "slots": sw.N_SLOTS,
                   "page_size": sw.PAGE_SIZE, "requests": sw.N_REQUESTS,
                   "prompt_len": sw.PROMPT_LEN, "gen": sw.GEN,
                   "gen_spread": sw.GEN_SPREAD},
        "decode_steps": steps,
        "tokens_per_sec": full["stats"]["tokens_per_sec"],
        "decode_ms_per_step_host": full["stats"]["decode_ms_per_step"],
        "wall_s": {"full": full["wall_s"], "first_token_only": pre["wall_s"],
                   "full_profiled": pfull["wall_s"],
                   "first_token_only_profiled": ppre["wall_s"]},
        "prefill_device_ms": ppre["device_us"] * 1e-3,
        "device_ms_per_decode_step": dev_ms,
        "device_ms_per_decode_step_by_kind": kinds,
        "launches_per_decode_step":
            (pfull["launches"] - ppre["launches"]) / steps,
        # device time of a step over its host time without the profiler
        # (the profiler's own cost, ~20 us a launch, inflates its wall)
        "decode_busy_share": dev_ms / full["stats"]["decode_ms_per_step"],
        "top_device_full_run": pfull["top"],
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    a = ap.parse_args(argv)
    text = json.dumps(profile(), indent=1)
    print(text)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
