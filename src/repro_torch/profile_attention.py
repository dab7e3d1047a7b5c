"""Where the fp32 flash-attention kernels (K5 forward, K6 backward) spend
their device time.

    PYTHONPATH=src python -m repro_torch.profile_attention [--out FILE]

Builds variants of ``kernels/flash_attention/csrc/flash_attention.cu``
with phases taken out, and times the forward, dQ and dK/dV kernels of
the full source and of each variant at ``train_4k`` (B=2, S=4,096,
causal) on qwen3-1.7b's heads and gemma3-12b's (global, and local with
its window of 1,024), fp32, as device medians of CUDA events with L2
flushed.  Forward phases: the scores, the online softmax (its scores are
still stored as P), the products, and all three with P's store (which
leaves the cp.async pipeline, its barriers and the epilogue).  Backward
phases: the scores, the products, and the scores, the softmax step and
the products.  A phase's share is the full
kernel's time less the variant's.  The variants' outputs are wrong: they
are built into ``kernels/_build/`` under their own names, timed here and
loaded by nothing else.  Prints one JSON object; needs a GPU and
``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess

import torch

from .configs.base import get_config
from .kernels import _build
from .kernels.flash_attention import ops as aops

SOURCE = aops.SOURCES[torch.float32]
# kernel -> phase -> the calls its variant takes out
PHASES = {
    "fwd": {
        "scores": [r"fwd_scores<HD>\([^;]*;"],
        "softmax": [r"fwd_softmax<HD>\([^;]*;"],
        "products": [r"fwd_products<HD>\([^;]*;"],
        "pipeline only": [r"fwd_scores<HD>\([^;]*;",
                          r"fwd_softmax<HD>\([^;]*;",
                          r"fwd_put<HD>\([^;]*;",
                          r"fwd_products<HD>\([^;]*;"]},
    "bwd": {
        "scores": [r"score_chunk<B::DC[^;]*;"],
        "products": [r"product_chunk<B::PR[^;]*;"],
        "pipeline only": [r"score_chunk<B::DC[^;]*;",
                          r"product_chunk<B::PR[^;]*;",
                          r"put_scores\(s, [^;]*;",
                          r"softmax_grad<\w+>\([^;]*;"]},
}
CASES = [("qwen3-1.7b", "qwen3-1.7b", 0),
         ("gemma3-12b global", "gemma3-12b", 0),
         ("gemma3-12b local", "gemma3-12b", None)]
FLUSH_FLOATS = 16 << 20          # 64 MB: more than the H100's 50 MB L2


def _variants():
    """{(part, phase): ctypes function}: the full source ("all", "full")
    and each phase removed, built together."""
    src = SOURCE.read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [("all", "full", [])] + [(part, name, pats) for part, phases in
                                    PHASES.items()
                                    for name, pats in phases.items()]
    procs = {}
    for part, name, pats in todo:
        text = src
        for pat in pats:
            # a removed chunk call leaves its stage taken from the ring
            text, n = re.subn(pat, "(void)st;" if "chunk" in pat or
                              "scores<" in pat or "products<" in pat
                              else ";", text)
            if n == 0:
                raise RuntimeError(f"{pat!r} is not in {SOURCE.name}")
        stem = f"fa_phase_{part}_" + name.replace(" ", "_")
        cu = _build.BUILD_DIR / f"{stem}.cu"
        cu.write_text(text)
        so = _build.BUILD_DIR / f"{stem}.so"
        procs[part, name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for key, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {key!r} variant:\n{out}")
        fn = ctypes.CDLL(str(so)).flash_attention
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[key] = fn
    return fns


def _device_ms(fn, iters=5):
    flush = torch.empty(FLUSH_FLOATS, device="cuda")
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
    return sorted(a.elapsed_time(b) for a, b in evs)[iters // 2]


def _shares(full, times, phases, kernels):
    """Per kernel: each phase's ms (full less its variant), the pipeline
    alone, and the rest (full less all of those)."""
    out = {}
    for kn in kernels:
        sh = {ph: full[kn] - times[ph][kn] for ph in phases
              if ph != "pipeline only"}
        sh["pipeline"] = times["pipeline only"][kn]
        sh["rest"] = full[kn] - sum(sh.values())
        out[kn] = sh
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_attention: needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    fns = _variants()
    kernel = aops._kernel
    result = {"device": torch.cuda.get_device_name(0), "cases": {}}
    for tag, arch, window in CASES:
        cfg = get_config(arch)
        window = cfg.sliding_window if window is None else window
        h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        gen = torch.Generator(device=dev).manual_seed(hd + window)
        q, g = (torch.randn(2, 4096, h, hd, generator=gen, device=dev)
                for _ in range(2))
        k, v = (torch.randn(2, 4096, hkv, hd, generator=gen, device=dev)
                for _ in range(2))
        o, lse = aops.attention_fwd(q, k, v, causal=True, window=window)
        delta = (o * g).sum(-1).transpose(1, 2)
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        o2, lse2 = torch.empty_like(o), torch.empty_like(lse)
        kernels = {
            "fwd": {"fwd": lambda: aops._launch(
                "fwd", aops._FWD, q, k, v, lse=lse2, out0=o2, causal=True,
                window=window)},
            "bwd": {
                "dq": lambda: aops._launch(
                    "dq", aops._DQ, q, k, v, do=g, lse=lse, delta=delta,
                    out0=dq, causal=True, window=window),
                "dkv": lambda: aops._launch(
                    "dkv", aops._DKV, q, k, v, do=g, lse=lse, delta=delta,
                    out0=dk, out1=dv, causal=True, window=window)}}
        times = {}
        for (part, name), fn in fns.items():
            aops._kernel = lambda source, fn=fn: fn
            todo = kernels[part] if part != "all" else \
                {**kernels["fwd"], **kernels["bwd"]}
            times[part, name] = {kn: _device_ms(kf)
                                 for kn, kf in todo.items()}
        aops._kernel = kernel
        full = times["all", "full"]
        result["cases"][tag] = {
            "ms": {f"{part} {name}": t for (part, name), t in times.items()},
            "shares_ms": {
                **_shares(full, {n: times["fwd", n] for n in PHASES["fwd"]},
                          PHASES["fwd"], kernels["fwd"]),
                **_shares(full, {n: times["bwd", n] for n in PHASES["bwd"]},
                          PHASES["bwd"], kernels["bwd"])}}
        del q, k, v, g, o, lse, delta, dq, dk, dv, o2, lse2
        torch.cuda.empty_cache()
    result["power"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
