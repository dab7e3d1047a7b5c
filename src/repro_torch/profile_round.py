"""Where the time of the paper's federated rounds goes on the GPU.

    PYTHONPATH=src python -m repro_torch.profile_round [--rounds 3]
        [--model vgg16|imdb|casa] [--topology hub|hierarchical|gossip]
        [--codec qint8] [--strategy NAME] [--out FILE]

Builds the federation chip_smoke.py drives, without evaluation: VGG16
from ``paper_round.build`` (8 clients), IMDB or CASA from
``paper_tasks.build`` (10 clients), under the topology asked for
(``hierarchical`` with 2 edges); with ``--codec`` the packed round with
that uplink codec; with ``--strategy`` that selection strategy.  It runs
one round to warm up, then ``--rounds`` rounds without and ``--rounds``
rounds under ``torch.profiler``, and prints one JSON object: the card
and its power limit, the host wall time per round, the device's busy
share (device kernel time over the profiled wall time), the kernel
launches per round, the device time and launches per round by kind (K1,
K2 and the library kernels) and the kernels that take the most device
time.  Under a scored strategy it then measures the same again on a
second federation that replays the first one's selections with a
stateless ``Replay``: the same training without the gradient-norm
telemetry and the state update ("without_telemetry"), so the
difference is their cost.  Needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from . import paper_round, paper_tasks
from .core import Replay
from .profiling import device_kernels

MODELS = ("vgg16", "imdb", "casa")
TOPOLOGIES = ("hub", "hierarchical", "gossip")


def _kind(name: str) -> str:
    if "masked_agg" in name:
        return "masked_agg (K1)"
    if "quantize_pack" in name:             # quantize_pack_group_kernel
        return "quantize_pack (K2)"
    if "LpNorm" in name:                    # the scored telemetry's norms
        return "norm telemetry (foreach_norm)"
    if any(k in name for k in ("RNN", "LSTM", "rnn", "lstm")):
        return "lstm (cuDNN)"
    if any(k in name for k in ("cudnn", "xmma", "implicit_gemm", "conv",
                               "dgrad", "wgrad", "gemm")):
        return "convolution / matmul"
    if "Memcpy" in name or "Memset" in name:
        return "memcpy / memset"
    return "elementwise / reduction"


def build(model: str = "vgg16", topology: str = "hub", codec: str = "",
          strategy=None):
    """The profiled federation on the card (``strategy``: a name or an
    instance overriding the selection)."""
    kw = {"topology": topology, "strategy": strategy or None}
    if topology == "hierarchical":
        kw["n_edges"] = 2
    if codec:
        kw.update(packed=True, codec=codec)
    if model == "vgg16":
        return paper_round.build("cuda", **kw)
    return paper_tasks.build(model, "cuda", evaluate=False, **kw)


def _measure(fed, rounds: int) -> dict:
    """One warm-up round, ``rounds`` clean and ``rounds`` profiled."""
    fed.fit(1)                                   # warm-up: cuDNN, kernel build
    clean = [r.seconds for r in fed.fit(rounds)[-rounds:]]   # no profiler
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        hist = fed.fit(rounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = device_kernels(prof)
    device_us = sum(k.us for k in kernels)
    by_kind: dict = {}
    launches_by_kind: dict = {}
    by_name: dict = {}
    for k in kernels:
        kind = _kind(k.name)
        by_kind[kind] = by_kind.get(kind, 0.0) + k.us * 1e-3 / rounds
        launches_by_kind[kind] = launches_by_kind.get(kind, 0) + 1 / rounds
        count, us = by_name.get(k.name, (0, 0.0))
        by_name[k.name] = (count + 1, us + k.us)
    top = sorted(by_name.items(), key=lambda x: -x[1][1])[:12]
    return {
        "round_seconds": clean,
        "round_seconds_profiled": [r.seconds for r in hist[-rounds:]],
        "profiled_wall_s": wall,
        "device_busy_share": device_us * 1e-6 / wall,
        "device_ms_per_round": device_us * 1e-3 / rounds,
        "kernel_launches_per_round": len(kernels) / rounds,
        "device_ms_per_round_by_kind": by_kind,
        "kernel_launches_per_round_by_kind": launches_by_kind,
        "top_device": [{"name": n[:80], "count": c, "device_ms": us * 1e-3}
                       for n, (c, us) in top],
    }


def profile(rounds: int, codec: str = "", model: str = "vgg16",
            topology: str = "hub", strategy: str = "") -> dict:
    fed = build(model, topology, codec, strategy)
    measured = _measure(fed, rounds)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    out = {
        "card": smi, "torch": torch.__version__,
        "config": {"model": model, "topology": topology,
                   "clients": fed.fl.n_clients,
                   "edges": fed.fl.resolve_n_edges()
                   if topology == "hierarchical" else None,
                   "strategy": fed.server.strategy.name,
                   "train_units": fed.fl.n_train_units,
                   "units": fed.assign.n_units,
                   "batch": fed.loader.batch_size,
                   "local_steps": fed.loader.steps,
                   "packed": fed.fl.packed, "codec": fed.fl.codec,
                   "rounds": rounds},
        **measured,
    }
    if fed.server.sel_state is not None:
        twin = build(model, topology, codec,
                     Replay(fed.server.sel_history))
        out["without_telemetry"] = _measure(twin, rounds)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--model", default="vgg16", choices=MODELS)
    ap.add_argument("--topology", default="hub", choices=TOPOLOGIES)
    ap.add_argument("--codec", default="",
                    help="profile the packed round with this uplink codec")
    ap.add_argument("--strategy", default="",
                    help="selection strategy (default: the federation's)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    a = ap.parse_args(argv)
    text = json.dumps(profile(a.rounds, a.codec, a.model, a.topology,
                              a.strategy), indent=1)
    print(text)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
