"""K1 (the fused masked aggregation) alone on the card, at the plans the
port runs it on.

    PYTHONPATH=src python -m repro_torch.profile_masked_agg \
        [--plans vgg16,imdb,...] [--seed N] [--dtype float32|bfloat16]
        [--out FILE]

The plans: the paper's hub rounds (VGG16 at full width with 8 clients,
IMDB and CASA with 10), the hierarchical hub combine (VGG16's plan over
2 edge planes) and the zoo rounds' hubs (qwen3-1.7b, hymba-1.5b cut to
16 layers, whisper-medium, granite-moe-1b-a400m, internvl2-26b cut to
2 layers; 2 clients), each tiling plan built from the leaf shapes alone
(the zoo's on ``meta``).  Selections are drawn as the round draws them
(``uniform`` at the plan's train fraction, one generator seeded from
``--seed``); client weights are uniform in [0.5, 2), one of the paper's
clients at 0 (a crashed client, still read); deltas and global tiles
are random.  For each plan: the kernel against its plain version on
every row, bitwise repeatable, an unselected NaN skipped
(``ops.check_kernel``); the share of live client planes; device medians
with L2 flushed (``profiling.device_ms``) of the kernel and of an empty
kernel (the launch floor); both byte bounds (every client plane, and
the live planes only) at the H100's memory rate
(``launch.roofline.HBM_BW``).  ``--dtype bfloat16`` runs K1's bf16
instance on the same draws rounded to bf16 (held to its plain version
by ``ref.bf16_agrees``; bounds at 2 bytes an element).  Prints a line a
plan and one JSON object; needs a GPU and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from .kernels.masked_agg import ops
from .kernels.masked_agg.ref import draw_selection, k1_bytes
from .launch.roofline import HBM_BW
from .profiling import device_ms

ZOO = {"qwen3-1.7b": ("qwen3-1.7b", None),
       "hymba-1.5b": ("hymba-1.5b", 16),
       "whisper-medium": ("whisper-medium", None),
       "granite-moe-1b-a400m": ("granite-moe-1b-a400m", None),
       "internvl2-26b": ("internvl2-26b", 2)}
PLANS = ("vgg16", "imdb", "casa", "hierarchical") + tuple(ZOO)


def _paper_plan(name):
    from .core.masking import build_units_flat
    from .models import paper_models as pm
    from . import paper_round, paper_tasks
    model = "vgg16" if name == "hierarchical" else name
    init = {"vgg16": lambda g: pm.init_vgg16(g, width_mult=paper_round.WIDTH),
            "imdb": pm.init_imdb, "casa": pm.init_casa}[model]
    units = {"vgg16": pm.vgg16_units, "imdb": pm.imdb_units,
             "casa": pm.casa_units}[model]
    params = init(torch.Generator().manual_seed(0))
    assign = build_units_flat(params, units(params))
    c, n_train = ((paper_round.N_CLIENTS, paper_round.N_TRAIN)
                  if model == "vgg16" else
                  (paper_tasks.N_CLIENTS, paper_tasks.N_TRAIN[model]))
    return ops.build_agg_plan(assign, params), c, n_train


def _zoo_plan(name):
    from .configs.base import get_config
    from .core.masking import build_units_zoo
    from .launch import specs
    arch, layers = ZOO[name]
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    params = specs.params_sds(cfg)
    assign = build_units_zoo(cfg, params)
    return ops.build_agg_plan(assign, params), 2, assign.n_units // 2


def plan_inputs(name: str, dev, seed: int = 0, dtype=torch.float32):
    """``(plan, g_t, d_t, sel_cu, w_c)`` on ``dev`` for one of
    :data:`PLANS`: the hub's client planes and ``(sel, weights)``, or
    for ``hierarchical`` the combine's 2 edge planes (zero where an edge
    has no participant, as stage 1 writes them) with ``e_den`` and unit
    edge weights; the tiles drawn in fp32, then rounded to ``dtype``."""
    from .core.comm import edge_membership
    plan, c, n_train = (_zoo_plan(name) if name in ZOO
                        else _paper_plan(name))
    sel = draw_selection(c, plan.n_units, n_train, seed)
    rng = np.random.default_rng(seed)
    w = torch.as_tensor(rng.uniform(0.5, 2.0, c), dtype=torch.float32)
    if name not in ZOO:
        w[c // 2] = 0.0                              # a crashed client
    if name == "hierarchical":
        mem = torch.as_tensor(edge_membership(c, 2), dtype=torch.float32)
        sel, w = mem @ (sel * w[:, None]), torch.ones(2)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t, tile = plan.n_rows, plan.tile
    g_t = torch.randn(t, tile, generator=gen, device=dev)
    d_t = 0.05 * torch.randn(sel.shape[0], t, tile, generator=gen,
                             device=dev)
    if name == "hierarchical":
        quiet = torch.as_tensor(sel.numpy()[:, plan.row_unit] <= 0,
                                device=dev)
        d_t[quiet] = 0.0
    return plan, g_t.to(dtype), d_t.to(dtype), sel.to(dev), w.to(dev)


def profile_plan(name, dev, *, seed=0, dtype=torch.float32):
    plan, g_t, d_t, sel, w = plan_inputs(name, dev, seed, dtype)
    k1_in = (g_t, d_t, sel, w, plan.row_unit_on(dev))
    t, tile, esz = plan.n_rows, plan.tile, g_t.element_size()
    err = ops.check_kernel(k1_in)["max_abs_err"]
    nb = k1_bytes(plan.row_unit, sel, tile, esz)
    rec = {"plan": name, "dtype": str(dtype).replace("torch.", ""), "T": t,
           "planes": nb["planes"], "units": plan.n_units, "live": nb["live"],
           "vec": ops.launch_vec(t, tile, esz), "max_abs_err": err,
           "bound_all_ms": nb["all"] / HBM_BW * 1e3,
           "bound_live_ms": nb["live_bytes"] / HBM_BW * 1e3,
           "empty_ms": device_ms(lambda: torch.cuda._sleep(0)),
           "ms": device_ms(lambda: ops.masked_agg(*k1_in))}
    del g_t, d_t, k1_in
    torch.cuda.empty_cache()
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plans", default=",".join(PLANS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_masked_agg: needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    recs = []
    for plan in args.plans.split(","):
        rec = profile_plan(plan, dev, seed=args.seed,
                           dtype=getattr(torch, args.dtype))
        recs.append(rec)
        ms = rec["ms"]
        print(f"[k1] {plan} {args.dtype}: T={rec['T']} "
              f"planes={rec['planes']} live "
              f"{rec['live']:.3f} ({rec['live'] / rec['planes']:.1%}), "
              f"{ops.THREADS} x {rec['vec']}, max abs err "
              f"{rec['max_abs_err']:.3e}; ms {ms:.4f}; bounds all "
              f"{rec['bound_all_ms']:.4f} live {rec['bound_live_ms']:.4f} "
              f"(kernel at {rec['bound_live_ms'] / ms:.1%} of live); empty "
              f"kernel {rec['empty_ms']:.4f}", flush=True)
    res = {"device": name, "plans": recs}
    print(json.dumps(res))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
