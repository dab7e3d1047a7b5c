"""Serving launcher: static-batch loop or the continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen3-1.7b --reduced --device cpu --batch 4 \\
        --prompt-len 32 --gen 16

    PYTHONPATH=src python -m repro_torch.launch.serve --engine continuous \\
        --arch qwen3-1.7b --batch 8 --requests 16 --prompt-len 128 \\
        --gen 32 --gen-spread 16

    PYTHONPATH=src python -m repro_torch.launch.serve --engine continuous \\
        --arch rwkv6-3b --reduced --device cpu --batch 4 --requests 8 \\
        --prompt-len 32 --gen 8 --gen-spread 4

    PYTHONPATH=src python -m repro_torch.launch.serve --engine continuous \\
        --arch hymba-1.5b --batch 8 --requests 16 --prompt-len 128 \\
        --gen 32 --gen-spread 16

    PYTHONPATH=src python -m repro_torch.launch.serve --engine static \\
        --arch whisper-medium --batch 8 --prompt-len 64 --gen 128

    PYTHONPATH=src python -m repro_torch.launch.serve --engine static \\
        --arch internvl2-26b --reduced --device cpu --batch 2 \\
        --prompt-len 8 --gen 4

The flags are those of ``repro.launch.serve``, plus ``--device``
(default ``cuda``: the card; the run fails without one unless
``--device cpu`` is given).  ``--engine static`` runs the fixed-batch
prefill+decode loop (``serve.engine.static_generate``); ``--engine
continuous`` routes the requests through the paged continuous-batching
engine with ``--batch`` decode slots (rwkv6-3b's state rows take no
pages; its prefill's scan runs on kernel K7 on the card; hymba-1.5b's
attention KV takes pages, its conv and SSM states slot rows).
whisper-medium (the ``audio`` family) and internvl2-26b (the ``vlm``
family) run the static loop only, as in the reference (``--engine
continuous`` raises the engine's ``ValueError``); whisper's ``frames``
(batch, 1,500, d_model) and the VLM's ``patches`` (batch, n_patches,
``vit_width``) are drawn from ``--seed`` too, and a VLM's ``max_len``
adds its patches, as the reference's does.  Weights are random, drawn
from ``--seed``; so are the prompts, from a torch generator: they are
not the reference launcher's prompts.  At full width internvl2-26b's 48
layers take 79.5 GB in fp32, more than one 80 GB card holds.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..common import resolve_device
from ..configs.base import get_config, list_configs
from ..models import get_model
from ..models.transformer import vit_width
from ..serve.engine import DecodeEngine, ServeConfig, static_generate


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list_configs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--engine", default="static",
                    choices=("static", "continuous"))
    ap.add_argument("--batch", type=int, default=4,
                    help="static: batch size; continuous: decode slots")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights, the prompts (a torch generator: "
                         "not the reference launcher's prompts) and the "
                         "sampling noise")
    ap.add_argument("--requests", type=int, default=0,
                    help="continuous: total requests (default: --batch)")
    ap.add_argument("--gen-spread", type=int, default=0,
                    help="continuous: request i generates gen + i %% spread")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pool-pages", type=int, default=0,
                    help="page pool size (0 = auto, no oversubscription)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = get_model(cfg)
    params = model.init_params(torch.Generator(device=dev)
                               .manual_seed(args.seed))

    b, s = args.batch, args.prompt_len
    n_req = args.requests or b
    prompts = torch.randint(
        0, cfg.vocab, (max(b, n_req), s),
        generator=torch.Generator().manual_seed(args.seed + 1),
        dtype=torch.int32).numpy()
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = torch.randn(
            (b, cfg.n_patches, vit_width(cfg)),
            generator=torch.Generator().manual_seed(args.seed + 2))
    if cfg.family == "audio":
        extra["frames"] = torch.randn(
            (b, cfg.enc_seq, cfg.d_model),
            generator=torch.Generator().manual_seed(args.seed + 3))
    gens = [args.gen + (i % args.gen_spread if args.gen_spread else 0)
            for i in range(n_req)]
    max_len = s + max(gens) + 8 + (cfg.n_patches if cfg.family == "vlm"
                                   else 0)

    if args.engine == "continuous":
        sv = ServeConfig(n_slots=b, max_len=max_len,
                         page_size=args.page_size, n_pages=args.pool_pages,
                         temperature=args.temperature, seed=args.seed)
        eng = DecodeEngine(cfg, params, sv, device=dev)
        for i in range(n_req):
            eng.submit(prompts[i], gens[i])
        t0 = time.time()
        results = eng.run()
        dt = time.time() - t0
        st = eng.stats()
        print(f"continuous: {n_req} requests x {b} slots, "
              f"{st['total_tokens']} tokens in {dt:.2f}s "
              f"({st['tokens_per_sec']:.1f} tok/s), "
              f"{st['n_decode_steps']} decode steps, "
              f"{st['n_preemptions']} preemptions, "
              f"peak pages {st['peak_pages']}/{st['n_pages'] - 1}")
        for i in range(min(n_req, 2)):
            print(f"  req{i}: {results[i].tolist()}")
        return

    t0 = time.time()
    out = static_generate(cfg, params, prompts[:b], args.gen,
                          max_len=max_len, temperature=args.temperature,
                          seed=args.seed, device=dev, extra=extra)
    dt = time.time() - t0
    print(f"static: prefill {b}x{s} + {args.gen} tokens/seq in {dt:.2f}s "
          f"({args.gen * b / max(dt, 1e-9):.1f} tok/s)")
    for i in range(min(b, 2)):
        print(f"  seq{i}: {out[i].tolist()}")


if __name__ == "__main__":
    main()
