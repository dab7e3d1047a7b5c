"""Federated training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch qwen3-1.7b --reduced --device cpu --clients 2 --rounds 2 \\
        --batch-size 2 --steps-per-round 1 --seq 32

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --clients 2 --rounds 1 --batch-size 1 --steps-per-round 1 --seq 64

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch whisper-medium --clients 2 --rounds 1 --batch-size 1 \\
        --steps-per-round 1 --seq 64

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch internvl2-26b --reduced --device cpu --clients 2 \\
        --rounds 1 --batch-size 1 --steps-per-round 1 --seq 16

The flags, defaults and output lines are those of
``repro.launch.train`` (a header line, one log line a round, ``total
...s; comm summary:`` and the JSON of ``comm_summary()``), plus
``--device`` (default ``cuda``: the card; the run fails without one
unless ``--device cpu`` is given).  It drives the paper's federated
round (per-client layer subsets from the registered strategy, masked
local Adam, participation-weighted FedAvg) over synthetic LM data
(``data.lm_batch``; for the ``audio`` family also ``frames``, (n,
enc_seq, d_model), and for the ``vlm`` family ``patches``, (n,
n_patches, ``vit_width``), standard normals from ``--seed``, as the
reference draws them) partitioned IID across clients, through the
``Federation`` facade, with the facade's default attention
(``attn_impl="reference"``).  Weights are random, drawn on the device
from ``--seed``.

``--client-shards`` (a device mesh) and ``--prod-env`` (the reference's
XLA launch profile, ``launch/env.py``) are not ported and raise
``NotPortedError``.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..common import resolve_device
from ..configs.base import get_config, list_configs
from ..core import (Checkpointer, FLConfig, Federation, NotPortedError,
                    registered_client_samplers, registered_strategies,
                    registered_topologies)
from ..data import FederatedLoader, iid_partition, lm_batch
from ..models.transformer import vit_width


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list_configs())
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale variant (what a CPU run can hold)")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--train-fraction", type=float, default=0.5)
    ap.add_argument("--strategy", default="uniform",
                    choices=registered_strategies())
    ap.add_argument("--score-ema", type=float, default=0.9,
                    help="EMA decay of the per-unit gradient-norm "
                         "scores a stateful strategy (score_weighted, "
                         "depth_dropout, successive) maintains")
    ap.add_argument("--score-every", type=int, default=1,
                    help="fold norm telemetry into the selection state "
                         "every N rounds/flushes")
    ap.add_argument("--synchronized", action="store_true")
    ap.add_argument("--topology", default="hub",
                    choices=registered_topologies())
    ap.add_argument("--edges", type=int, default=None,
                    help="edge aggregators (hierarchical; default ~sqrt)")
    ap.add_argument("--packed", action="store_true",
                    help="packed trained-unit round path (DESIGN.md §7)")
    ap.add_argument("--fused-agg", default="auto",
                    choices=("auto", "on", "off"),
                    help="fused CUDA aggregation (kernels/masked_agg)")
    ap.add_argument("--fedprox-mu", type=float, default=0.0)
    ap.add_argument("--async-buffer", type=int, default=0,
                    help="FedBuff-style semi-async rounds: flush the "
                         "global model every N buffered updates (0=sync)")
    ap.add_argument("--staleness", default="polynomial",
                    help="stale-delta reweighting rule (registered in "
                         "core/async_agg.py)")
    ap.add_argument("--staleness-alpha", type=float, default=0.5)
    ap.add_argument("--delay-dist", default="pareto:1.5",
                    help="simulated client-latency distribution for "
                         "async rounds: none|exponential[:s]|"
                         "lognormal[:s]|pareto[:a]")
    ap.add_argument("--registered", type=int, default=0,
                    help="registered fleet size: sample --clients "
                         "participants per round from this many "
                         "registered clients (0 = fleet == cohort)")
    ap.add_argument("--cohort-chunk", type=int, default=0,
                    help="stream the cohort through the round step in "
                         "chunks of this many clients (0 = whole "
                         "cohort in one shot); bounds host memory")
    ap.add_argument("--client-sampler", default="uniform",
                    choices=registered_client_samplers(),
                    help="per-round cohort draw from the registered "
                         "fleet (core/cohort.py registry)")
    ap.add_argument("--client-shards", type=int, default=0,
                    help="split the cohort over this many device groups "
                         "(not ported: any value but 0 raises)")
    ap.add_argument("--history-cap", type=int, default=0,
                    help="retain at most N rounds of selection history; "
                         "older rounds fold into O(1) accounting "
                         "totals (0 = unbounded)")
    ap.add_argument("--prod-env", action="store_true",
                    help="the reference's production launch profile "
                         "(launch/env.py; not ported: raises)")
    ap.add_argument("--faults", default="",
                    help="fault-injection chaos spec, e.g. "
                         "'crash:0.1,nan:0.05,kill:0.02' (core/faults.py;"
                         " delta faults need --packed)")
    ap.add_argument("--max-delta-norm", type=float, default=0.0,
                    help="quarantine packed updates whose delta norm "
                         "exceeds this (0 = isfinite gate only)")
    ap.add_argument("--drop-prob", type=float, default=0.0,
                    help="per-dispatch in-transit loss probability "
                         "(async mode only)")
    ap.add_argument("--codec", default="none",
                    help="uplink compression codec for packed trained-"
                         "slot deltas (core/codecs.py): none, qint8, "
                         "qint4, topk_ef")
    ap.add_argument("--codec-topk", type=float, default=0.1,
                    help="kept-coordinate fraction for the topk_ef codec")
    ap.add_argument("--fault-retries", type=int, default=3,
                    help="resample attempts per crashed cohort slot")
    ap.add_argument("--dropout", type=float, default=0.0)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--steps-per-round", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.prod_env:
        raise NotPortedError(
            "--prod-env: the production launch profile (the reference's "
            "launch/env.py) is not ported to repro_torch yet")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    n = args.clients * args.batch_size * args.steps_per_round * 8
    data = lm_batch(n, args.seq, cfg.vocab, key=args.seed)
    if cfg.family == "vlm":
        data["patches"] = np.random.default_rng(args.seed).normal(
            0, 1, (n, cfg.n_patches, vit_width(cfg))).astype(np.float32)
    if cfg.family == "audio":
        data["frames"] = np.random.default_rng(args.seed).normal(
            0, 1, (n, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    shards = iid_partition(n, args.clients, key=args.seed + 1)
    client_data = [{k: v[s] for k, v in data.items()} for s in shards]
    if args.registered > args.clients:
        # registered fleet larger than the synthetic corpus: tile the
        # cohort-sized shards (dict views, no copies) so every
        # registered id resolves; per-(round, id) draws stay distinct
        client_data = [client_data[i % args.clients]
                       for i in range(args.registered)]
    loader = FederatedLoader(client_data,
                             batch_size=args.batch_size,
                             steps_per_round=args.steps_per_round,
                             key=args.seed)

    fl = FLConfig(n_clients=args.clients,
                  train_fraction=args.train_fraction,
                  strategy=args.strategy, synchronized=args.synchronized,
                  lr=args.lr, prox_mu=args.fedprox_mu,
                  topology=args.topology, n_edges=args.edges,
                  packed=args.packed, fused_agg=args.fused_agg,
                  async_buffer=args.async_buffer,
                  staleness=args.staleness,
                  staleness_alpha=args.staleness_alpha,
                  client_delay_dist=args.delay_dist,
                  score_ema=args.score_ema, score_every=args.score_every,
                  n_registered=args.registered,
                  cohort_chunk=args.cohort_chunk,
                  client_sampler=args.client_sampler,
                  client_shards=args.client_shards,
                  history_cap=args.history_cap,
                  faults=args.faults,
                  max_delta_norm=args.max_delta_norm,
                  client_drop_prob=args.drop_prob,
                  fault_retries=args.fault_retries,
                  codec=args.codec, codec_topk=args.codec_topk)
    hooks = [Checkpointer(args.ckpt)] if args.ckpt else []
    fed = Federation.from_config(cfg, fl, data=loader, seed=args.seed,
                                 dropout_rate=args.dropout, hooks=hooks,
                                 device=dev)
    print(f"arch={cfg.name} reduced={args.reduced} "
          f"units={fed.assign.n_units} "
          f"train={fl.resolve_n_train(fed.assign.n_units)} "
          f"clients={args.clients} topology={args.topology}" +
          (f" edges={fl.resolve_n_edges()}"
           if args.topology == "hierarchical" else "") +
          (f" async_buffer={fl.async_buffer} staleness={fl.staleness}"
           f" delays={fl.client_delay_dist}" if fl.async_buffer else "") +
          (f" scoring=on ema={fl.score_ema} every={fl.score_every}"
           if fed.server.sel_state is not None else "") +
          (f" fleet={fl.n_registered or args.clients}"
           f" chunk={fl.cohort_chunk or args.clients}"
           f" sampler={fl.client_sampler or 'uniform'}"
           if fl.uses_cohort_engine() else "") +
          (f" faults={fl.faults}" if fl.faults else "") +
          (f" codec={fl.codec}" if fl.codec != "none" else ""))
    t0 = time.time()
    fed.fit(args.rounds, log_every=1)
    print(f"total {time.time()-t0:.1f}s; comm summary:")
    print(json.dumps(fed.comm_summary(), indent=1))
    if args.ckpt:
        print(f"saved server state to {args.ckpt}")


if __name__ == "__main__":
    main()
