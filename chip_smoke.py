#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root.  It drives ``repro_torch`` only (no JAX,
nothing of the ``repro`` package) in twenty-eight phases, in the order
below except that 17-20, then 22-28, then 21 run after 8, and any
failure exits non-zero:

1. build — compiles every CUDA kernel of the port from the sources in
   the checkout with ``nvcc`` (``repro_torch/kernels/_build.py``).
2. kernel — ``masked_agg`` at the round's shapes (VGG16 at full width,
   8 clients, tile 2048, with a unit nobody selected, a client of
   weight 0 and leaves that are not a multiple of the tile) against its
   plain PyTorch version on the card, at the reference's own bar
   (atol = rtol = 2e-5); the tree-level fused FedAvg against the plain
   ``masked_fedavg``; bitwise repeatability; median times of the
   kernel, the plain version and a ``torch.bmm`` yardstick beside the
   bound the card's memory rate sets.
3. parity — one small hub round on the card through the kernel
   against the same round on the CPU through the plain aggregation,
   with the same selection replayed.
4. round — the paper's hub round (``repro_torch/paper_round.py``):
   ``Federation.from_config`` on VGG16 at full width, 8 clients training
   7 of 14 units with the ``uniform`` strategy, ``cifar_like`` data split
   by ``iid_partition``, batch 32, 2 local steps, 3 rounds, evaluated on
   256 held-out images.  Checks finite losses, one kernel launch per
   round, exact-zero deltas on every client's frozen units, and
   ``comm_summary()`` equal to Table 4's formula on the recorded
   selections.
5. round-repeat — the same federation built twice from the same seed
   (``paper_round.build``), 2 rounds each: every parameter and every
   ``sel_history`` row bitwise equal between the two, and equal
   ``comm_summary()`` (``common/device.py`` turns on cuDNN's
   deterministic algorithms).
6. codec-kernel — ``quantize_pack_group`` (K2, one launch for a list of
   leaves) at bits 8 and 4 over every one of the 80 VGG16 leaf shapes
   with 8 rows (one of them all zero), plus odd and long rows and a row
   holding a NaN and an infinity, in one launch: each leaf's codes and
   scales equal bitwise to its plain PyTorch version on the same ``x``
   and ``u``, again with every row of several chunks forced into two
   visits and with every row waiting in place for its maxima (x read
   once), two launches bitwise equal, and single leaves
   (``quantize_pack``, a group of one) too; median device time (L2
   flushed) and wall time with the host of the grouped call over the 80
   leaves (one round's encode), the plain version's, the bound, the
   kernel's share of it and its time against the previous design's 80
   calls.
7. packed-round — the same federation with ``packed=True,
   codec="qint8"``, 3 rounds: finite losses, one grouped K2 launch per
   round and K1 never, decoded deltas of frozen (client, leaf) pairs
   exactly zero, and in every round ``sel @ codec_unit_bytes`` ==
   ``encoded_wire_bytes`` of the round's slot plan == the billed uplink,
   beside the fp32 uplink of the same selections; then the same 3 rounds
   with the codec's ``rows_roundtrip`` put back to the per-leaf loop (one
   launch a leaf): parameters, ``sel_history`` and ``comm_summary()``
   bitwise equal to the grouped rounds'.
8. codec-rounds — one round each with ``qint4`` (one grouped K2
   launch) and ``topk_ef``; the latter holds ``decoded + new residual ==
   signal`` exactly on the rows of participating clients.
9. decode-kernel — ``paged_decode_attention`` (K3) on qwen3's heads
   (16 query heads over 8 KV heads of 128) at the serving shape (8
   sequences of 129-175 tokens) and at 8 x 4,096 tokens, pages
   scattered by a random permutation, valid lengths ragged, fp32 and
   bf16: within 2e-5 of its plain version in fp32 and 3e-2 of the fp32
   plain version on the same bf16 inputs; bf16 also element by element
   (|x - y| <= 2^-8|y| + ``ref.BF16_ATOL``), with two planted wrong
   outputs (each long sequence's last split, or last tile, left out)
   that must fail that bar; bitwise repeatable, and the
   same output bitwise when the trash page and every page the tables do
   not reach are NaN; the first call of each case runs under
   ``torch.cuda.set_sync_debug_mode("error")`` (the wrapper never reads
   ``valid_len`` back); prints each case's split plan (splits, tokens
   per split, blocks, workspace bytes); median device times (L2 flushed)
   of the kernel, the plain version and a gather +
   ``scaled_dot_product_attention`` yardstick beside the bound in bytes,
   and the kernel's share of it.
10. serve — qwen3-1.7b at full width in fp32 (random weights) through
   ``DecodeEngine`` (``repro_torch/serve_workload.py``): 8 slots over
   16-token pages, 16 requests of 128 prompt tokens, request i
   generating ``32 + i % 16`` tokens.  Checks the parameter count, that
   every request finishes with its token count, one decode input
   signature, and K3 launched once per layer per decode step; prints
   tokens/s, decode ms per step, TTFT, latency, preemptions, peak pages
   and memory.
11. serve-parity — the same requests through the engine (K3) against
   ``static_generate`` (dense cache, plain attention) on the card: every
   logits row within 1e-3, and equal token streams except at a step
   whose static top-2 logit gap is below that tolerance (printed).
12. attention-kernels — ``flash_attention`` (K5 forward, K6 backward)
   at full attention width in ``train_4k`` (B=2, S=4,096, causal; 16
   query heads over 8 KV heads): qwen3-1.7b (head dim 128), a gemma3-12b
   local layer (head dim 256, window 1,024) and a global one, fp32 and
   bf16 (fp32 on the SIMT kernels of ``flash_attention.cu``, bf16 on the
   tensor-core kernels of ``flash_attention_sm90.cu``).  One
   ``torch.autograd.grad`` of ``(flash_attention(q, k, v) * g).sum()``
   per case must launch the forward, dQ and dK/dV kernels once each; o,
   lse, dq, dk and dv are held to the plain versions (fp32: 2e-5 on o and
   lse, 5e-4 on gradients; bf16 against the fp32 plain version on the
   same inputs: 3e-2, relative to the largest gradient, and element by
   element against the plain version that rounds P and dS to bf16 where
   the kernels do, at ``ref.rounding_error_ratio``'s bar, lse at
   LSE_EMU_TOL; wrong outputs planted in one head, a key tile left out or
   one head's share of dK/dV, must fail that bar, and in fp32 the same
   wrong outputs must fail 2e-5 (o, lse) and 5e-4); two runs bitwise
   equal; median device times of the forward,
   backward and both, of the plain version and of
   ``scaled_dot_product_attention`` with GQA (the cuDNN / PyTorch kernels
   it ran are named) beside the bound in operations (fp32 at 67 TFLOP/s,
   bf16 at the tensor cores' 989 TFLOP/s), the kernel's share of it and,
   in fp32, the forward's time against the previous design's.
13. decode-dense — ``decode_attention`` (K4, launched on K3's kernel)
   at qwen3-1.7b width in ``decode_32k`` (8 caches of 32,768 positions,
   ragged valid lengths, fp32 and bf16), on a gemma3-12b ring cache
   (1,024 slots, window 1,024, valid lengths beyond it; also through
   ``flash_decode`` in the reference kernel's layout, and valid length 0
   giving zeros) and on a cache of 1,000 positions with ``blk_k`` 512
   (positions 512.. never read): within 2e-5 of the plain version (3e-2
   for bf16, and bf16 element by element with planted wrong outputs, as
   in 9), one K3 launch per call, bitwise repeatable, the first call
   of each case with no host sync (as in 9); prints each case's split
   plan, and at ``decode_32k`` requires more than one split per
   (sequence, KV head) and at least one block per SM; median device
   times of the kernel, the plain version and a masked
   ``scaled_dot_product_attention`` beside the bound in bytes, and the
   kernel's share of it.
14. wkv-kernel — ``wkv`` (K7, the chunked RWKV-6 scan, in the model
   layout the prefill passes) at rwkv6-3b's width (40 heads of 64): the
   serving prefill's shape (8 prompts x 128 tokens), one prompt of 128
   (the engine's later prefills), ``prefill_32k`` at batch 1 (32,768
   tokens), and odd lengths 145 (chunk 5) and 127 (chunk 1); r, k, v ~
   N(0, 1), log-decay -|N(0, 1)|, u ~ 0.1 N(0, 1).  Prints each case's
   segment plan (segments, blocks, kernels a call).  fp32 within 1e-4 of
   the plain chunked version (o and state), and at the serving shape
   within 1e-3 of the per-token oracle; bf16 r/k/v (fp32 log-decay, as a
   bf16 model passes it) against the fp32 plain version on the same
   bf16-rounded inputs, 1e-2 x max|o| on o, element by element at
   ``ref.bf16_error_ratio``'s bar (|x - y| <= 2^-8|y| + ``ref.BF16_ATOL``)
   and 1e-4 on the fp32 state; where a row has several segments, two
   planted wrong outputs (the carry dropped at the middle segment, its
   last chunk left out of the carry) must fail the same bars; log-decay
   -50 gives finite output; one counted call, bitwise repeatable; median
   device times (L2 flushed) of the kernel and the plain version beside
   the bound.
15. serve-rwkv6 — rwkv6-3b at full width in fp32 (random weights) under
   ``[serve]``'s traffic (``serve_workload.build(arch="rwkv6-3b")``).
   The qwen3 workload is freed first.  Checks the parameter count, every
   request's token count, one decode input signature, K7 launched once
   per layer per prefill call and K3 never; prints tokens/s, decode ms
   per step, TTFT, latency, preemptions, the state and peak memory.
16. serve-rwkv6-parity — the engine against ``static_generate`` on the
   card, as ``[serve-parity]`` (logits 1e-3, tokens equal barring near
   ties), with 16 slots so that the engine prefills and decodes in the
   static loop's batch: this model's logits move by more than 1e-3 with
   the batch alone (the plain forward's, batch 8 against 16: printed);
   the main path's 8-slot engine against ``slotted_generate``, the plain
   loop that batches as the engine does (a prefill of the first 8
   prompts, then one per freed slot; every decode step over 8 rows), at
   the same 1e-3; and the prefill's last-position logits (scan on K7)
   against ``forward``'s (the plain ``chunked_linear_scan``) for the
   first 8 prompts in one batch, within 1e-3.

17. paper-tasks — the paper's IMDB CNN-LSTM (2,638,966 params, 2 of 4
   units a round) and CASA LSTM (68,962 params, 3 of 6) at full width
   (``repro_torch/paper_tasks.py``: 10 clients, batch 16, 2 local steps,
   Adam at 3e-3, the LSTM on cuDNN), 3 hub rounds each: finite losses,
   one K1 launch per round, exact-zero deltas on every frozen (client,
   leaf), ``comm_summary()`` equal to Table 4's formula; held-out
   accuracy, round seconds and peak memory; then each task built twice
   from one seed, 2 rounds each: parameters and ``sel_history`` bitwise
   equal.
18. paper-tasks-parity — one round of each task on the card (K1)
   against the same round on the CPU (plain aggregation), the model in
   float64 and the selection replayed, at PARITY_TOL.
19. hier-round — VGG16 at full width under 2 edge aggregators of 4
   clients (``paper_round.build(topology="hierarchical", n_edges=2)``),
   3 rounds: one K1 launch per round over the 2 edge planes, the billed
   uplink equal to ``hierarchical_round_bytes`` (the edge->hub WAN) and
   not above the flat hub's on the same selections in any round, below
   it over the run; the fused two-stage aggregate on the last round's
   deltas within 2e-5 of the plain ``hierarchical_masked_fedavg``.  Then
   the same federation with ``packed=True, codec="qint8"``, 2 rounds:
   one grouped K2 launch per round and K1 never, the bill equal to the
   per-edge union at wire width, frozen decoded deltas exactly zero.
20. gossip-round — VGG16 at full width on a ring of 8 replicas, 2
   rounds: K1 never, the bill equal to ``gossip_round_bytes``, and the
   replicas' mean after mixing within 1e-6 (relative to the largest
   entry) of the trained replicas' mean; the state's size and peak
   memory.
21. k1-plans — K1 at the IMDB and CASA hub plans (10 clients, random
   deltas, a unit nobody selected, a client of weight 0) and at the
   hierarchical hub combine (the 2 edge planes of 19's last round)
   against its plain version at 2e-5, bitwise repeatable; device medians
   (L2 flushed) of the kernel, the plain version and a ``torch.bmm``
   yardstick beside the bound in bytes.
22. scored-round — VGG16 at full width under the scored strategies
   (``paper_round.build(strategy=...)``): ``score_weighted``,
   ``depth_dropout`` and ``successive`` 4 hub rounds each, and
   ``score_weighted`` on 2 edges for 2 rounds.  Each round: one K1
   launch; the per-client telemetry ``unit_sqnorm`` exactly zero on
   every frozen unit and positive on every trained one; after the state
   update ``sel_state.counts`` equal to the column sums of the active
   clients' selections so far and every unit trained so far with a
   positive score; the bill equal to Table 4 (hub) or
   ``hierarchical_round_bytes``.  Then one ``score_weighted`` round of
   VGG16 width 0.125 in float64 (its cross-entropy too) on the card (K1)
   and on the CPU with the same injected Gumbel noise and live state,
   with Adam and with SGD: selections equal, parameters within
   PARITY_TOL, telemetry within NORM_RTOL.
23. scored-packed — the ``score_weighted`` hub round packed with qint8,
   4 rounds: one K2 launch a round and K1 never, 22's telemetry and
   state checks; each round's dense telemetry on the packed run's own
   params, batches and selections within NORM_RTOL (relative) of the
   packed run's.
24. ckpt-resume — ``score_weighted`` hub, packed ``topk_ef`` (the
   error-feedback residual), packed qint8 (the codec's device
   generator) and gossip (8 stacked replicas), VGG16 at full width: 4
   rounds straight against 2 rounds, ``Federation.save``, a new
   ``Federation`` restored, 2 more rounds: state, ``sel_state``, codec
   state, ``sel_history`` and ``comm_summary()`` bitwise equal; the
   checkpoint's bytes and the save and restore wall times beside the
   card's name and power limit.
25. async-round — VGG16 at full width under the buffered-async engine
   (``paper_round.build(async_buffer=4, client_delay_dist="pareto:1.2",
   packed=True, codec="qint8")``: 8 clients, FedBuff buffer 4, the
   reference's heavy-tailed delays), 3 flushes on the hub, then on 2
   edges: one grouped K2 launch per dispatch (the whole cohort at the
   start, then the one client that reported back), K1 never, every
   flush's bill equal to ``buffered_hub_round_bytes`` /
   ``buffered_hierarchical_round_bytes`` exactly, finite; each flush's
   seconds, staleness, entries and bytes.  A zero-staleness flush
   (delay ``none``, buffer 8) bitwise equal to the synchronous packed
   qint8 round; VGG16 width 0.125 in float64 (``_xent64``) on the card
   and the CPU, one flush under Adam and three under SGD: the same
   schedule, params within PARITY_TOL; K2 at the single-client dispatch shape (80 leaves
   x 1 row) against its plain version, bitwise, with its device and wall
   medians beside its byte bound.
26. cohort-round — the cohort engine: 1,000 registered clients (each
   with one round's images), a cohort of 8, ``loss_proportional``
   sampling, qint8, ``crash:0.1`` (crashed members resampled), 2 rounds
   in chunks of 4 and in one chunk of 8: one K2 launch a chunk, the two
   runs bitwise equal (params, selections, losses, bill, fleet EMAs);
   one ``uniform`` round; R == C (8 registered) bitwise equal to the
   synchronous packed round.
27. chaos — ``crash:0.25`` on the dense hub (K1 one launch a round, the
   crashed clients' weights zero exactly where the injector drew them),
   ``nan``/``inf``/``bitflip`` corruption on the packed qint8 hub behind
   the validation gate (``max_delta_norm``): the quarantine vector equal
   to the injected plan in every round, params finite; the async mix
   ``crash:0.1,nan:0.05,bitflip:0.05,duplicate:0.1,torn:0.05`` with 10%
   in-transit loss: quarantined entries equal to the corrupted or torn
   ones, wasted bytes billed; zero-rate chaos bitwise equal to clean.
28. engine-resume — ``run_with_restarts`` (``kill:0.5``, a
   ``Checkpointer`` every round) against the uninterrupted run, bitwise,
   for the async engine, the cohort engine and ``history_cap=2`` on a
   6-round dense hub run (whose capped bill equals Table 4 of every
   round's selections).

It runs on one card: the first of ``CUDA_VISIBLE_DEVICES`` (card 0 if
that is unset), and it hides the others.  Before the last line it prints
the card's name and power limit (as ``nvidia-smi`` reports them) and a
JSON line of per-kernel numbers (K1's and K2's launches summed over the
paths that ran them, each path's count in ``launches_by_path``, K1's
other plans in ``plans``, K2's single-client dispatch in
``dispatch_1client``); the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

# one card: set before torch initialises CUDA
CARD = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
os.environ["CUDA_VISIBLE_DEVICES"] = CARD

import torch  # noqa: E402

ROUNDS = 3
TOL = 2e-5
PARITY_TOL = 1e-5        # float32 optimizer/aggregation rounding on float64 params
FP32_PEAK = 67e12            # H100 SXM, float32 outside the tensor cores
BF16_PEAK = 989e12           # H100 SXM, bf16 dense on the tensor cores
REPEAT_ROUNDS = 2
# The previous designs' times at these shapes on an H100 80GB HBM3 at
# 700 W (PERF.md section 6), printed beside the fp32 forward and K2: the
# SIMT forward with 64 x 64 tiles, device medians with L2 flushed
# (chip_smoke.py), and the two-kernel quantize-pack's device time for
# one packed round's 80 per-leaf calls (profile_round.py --codec qint8).
PREVIOUS_MS = {"qwen3-1.7b": 6.6538, "gemma3-12b local": 6.1076,
             "gemma3-12b global": 13.6432, "k2": 0.822}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def memory_rate(name: str) -> float:
    """Peak device-memory bytes/s of the card, from its data sheet."""
    if "H200" in name:
        return 4.8e12
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    return 3.35e12                                   # H100 SXM


def median_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build()
    secs = time.perf_counter() - t0
    for name, log in logs.items():
        print(f"[build] {name}:")
        for line in log.strip().splitlines():
            print(f"    {line}")
    print(f"[build] {len(logs)} kernel source(s) in {secs:.2f} s")


def _k1_case(dev, params, assign, c):
    """K1's inputs at ``params``' tile plan for ``c`` clients: random
    deltas, unit 1 selected by nobody, client ``c // 2`` of weight 0;
    zero padding, so that whole tile buffers can be compared."""
    from repro_torch.kernels.masked_agg import ops

    plan = ops.build_agg_plan(assign, params)
    rng = np.random.default_rng(0)
    sel = torch.as_tensor(rng.integers(0, 2, (c, assign.n_units)),
                          dtype=torch.float32)
    sel[:, 1] = 0.0                                  # a unit nobody selected
    weights = torch.as_tensor(rng.uniform(0.5, 2.0, c), dtype=torch.float32)
    weights[c // 2] = 0.0                            # a client of weight 0
    dgen = torch.Generator(device=dev).manual_seed(0)
    deltas = {p: 0.05 * torch.randn((c,) + tuple(x.shape), generator=dgen,
                                    device=dev)
              for p, x in params.items()}
    g_t = ops.pack_into(plan, params,
                        ops.new_tile_buffer(plan, device=dev).zero_())
    d_t = ops.pack_into(plan, deltas,
                        ops.new_tile_buffer(plan, (c,), device=dev).zero_())
    w_t = ops.row_weights(plan, sel * weights[:, None], dev)
    return plan, sel, weights, deltas, g_t, d_t, w_t


def _k1_check(tag, g_t, d_t, w_t, still=None):
    """K1 against its plain version at TOL, bitwise repeatable, and the
    tile rows ``still`` (a unit nobody selected) unchanged; returns the
    max abs error and the plain output."""
    from repro_torch.kernels.masked_agg import ops
    from repro_torch.kernels.masked_agg.ref import masked_agg_ref

    out_k = ops.masked_agg(g_t, d_t, w_t)
    out_p = masked_agg_ref(g_t, d_t, w_t)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    check(torch.allclose(out_k, out_p, atol=TOL, rtol=TOL),
          f"{tag}: kernel vs plain: max abs err {err}")
    check(torch.equal(out_k, ops.masked_agg(g_t, d_t, w_t)),
          f"{tag}: kernel is not bitwise repeatable")
    if still is not None:
        check(torch.equal(out_k[still], g_t[still]),
              f"{tag}: a unit nobody selected changed")
    return err, out_p


def phase_kernel(dev):
    from repro_torch.core import build_units_flat
    from repro_torch.core.aggregation import masked_fedavg
    from repro_torch.kernels.masked_agg import ops
    from repro_torch.models import paper_models as pm
    from repro_torch.paper_round import N_CLIENTS, WIDTH

    gen = torch.Generator().manual_seed(0)
    params = {p: x.to(dev) for p, x in
              pm.init_vgg16(gen, width_mult=WIDTH).items()}
    assign = build_units_flat(params, pm.vgg16_units(params))
    c = N_CLIENTS
    plan, sel, weights, deltas, g_t, d_t, w_t = _k1_case(dev, params,
                                                         assign, c)
    ragged = [s for s in plan.segments if s.n % plan.tile]
    check(ragged, "no leaf off the tile multiple in the plan")
    t, tile = g_t.shape
    err, out_p = _k1_check("kernel", g_t, d_t, w_t, torch.as_tensor(
        plan.row_unit == 1, device=dev))
    tree_k = ops.masked_fedavg_fused(params, deltas, sel, weights, assign,
                                     plan=plan)
    tree_p = masked_fedavg(params, deltas, sel, weights, assign)
    tree_err = max(float((tree_k[p] - tree_p[p]).abs().max())
                   for p in params)
    check(all(torch.allclose(tree_k[p], tree_p[p], atol=TOL, rtol=TOL)
              for p in params), f"fused vs masked_fedavg: {tree_err}")
    print(f"[kernel] T={t} tile={tile} C={c}: max abs err vs plain "
          f"{err:.3e}, tree-level vs masked_fedavg {tree_err:.3e} "
          f"(tol {TOL})")

    m = _k1_measure(g_t, d_t, w_t, out_p, median_ms)
    print(f"[kernel] median ms: kernel {m['ms']:.4f}, plain "
          f"{m['plain_ms']:.4f}, torch.bmm {m['library_ms']:.4f}; bound "
          f"{m['bound_ms']:.4f}: {m['text']}")
    return {"name": "masked_agg", "route": "cuda",
            "source": "src/repro_torch/kernels/masked_agg/csrc/masked_agg.cu",
            "replaces": "src/repro/kernels/masked_agg/kernel.py:41",
            "max_abs_err": err, "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"]}


def _k1_measure(g_t, d_t, w_t, out_p, timer):
    """K1's time, its plain version's and a ``torch.bmm`` yardstick's on
    the same (T, tile) / (C, T, tile) / (T, C) inputs (``timer`` is
    ``median_ms`` or ``device_ms``), beside the bound: bytes (each input
    read once, the output written once) over the memory rate, or FLOPs
    over the fp32 peak."""
    from repro_torch.kernels.masked_agg import ops
    from repro_torch.kernels.masked_agg.ref import masked_agg_ref

    t, tile = g_t.shape
    c = d_t.shape[0]
    d_tct = d_t.permute(1, 0, 2).contiguous()        # (T, C, tile)

    def library():
        num = torch.bmm(w_t.unsqueeze(1), d_tct).squeeze(1)
        den = w_t.sum(1, keepdim=True)
        return g_t + torch.where(den > 0, num / den.clamp_min(1e-9),
                                 torch.zeros_like(num))

    lib_err = float((library() - out_p).abs().max())
    check(lib_err <= 1e-4, f"torch.bmm yardstick disagrees: {lib_err}")
    nbytes = 4 * (t * tile * (c + 2) + t * c)
    flops = 2 * c * t * tile
    name = torch.cuda.get_device_name(0)
    by_bytes, by_ops = nbytes / memory_rate(name), flops / FP32_PEAK
    launches0 = ops.masked_agg.launches
    ms = timer(lambda: ops.masked_agg(g_t, d_t, w_t))
    plain_ms = timer(lambda: masked_agg_ref(g_t, d_t, w_t))
    library_ms = timer(library)
    check(ops.masked_agg.launches > launches0, "timing did not launch")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "text": f"{nbytes / 1e6:.1f} MB at "
                    f"{memory_rate(name) / 1e12:.2f} TB/s is "
                    f"{by_bytes * 1e3:.4f}, {flops / 1e9:.2f} GFLOP at "
                    f"{FP32_PEAK / 1e12:.0f} TFLOP/s is {by_ops * 1e3:.4f}"}


def phase_parity(dev):
    """One small hub round on the card (through the kernel) against the
    same round on the CPU (plain aggregation): same params, batches and
    replayed selection, with Adam (the paper's optimizer) and with SGD.

    The model runs in float64 here.  In float32 the two devices' conv
    arithmetic differs by ~1e-6, enough to flip the odd ReLU whose input
    lies that close to 0 and to flip the sign of Adam's first step on
    gradients that are pure rounding noise (conv biases ahead of
    batch-statistics BN); float64 leaves neither, so every leaf is held
    to PARITY_TOL.  The optimizer and the aggregation kernel still
    compute in float32, as on the main path.
    """
    from repro_torch.core import FLConfig, Replay, build_round_step
    from repro_torch.core import build_units_flat
    from repro_torch.data import cifar_like
    from repro_torch.models import paper_models as pm

    c = 3
    params = pm.init_vgg16(torch.Generator().manual_seed(1),
                           dtype=torch.float64, width_mult=0.125)
    assign = build_units_flat(params, pm.vgg16_units(params))
    x, y = cifar_like(c * 4, key=3)
    batches = {"x": x.reshape(c, 1, 4, 32, 32, 3), "y": y.reshape(c, 1, 4)}
    sel = np.random.default_rng(2).integers(0, 2, (c, assign.n_units))
    for opt in ("adam", "sgd"):
        out = {}
        for d in (dev, torch.device("cpu")):
            fl = FLConfig(n_clients=c, n_train_units=7, optimizer=opt)
            step = build_round_step(
                functools.partial(pm.vgg16_loss, device=d), assign, fl,
                strategy=Replay([sel]), device=d)
            new, _ = step({p: v.to(d) for p, v in params.items()},
                          {k: torch.as_tensor(v, device=d)
                           for k, v in batches.items()},
                          torch.ones(c), None)
            out[d.type] = {p: v.cpu() for p, v in new.items()}
        err = {p: float((out["cuda"][p] - out["cpu"][p]).abs().max())
               for p in params}
        worst = max(err, key=err.get)
        check(err[worst] <= PARITY_TOL,
              f"parity ({opt}) {worst}: card vs CPU max abs err "
              f"{err[worst]} > {PARITY_TOL}")
        print(f"[parity] {opt}: one hub round, VGG16 width 0.125 in "
              f"float64, {c} clients: card (kernel) vs CPU (plain) max abs "
              f"err {err[worst]:.3e} at {worst} (tol {PARITY_TOL})")


class FrozenDeltaCheck:
    """Server hook: every client's frozen units must ship exact zeros."""

    def __init__(self, assign):
        self.assign = assign
        self.checked = 0

    def on_round_start(self, server, round_idx, weights):
        return None

    def on_round_end(self, server, record, metrics):
        sel = metrics["sel"]                                  # (C, U) CPU
        paths = list(self.assign.leaf_units)
        units = [self.assign.leaf_units[p].base for p in paths]
        # (leaves, C) largest |delta| per client, read back in one copy
        peak = torch.stack([metrics["deltas"][p].flatten(1).abs().amax(1)
                            for p in paths]).cpu()
        frozen = (sel[:, units] == 0).t()                     # (leaves, C)
        check(bool((peak[frozen] == 0).all()),
              f"round {record.round}: a frozen unit has a non-zero delta")
        check(bool((peak[~frozen] > 0).any()),
              f"round {record.round}: no trained unit moved")
        self.checked += int(frozen.sum())

    def on_fit_end(self, server, history):
        pass


def phase_round(dev):
    from repro_torch import paper_round
    from repro_torch.core.comm import table4_row
    from repro_torch.kernels.masked_agg import ops

    fed = paper_round.build(dev, eval_images=256)
    check(fed.fl.resolve_fused_agg(fed.device), "fused_agg did not resolve on")
    frozen = FrozenDeltaCheck(fed.assign)
    fed.server.add_hook(frozen)
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()
    hist = fed.fit(ROUNDS, log_every=1)
    torch.cuda.synchronize()
    launches = ops.masked_agg.launches

    check(all(math.isfinite(r.loss) for r in hist), "non-finite loss")
    check(launches == ROUNDS,
          f"masked_agg launched {launches} times in {ROUNDS} rounds")
    check(frozen.checked > 0, "no frozen unit was checked")
    summ = fed.comm_summary()
    t4 = table4_row(fed.assign, fed.params, np.stack(fed.server.sel_history))
    check(all(summ[k] == v for k, v in t4.items()),
          f"comm_summary {summ} != table4_row {t4}")
    for r in hist:
        print(f"[round] {r.round}: loss {r.loss:.4f} eval accuracy "
              f"{r.eval_metric:.4f} {r.seconds:.3f} s "
              f"uplink {r.uplink_bytes:.0f} B")
    print(f"[round] masked_agg launches {launches}; frozen (client, leaf) "
          f"deltas checked exactly zero: {frozen.checked}; comm_summary "
          f"== table4_row: avg uplink {summ['avg_uplink_bytes']:.0f} B, "
          f"reduction vs full {summ['reduction_vs_full']:.4f}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def phase_round_repeat(dev):
    """Two federations built from the same seed fit the same rounds: every
    parameter and every selection row bitwise equal, the same bill."""
    from repro_torch import paper_round

    feds = []
    for _ in range(2):
        fed = paper_round.build(dev)
        fed.fit(REPEAT_ROUNDS)
        torch.cuda.synchronize()
        feds.append(fed)
    a, b = feds
    diff = [p for p in a.params if not torch.equal(a.params[p], b.params[p])]
    check(not diff, f"{len(diff)} of {len(a.params)} parameters differ "
          f"between two identical runs, e.g. {diff[:3]}")
    sel_a, sel_b = a.server.sel_history, b.server.sel_history
    check(len(sel_a) == len(sel_b) == REPEAT_ROUNDS and
          all(np.array_equal(x, y) for x, y in zip(sel_a, sel_b)),
          "sel_history differs between two identical runs")
    check(a.comm_summary() == b.comm_summary(),
          f"comm_summary differs: {a.comm_summary()} vs {b.comm_summary()}")
    print(f"[round-repeat] two federations from the same seed, "
          f"{REPEAT_ROUNDS} rounds each: {len(a.params)} parameters and "
          f"{len(sel_a)} sel_history rows bitwise equal, comm_summary equal "
          f"(cudnn.deterministic {torch.backends.cudnn.deterministic}, "
          f"cudnn.benchmark {torch.backends.cudnn.benchmark})")


def _vgg_leaf_sizes():
    from repro_torch.models import paper_models as pm
    from repro_torch.paper_round import WIDTH
    params = pm.init_vgg16(torch.Generator().manual_seed(0), width_mult=WIDTH)
    return [int(np.prod(tuple(x.shape))) for x in params.values()]


def _same_codes(got, want):
    """Codes bitwise equal (dtype and shape too) and scales bitwise equal,
    a NaN scale equal to a NaN."""
    return (got[0].dtype == want[0].dtype and torch.equal(got[0], want[0])
            and torch.equal(got[1].isnan(), want[1].isnan()) and
            torch.equal(torch.nan_to_num(got[1]), torch.nan_to_num(want[1])))


def phase_codec_kernel(dev):
    from repro_torch.kernels.codec import ops as qops
    from repro_torch.kernels.codec.ref import (quantize_pack_group_ref,
                                               quantize_pack_ref)
    from repro_torch.paper_round import N_CLIENTS

    sizes = _vgg_leaf_sizes()
    check(len(sizes) == 80, f"VGG16 has {len(sizes)} leaves, expected 80")
    r = N_CLIENTS
    gen = torch.Generator(device=dev).manual_seed(0)

    def case(p, rows=r):
        x = 0.01 * torch.randn(rows, p, generator=gen, device=dev)
        x[rows - 1] = 0.0                    # a non-participant's row
        return x, torch.rand(rows, p, generator=gen, device=dev)

    leaves = [case(p) for p in sizes]
    extra = [case(p) for p in (1, 4097, 30_001, 2_359_297)]  # odd, long
    nan_x, nan_u = case(40_000, 3)             # a NaN and an inf: the max
    nan_x[0, 123], nan_x[1, 9] = float("nan"), float("inf")  # keeps NaN
    extra.append((nan_x, nan_u))
    xs, us = [x for x, _ in leaves + extra], [u for _, u in leaves + extra]
    lx, lu = xs[:len(leaves)], us[:len(leaves)]
    name = torch.cuda.get_device_name(0)
    out = {}
    for bits in (8, 4):
        want = quantize_pack_group_ref(xs, us, bits)
        # rows of 1 chunk, rows of up to 8 that wait in place for their
        # maxima, and rows of 288 (and 289) that take two visits
        before = qops.quantize_pack_group.launches
        got = qops.quantize_pack_group(xs, us, bits)
        torch.cuda.synchronize()
        check(qops.quantize_pack_group.launches == before + 1,
              f"quantize_pack bits {bits}: {len(xs)} leaves took "
              f"{qops.quantize_pack_group.launches - before} launches")
        bad = [i for i, (g, w) in enumerate(zip(got, want))
               if not _same_codes(g, w)]
        check(not bad, f"quantize_pack bits {bits}: leaves {bad[:5]} differ "
              f"from the plain version")
        again = qops.quantize_pack_group(xs, us, bits)
        check(all(_same_codes(a, g) for a, g in zip(again, got)),
              f"quantize_pack bits {bits} is not bitwise repeatable")
        check(bool(got[-1][1][0].isnan()) and bool(got[-1][1][1].isinf()),
              "the NaN row's scale is not NaN or the inf row's not inf")
        if bits == 4:
            check(bool((got[0][0][r - 1] == 0x88).all()),
                  "an all-zero row did not pack to 0x88")
        for x, u in (leaves[0], extra[1]):   # one leaf: a group of one
            check(_same_codes(qops.quantize_pack(x, u, bits),
                              quantize_pack_ref(x, u, bits)),
                  f"quantize_pack bits {bits}: a single leaf differs")
        del got, again, want
        n = r * sum(sizes)
        code_bytes = n if bits == 8 else r * sum((p + 1) // 2 for p in sizes)
        nbytes = 8 * n + code_bytes + 4 * r * len(sizes)
        ops_ = 7 * n              # |x|, max, mul, add, floor, two clamps
        by_bytes, by_ops = nbytes / memory_rate(name), ops_ / FP32_PEAK
        bound = max(by_bytes, by_ops) * 1e3
        ms = device_ms(lambda: qops.quantize_pack_group(lx, lu, bits))
        wall = median_ms(lambda: qops.quantize_pack_group(lx, lu, bits))
        plain_ms = median_ms(lambda: quantize_pack_group_ref(lx, lu, bits),
                             iters=10)
        # the largest single leaf, 8 x 2,359,296 elements
        x, u = max(leaves, key=lambda xu: xu[0].numel())
        one_bytes = x.numel() * (9 if bits == 8 else 8.5) + 4 * r
        one_ms = device_ms(lambda: qops.quantize_pack(x, u, bits))
        one_plain = median_ms(lambda: quantize_pack_ref(x, u, bits))
        print(f"[codec-kernel] bits {bits}: largest leaf {tuple(x.shape)} "
              f"alone: median ms kernel {one_ms:.4f} (device, L2 flushed), "
              f"plain {one_plain:.4f}; bound "
              f"{one_bytes / memory_rate(name) * 1e3:.4f}")
        print(f"[codec-kernel] bits {bits}: {len(leaves)} VGG16 leaf shapes "
              f"x {r} rows (one all zero) + {len(extra)} odd, long and NaN "
              f"leaves in one launch: codes and scales bitwise equal to the "
              f"plain version; two launches bitwise equal; single leaves "
              f"too")
        print(f"[codec-kernel] bits {bits}: the grouped call over the 80 "
              f"leaves (one launch): median ms {ms:.4f} on the device (L2 "
              f"flushed), {wall:.4f} with the host's enqueue; plain "
              f"{plain_ms:.4f} (80 calls, with the host); bound {bound:.4f}: "
              f"{nbytes / 1e9:.4f} GB at {memory_rate(name) / 1e12:.2f} "
              f"TB/s is {by_bytes * 1e3:.4f}, {ops_ / 1e9:.3f} G ops at "
              f"{FP32_PEAK / 1e12:.0f} TFLOP/s is {by_ops * 1e3:.4f}; kernel "
              f"at {bound / ms:.1%} of the bound; {ms / PREVIOUS_MS['k2']:.3f}x "
              f"the previous design's device time for one round's 80 calls "
              f"({PREVIOUS_MS['k2']} ms)")
        out[bits] = {"ms": ms, "wall_ms": wall, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": "bytes"
                     if by_bytes >= by_ops else "operations"}
    return {"name": "quantize_pack", "route": "cuda",
            "source": "src/repro_torch/kernels/codec/csrc/quantize_pack.cu",
            "replaces": "src/repro/kernels/codec/kernel.py:60",
            "max_abs_err": 0.0, **out[8], "library_ms": None}


class Capture:
    """Server hook: keeps each round's metrics for the checks below."""

    def __init__(self):
        self.rounds = []

    def on_round_start(self, server, round_idx, weights):
        return None

    def on_round_end(self, server, record, metrics):
        self.rounds.append((record, metrics))

    def on_fit_end(self, server, history):
        pass


def _check_wire_bytes(fed, cap, tag):
    """Every round: claimed (sel @ codec_unit_bytes) == encoded wire
    bytes of the round's slot plan == billed uplink; returns the fp32
    uplink of the same selections beside the billed one."""
    from repro_torch.core import codec_unit_bytes, encoded_wire_bytes
    from repro_torch.core.comm import unit_bytes
    from repro_torch.core.masking import slot_plan

    server = fed.server
    params = {p: x.cpu() for p, x in fed.params.items()}
    cub = codec_unit_bytes(server.codec, fed.assign, params, fed.fl)
    ub = unit_bytes(fed.assign, params)
    n_slots = fed.fl.resolve_n_slots(fed.assign.n_units)
    out = []
    for rec, m in cap.rounds:
        sel = m["sel"]
        plans = [slot_plan(fed.assign, s, n_slots, params) for s in sel]
        valid = {p: torch.stack([pl[1][p] for pl in plans]) for p in params}
        enc = encoded_wire_bytes(server.codec, fed.assign, params, valid,
                                 fed.fl)
        claimed = float((sel.numpy() @ cub).sum())
        check(claimed == enc == rec.uplink_bytes,
              f"{tag} round {rec.round}: claimed {claimed}, encoded {enc}, "
              f"billed {rec.uplink_bytes}")
        out.append((rec.uplink_bytes, float((sel.numpy() @ ub).sum())))
    return out


def phase_packed_round(dev):
    from repro_torch import paper_round
    from repro_torch.core import Codec, get_codec
    from repro_torch.kernels.codec import ops as qops
    from repro_torch.kernels.masked_agg import ops

    fed = paper_round.build(dev, eval_images=256, packed=True, codec="qint8")
    frozen, cap = FrozenDeltaCheck(fed.assign), Capture()
    fed.server.add_hook(frozen).add_hook(cap)
    n_leaves = len(fed.params)
    torch.cuda.reset_peak_memory_stats()

    qops.reset_launch_counts()
    ops.reset_launch_counts()
    hist = fed.fit(ROUNDS, log_every=1)
    torch.cuda.synchronize()
    launches = qops.quantize_pack_group.launches
    k1 = ops.masked_agg.launches
    peak = torch.cuda.max_memory_allocated()

    check(all(math.isfinite(r.loss) for r in hist), "non-finite loss")
    check(launches == ROUNDS,
          f"quantize_pack launched {launches} times in {ROUNDS} rounds of "
          f"{n_leaves} leaves: expected one grouped launch a round")
    check(k1 == 0, f"the packed round launched masked_agg {k1} times")
    check(frozen.checked > 0, "no frozen unit was checked")
    wire = _check_wire_bytes(fed, cap, "packed-round")
    for r, (billed, fp32) in zip(hist, wire):
        print(f"[packed-round] {r.round}: loss {r.loss:.4f} eval accuracy "
              f"{r.eval_metric:.4f} {r.seconds:.3f} s uplink {billed:.0f} B "
              f"qint8 = claimed = encoded; fp32 on the same selections "
              f"{fp32:.0f} B ({fp32 / billed:.4f}x)")
    grouped = ({p: x.clone() for p, x in fed.params.items()},
               list(fed.server.sel_history), fed.comm_summary(),
               [r.seconds for r in hist])
    n_frozen = frozen.checked
    del fed, frozen, cap
    torch.cuda.empty_cache()

    # the same rounds with the codec's rows_roundtrip put back to the
    # per-leaf loop (one quantize_pack call a leaf): bitwise the same round
    cls = type(get_codec("qint8"))
    cls.rows_roundtrip = Codec.rows_roundtrip
    try:
        fed = paper_round.build(dev, eval_images=256, packed=True,
                                codec="qint8")
        torch.cuda.reset_peak_memory_stats()
        qops.reset_launch_counts()
        per_leaf = fed.fit(ROUNDS)
        torch.cuda.synchronize()
        per_leaf_peak = torch.cuda.max_memory_allocated()
    finally:
        del cls.rows_roundtrip
    check(qops.quantize_pack_group.launches == ROUNDS * n_leaves,
          f"the per-leaf loop launched quantize_pack "
          f"{qops.quantize_pack_group.launches} times")
    diff = [p for p in fed.params if not torch.equal(fed.params[p],
                                                     grouped[0][p])]
    check(not diff, f"{len(diff)} parameters differ between the grouped and "
          f"the per-leaf codec round, e.g. {diff[:3]}")
    check(all(np.array_equal(a, b) for a, b in
              zip(fed.server.sel_history, grouped[1])) and
          len(fed.server.sel_history) == len(grouped[1]),
          "sel_history differs between the grouped and per-leaf rounds")
    check(fed.comm_summary() == grouped[2],
          f"comm_summary differs: {fed.comm_summary()} vs {grouped[2]}")
    print(f"[packed-round] quantize_pack launches {launches} "
          f"({launches // ROUNDS} grouped launch per round over {n_leaves} "
          f"leaves), masked_agg launches {k1}; frozen (client, leaf) decoded "
          f"deltas checked exactly zero: {n_frozen}; peak memory "
          f"{peak / 2**30:.2f} GiB")
    print(f"[packed-round] the same {ROUNDS} rounds with rows_roundtrip put "
          f"back to the per-leaf loop ({ROUNDS * n_leaves} launches): "
          f"{len(grouped[0])} parameters, {len(grouped[1])} sel_history rows "
          f"and comm_summary bitwise equal; round seconds grouped "
          + ", ".join(f"{x:.3f}" for x in grouped[3]) + ", per leaf "
          + ", ".join(f"{r.seconds:.3f}" for r in per_leaf)
          + f"; peak memory per leaf {per_leaf_peak / 2**30:.2f} GiB")
    del fed
    torch.cuda.empty_cache()
    return launches


def phase_codec_rounds(dev):
    from repro_torch import paper_round
    from repro_torch.core import get_codec
    from repro_torch.kernels.codec import ops as qops

    fed = paper_round.build(dev, packed=True, codec="qint4")
    cap = Capture()
    fed.server.add_hook(FrozenDeltaCheck(fed.assign)).add_hook(cap)
    qops.reset_launch_counts()
    (rec,) = fed.fit(1)
    torch.cuda.synchronize()
    check(math.isfinite(rec.loss), "qint4: non-finite loss")
    check(qops.quantize_pack_group.launches == 1,
          f"qint4: quantize_pack launched "
          f"{qops.quantize_pack_group.launches} times for "
          f"{len(fed.params)} leaves: expected one grouped launch")
    ((billed, fp32),) = _check_wire_bytes(fed, cap, "qint4")
    print(f"[codec-rounds] qint4: loss {rec.loss:.4f} {rec.seconds:.3f} s "
          f"uplink {billed:.0f} B = claimed = encoded; fp32 {fp32:.0f} B "
          f"({fp32 / billed:.4f}x)")

    # topk_ef: record what the codec saw and sent, then hold the residual
    # identity on the round's own tensors
    codec = get_codec("topk_ef")
    seen = []

    def recording(x2, draw, fl=None):
        xh = type(codec).row_roundtrip(codec, x2, draw, fl)
        seen.append(x2)
        return xh

    codec.row_roundtrip = recording
    try:
        fed = paper_round.build(dev, packed=True, codec="topk_ef")
        cap = Capture()
        fed.server.add_hook(FrozenDeltaCheck(fed.assign)).add_hook(cap)
        torch.cuda.reset_peak_memory_stats()
        (rec,) = fed.fit(1)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    finally:
        del codec.row_roundtrip
    check(math.isfinite(rec.loss), "topk_ef: non-finite loss")
    (_, m), = cap.rounds
    state = fed.server.codec_state
    sel = m["sel"]
    weights = torch.as_tensor(rec.effective_weights)
    n_ok = 0
    check(len(seen) == len(state), "topk_ef: one codec call per leaf")
    for (path, res), x2 in zip(state.items(), seen):
        lu = fed.assign.leaf_units[path]
        check(res.dtype == torch.float32 and
              tuple(res.shape) == (sel.shape[0],) + tuple(fed.params[path].shape),
              f"topk_ef state {path}: {res.dtype} {tuple(res.shape)}")
        ok = ((sel[:, lu.base] > 0) & (weights > 0)).to(dev)
        x = x2.reshape(res.shape)
        dec = m["deltas"][path]
        check(torch.equal((dec + res)[ok], x[ok]),
              f"topk_ef {path}: decoded + residual != signal")
        check(bool((res[~ok] == 0).all()) and bool((dec[~ok] == 0).all()),
              f"topk_ef {path}: a non-participant row moved")
        n_ok += int(ok.sum())
    ((billed, fp32),) = _check_wire_bytes(fed, cap, "topk_ef")
    ef_bytes = sum(x.numel() * x.element_size() for x in state.values())
    print(f"[codec-rounds] topk_ef: loss {rec.loss:.4f} {rec.seconds:.3f} s "
          f"uplink {billed:.0f} B = claimed = encoded; fp32 {fp32:.0f} B; "
          f"decoded + new residual == signal on {n_ok} (client, leaf) rows; "
          f"EF state {ef_bytes / 1e6:.1f} MB; peak memory "
          f"{peak / 2**30:.2f} GiB")



# -- the paper's other tasks and topologies ------------------------------------

def phase_paper_tasks(dev):
    """IMDB and CASA at full width (``repro_torch/paper_tasks.py``), 3 hub
    rounds each through K1, then each built twice for 2 rounds."""
    from repro_torch import paper_tasks
    from repro_torch.core.comm import table4_row
    from repro_torch.kernels.masked_agg import ops

    launches = {}
    for task in paper_tasks.TASKS:
        fed = paper_tasks.build(task, dev)
        frozen = FrozenDeltaCheck(fed.assign)
        fed.server.add_hook(frozen)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        hist = fed.fit(ROUNDS)
        torch.cuda.synchronize()
        n = ops.masked_agg.launches
        check(all(math.isfinite(r.loss) for r in hist),
              f"{task}: non-finite loss")
        check(n == ROUNDS, f"{task}: masked_agg launched {n} times in "
              f"{ROUNDS} rounds")
        check(frozen.checked > 0, f"{task}: no frozen unit was checked")
        summ = fed.comm_summary()
        t4 = table4_row(fed.assign, fed.params,
                        np.stack(fed.server.sel_history))
        check(all(summ[k] == v for k, v in t4.items()),
              f"{task}: comm_summary {summ} != table4_row {t4}")
        for r in hist:
            print(f"[paper-tasks] {task} {r.round}: loss {r.loss:.4f} eval "
                  f"accuracy {r.eval_metric:.4f} {r.seconds:.3f} s uplink "
                  f"{r.uplink_bytes:.0f} B")
        n_params = sum(x.numel() for x in fed.params.values())
        print(f"[paper-tasks] {task}: {n_params} params, "
              f"{fed.fl.n_train_units} of {fed.assign.n_units} units a round, "
              f"{fed.fl.n_clients} clients; masked_agg launches {n}; "
              f"frozen (client, leaf) deltas exactly zero: {frozen.checked}; "
              f"comm_summary == table4_row; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        launches[task] = n

        feds = []
        for _ in range(2):
            f = paper_tasks.build(task, dev, evaluate=False)
            f.fit(REPEAT_ROUNDS)
            torch.cuda.synchronize()
            feds.append(f)
        a, b = feds
        diff = [p for p in a.params
                if not torch.equal(a.params[p], b.params[p])]
        check(not diff, f"{task}: {len(diff)} parameters differ between two "
              f"identical runs, e.g. {diff[:3]}")
        check(all(np.array_equal(x, y) for x, y in
                  zip(a.server.sel_history, b.server.sel_history)),
              f"{task}: sel_history differs between two identical runs")
        print(f"[paper-tasks] {task}: built twice from one seed, "
              f"{REPEAT_ROUNDS} rounds each: {len(a.params)} parameters and "
              f"sel_history bitwise equal")
    return launches


def phase_paper_tasks_parity(dev):
    """One round of each task on the card (K1) against the same round on
    the CPU (plain aggregation), the model in float64 and the selection
    replayed, as ``[parity]`` does for VGG16."""
    from repro_torch import paper_tasks
    from repro_torch.core import Replay

    for task in paper_tasks.TASKS:
        n_units = {"imdb": 4, "casa": 6}[task]
        sel = np.zeros((paper_tasks.N_CLIENTS, n_units), np.float32)
        rng = np.random.default_rng(3)
        for row in sel:
            row[rng.choice(n_units, paper_tasks.N_TRAIN[task],
                           replace=False)] = 1.0
        out = {}
        for d in (dev, torch.device("cpu")):
            fed = paper_tasks.build(task, d, evaluate=False,
                                    dtype=torch.float64,
                                    strategy=Replay([sel]))
            fed.fit(1)
            out[d.type] = {p: v.cpu() for p, v in fed.params.items()}
        err = {p: float((out["cuda"][p] - out["cpu"][p]).abs().max())
               for p in out["cpu"]}
        worst = max(err, key=err.get)
        check(err[worst] <= PARITY_TOL,
              f"{task} parity {worst}: card vs CPU max abs err "
              f"{err[worst]} > {PARITY_TOL}")
        print(f"[paper-tasks-parity] {task}: one hub round in float64, "
              f"{paper_tasks.N_CLIENTS} clients: card (kernel) vs CPU (plain) "
              f"max abs err {err[worst]:.3e} at {worst} (tol {PARITY_TOL})")


class StateBefore:
    """Server hook: keeps a copy of the server state at a round's start."""

    def __init__(self):
        self.states = []

    def on_round_start(self, server, round_idx, weights):
        self.states.append({p: x.clone() for p, x in server.params.items()})
        return None

    def on_round_end(self, server, record, metrics):
        pass

    def on_fit_end(self, server, history):
        pass


def phase_hier_round(dev):
    """VGG16 at full width under 2 edge aggregators of 4 clients: 3 dense
    rounds (K1 once a round, over the E planes of the hub combine), then
    2 packed qint8 rounds (K2 once a round, K1 never).  Returns K1's and
    K2's launches and the hub combine's K1 inputs from the last round."""
    from repro_torch import paper_round
    from repro_torch.core import codec_unit_bytes
    from repro_torch.core.aggregation import (hierarchical_edge_partials,
                                              hierarchical_masked_fedavg)
    from repro_torch.core.comm import (edge_membership, hub_round_bytes,
                                       hierarchical_round_bytes, unit_bytes)
    from repro_torch.core.topology import _fused_hier_aggregate
    from repro_torch.kernels.codec import ops as qops
    from repro_torch.kernels.masked_agg import ops

    fed = paper_round.build(dev, topology="hierarchical", n_edges=2)
    check(fed.fl.resolve_fused_agg(fed.device), "fused_agg did not resolve on")
    frozen, cap = FrozenDeltaCheck(fed.assign), Capture()
    fed.server.add_hook(frozen).add_hook(cap)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    hist = fed.fit(ROUNDS)
    torch.cuda.synchronize()
    k1 = ops.masked_agg.launches
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(r.loss) for r in hist), "non-finite loss")
    check(k1 == ROUNDS, f"masked_agg launched {k1} times in {ROUNDS} "
          f"hierarchical rounds")
    check(frozen.checked > 0, "no frozen unit was checked")
    params = {p: x.cpu() for p, x in fed.params.items()}
    ub = unit_bytes(fed.assign, params)
    mem_np = edge_membership(fed.fl.n_clients, 2)
    billed, flat = [], []
    for rec, m in cap.rounds:
        sel = m["sel"].numpy()
        want = hierarchical_round_bytes(sel, ub, mem_np)["uplink"]
        check(rec.uplink_bytes == want, f"round {rec.round}: billed "
              f"{rec.uplink_bytes} != hierarchical_round_bytes {want}")
        hub = hub_round_bytes(sel, ub)["uplink"]
        check(rec.uplink_bytes <= hub, f"round {rec.round}: edge->hub "
              f"{rec.uplink_bytes} above the flat hub's {hub}")
        billed.append(rec.uplink_bytes)
        flat.append(hub)
    check(sum(billed) < sum(flat), "edge->hub bytes not below the flat hub")
    for r, b, f in zip(hist, billed, flat):
        print(f"[hier-round] {r.round}: loss {r.loss:.4f} {r.seconds:.3f} s "
              f"edge->hub uplink {b:.0f} B = hierarchical_round_bytes; flat "
              f"hub on the same selections {f:.0f} B ({b / f:.4f})")

    # the fused two-stage aggregate on the last round's deltas against the
    # plain hierarchical_masked_fedavg (K1 launches here are not counted)
    _, m = cap.rounds[-1]
    mem = torch.as_tensor(mem_np)
    w = torch.as_tensor(cap.rounds[-1][0].effective_weights)
    g = fed.params
    fused = _fused_hier_aggregate(fed.assign, mem)(g, m["deltas"], m["sel"],
                                                   w)
    plain = hierarchical_masked_fedavg(g, m["deltas"], m["sel"], w,
                                       fed.assign, mem)
    agg_err = max(float((fused[p] - plain[p]).abs().max()) for p in g)
    check(all(torch.allclose(fused[p], plain[p], atol=TOL, rtol=TOL)
              for p in g), f"fused hierarchical vs plain: {agg_err}")
    means, e_den = hierarchical_edge_partials(m["deltas"], m["sel"], w,
                                              fed.assign, mem)
    plan = ops.build_agg_plan(fed.assign, g)
    g_t = ops.pack_into(plan, g, ops.new_tile_buffer(plan, device=dev)
                        .zero_())
    d_t = ops.pack_into(plan, means, ops.new_tile_buffer(
        plan, (2,), device=dev).zero_())
    w_t = ops.row_weights(plan, e_den, dev)
    print(f"[hier-round] masked_agg launches {k1} (one a round over E=2 edge "
          f"planes, T={plan.n_rows}); frozen (client, leaf) deltas exactly "
          f"zero: {frozen.checked}; fused two-stage aggregate vs "
          f"hierarchical_masked_fedavg on round {hist[-1].round}'s deltas: "
          f"max abs err {agg_err:.3e} (tol {TOL}); peak memory "
          f"{peak / 2**30:.2f} GiB")
    del fed, frozen, cap, fused, plain, means, m
    torch.cuda.empty_cache()

    fed = paper_round.build(dev, topology="hierarchical", n_edges=2,
                            packed=True, codec="qint8")
    frozen, cap = FrozenDeltaCheck(fed.assign), Capture()
    fed.server.add_hook(frozen).add_hook(cap)
    qops.reset_launch_counts()
    ops.reset_launch_counts()
    hist = fed.fit(REPEAT_ROUNDS)
    torch.cuda.synchronize()
    k2 = qops.quantize_pack_group.launches
    check(all(math.isfinite(r.loss) for r in hist), "packed: non-finite loss")
    check(k2 == REPEAT_ROUNDS, f"quantize_pack launched {k2} times in "
          f"{REPEAT_ROUNDS} packed hierarchical rounds")
    check(ops.masked_agg.launches == 0, f"the packed hierarchical round "
          f"launched masked_agg {ops.masked_agg.launches} times")
    check(frozen.checked > 0, "packed: no frozen unit was checked")
    cub = codec_unit_bytes(fed.server.codec, fed.assign, params, fed.fl)
    for rec, m in cap.rounds:
        sel = m["sel"].numpy()
        want = hierarchical_round_bytes(sel, cub, mem_np)["uplink"]
        check(rec.uplink_bytes == want, f"packed round {rec.round}: billed "
              f"{rec.uplink_bytes} != the per-edge union at wire width {want}")
        fp32 = hierarchical_round_bytes(sel, ub, mem_np)["uplink"]
        print(f"[hier-round] packed qint8 {rec.round}: loss {rec.loss:.4f} "
              f"{rec.seconds:.3f} s edge->hub uplink {rec.uplink_bytes:.0f} B "
              f"= per-edge union at wire width; fp32 {fp32:.0f} B")
    print(f"[hier-round] packed qint8: quantize_pack launches {k2}, "
          f"masked_agg 0; frozen decoded deltas exactly zero: "
          f"{frozen.checked}")
    del fed
    torch.cuda.empty_cache()
    return k1, k2, (g_t, d_t, w_t)


def phase_gossip_round(dev):
    """VGG16 at full width on a ring of 8 replicas, 2 rounds: no K1, the
    gossip bill, and mixing that keeps the replicas' fp32 mean."""
    from repro_torch import paper_round
    from repro_torch.core.comm import gossip_round_bytes, unit_bytes
    from repro_torch.kernels.masked_agg import ops

    fed = paper_round.build(dev, topology="gossip")
    before, cap = StateBefore(), Capture()
    fed.server.add_hook(before).add_hook(cap)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    hist = fed.fit(REPEAT_ROUNDS)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(r.loss) for r in hist), "non-finite loss")
    check(ops.masked_agg.launches == 0,
          f"gossip launched masked_agg {ops.masked_agg.launches} times")
    ub = unit_bytes(fed.assign, {p: x.cpu() for p, x in fed.params.items()})
    for rec, m in cap.rounds:
        want = gossip_round_bytes(m["sel"].numpy(), ub)["uplink"]
        check(rec.uplink_bytes == want, f"round {rec.round}: billed "
              f"{rec.uplink_bytes} != gossip_round_bytes {want}")
    # the last round: trained replicas (updates of clients of weight > 0
    # applied) against the mixed ones the server now holds
    rec, m = cap.rounds[-1]
    keep = torch.as_tensor(rec.effective_weights, device=dev) > 0
    worst = 0.0
    for p, x in before.states[-1].items():
        trained = torch.where(keep.reshape((-1,) + (1,) * (x.ndim - 1)),
                              x + m["deltas"][p], x)
        diff = float((fed.server.params[p].double().mean(0)
                      - trained.double().mean(0)).abs().max())
        scale = max(float(trained.abs().max()), 1e-30)
        worst = max(worst, diff / scale)
    check(worst <= 1e-6, f"mixing moved the replica mean by {worst} relative")
    state_bytes = sum(x.numel() * x.element_size()
                      for x in fed.server.params.values())
    for r in hist:
        print(f"[gossip-round] {r.round}: loss {r.loss:.4f} {r.seconds:.3f} s "
              f"peer bytes {r.uplink_bytes:.0f} B = gossip_round_bytes")
    print(f"[gossip-round] masked_agg launches 0; replica mean before vs "
          f"after mixing: max {worst:.3e} relative to the largest entry "
          f"(tol 1e-6); state {fed.fl.n_clients} replicas, "
          f"{state_bytes / 1e6:.1f} MB; peak memory {peak / 2**30:.2f} GiB")
    del fed, before, cap
    torch.cuda.empty_cache()


# -- scored selection and checkpoints ------------------------------------------

SCORED_ROUNDS = 4
NORM_RTOL = 1e-5         # telemetry: card vs CPU, and packed vs dense


class ScoredCheck:
    """Server hook: every round's telemetry is exactly zero on frozen
    units and positive on trained ones; after the state update (which
    runs before this hook) ``counts`` equal the column sums of the
    active clients' selections so far and every unit trained so far has
    a positive score.  Keeps (sel, unit_sqnorm) of each round on the
    CPU."""

    def __init__(self):
        self.rounds = []
        self.counts = None

    def on_round_start(self, server, round_idx, weights):
        return None

    def on_round_end(self, server, record, metrics):
        sel = metrics["sel"].float()
        sq = metrics["unit_sqnorm"].cpu()
        check(tuple(sq.shape) == tuple(sel.shape),
              f"round {record.round}: unit_sqnorm {tuple(sq.shape)}")
        check(bool((sq[sel == 0] == 0).all()),
              f"round {record.round}: telemetry on a frozen unit")
        check(bool((sq[sel > 0] > 0).all()),
              f"round {record.round}: a trained unit has no telemetry")
        active = torch.as_tensor(record.effective_weights) > 0
        add = (sel * active[:, None].float()).sum(0)
        self.counts = add if self.counts is None else self.counts + add
        st = server.sel_state
        check(torch.equal(st.counts, self.counts),
              f"round {record.round}: sel_state.counts {st.counts} != the "
              f"active selections' column sums {self.counts}")
        check(bool((st.scores[st.counts > 0] > 0).all()),
              f"round {record.round}: a trained unit has score 0")
        check(int(st.round) == record.round + 1,
              f"round {record.round}: sel_state.round {int(st.round)}")
        self.rounds.append((sel, sq))

    def on_fit_end(self, server, history):
        pass


def _xent64(params, batch, *, device):
    """VGG16's cross-entropy in the params' dtype.  ``vgg16_loss`` takes
    it in float32 (as the reference does); with Adam's first step
    (lr / (1 + eps / |g|)) that float32 rounding moves a parameter
    whose gradient lies near eps by more than PARITY_TOL (1.12e-5 at
    conv12/w on one scored selection), so this check keeps the whole
    gradient in float64."""
    from repro_torch.models import paper_models as pm
    logits = pm.vgg16_apply(params, batch["x"], device=device)
    y = torch.as_tensor(batch["y"], device=logits.device).long()
    return torch.nn.functional.cross_entropy(logits, y), {}


def _scored_parity(dev):
    """One score_weighted hub round, VGG16 width 0.125 in float64 (the
    loss too: ``_xent64``), on the card (K1) and on the CPU with the same
    injected Gumbel noise and the same live state, with Adam and with
    SGD: selections equal, parameters within PARITY_TOL, telemetry
    within NORM_RTOL.  Returns the worst readings."""
    from repro_torch.core import (FLConfig, SelectionState, build_round_step,
                                  build_units_flat, get_strategy)
    from repro_torch.data import cifar_like
    from repro_torch.models import paper_models as pm

    c = 3
    params = pm.init_vgg16(torch.Generator().manual_seed(1),
                           dtype=torch.float64, width_mult=0.125)
    assign = build_units_flat(params, pm.vgg16_units(params))
    u = assign.n_units
    x, y = cifar_like(c * 4, key=3)
    batches = {"x": x.reshape(c, 1, 4, 32, 32, 3), "y": y.reshape(c, 1, 4)}
    rng = np.random.default_rng(4)
    state = SelectionState(
        torch.as_tensor(rng.uniform(0.1, 3.0, u), dtype=torch.float32),
        torch.ones(u), torch.tensor(3, dtype=torch.int32))
    noise = [torch.as_tensor(-np.log(-np.log(rng.uniform(1e-6, 1.0, u))),
                             dtype=torch.float32) for _ in range(c)]
    readings = []
    for opt in ("adam", "sgd"):
        out = []
        for d in (dev, torch.device("cpu")):
            strat = type(get_strategy("score_weighted"))()
            it = iter(noise)
            strat.gumbel = lambda gen, n: next(it)
            fl = FLConfig(n_clients=c, n_train_units=7, optimizer=opt)
            step = build_round_step(functools.partial(_xent64, device=d),
                                    assign, fl, strategy=strat, device=d)
            new, m = step({p: v.to(d) for p, v in params.items()},
                          {k: torch.as_tensor(v, device=d)
                           for k, v in batches.items()},
                          torch.ones(c), None, sel_state=state)
            out.append(({p: v.cpu() for p, v in new.items()}, m["sel"],
                        m["unit_sqnorm"].cpu()))
        (p_c, sel_c, sq_c), (p_h, sel_h, sq_h) = out
        check(torch.equal(sel_c, sel_h),
              "scored parity: selections differ between card and CPU")
        err = {p: float((p_c[p] - p_h[p]).abs().max()) for p in params}
        worst = max(err, key=err.get)
        check(err[worst] <= PARITY_TOL, f"scored parity ({opt}) {worst}: "
              f"card vs CPU max abs err {err[worst]} > {PARITY_TOL}")
        rel = float(((sq_c - sq_h).abs() / sq_h.clamp_min(1e-30))
                    [sq_h > 0].max())
        check(rel <= NORM_RTOL and torch.equal(sq_c == 0, sq_h == 0),
              f"scored parity ({opt}): telemetry card vs CPU relative err "
              f"{rel}")
        readings.append((opt, err[worst], worst, rel))
    return readings


def phase_scored_round(dev):
    """VGG16 at full width under the three scored strategies (4 hub rounds
    each) and ``score_weighted`` on the hierarchical topology (2 rounds):
    one K1 launch a round, the telemetry and state checks of
    ``ScoredCheck``, the bill equal to Table 4 (hub) or
    ``hierarchical_round_bytes``; then a float64 card-vs-CPU scored
    round.  Returns K1's launches by path."""
    from repro_torch import paper_round
    from repro_torch.core.comm import (edge_membership,
                                       hierarchical_round_bytes, table4_row,
                                       unit_bytes)
    from repro_torch.kernels.masked_agg import ops

    paths = {}
    runs = [(name, "hub", SCORED_ROUNDS, {}) for name in
            ("score_weighted", "depth_dropout", "successive")]
    runs.append(("score_weighted", "hierarchical", REPEAT_ROUNDS,
                 {"topology": "hierarchical", "n_edges": 2}))
    for name, topo, rounds, kw in runs:
        fed = paper_round.build(dev, strategy=name, **kw)
        check(fed.server.strategy.name == name and
              fed.server.sel_state is not None,
              f"{name}: the server holds no selection state")
        hook = ScoredCheck()
        fed.server.add_hook(hook)
        ops.reset_launch_counts()
        hist = fed.fit(rounds)
        torch.cuda.synchronize()
        k1 = ops.masked_agg.launches
        check(all(math.isfinite(r.loss) for r in hist), f"{name}: loss")
        check(k1 == rounds, f"{name} {topo}: masked_agg launched {k1} times "
              f"in {rounds} rounds")
        params = {p: x.cpu() for p, x in fed.params.items()}
        hist_sel = np.stack(fed.server.sel_history)
        if topo == "hub":
            summ, t4 = fed.comm_summary(), table4_row(fed.assign, params,
                                                      hist_sel)
            check(all(summ[k] == v for k, v in t4.items()),
                  f"{name}: comm_summary {summ} != table4_row {t4}")
        else:
            mem = edge_membership(fed.fl.n_clients, 2)
            ub = unit_bytes(fed.assign, params)
            for rec, sel in zip(hist, hist_sel):
                want = hierarchical_round_bytes(sel, ub, mem)["uplink"]
                check(rec.uplink_bytes == want, f"{name} hierarchical round "
                      f"{rec.round}: billed {rec.uplink_bytes} != {want}")
        st = fed.server.sel_state
        trained = int((st.counts > 0).sum())
        print(f"[scored-round] {name} {topo}: rounds "
              + ", ".join(f"{r.round} loss {r.loss:.4f} {r.seconds:.3f} s"
                          for r in hist)
              + f"; masked_agg launches {k1}; telemetry exact zero on every "
              f"frozen unit, positive on every trained one; sel_state.counts "
              f"== active selections' column sums ({float(st.counts.sum()):.0f}"
              f"); {trained} of {fed.assign.n_units} units trained so far, "
              f"all with a positive score (max {float(st.scores.max()):.4e});"
              f" bill == {'Table 4' if topo == 'hub' else 'hierarchical_round_bytes'}")
        paths[f"{topo} vgg16 {name}"] = k1
        del fed, hook
        torch.cuda.empty_cache()
    for opt, err, worst, rel in _scored_parity(dev):
        print(f"[scored-round] parity ({opt}): one score_weighted hub round, "
              f"VGG16 width 0.125 in float64 (loss too), 3 clients, the same "
              f"injected Gumbel noise and state: selections equal; card (K1) "
              f"vs CPU max abs err {err:.3e} at {worst} (tol {PARITY_TOL}); "
              f"telemetry relative err {rel:.3e} (tol {NORM_RTOL})")
    return paths


class _Telemetry:
    """Server hook: each round's starting params (cloned), selection and
    telemetry (on the CPU)."""

    def __init__(self):
        self.before, self.rounds = [], []

    def on_round_start(self, server, round_idx, weights):
        self.before.append({p: x.clone() for p, x in server.params.items()})
        return None

    def on_round_end(self, server, record, metrics):
        self.rounds.append((metrics["sel"].clone(),
                            metrics["unit_sqnorm"].cpu()))

    def on_fit_end(self, server, history):
        pass


def phase_scored_packed(dev):
    """The score_weighted hub round packed with qint8, 4 rounds: one K2
    launch a round and K1 never; then each round's dense telemetry on
    the packed run's own params, batches and selections against the
    packed run's, within NORM_RTOL.  Returns K2's launches."""
    from repro_torch import paper_round
    from repro_torch.core import Replay, build_round_step
    from repro_torch.kernels.codec import ops as qops
    from repro_torch.kernels.masked_agg import ops
    from repro_torch.models import paper_models as pm

    fed = paper_round.build(dev, strategy="score_weighted", packed=True,
                            codec="qint8")
    tel, chk = _Telemetry(), ScoredCheck()
    fed.server.add_hook(tel).add_hook(chk)
    qops.reset_launch_counts()
    ops.reset_launch_counts()
    hist = fed.fit(SCORED_ROUNDS)
    torch.cuda.synchronize()
    k2, k1 = qops.quantize_pack_group.launches, ops.masked_agg.launches
    check(all(math.isfinite(r.loss) for r in hist), "scored packed: loss")
    check(k2 == SCORED_ROUNDS, f"scored packed: quantize_pack launched {k2} "
          f"times in {SCORED_ROUNDS} rounds")
    check(k1 == 0, f"scored packed: masked_agg launched {k1} times")

    class ScoredReplay(Replay):
        stateful = True                  # the dense step then reports norms

    fl = dataclasses.replace(fed.fl, packed=False, codec="none")
    step = build_round_step(
        functools.partial(pm.vgg16_loss, device=dev), fed.assign, fl,
        strategy=ScoredReplay([s.numpy() for s, _ in tel.rounds]),
        device=dev)
    weights = torch.as_tensor(fed.loader.weights())
    worst = 0.0
    for r, (sel, sq_p) in enumerate(tel.rounds):
        batches = {k: torch.as_tensor(v, device=dev)
                   for k, v in fed.loader.round_batches(r).items()}
        _, m = step(tel.before[r], batches, weights, None)
        sq_d = m["unit_sqnorm"].cpu()
        check(torch.equal(m["sel"], sel), f"round {r}: replay differs")
        check(torch.equal(sq_d == 0, sq_p == 0),
              f"round {r}: packed and dense telemetry zero on other units")
        rel = float(((sq_p - sq_d).abs() / sq_d.clamp_min(1e-30))
                    [sq_d > 0].max())
        check(rel <= NORM_RTOL, f"round {r}: packed vs dense telemetry "
              f"relative err {rel} > {NORM_RTOL}")
        worst = max(worst, rel)
    for r in hist:
        print(f"[scored-packed] {r.round}: loss {r.loss:.4f} "
              f"{r.seconds:.3f} s uplink {r.uplink_bytes:.0f} B qint8")
    print(f"[scored-packed] score_weighted packed qint8: quantize_pack "
          f"launches {k2} (one a round), masked_agg 0; telemetry and state "
          f"checks as [scored-round]; dense telemetry on the same params, "
          f"batches and selections: max relative err {worst:.3e} (tol "
          f"{NORM_RTOL})")
    del fed, tel, chk, step
    torch.cuda.empty_cache()
    return k2


def _same_state(a, b):
    return set(a) == set(b) and all(torch.equal(a[p], b[p]) for p in a)


def phase_ckpt_resume(dev, smi):
    """Four runs of VGG16 at full width (score_weighted hub; packed
    topk_ef, with its error-feedback residual; packed qint8, with its
    device generator; gossip, 8 stacked replicas), each 4 rounds straight
    against 2 rounds, ``Federation.save``, a new ``Federation`` restored,
    2 more rounds: the state, the selection state, the codec state,
    ``sel_history`` and ``comm_summary()`` bitwise equal.  Prints each
    checkpoint's bytes and the save and restore wall times."""
    import shutil
    import tempfile
    from repro_torch import paper_round

    runs = [("score_weighted hub", {"strategy": "score_weighted"}),
            ("packed topk_ef", {"packed": True, "codec": "topk_ef"}),
            ("packed qint8", {"packed": True, "codec": "qint8"}),
            ("gossip", {"topology": "gossip"})]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        for tag, kw in runs:
            full = paper_round.build(dev, **kw)
            full.fit(SCORED_ROUNDS)
            half = paper_round.build(dev, **kw)
            half.fit(SCORED_ROUNDS // 2)
            path = os.path.join(tmp, tag.replace(" ", "_"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            half.save(path)
            t_save = time.perf_counter() - t0
            nbytes = os.path.getsize(path + ".npz") \
                + os.path.getsize(path + ".json")
            del half
            torch.cuda.empty_cache()
            resumed = paper_round.build(dev, **kw)
            t0 = time.perf_counter()
            meta = resumed.restore(path)
            torch.cuda.synchronize()
            t_restore = time.perf_counter() - t0
            check(meta["round"] == SCORED_ROUNDS // 2,
                  f"{tag}: restored round {meta['round']}")
            resumed.fit(SCORED_ROUNDS - SCORED_ROUNDS // 2)
            torch.cuda.synchronize()
            a, b = full.server, resumed.server
            check(_same_state(a.params, b.params),
                  f"{tag}: resumed state differs from the uninterrupted run")
            check((a.sel_state is None) == (b.sel_state is None) and
                  (a.sel_state is None or all(
                      torch.equal(x, y) for x, y in zip(a.sel_state,
                                                        b.sel_state))),
                  f"{tag}: sel_state differs")
            check((a.codec_state is None) == (b.codec_state is None) and
                  (a.codec_state is None or
                   _same_state(a.codec_state, b.codec_state)),
                  f"{tag}: codec state differs")
            check(len(a.sel_history) == len(b.sel_history) == SCORED_ROUNDS
                  and all(np.array_equal(x, y) for x, y in
                          zip(a.sel_history, b.sel_history)),
                  f"{tag}: sel_history differs")
            check(full.comm_summary() == resumed.comm_summary(),
                  f"{tag}: comm_summary differs")
            extra = []
            if a.sel_state is not None:
                extra.append("sel_state")
            if a.codec_state is not None:
                extra.append("EF residual")
            if a.codec_generator is not None:
                extra.append("codec generator")
            print(f"[ckpt-resume] {tag}: {SCORED_ROUNDS} rounds straight == "
                  f"{SCORED_ROUNDS // 2} + save + restore into a new "
                  f"Federation + {SCORED_ROUNDS - SCORED_ROUNDS // 2}, "
                  f"bitwise: state ({len(a.params)} leaves), "
                  + ", ".join(extra + ["sel_history", "comm_summary"])
                  + f"; checkpoint {nbytes} B, save {t_save:.3f} s, restore "
                  f"{t_restore:.3f} s ({smi})")
            del full, resumed, a, b
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_k1_plans(dev, hier_inputs):
    """K1 at the IMDB and CASA hub plans (10 clients) and at the
    hierarchical hub combine (VGG16, 2 edge planes from ``[hier-round]``):
    against its plain version, device medians (L2 flushed) beside the
    bound and a ``torch.bmm`` yardstick."""
    from repro_torch import paper_tasks
    from repro_torch.core import build_units_flat
    from repro_torch.models import paper_models as pm

    out = []
    cases = []
    for task in paper_tasks.TASKS:
        init = {"imdb": pm.init_imdb, "casa": pm.init_casa}[task]
        units = {"imdb": pm.imdb_units, "casa": pm.casa_units}[task]
        params = {p: x.to(dev) for p, x in
                  init(torch.Generator().manual_seed(0)).items()}
        assign = build_units_flat(params, units(params))
        plan, *_, g_t, d_t, w_t = _k1_case(dev, params, assign,
                                           paper_tasks.N_CLIENTS)
        cases.append((task, g_t, d_t, w_t, torch.as_tensor(
            plan.row_unit == 1, device=dev)))
    cases.append(("vgg16 hierarchical combine", *hier_inputs, None))
    for tag, g_t, d_t, w_t, still in cases:
        err, out_p = _k1_check(tag, g_t, d_t, w_t, still)
        m = _k1_measure(g_t, d_t, w_t, out_p, device_ms)
        t, _ = g_t.shape
        print(f"[k1-plans] {tag}: T={t} planes={d_t.shape[0]}: max abs err "
              f"{err:.3e}; device median ms kernel {m['ms']:.4f}, plain "
              f"{m['plain_ms']:.4f}, torch.bmm {m['library_ms']:.4f}; bound "
              f"{m['bound_ms']:.4f} (the kernel at "
              f"{m['bound_ms'] / m['ms']:.1%} of it): {m['text']}")
        out.append({"plan": tag, "rows": t, "planes": int(d_t.shape[0]),
                    "max_abs_err": err, "ms": m["ms"],
                    "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                    "library_ms": m["library_ms"]})
    return out

# -- K3 and the serving path ---------------------------------------------------

QWEN3_PARAMS = 1_720_574_976     # the reference's init at full width
LOGIT_TOL = 1e-3                 # card: continuous (K3) vs static (plain)
FLUSH_FLOATS = 16 << 20          # 64 MB: more than the H100's 50 MB L2


def device_ms(fn, iters=20, warmup=3):
    """Median device time of ``fn`` with L2 flushed before each call.

    The host enqueues every (flush, event, call, event) behind a GPU sleep,
    so the window between the events holds the device work of ``fn``
    alone, not the host's enqueue."""
    flush = torch.empty(FLUSH_FLOATS, device="cuda")
    for _ in range(warmup):
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
    return float(np.median([a.elapsed_time(b) for a, b in evs]))


def _paged_case(dev, b, mp, lo, hi, dtype, seed, h=16, hkv=8, hd=128, ps=16):
    """qwen3's heads; sequence i owns mp pages scattered over the pool by a
    random permutation (8 pages nobody owns, page 0 the trash page);
    ragged valid lengths in [lo, hi]; table entries past them -> 0."""
    n_pages = 1 + b * mp + 8
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, 1, h, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(n_pages, ps, hkv, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(n_pages, ps, hkv, hd, generator=gen, device=dev).to(dtype)
    rng = np.random.default_rng(seed)
    valid = rng.integers(lo, hi + 1, b)
    owned = rng.permutation(np.arange(1, n_pages))[:b * mp].reshape(b, mp)
    pt = np.where(np.arange(mp)[None] * ps < valid[:, None], owned, 0)
    return (q, k, v, torch.as_tensor(pt, dtype=torch.int32, device=dev),
            torch.as_tensor(valid, dtype=torch.int32, device=dev))


def _sdpa(q, k, v, pt, valid):
    """Yardstick (never called by the port): gather the pages, then one
    scaled_dot_product_attention with GQA and the valid mask."""
    import torch.nn.functional as F
    b, _, h, hd = q.shape
    ps, hkv = k.shape[1], k.shape[2]
    s = pt.shape[1] * ps
    kd = k[pt.long()].reshape(b, s, hkv, hd).transpose(1, 2)
    vd = v[pt.long()].reshape(b, s, hkv, hd).transpose(1, 2)
    mask = (torch.arange(s, device=q.device)[None] < valid[:, None])
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), kd, vd, attn_mask=mask[:, None, None, :],
        enable_gqa=True).transpose(1, 2)


def _no_sync(fn):
    """``fn()`` under ``set_sync_debug_mode("error")``: a host sync inside
    raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _bf16_bar(tag, out, want, valid, pl, plain):
    """The bf16 output ``out`` held element by element to ``want``, the
    fp32 plain version (``ref.bf16_error_ratio``), and two wrong outputs
    that must fail that bar: ``plain(lengths)`` rounded to bf16 with the
    last split's span, or the last ring tile, of every sequence longer
    than it left out (what a combine that dropped a working split's
    partial, or a block that skipped its last tile, would give).  Returns
    the line to print."""
    from repro_torch.kernels.flash_decode.ref import (BF16_ATOL, BF16_REL,
                                                      bf16_error_ratio)
    ratio = bf16_error_ratio(out, want)
    excess = float(((out.float() - want).abs() - BF16_REL * want.abs()).max())
    check(ratio <= 1.0, f"{tag}: bf16 output outside the element-wise bar "
          f"({ratio:.3f} of it; largest excess over 2^-8|y| {excess:.3e})")
    planted = {}
    for what, n in (("split", pl.span), ("tile", pl.tile)):
        short = torch.where(valid > n, valid - n, valid)
        planted[what] = bf16_error_ratio(plain(short).to(torch.bfloat16),
                                         want)
        check(planted[what] > 1.0, f"{tag}: the output with each sequence's "
              f"last {what} ({n} tokens) left out passes the element-wise "
              f"bar ({planted[what]:.3f} of it)")
    return (f"{tag}: element by element vs fp32 plain, |x-y| <= 2^-8|y| + "
            f"{BF16_ATOL:.3e}: kernel at {ratio:.4f} of the bar (largest "
            f"excess over 2^-8|y| {excess:.3e}); planted, last split "
            f"({pl.span} tokens) left out {planted['split']:.1f}x, last tile "
            f"({pl.tile}) left out {planted['tile']:.1f}x")


def _plan_text(pl):
    return (f"plan {pl.n_splits} split(s) x {pl.span} tokens (tiles of "
            f"{pl.tile}), {pl.blocks} blocks, workspace "
            f"{pl.workspace_bytes} B")


def phase_decode_kernel(dev):
    from repro_torch.kernels.flash_decode import ops as fops
    from repro_torch.kernels.flash_decode.ref import paged_decode_ref
    from repro_torch import serve_workload as sw

    name = torch.cuda.get_device_name(0)
    max_len = sw.PROMPT_LEN + sw.GEN + sw.GEN_SPREAD - 1 + 8
    mp_serve = -(-max_len // sw.PAGE_SIZE)
    shapes = {  # the serving shape: 128-token prompts plus 1..47 tokens
        "serving": (sw.N_SLOTS, mp_serve, sw.PROMPT_LEN + 1,
                    sw.PROMPT_LEN + sw.GEN + sw.GEN_SPREAD - 1),
        "long": (8, 256, 3072, 4096)}
    row = None
    for shape, (b, mp, lo, hi) in shapes.items():
        for dtype, tol in ((torch.float32, TOL), (torch.bfloat16, 3e-2)):
            q, k, v, pt, valid = _paged_case(dev, b, mp, lo, hi, dtype, 1)
            out = _no_sync(lambda: fops.paged_decode_attention(
                q, k, v, pt, valid))
            kf, vf = k.float(), v.float()
            want = paged_decode_ref(q.float(), kf, vf, pt, valid)
            torch.cuda.synchronize()
            err = float((out.float() - want).abs().max())
            tag = f"[decode-kernel] {shape} {str(dtype)[6:]}"
            check(out.dtype == dtype and err <= tol,
                  f"{tag}: max abs err vs plain {err} > {tol}")
            h, hd = q.shape[2], q.shape[3]
            hkv, ps = k.shape[2], k.shape[1]
            pl = fops.plan(b, hkv, h // hkv, mp, ps, hd, dtype, dev)
            bar = (_bf16_bar(tag, out, want, valid, pl,
                             lambda vl: paged_decode_ref(q.float(), kf, vf,
                                                         pt, vl))
                   if dtype == torch.bfloat16 else None)
            del kf, vf
            check(torch.equal(out, fops.paged_decode_attention(
                q, k, v, pt, valid)), f"{tag}: not bitwise repeatable")
            owned = torch.zeros(k.shape[0], dtype=torch.bool, device=dev)
            owned[pt.long().flatten()] = True
            owned[0] = False
            kn, vn = k.clone(), v.clone()
            kn[~owned] = float("nan")
            vn[~owned] = float("nan")
            nan_out = fops.paged_decode_attention(q, kn, vn, pt, valid)
            check(bool(torch.isfinite(nan_out).all()) and
                  torch.equal(nan_out, out),
                  f"{tag}: NaN in the trash page or unowned pages reached "
                  f"the output")
            lib = _sdpa(q, k, v, pt, valid)
            lib_err = float((lib.float() - want).abs().max())
            check(lib_err <= (1e-3 if dtype == torch.float32 else 5e-2),
                  f"{tag}: the sdpa yardstick disagrees by {lib_err}")
            ms = device_ms(lambda: fops.paged_decode_attention(
                q, k, v, pt, valid))
            plain_ms = device_ms(lambda: paged_decode_ref(q, k, v, pt, valid))
            library_ms = device_ms(lambda: _sdpa(q, k, v, pt, valid))
            ntok = int(valid.sum())
            pages = int(((valid + ps - 1) // ps).sum())
            nbytes = (q.element_size() * (2 * ntok * hkv * hd + 2 * b * h * hd)
                      + 4 * (pages + b))
            flops = 4 * ntok * h * hd
            by_bytes, by_ops = nbytes / memory_rate(name), flops / FP32_PEAK
            bound = max(by_bytes, by_ops) * 1e3
            print(f"{tag}: B={b} H={h} Hkv={hkv} hd={hd} pages of {ps}, "
                  f"table width {mp}, valid {int(valid.min())}..."
                  f"{int(valid.max())} ({ntok} tokens): max abs err vs plain "
                  f"{err:.3e} (tol {tol}), sdpa yardstick {lib_err:.3e}; "
                  f"bitwise repeatable; NaN trash/unowned pages never read")
            if bar:
                print(bar)
            print(f"{tag}: {_plan_text(pl)}; no host sync")
            print(f"{tag}: median device ms (L2 flushed): kernel {ms:.4f}, "
                  f"plain {plain_ms:.4f}, gather + sdpa {library_ms:.4f}; "
                  f"bound {bound:.4f}: {nbytes / 1e6:.2f} MB at "
                  f"{memory_rate(name) / 1e12:.2f} TB/s is "
                  f"{by_bytes * 1e3:.4f}, {flops / 1e9:.3f} GFLOP at "
                  f"{FP32_PEAK / 1e12:.0f} TFLOP/s is {by_ops * 1e3:.4f}; "
                  f"kernel at {bound / ms:.1%} of the bound")
            if shape == "serving" and dtype == torch.float32:
                row = {"name": "flash_decode_paged", "route": "cuda",
                       "splits": pl.n_splits,
                       "source": "src/repro_torch/kernels/flash_decode/csrc/"
                                 "flash_decode_paged.cu",
                       "replaces": "src/repro/kernels/flash_decode/kernel.py"
                                   ":111",
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound,
                       "bound_by": "bytes" if by_bytes >= by_ops
                       else "operations",
                       "library_ms": library_ms}
    return row


def phase_serve(dev):
    from repro_torch import serve_workload as sw
    from repro_torch.common import param_count
    from repro_torch.kernels.flash_decode import ops as fops

    t0 = time.perf_counter()
    w = sw.build(dev)
    torch.cuda.synchronize()
    n = param_count(w.params)
    check(n == QWEN3_PARAMS, f"qwen3-1.7b has {n} params, expected "
          f"{QWEN3_PARAMS}")
    check(all(x.dtype == torch.float32 and x.device == dev
              for x in w.params.values()), "params are not fp32 on the card")
    print(f"[serve] {sw.ARCH} at full width: {w.cfg.n_layers} layers, d_model "
          f"{w.cfg.d_model}, {w.cfg.n_heads} heads / {w.cfg.n_kv_heads} KV "
          f"heads of {w.cfg.head_dim}, vocab {w.cfg.padded_vocab}, {n} fp32 "
          f"params ({n * 4 / 1e9:.2f} GB) drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    sw.engine(w, n_requests=2, gen=3).run()          # warm-up, not measured
    eng = sw.engine(w)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fops.reset_launch_counts()
    res = eng.run()
    torch.cuda.synchronize()
    launches = fops.paged_decode_attention.launches

    st = eng.stats()
    check(launches == w.cfg.n_layers * st["n_decode_steps"],
          f"K3 launched {launches} times in {st['n_decode_steps']} decode "
          f"steps of {w.cfg.n_layers} layers")
    check(all(len(res[i]) == g for i, g in enumerate(w.gens)),
          "a request did not finish with its requested token count")
    check(eng.decode_cache_size == 1,
          f"decode step saw {eng.decode_cache_size} input signatures")
    print(f"[serve] {st['n_requests']} requests of {sw.PROMPT_LEN} prompt "
          f"tokens over {w.serve.n_slots} slots (pages of "
          f"{w.serve.page_size}), {st['total_tokens']} tokens in "
          f"{st['wall_s']:.3f} s: {st['tokens_per_sec']:.1f} tok/s; decode "
          f"{st['decode_ms_per_step']:.3f} ms per step over "
          f"{st['n_decode_steps']} steps; TTFT p50 {st['ttft_p50_s']:.3f} s "
          f"p99 {st['ttft_p99_s']:.3f} s; latency p50 "
          f"{st['latency_p50_s']:.3f} s p99 {st['latency_p99_s']:.3f} s; "
          f"{st['n_preemptions']} preemptions; peak pages "
          f"{st['peak_pages']}/{st['n_pages'] - 1}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"[serve] flash_decode_paged (K3) launches {launches} = "
          f"{w.cfg.n_layers} x {st['n_decode_steps']} decode steps; every "
          f"request finished with its requested token count; decode input "
          f"signatures {eng.decode_cache_size}")
    return w, launches


def _static(w):
    """The static loop over every prompt of ``w``: (tokens, logits rows)."""
    from repro_torch.serve.engine import static_generate
    from repro_torch.serve.paged_cache import build_layout
    max_len = build_layout(w.cfg, w.serve.page_size, w.serve.max_len).max_len
    return static_generate(w.cfg, w.params, w.prompts, max(w.gens),
                           max_len=max_len, collect_logits=True,
                           device=w.device)


def phase_serve_parity(w, tag="serve-parity",
                       what="continuous (K3) vs static (plain)", static=None,
                       **overrides):
    """The continuous engine (qwen3: paged decode through K3) against the
    static loop (dense cache, plain attention) on the same prompts, on the
    card.  Logits rows agree to LOGIT_TOL; tokens agree, except at a step
    where the static loop's top-2 logit gap is below LOGIT_TOL (a near
    tie that rounding may break either way), after which that request's
    streams are no longer comparable.  ``overrides`` replace the engine's
    ServeConfig fields; ``static`` is a finished static run."""
    from repro_torch import serve_workload as sw

    eng = sw.engine(w, record_logits=True, **overrides)
    res = eng.run()
    out, rows = static or _static(w)
    worst, compared, diverged = 0.0, 0, []
    for i, g in enumerate(w.gens):
        mine = np.stack(eng.logits_rows[i])
        check(mine.shape[0] == g, f"request {i}: {mine.shape[0]} rows")
        for t in range(g):
            err = float(np.abs(mine[t] - rows[t][i]).max())
            check(err <= LOGIT_TOL, f"request {i} step {t}: logits differ "
                  f"by {err} > {LOGIT_TOL}")
            worst = max(worst, err)
            compared += 1
            if res[i][t] != out[i][t]:
                top2 = np.sort(rows[t][i])[-2:]
                gap = float(top2[1] - top2[0])
                check(gap < LOGIT_TOL, f"request {i} step {t}: tokens "
                      f"{res[i][t]} vs {out[i][t]} with a top-2 gap {gap}")
                diverged.append((i, t, gap))
                print(f"[{tag}] request {i} diverges at step {t}: "
                      f"static top-2 gap {gap:.3e} < {LOGIT_TOL}")
                break
    print(f"[{tag}] {what} on the card: "
          f"{compared} logits rows of {len(w.gens)} requests, max abs err "
          f"{worst:.3e} (tol {LOGIT_TOL}); token streams equal"
          + (f" up to {len(diverged)} near-tie divergence(s)" if diverged
             else ""))


# -- K4, K5, K6: the attention kernels' entry points ---------------------------

TRAIN_B, TRAIN_S = 2, 4096       # launch/shapes.py train_4k at batch 2
DECODE_S = 32_768                # launch/shapes.py decode_32k
ATTN_ITERS = 10
# bf16 kernels vs the plain version that rounds P and dS to bf16 where they
# do (ref.py round_to): o, dq, dk, dv element by element at
# ref.rounding_error_ratio's bar (2^-7 of the value + 2^-5 of its row's rms
# + 2^-16 of the largest value), lse at LSE_EMU_TOL; planted wrong outputs
# (one key tile or one query head's share left out) must fail that bar
LSE_EMU_TOL = 1e-5
ATTN_OUTS = ("o", "dq", "dk", "dv")


def _allowed_pairs(s, causal, window):
    """Allowed (query, key) pairs of one (batch, head) at Sq = Sk = s."""
    i = np.arange(s)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros_like(i)
    hi = i if causal else np.full_like(i, s - 1)
    return int((hi - lo + 1).clip(min=0).sum())


def _attn_configs():
    from repro_torch.configs.base import get_config
    qwen, gemma = get_config("qwen3-1.7b"), get_config("gemma3-12b")
    return [("qwen3-1.7b", qwen, 0),
            ("gemma3-12b local", gemma, gemma.sliding_window),
            ("gemma3-12b global", gemma, 0)]


def _planted_wrong(q, k, v, g, o, lse, want, window):
    """Wrong outputs a faulty bf16 kernel could give, each in batch 0 and
    the last query head, from the rounding plain version's ``want`` (o, dq,
    dk, dv) and lse: the forward and dQ with the key tile at S/2 left
    out, dK and dV without that head's share in the last key tile."""
    s, hd = q.shape[1], q.shape[3]
    hh, kvh = q.shape[2] - 1, k.shape[2] - 1
    qh, kh, vh, gh = (x[0, :, i].float() for x, i in
                      ((q, hh), (k, kvh), (v, kvh), (g, hh)))
    i = torch.arange(s, device=q.device)
    mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window
                                      if window > 0 else True)
    sc = qh @ kh.T / math.sqrt(hd)
    p = torch.where(mask, torch.exp(sc - lse[0, hh][:, None]), 0.0)
    dlt = (o[0, :, hh].float() * gh).sum(-1)
    ds = p * (gh @ vh.T - dlt[:, None]) / math.sqrt(hd)
    tile, last, r0 = slice(s // 2, s // 2 + 64), slice(s - 64, s), s // 2
    mask[:, tile] = False
    s2 = torch.where(mask, sc, -1e30)[r0:]
    wrong = {}
    for n, rows, val in (
            ("o", r0, torch.softmax(s2, -1) @ vh),
            ("lse", r0, torch.logsumexp(s2, -1)),
            ("dq", 0, want[1][0, :, hh].float() - ds[:, tile] @ kh[tile]),
            ("dk", last, want[2][0, last, kvh].float() - ds[:, last].T @ qh),
            ("dv", last, want[3][0, last, kvh].float() - p[:, last].T @ gh)):
        x = (lse if n == "lse" else want[ATTN_OUTS.index(n)]).clone()
        if n == "lse":
            x[0, hh, rows:] = val
        elif isinstance(rows, slice):
            x[0, rows, kvh] = val.to(x.dtype)
        else:
            x[0, rows:, hh] = val.to(x.dtype)
        wrong[n] = x
    return wrong


def _sdpa_attn(q, k, v, window):
    """Yardstick (never called by the port): one scaled_dot_product_attention
    with GQA in the model layout, causal, or an explicit window mask."""
    import torch.nn.functional as F
    s = q.shape[1]
    args = dict(enable_gqa=True)
    if window > 0:
        i = torch.arange(s, device=q.device)
        args["attn_mask"] = (i[None] <= i[:, None]) & \
            (i[None] > i[:, None] - window)
    else:
        args["is_causal"] = True
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        **args).transpose(1, 2)


def _sdpa_backend(q, k, v, g, window):
    """Names of the CUDA kernels one SDPA forward + backward ran."""
    from torch.profiler import ProfilerActivity, profile
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        o = _sdpa_attn(qs, ks, vs, window)
        torch.autograd.grad(o, (qs, ks, vs), g)
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if any(w in e.key.lower() for w in
                           ("attention", "fmha", "flash", "sdpa", "cudnn",
                            "softmax"))})
    return ", ".join(n[:60] for n in names) or "no attention kernel named"


def phase_attention_kernels(dev):
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_fwd_ref,
        rounding_error_ratio)

    name = torch.cuda.get_device_name(0)
    b, s = TRAIN_B, TRAIN_S
    rows, driven = {}, {"fwd": 0, "dq": 0, "dkv": 0}
    for cfg_name, cfg, window in _attn_configs():
        h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"[attention-kernels] {cfg_name} {str(dtype)[6:]}"
            gen = torch.Generator(device=dev).manual_seed(hd + window)
            q, g = (torch.randn(b, s, h, hd, generator=gen, device=dev)
                    .to(dtype) for _ in range(2))
            k, v = (torch.randn(b, s, hkv, hd, generator=gen, device=dev)
                    .to(dtype) for _ in range(2))

            def train(q=q, k=k, v=v, g=g, window=window):
                qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
                o = aops.flash_attention(qs, ks, vs, True, window)
                return (o.detach(),) + torch.autograd.grad(
                    (o * g).sum(), (qs, ks, vs))

            aops.reset_launch_counts()        # the main path's call
            got = train()
            torch.cuda.synchronize()
            step = dict(aops.LAUNCHES)
            check(step == {"fwd": 1, "dq": 1, "dkv": 1},
                  f"{tag}: launches {step}, expected one of each")
            for key in driven:
                driven[key] += step[key]
            _, lse = aops.attention_fwd(q, k, v, causal=True, window=window)
            again = train()
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  f"{tag}: two launches are not bitwise equal")
            qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
            o_ref, lse_ref = flash_attention_fwd_ref(qf, kf, vf, causal=True,
                                                     window=window)
            want = (o_ref,) + flash_attention_bwd_ref(
                qf, kf, vf, o_ref, lse_ref, gf, causal=True, window=window)
            errs = {n: float((x.float() - y).abs().max()) for n, x, y in
                    zip(ATTN_OUTS, got, want)}
            errs["lse"] = float((lse - lse_ref).abs().max())
            mean = {n: float((x.float() - y).abs().mean()) for n, x, y in
                    zip(ATTN_OUTS, got, want)}
            for n, err in errs.items():
                if dtype == torch.float32:
                    tol = TOL if n in ("o", "lse") else 5e-4
                else:
                    ref = lse_ref if n == "lse" else want[ATTN_OUTS.index(n)]
                    tol = 3e-2 * (1.0 if n in ("o", "lse") else
                                  max(1.0, float(ref.abs().max())))
                check(err <= tol, f"{tag}: {n} max abs err vs plain {err} > "
                      f"{tol}")
            emu, planted = {}, {}
            if dtype == torch.float32:
                # o and lse with one key tile left out must fail the fp32
                # bar of 2e-5, gradients with one key tile (or one head's
                # share of the last key tile) left out that of 5e-4
                for n, x in _planted_wrong(q, k, v, g, got[0], lse, want,
                                           window).items():
                    ref = lse_ref if n == "lse" else want[ATTN_OUTS.index(n)]
                    tol = TOL if n in ("o", "lse") else 5e-4
                    planted[n] = float((x.float() - ref).abs().max()) / tol
                    check(planted[n] > 1.0, f"{tag}: a planted wrong {n} "
                          f"passes the {tol} bar ({planted[n]:.3f} of it)")
            if dtype == torch.bfloat16:
                # P and dS rounded as the kernels do; the backward from the
                # kernel's own o and lse, so that each kernel is held alone
                o_emu, lse_emu = flash_attention_fwd_ref(
                    qf, kf, vf, causal=True, window=window,
                    round_to=torch.bfloat16)
                want = (o_emu.to(dtype),) + flash_attention_bwd_ref(
                    q, k, v, got[0], lse, g, causal=True, window=window,
                    round_to=torch.bfloat16)
                for n, x, y in zip(ATTN_OUTS, got, want):
                    emu[n] = rounding_error_ratio(x, y)
                    mean[n + " rounding"] = float((x.float() - y.float())
                                                  .abs().mean())
                    check(emu[n] <= 1.0, f"{tag}: {n} vs the bf16-rounding "
                          f"plain version at {emu[n]:.3f} of the bar")
                emu["lse"] = float((lse - lse_emu).abs().max()) / LSE_EMU_TOL
                check(emu["lse"] <= 1.0, f"{tag}: lse vs the bf16-rounding "
                      f"plain version at {emu['lse']:.3f} of the bar")
                # the same bars must see a kernel that is wrong by a
                # typical amount in a small part of its output
                for n, x in _planted_wrong(q, k, v, g, got[0], lse, want,
                                           window).items():
                    planted[n] = (float((x - lse_emu).abs().max())
                                  / LSE_EMU_TOL if n == "lse" else
                                  rounding_error_ratio(
                                      x, want[ATTN_OUTS.index(n)]))
                    check(planted[n] > 1.0, f"{tag}: a planted wrong {n} "
                          f"passes the bar ({planted[n]:.3f} of it)")
                del o_emu, lse_emu
            del want, got, again
            pairs = b * h * _allowed_pairs(s, True, window)
            esz = q.element_size()
            fwd_ops, bwd_ops = 4 * hd * pairs, 10 * hd * pairs
            fwd_bytes = esz * (2 * q.numel() + 2 * k.numel()) + 4 * b * h * s
            bwd_bytes = esz * (4 * q.numel() + 4 * k.numel()) + 8 * b * h * s
            o, lse = aops.attention_fwd(q, k, v, causal=True, window=window)
            t = {
                "fwd": device_ms(lambda: aops.attention_fwd(
                    q, k, v, causal=True, window=window), ATTN_ITERS),
                "bwd": device_ms(lambda: aops.attention_bwd(
                    q, k, v, o, lse, g, causal=True, window=window),
                    ATTN_ITERS),
                "train": device_ms(train, ATTN_ITERS),
                "plain_fwd": device_ms(lambda: flash_attention_fwd_ref(
                    q, k, v, causal=True, window=window), ATTN_ITERS),
                "plain_bwd": device_ms(lambda: flash_attention_bwd_ref(
                    q, k, v, o, lse, g, causal=True, window=window),
                    ATTN_ITERS)}
            lib = _sdpa_attn(q, k, v, window)
            lib_err = float((lib.float() - o_ref).abs().max())
            check(lib_err <= (1e-3 if dtype == torch.float32 else 5e-2),
                  f"{tag}: the sdpa yardstick disagrees by {lib_err}")
            qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
            lib_o = _sdpa_attn(qs, ks, vs, window)

            def lib_train():
                qs_, ks_, vs_ = (x.detach().requires_grad_()
                                 for x in (q, k, v))
                return torch.autograd.grad(
                    (_sdpa_attn(qs_, ks_, vs_, window) * g).sum(),
                    (qs_, ks_, vs_))

            t["lib_fwd"] = device_ms(lambda: _sdpa_attn(q, k, v, window),
                                     ATTN_ITERS)
            t["lib_bwd"] = device_ms(lambda: torch.autograd.grad(
                lib_o, (qs, ks, vs), g, retain_graph=True), ATTN_ITERS)
            t["lib_train"] = device_ms(lib_train, ATTN_ITERS)
            backend = _sdpa_backend(q, k, v, g, window)
            del lib, lib_o, qs, ks, vs, o_ref, lse_ref
            bound = {}
            peak = FP32_PEAK if dtype == torch.float32 else BF16_PEAK
            for part, ops_, nbytes in (("fwd", fwd_ops, fwd_bytes),
                                       ("bwd", bwd_ops, bwd_bytes)):
                by_bytes = nbytes / memory_rate(name)
                by_ops = ops_ / peak
                bound[part] = (max(by_bytes, by_ops) * 1e3,
                               "bytes" if by_bytes >= by_ops
                               else "operations", by_ops, by_bytes)
            print(f"{tag}: B={b} S={s} H={h} Hkv={hkv} hd={hd} causal "
                  f"window={window}: max abs err vs plain "
                  + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
                  + (f"; vs the bf16-rounding plain version, share of the "
                     "bar: " + ", ".join(f"{n} {e:.4f}" for n, e in
                                         emu.items()) if emu else "")
                  + "; planted wrong outputs, share of the bar: " + ", ".join(
                      f"{n} {e:.2f}" for n, e in planted.items())
                  + "; mean abs err " + ", ".join(f"{n} {e:.3e}" for n, e in
                                                  mean.items())
                  + f"; sdpa yardstick o {lib_err:.3e}; launches fwd 1, dQ "
                  f"1, dK/dV 1 per call; two launches bitwise equal")
            print(f"{tag}: median device ms (L2 flushed): kernel fwd "
                  f"{t['fwd']:.4f}, bwd {t['bwd']:.4f}, fwd+bwd "
                  f"{t['train']:.4f}; plain fwd {t['plain_fwd']:.4f}, bwd "
                  f"{t['plain_bwd']:.4f}; sdpa fwd {t['lib_fwd']:.4f}, bwd "
                  f"{t['lib_bwd']:.4f}, fwd+bwd {t['lib_train']:.4f} "
                  f"[{backend}]")
            print(f"{tag}: bound fwd {bound['fwd'][0]:.4f} ms "
                  f"({fwd_ops / 1e9:.2f} GFLOP at {peak / 1e12:.0f} "
                  f"TFLOP/s {str(dtype)[6:]}; {fwd_bytes / 1e6:.1f} MB at "
                  f"{memory_rate(name) / 1e12:.2f} TB/s is "
                  f"{bound['fwd'][3] * 1e3:.4f}), bwd {bound['bwd'][0]:.4f} "
                  f"ms ({bwd_ops / 1e9:.2f} GFLOP); kernel at "
                  f"{bound['fwd'][0] / t['fwd']:.1%} (fwd) and "
                  f"{bound['bwd'][0] / t['bwd']:.1%} (bwd) of the bound; "
                  f"sdpa at {bound['fwd'][0] / t['lib_fwd']:.1%} and "
                  f"{bound['bwd'][0] / t['lib_bwd']:.1%}; kernel / sdpa "
                  f"{t['fwd'] / t['lib_fwd']:.2f}x (fwd), "
                  f"{t['bwd'] / t['lib_bwd']:.2f}x (bwd)"
                  + (f"; fwd {t['fwd'] / PREVIOUS_MS[cfg_name]:.3f}x the "
                     f"previous design's {PREVIOUS_MS[cfg_name]} ms"
                     if dtype == torch.float32 else ""))
            if cfg_name == "qwen3-1.7b" and dtype == torch.bfloat16:
                for part in ("fwd", "bwd"):
                    rows[part].update({
                        "bf16_source": "src/repro_torch/kernels/"
                                       "flash_attention/csrc/"
                                       "flash_attention_sm90.cu",
                        "bf16_ms": t[part], "bf16_bound_ms": bound[part][0],
                        "bf16_library_ms": t[f"lib_{part}"],
                        "bf16_max_abs_err": (
                            max(errs["o"], errs["lse"]) if part == "fwd"
                            else max(errs["dq"], errs["dk"], errs["dv"]))})
            if cfg_name == "qwen3-1.7b" and dtype == torch.float32:
                src = "src/repro_torch/kernels/flash_attention/csrc/" \
                      "flash_attention.cu"
                rows["fwd"] = {
                    "name": "flash_attention_fwd", "route": "cuda",
                    "source": src,
                    "replaces": "src/repro/kernels/flash_attention/kernel.py"
                                ":82",
                    "max_abs_err": max(errs["o"], errs["lse"]),
                    "ms": t["fwd"], "plain_ms": t["plain_fwd"],
                    "bound_ms": bound["fwd"][0],
                    "bound_by": bound["fwd"][1], "library_ms": t["lib_fwd"]}
                rows["bwd"] = {
                    "name": "flash_attention_bwd", "route": "cuda",
                    "source": src,
                    "replaces": "src/repro/kernels/flash_attention/kernel.py"
                                ":231",
                    "max_abs_err": max(errs["dq"], errs["dk"], errs["dv"]),
                    "ms": t["bwd"], "plain_ms": t["plain_bwd"],
                    "bound_ms": bound["bwd"][0],
                    "bound_by": bound["bwd"][1], "library_ms": t["lib_bwd"]}
            del q, k, v, g, o, lse
            torch.cuda.empty_cache()
    check(driven["fwd"] == 2 * len(_attn_configs()),
          f"[attention-kernels] launches {driven}")
    rows["fwd"]["launches"] = driven["fwd"]
    rows["bwd"]["launches"] = driven["dq"] + driven["dkv"]
    return rows["fwd"], rows["bwd"]


def _sdpa_decode(q, k, v, valid):
    """Yardstick (never called by the port): gather-free SDPA over the
    dense cache with a validity mask and GQA."""
    import torch.nn.functional as F
    s = k.shape[1]
    mask = torch.arange(s, device=q.device)[None] < valid[:, None]
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask[:, None, None, :], enable_gqa=True).transpose(1, 2)


def phase_decode_dense(dev):
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_decode import ops as fops
    from repro_torch.kernels.flash_decode.ref import (decode_attention_ref,
                                                      dense_span,
                                                      flash_decode_ref)

    name = torch.cuda.get_device_name(0)
    qwen, gemma = get_config("qwen3-1.7b"), get_config("gemma3-12b")
    w = gemma.sliding_window
    cases = [  # tag, config, B, S, window, valid range, blk_k, dtypes
        ("decode_32k", qwen, 8, DECODE_S, 0, (1, DECODE_S), 512,
         (torch.float32, torch.bfloat16)),
        ("gemma3 ring", gemma, 8, w, w, (1, 4 * w), 512, (torch.float32,)),
        ("S=1000", qwen, 4, 1000, 0, (1, 1000), 512, (torch.float32,))]
    row, launches = None, 0
    for tag0, cfg, b, s, window, (lo, hi), blk, dtypes in cases:
        h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        for dtype in dtypes:
            tag = f"[decode-dense] {tag0} {str(dtype)[6:]}"
            gen = torch.Generator(device=dev).manual_seed(s)
            q = torch.randn(b, 1, h, hd, generator=gen, device=dev).to(dtype)
            k, v = (torch.randn(b, s, hkv, hd, generator=gen, device=dev)
                    .to(dtype) for _ in range(2))
            vals = np.random.default_rng(s).integers(lo, hi + 1, b)
            vals[0], vals[-1] = lo, hi
            valid = torch.as_tensor(vals, dtype=torch.int32, device=dev)
            fops.reset_launch_counts()        # the main path's call
            out = _no_sync(lambda: fops.decode_attention(
                q, k, v, valid, window=window, blk_k=blk))
            torch.cuda.synchronize()
            n = fops.paged_decode_attention.launches
            check(n == 1, f"{tag}: decode_attention launched K3's kernel "
                  f"{n} times")
            launches += n
            kf, vf = k.float(), v.float()
            want = decode_attention_ref(q.float(), kf, vf, valid,
                                        window=window, blk_k=blk)
            err = float((out.float() - want).abs().max())
            tol = TOL if dtype == torch.float32 else 3e-2
            check(out.dtype == dtype and err <= tol,
                  f"{tag}: max abs err vs plain {err} > {tol}")
            check(torch.equal(out, fops.decode_attention(
                q, k, v, valid, window=window, blk_k=blk)),
                f"{tag}: not bitwise repeatable")
            span = dense_span(s, blk)
            pl = fops.plan(b, hkv, h // hkv, 1, span, hd, dtype, dev)
            if dtype == torch.bfloat16:
                print(_bf16_bar(tag, out, want, valid, pl,
                                lambda vl: decode_attention_ref(
                                    q.float(), kf, vf, vl, window=window,
                                    blk_k=blk)))
            del kf, vf
            if tag0 == "decode_32k":
                n_sm = torch.cuda.get_device_properties(
                    dev).multi_processor_count
                check(pl.n_splits > 1 and pl.blocks >= n_sm,
                      f"{tag}: the split path is not live: {_plan_text(pl)} "
                      f"on {n_sm} SMs")
            eff = valid.clamp(max=window) if window else valid
            eff = eff.clamp(max=span)
            extra = ""
            if tag0 == "gemma3 ring":
                # the reference kernel's layout, one valid length per head
                n_rep = h // hkv
                qk = q[:, 0].reshape(b * h, 1, hd)
                kk = k.permute(0, 2, 1, 3).reshape(b * hkv, s, hd)
                vk = v.permute(0, 2, 1, 3).reshape(b * hkv, s, hd)
                vh = eff.repeat_interleave(h)
                before = fops.paged_decode_attention.launches
                got = fops.flash_decode(qk, kk, vk, vh, blk_k=blk)
                check(fops.paged_decode_attention.launches == before + 1,
                      f"{tag}: flash_decode did not launch K3's kernel")
                kerr = float((got - flash_decode_ref(qk, kk, vk, vh))
                             .abs().max())
                check(kerr <= TOL, f"{tag}: flash_decode (kernel layout) "
                      f"max abs err {kerr}")
                zero = valid.clone()
                zero[1] = 0
                z = fops.decode_attention(q, k, v, zero, window=window)
                check(bool((z[1] == 0).all()),
                      f"{tag}: valid_len 0 did not give zeros")
                extra = (f"; flash_decode (kernel layout, {n_rep} heads per "
                         f"KV head) err {kerr:.3e}; valid_len 0 gives zeros")
            if tag0 == "S=1000":
                kn, vn = k.clone(), v.clone()
                kn[:, span:] = float("nan")
                vn[:, span:] = float("nan")
                nan_out = fops.decode_attention(q, kn, vn, valid, blk_k=blk)
                check(torch.equal(nan_out, out), f"{tag}: a position at or "
                      f"past {span} was read")
                extra = (f"; positions {span}..{s - 1} never read (NaN "
                         f"there changes nothing)")
            print(f"{tag}: B={b} S={s} H={h} Hkv={hkv} hd={hd} window "
                  f"{window} blk_k {blk} (reads {span}), valid "
                  f"{int(valid.min())}...{int(valid.max())}: max abs err vs "
                  f"plain {err:.3e} (tol {tol}); bitwise repeatable{extra}")
            print(f"{tag}: {_plan_text(pl)}; no host sync")
            if tag0 != "decode_32k":
                continue
            lib = _sdpa_decode(q, k, v, valid)
            lib_err = float((lib.float() - want).abs().max())
            check(lib_err <= (1e-3 if dtype == torch.float32 else 5e-2),
                  f"{tag}: the sdpa yardstick disagrees by {lib_err}")
            del want, lib
            ms = device_ms(lambda: fops.decode_attention(q, k, v, valid))
            plain_ms = device_ms(lambda: decode_attention_ref(q, k, v, valid),
                                 ATTN_ITERS)
            library_ms = device_ms(lambda: _sdpa_decode(q, k, v, valid))
            ntok = int(eff.sum())
            nbytes = (q.element_size() * (2 * ntok * hkv * hd
                                          + 2 * b * h * hd) + 4 * b)
            flops = 4 * ntok * h * hd
            by_bytes, by_ops = nbytes / memory_rate(name), flops / FP32_PEAK
            bound = max(by_bytes, by_ops) * 1e3
            print(f"{tag}: median device ms (L2 flushed): kernel {ms:.4f}, "
                  f"plain {plain_ms:.4f}, masked sdpa {library_ms:.4f}; "
                  f"bound {bound:.4f}: {nbytes / 1e9:.3f} GB at "
                  f"{memory_rate(name) / 1e12:.2f} TB/s is "
                  f"{by_bytes * 1e3:.4f}, {flops / 1e9:.3f} GFLOP is "
                  f"{by_ops * 1e3:.4f}; kernel at {bound / ms:.1%} of the "
                  f"bound; sdpa yardstick err {lib_err:.3e}")
            if dtype == torch.float32:
                row = {"name": "flash_decode", "route": "cuda",
                       "splits": pl.n_splits,
                       "source": "src/repro_torch/kernels/flash_decode/csrc/"
                                 "flash_decode_paged.cu",
                       "replaces": "src/repro/kernels/flash_decode/kernel.py"
                                   ":163",
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound,
                       "bound_by": "bytes" if by_bytes >= by_ops
                       else "operations",
                       "library_ms": library_ms}
            del q, k, v
            torch.cuda.empty_cache()
    row["launches"] = launches
    return row


# -- K7 and the rwkv6 serving path ----------------------------------------------

RWKV_PARAMS = 3_073_395_200      # the reference's init at full width
PREFILL_32K = 32_768             # launch/shapes.py prefill_32k, at batch 1
WKV_TOL = 1e-4                   # K7 vs its plain chunked version, fp32
WKV_ORACLE_TOL = 1e-3            # K7 vs the per-token oracle, fp32


def _wkv_inputs(dev, b, s, h, dk, seed):
    """Model layout (B, S, H, dk): r, k, v ~ N(0, 1), log-decay
    -|N(0, 1)|; u ~ 0.1 N(0, 1) of (H, dk)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    r, k, v, d = (torch.randn(b, s, h, dk, generator=gen, device=dev)
                  for _ in range(4))
    return r, k, v, -d.abs(), 0.1 * torch.randn(h, dk, generator=gen,
                                                 device=dev)


def _fold(x):
    """(B, S, H, d) -> the kernel layout (B*H, S, d)."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d)


def _wkv_planted(folded, uu, chunk, segment, dtype):
    """Wrong outputs a faulty segmented K7 could give, from the plain
    segmented version: the carried state dropped at the middle segment's
    start, and the middle segment's last chunk left out of its local
    state (so of the carry into the next one); rounded to ``dtype``."""
    from repro_torch.kernels.rwkv6_scan.ref import (carry, segment_outputs,
                                                    segment_states)
    f32 = [x.float() for x in folded]
    loc, a = segment_states(*f32, uu, chunk=chunk, segment=segment)
    m = loc.shape[1] // 2
    s_in = carry(loc, a)
    s_in[:, m] = 0.0
    dropped, _ = segment_outputs(*f32, uu, s_in, chunk=chunk,
                                 segment=segment)
    lo = m * segment
    short = [x[:, lo:lo + segment - chunk] for x in f32]
    loc[:, m] = segment_states(*short, uu, chunk=chunk,
                               segment=segment - chunk)[0][:, 0]
    missing, _ = segment_outputs(*f32, uu, carry(loc, a), chunk=chunk,
                                 segment=segment)
    return {"carry dropped": dropped.to(dtype),
            "last chunk left out": missing.to(dtype)}


def phase_wkv_kernel(dev):
    from repro_torch import serve_workload as sw
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.rwkv6_scan import ops as wops
    from repro_torch.kernels.rwkv6_scan.ref import (BF16_ATOL,
                                                    bf16_error_ratio,
                                                    rwkv6_scan_chunked_ref,
                                                    rwkv6_scan_ref)
    from repro_torch.models.linear_scan import chunk_len

    name = torch.cuda.get_device_name(0)
    cfg = get_config("rwkv6-3b")
    h, dk = cfg.n_heads, cfg.head_dim
    cases = [  # tag, B, S, timed
        ("serving", sw.N_SLOTS, sw.PROMPT_LEN, True),
        ("one prompt", 1, sw.PROMPT_LEN, True),
        ("prefill_32k", 1, PREFILL_32K, True),
        ("S=145", sw.N_SLOTS, 145, False),
        ("S=127", sw.N_SLOTS, 127, False)]
    row = None
    for tag0, b, s, timed in cases:
        chunk = chunk_len(s, 16)
        r, k, v, ld, u = _wkv_inputs(dev, b, s, h, dk, seed=s)
        pl = wops.plan(b * h, s, chunk, dk, dev)
        print(f"[wkv-kernel] {tag0}: plan {pl.n_seg} segment(s) of "
              f"{pl.seg_len} tokens, {pl.blocks} blocks a walk, "
              f"{pl.kernels} kernel(s) a call, workspace "
              f"{pl.workspace_bytes / 1e6:.1f} MB")
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"[wkv-kernel] {tag0} {str(dtype)[6:]}"
            rr, kk, vv = (x.to(dtype) for x in (r, k, v))
            wops.reset_launch_counts()
            o, st = wops.wkv(rr, kk, vv, ld, u, chunk=chunk)
            torch.cuda.synchronize()
            n = wops.rwkv6_scan.launches
            check(n == 1, f"{tag}: wkv launched K7 {n} times")
            folded = [_fold(x) for x in (rr, kk, vv, ld)]
            uu = u.repeat(b, 1)
            want_o, want_st = rwkv6_scan_chunked_ref(
                *(x.float() for x in folded), uu, chunk=chunk)
            err = float((_fold(o).float() - want_o).abs().max())
            err_st = float((st.reshape(b * h, dk, dk) - want_st).abs().max())
            tol = WKV_TOL if dtype == torch.float32 else \
                1e-2 * float(want_o.abs().max())
            check(o.dtype == dtype and err <= tol and err_st <= WKV_TOL,
                  f"{tag}: max abs err vs plain o {err} (tol {tol}), state "
                  f"{err_st} (tol {WKV_TOL})")
            extra = ""
            if dtype == torch.bfloat16:
                # element by element: o's own rounding (2^-8 of the value)
                # plus fp32's order of sums (BF16_ATOL)
                ratio = bf16_error_ratio(_fold(o), want_o)
                check(ratio <= 1.0, f"{tag}: o vs the fp32 plain version at "
                      f"{ratio:.4f} of the element-wise bar")
                extra = (f"; element-wise bar |x - y| <= 2^-8|y| + "
                         f"{BF16_ATOL:.3e}: {ratio:.4f} of it")
            if pl.n_seg > 1:
                # the same bars must see a kernel that loses the carry or a
                # chunk at one segment boundary
                planted = {}
                for pname, x in _wkv_planted(folded, uu, chunk, pl.seg_len,
                                             dtype).items():
                    planted[pname] = (
                        float((x.float() - want_o).abs().max()) / WKV_TOL
                        if dtype == torch.float32 else
                        bf16_error_ratio(x, want_o))
                    check(planted[pname] > 1.0, f"{tag}: planted wrong "
                          f"output ({pname}) passes the bar at "
                          f"{planted[pname]:.3f} of it")
                extra += "; planted wrong outputs, share of the bar: " + \
                    ", ".join(f"{n_} {x:.1f}" for n_, x in planted.items())
            again = wops.wkv(rr, kk, vv, ld, u, chunk=chunk)
            check(torch.equal(again[0], o) and torch.equal(again[1], st),
                  f"{tag}: not bitwise repeatable")
            if tag0 == "serving" and dtype == torch.float32:
                oo, ost = rwkv6_scan_ref(*folded, uu)
                err_or = max(float((_fold(o) - oo).abs().max()),
                             float((st.reshape(b * h, dk, dk) - ost)
                                   .abs().max()))
                check(err_or <= WKV_ORACLE_TOL, f"{tag}: max abs err vs the "
                      f"per-token oracle {err_or} > {WKV_ORACLE_TOL}")
                strong = wops.wkv(rr, kk, vv, torch.full_like(ld, -50.0), u,
                                  chunk=chunk)
                check(all(bool(torch.isfinite(x).all()) for x in strong),
                      f"{tag}: log-decay -50 gave a non-finite output")
                extra += (f"; per-token oracle {err_or:.3e} (tol "
                          f"{WKV_ORACLE_TOL}); log-decay -50 finite")
            print(f"{tag}: B={b} S={s} H={h} dk=dv={dk} chunk {chunk}: max "
                  f"abs err vs plain o {err:.3e} (tol {tol:.3e}), state "
                  f"{err_st:.3e}; max|o| {float(want_o.abs().max()):.2f}; "
                  f"one counted call, bitwise repeatable{extra}")
            del want_o, want_st, again
            if timed:
                iters = ATTN_ITERS if s <= 1024 else 3
                ms = device_ms(lambda: wops.wkv(rr, kk, vv, ld, u,
                                                chunk=chunk), iters)
                plain_ms = device_ms(lambda: rwkv6_scan_chunked_ref(
                    *folded, uu, chunk=chunk), iters, warmup=1)
                esz, dsz = rr.element_size(), ld.element_size()
                tokens = b * s * h
                nbytes = (tokens * dk * (4 * esz + dsz) + 4 * h * dk
                          + 4 * b * h * dk * dk)
                flops = tokens * 2 * (2 * chunk * dk + 2 * dk * dk)
                by_bytes = nbytes / memory_rate(name)
                by_ops = flops / FP32_PEAK
                bound = max(by_bytes, by_ops) * 1e3
                print(f"{tag}: median device ms (L2 flushed): kernel "
                      f"{ms:.4f}, plain {plain_ms:.4f}; bound {bound:.4f}: "
                      f"{nbytes / 1e6:.1f} MB at {memory_rate(name) / 1e12:.2f}"
                      f" TB/s is {by_bytes * 1e3:.4f}, {flops / 1e9:.3f} GFLOP"
                      f" at {FP32_PEAK / 1e12:.0f} TFLOP/s is "
                      f"{by_ops * 1e3:.4f}; kernel at {bound / ms:.1%} of "
                      f"the bound; no single PyTorch call computes this "
                      f"recurrence")
                if tag0 == "serving" and dtype == torch.float32:
                    row = {"name": "rwkv6_scan", "route": "cuda",
                           "source": "src/repro_torch/kernels/rwkv6_scan/"
                                     "csrc/rwkv6_scan.cu",
                           "replaces": "src/repro/kernels/rwkv6_scan/"
                                       "kernel.py:66",
                           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bound,
                           "bound_by": "bytes" if by_bytes >= by_ops
                           else "operations",
                           "library_ms": None}
            del o, st, folded
        del r, k, v, ld
        torch.cuda.empty_cache()
    return row


def phase_serve_rwkv6(dev):
    from repro_torch import serve_workload as sw
    from repro_torch.common import param_count
    from repro_torch.kernels.flash_decode import ops as fops
    from repro_torch.kernels.rwkv6_scan import ops as wops

    t0 = time.perf_counter()
    w = sw.build(dev, arch="rwkv6-3b")
    torch.cuda.synchronize()
    n = param_count(w.params)
    check(n == RWKV_PARAMS, f"rwkv6-3b has {n} params, expected "
          f"{RWKV_PARAMS}")
    check(all(x.dtype == torch.float32 and x.device == dev
              for x in w.params.values()), "params are not fp32 on the card")
    cfg = w.cfg
    print(f"[serve-rwkv6] {cfg.name} at full width: {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads} WKV heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.padded_vocab}, {n} "
          f"fp32 params ({n * 4 / 1e9:.2f} GB) drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    sw.engine(w, n_requests=2, gen=3).run()          # warm-up, not measured
    eng = sw.engine(w)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    wops.reset_launch_counts()
    fops.reset_launch_counts()
    res = eng.run()
    torch.cuda.synchronize()
    launches = wops.rwkv6_scan.launches
    k3 = fops.paged_decode_attention.launches

    st = eng.stats()
    check(launches == cfg.n_layers * st["n_prefill_calls"],
          f"K7 launched {launches} times in {st['n_prefill_calls']} prefill "
          f"calls of {cfg.n_layers} layers")
    check(k3 == 0, f"K3 launched {k3} times on an attention-free model")
    check(all(len(res[i]) == g for i, g in enumerate(w.gens)),
          "a request did not finish with its requested token count")
    check(eng.decode_cache_size == 1,
          f"decode step saw {eng.decode_cache_size} input signatures")
    state_bytes = sum(x.numel() * x.element_size()
                      for x in eng.paged.values())
    print(f"[serve-rwkv6] {st['n_requests']} requests of {sw.PROMPT_LEN} "
          f"prompt tokens over {w.serve.n_slots} slots, "
          f"{st['total_tokens']} tokens in {st['wall_s']:.3f} s: "
          f"{st['tokens_per_sec']:.1f} tok/s; decode "
          f"{st['decode_ms_per_step']:.3f} ms per step over "
          f"{st['n_decode_steps']} steps; {st['n_prefill_calls']} prefill "
          f"calls; TTFT p50 {st['ttft_p50_s']:.3f} s p99 "
          f"{st['ttft_p99_s']:.3f} s; latency p50 {st['latency_p50_s']:.3f} "
          f"s p99 {st['latency_p99_s']:.3f} s; {st['n_preemptions']} "
          f"preemptions; state {state_bytes / 1e6:.1f} MB "
          f"({state_bytes / w.serve.n_slots / 1e6:.2f} MB per slot); peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"[serve-rwkv6] rwkv6_scan (K7) launches {launches} = "
          f"{cfg.n_layers} x {st['n_prefill_calls']} prefill calls; K3 "
          f"launches {k3}; every request finished with its requested token "
          f"count; decode input signatures {eng.decode_cache_size}")
    return w, launches


def _slotted(w):
    """``slotted_generate`` over every prompt of ``w`` at the engine's slot
    count, as ``phase_serve_parity`` reads a finished static run: (tokens
    by request, logits rows by step, each {request: row})."""
    from repro_torch.serve.engine import slotted_generate
    from repro_torch.serve.paged_cache import build_layout
    max_len = build_layout(w.cfg, w.serve.page_size, w.serve.max_len).max_len
    toks, rows = slotted_generate(w.cfg, w.params, w.prompts, w.gens,
                                  n_slots=w.serve.n_slots, max_len=max_len,
                                  device=w.device)
    return toks, [{i: r[t] for i, r in enumerate(rows) if t < len(r)}
                  for t in range(max(w.gens))]


def phase_serve_rwkv6_parity(w):
    """The engine against the static loop at the static loop's batch (as
    ``[serve-parity]``); the main path's engine against the loop that
    batches as it does; then the serving prefill's last-position logits
    (scan on K7) against the training forward's (the plain
    ``chunked_linear_scan``)."""
    from repro_torch.kernels.rwkv6_scan import ops as wops
    from repro_torch.models import get_model

    n_req, n = len(w.gens), w.serve.n_slots
    phase_serve_parity(w, "serve-rwkv6-parity", f"continuous over {n_req} "
                       f"slots (the static loop's batch) vs static, both "
                       f"prefill on K7", n_slots=n_req)
    phase_serve_parity(w, "serve-rwkv6-parity", f"continuous over {n} slots "
                       f"(the main path) vs slotted_generate (the same "
                       f"batching: a prefill of {n}, then of 1 per freed "
                       f"slot; decode over {n} rows)", static=_slotted(w))
    model = get_model(w.cfg)
    prompts = torch.as_tensor(w.prompts, device=w.device)
    with torch.no_grad():
        wops.reset_launch_counts()
        pre, _ = model.prefill(w.params, prompts[:n], last_only=True)
        check(wops.rwkv6_scan.launches == w.cfg.n_layers,
              f"prefill launched K7 {wops.rwkv6_scan.launches} times")
        full, _, _ = model.forward(w.params, prompts[:n])
        err = float((pre[:, -1] - full[:, -1]).abs().max())
        wide, _, _ = model.forward(w.params, prompts)
        batching = float((wide[:n, -1] - full[:, -1]).abs().max())
    print(f"[serve-rwkv6-parity] why each engine is held to a loop of its "
          f"own batching: the plain forward's last-position logits of the "
          f"same {n} prompts in a batch of {n} vs of {n_req} differ by "
          f"{batching:.3e}")
    check(err <= LOGIT_TOL, f"prefill (K7) vs forward (plain scan) "
          f"last-position logits differ by {err} > {LOGIT_TOL}")
    print(f"[serve-rwkv6-parity] prefill (scan on K7) vs forward (plain "
          f"chunked_linear_scan) on {n} prompts of {prompts.shape[1]} "
          f"tokens, one batch: last-position logits max abs err {err:.3e} "
          f"(tol {LOGIT_TOL})")


# -- the round engines (async, cohort, faults) on the VGG16 round --------------

ENGINE_ROUNDS = 3        # flushes or rounds of each engine run
# the reference's benchmarks/async_bench.py default: heavy-tailed delays
ASYNC_KW = dict(packed=True, codec="qint8", async_buffer=4,
                client_delay_dist="pareto:1.2")
ASYNC_FAULTS = "crash:0.1,nan:0.05,bitflip:0.05,duplicate:0.1,torn:0.05"
SYNC_DELTA_FAULTS = "nan:0.15,inf:0.05,bitflip:0.1"
# far above a clean VGG16 delta's norm (at most sqrt(14.7 M) x 2 lr),
# far below a flipped exponent bit's (values x 2^128)
MAX_DELTA_NORM = 1e4
COHORT_KW = dict(packed=True, codec="qint8", n_registered=1000)


def _flush_seqs(eng):
    """Wrap the async engine's buffer flush to record each flush's
    (client, seq) entries, in the flush's own (client, seq) order."""
    seen = []
    flush = eng.buffer.flush

    def recording(global_params, version):
        seen.append(sorted((e.client, e.seq) for e in eng.buffer.entries))
        return flush(global_params, version)
    eng.buffer.flush = recording
    return seen


def _check_flush_bytes(fed, cap, tag):
    """Every flush's bill equals ``buffered_hub_round_bytes`` /
    ``buffered_hierarchical_round_bytes`` of its entries (weight-0
    entries masked) at the codec's wire width, exactly."""
    from repro_torch.core import comm
    srv, fl = fed.server, fed.fl
    wub = srv.wire_unit_bytes()
    for rec, m in cap.rounds:
        es = np.asarray(m["entry_sel"]) * (np.asarray(
            rec.effective_weights) > 0)[:, None]
        if fl.topology == "hierarchical":
            want = comm.buffered_hierarchical_round_bytes(
                es, m["entry_clients"], wub, comm.edge_membership(
                    fl.n_clients, fl.resolve_n_edges()))["uplink"]
        else:
            want = comm.buffered_hub_round_bytes(es, wub)["uplink"]
        check(rec.uplink_bytes == want, f"{tag} flush {rec.round}: billed "
              f"{rec.uplink_bytes} != buffered bytes {want}")


def _finite(fed):
    return all(bool(torch.isfinite(x).all()) for x in fed.params.values())


def _async_run(dev, tag, phase="async-round", **kw):
    """One async VGG16 run of ENGINE_ROUNDS flushes: K2 launched once per
    dispatch (the engine's dispatch counter), K1 never, bills exact;
    prints under ``[phase]``.  Returns (federation, capture, flush
    entries, K2 launches)."""
    from repro_torch import paper_round
    from repro_torch.kernels.codec import ops as qops
    from repro_torch.kernels.masked_agg import ops as aops

    fed = paper_round.build(dev, **dict(ASYNC_KW, **kw))
    cap = Capture()
    fed.server.add_hook(cap)
    eng = fed.server.async_engine
    seqs = _flush_seqs(eng)
    qops.reset_launch_counts()
    aops.reset_launch_counts()
    hist = fed.fit(ENGINE_ROUNDS)
    torch.cuda.synchronize()
    k2 = qops.quantize_pack_group.launches
    check(k2 == eng._codec_dispatch and k2 > 1,
          f"async {tag}: quantize_pack launched {k2} times for "
          f"{eng._codec_dispatch} dispatches")
    check(aops.masked_agg.launches == 0, f"async {tag}: K1 launched")
    check(all(math.isfinite(r.loss) for r in hist) and _finite(fed),
          f"async {tag}: non-finite loss or params")
    _check_flush_bytes(fed, cap, f"async {tag}")
    for r in hist:
        print(f"[{phase}] {tag} flush {r.round}: {r.seconds:.3f} s, "
              f"staleness mean {r.staleness_mean:.2f} max "
              f"{r.staleness_max:.0f}, {len(r.effective_weights)} entries "
              f"({r.n_participants} clients), uplink {r.uplink_bytes:.0f} B "
              f"qint8 == buffered bytes, wasted {r.wasted_bytes:.0f} B, "
              f"t_sim {r.sim_time:.2f}")
    print(f"[{phase}] {tag}: {eng._codec_dispatch} dispatches "
          f"({fed.fl.n_clients} at start, then one client each), K2 "
          f"launches {k2} (one grouped launch a dispatch), masked_agg 0")
    return fed, cap, seqs, k2


def _k2_dispatch_timing(dev, smi):
    """K2 at the single-client dispatch shape (one row of every VGG16
    leaf, one launch): codes bitwise the plain version's; device median
    (L2 flushed), wall median with the host, the plain version's, and
    the bound (x and uniforms read once, codes and scales written once,
    over the memory rate)."""
    from repro_torch.kernels.codec import ops as qops
    from repro_torch.kernels.codec.ref import quantize_pack_group_ref

    sizes = _vgg_leaf_sizes()
    gen = torch.Generator(device=dev).manual_seed(5)
    xs = [0.01 * torch.randn(1, p, generator=gen, device=dev) for p in sizes]
    us = [torch.rand(1, p, generator=gen, device=dev) for p in sizes]
    got = qops.quantize_pack_group(xs, us, 8)
    want = quantize_pack_group_ref(xs, us, 8)
    torch.cuda.synchronize()
    check(all(_same_codes(g, w) for g, w in zip(got, want)),
          "quantize_pack at the dispatch shape differs from the plain version")
    n = sum(sizes)
    nbytes = 8 * n + n + 4 * len(sizes)
    by_bytes = nbytes / memory_rate(torch.cuda.get_device_name(0))
    by_ops = 7 * n / FP32_PEAK
    bound = max(by_bytes, by_ops) * 1e3
    ms = device_ms(lambda: qops.quantize_pack_group(xs, us, 8))
    wall = median_ms(lambda: qops.quantize_pack_group(xs, us, 8))
    plain = median_ms(lambda: quantize_pack_group_ref(xs, us, 8), iters=10)
    print(f"[async-round] K2 at one client's dispatch ({len(sizes)} leaves "
          f"x 1 row, {n} elements, int8): codes bitwise the plain version's; "
          f"median ms device {ms:.4f} (L2 flushed), wall {wall:.4f}, plain "
          f"{plain:.4f}; bound {bound:.4f} ({nbytes / 1e6:.2f} MB, bytes): "
          f"kernel at {bound / ms:.1%} of it ({smi})")
    return {"ms": ms, "wall_ms": wall, "plain_ms": plain, "bound_ms": bound,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _async_parity(dev, optimizer, flushes):
    """Async flushes of VGG16 width 0.125 in float64 (``_xent64``), 3
    clients, buffer 2, heavy-tailed delays, on the card and on the CPU:
    the same schedule, flushed clients and staleness, parameters within
    PARITY_TOL.  Returns the worst error and its leaf.

    The flush accumulates in float32, as on the main path, so after the
    first flush both devices train from float32-rounded parameters that
    may differ in their last bit; Adam's first step (lr / (1 + eps /
    |g|)) amplifies that on gradients near eps, so the check runs one
    flush under Adam and several only under SGD."""
    from repro_torch.core import FLConfig, Federation, build_units_flat
    from repro_torch.data import cifar_like
    from repro_torch.models import paper_models as pm

    c = 3
    params = pm.init_vgg16(torch.Generator().manual_seed(1),
                           dtype=torch.float64, width_mult=0.125)
    assign = build_units_flat(params, pm.vgg16_units(params))
    x, y = cifar_like(c * 4, key=3)
    batches = {"x": x.reshape(c, 1, 4, 32, 32, 3), "y": y.reshape(c, 1, 4)}
    out = []
    for d in (dev, torch.device("cpu")):
        fl = FLConfig(n_clients=c, n_train_units=7, async_buffer=2,
                      client_delay_dist="pareto:1.2", optimizer=optimizer)
        fed = Federation(loss_fn=functools.partial(_xent64, device=d),
                         params=params, assign=assign, fl=fl, seed=3,
                         device=d)
        b = {k: torch.as_tensor(v, device=d) for k, v in batches.items()}
        fed.server.run(flushes, lambda w: b)
        out.append(({p: v.cpu() for p, v in fed.params.items()},
                    fed.server.async_engine.flush_clients,
                    [(r.staleness_mean, r.sim_time) for r in fed.history]))
    (pc, fc, sc), (ph, fh, sh) = out
    check(sc == sh and all(np.array_equal(a, b) for a, b in zip(fc, fh)),
          "async parity: schedules differ between card and CPU")
    err = {p: float((pc[p] - ph[p]).abs().max()) for p in pc}
    worst = max(err, key=err.get)
    check(err[worst] <= PARITY_TOL, f"async parity {worst}: card vs CPU "
          f"max abs err {err[worst]} > {PARITY_TOL}")
    return err[worst], worst


def phase_async_round(dev, smi):
    """VGG16 at full width under the buffered-async engine (8 clients,
    buffer 4, pareto:1.2, qint8), hub then 2 edges; the zero-staleness
    flush against the synchronous packed round, bitwise; a float64
    card-vs-CPU flush; K2 at the single-client dispatch shape.  Returns
    K2's launches by path and its dispatch-shape timing."""
    from repro_torch import paper_round

    k2 = {}
    for tag, kw in (("hub", {}),
                    ("hierarchical", {"topology": "hierarchical",
                                      "n_edges": 2})):
        fed, _, _, k2[f"async {tag} vgg16 qint8"] = _async_run(dev, tag, **kw)
        del fed
        torch.cuda.empty_cache()
    sync = paper_round.build(dev, packed=True, codec="qint8")
    (rs,) = sync.fit(1)
    az = paper_round.build(dev, packed=True, codec="qint8", async_buffer=8,
                           client_delay_dist="none")
    (ra,) = az.fit(1)
    torch.cuda.synchronize()
    diff = [p for p in sync.params if not torch.equal(sync.params[p],
                                                      az.params[p])]
    check(not diff, f"zero-staleness flush differs from the sync round at "
          f"{len(diff)} leaves, e.g. {diff[:3]}")
    check(ra.staleness_max == 0.0 and ra.uplink_bytes == rs.uplink_bytes,
          "zero-staleness flush: staleness or bill differ")
    print(f"[async-round] zero staleness (delay none, buffer 8 = C): the "
          f"flush == the sync packed qint8 round bitwise ({len(sync.params)} "
          f"leaves), uplink {ra.uplink_bytes:.0f} B both; {ra.seconds:.3f} s "
          f"against {rs.seconds:.3f} s")
    del sync, az
    torch.cuda.empty_cache()
    for opt, flushes in (("adam", 1), ("sgd", 3)):
        err, at = _async_parity(dev, opt, flushes)
        print(f"[async-round] parity ({opt}): {flushes} flush(es) of VGG16 "
              f"width 0.125 in float64, card vs CPU: same schedule, max "
              f"abs err {err:.3e} at {at} (tol {PARITY_TOL})")
    return k2, _k2_dispatch_timing(dev, smi)


def phase_cohort_round(dev):
    """VGG16 at full width in the cohort engine: 1,000 registered
    clients, a cohort of 8 in chunks of 4 and of 8 (one chunk), the
    ``loss_proportional`` sampler, qint8, ``crash:0.1`` (resampling):
    one K2 launch a chunk, the two chunkings bitwise equal; the
    ``uniform`` sampler; R == C against the synchronous packed round,
    bitwise.  Returns K2's launches by path."""
    from repro_torch import paper_round
    from repro_torch.kernels.codec import ops as qops

    runs, k2 = {}, {}
    for chunk in (4, 8):
        fed = paper_round.build(dev, cohort_chunk=chunk, faults="crash:0.1",
                                client_sampler="loss_proportional",
                                **COHORT_KW)
        eng = fed.server.cohort_engine
        qops.reset_launch_counts()
        hist = fed.fit(2)
        torch.cuda.synchronize()
        launches = qops.quantize_pack_group.launches
        chunks = sum(eng.n_chunks for r in hist if not r.skipped)
        check(launches == chunks, f"cohort chunk {chunk}: quantize_pack "
              f"launched {launches} times for {chunks} chunks")
        check(all(math.isfinite(r.loss) for r in hist) and _finite(fed),
              f"cohort chunk {chunk}: non-finite loss or params")
        for r in hist:
            print(f"[cohort-round] chunk {chunk} round {r.round}: "
                  f"{r.seconds:.3f} s, {r.n_participants} participants of "
                  f"1,000 registered, loss {r.loss:.4f}, uplink "
                  f"{r.uplink_bytes:.0f} B qint8; K2 {launches // 2} "
                  f"launches a round ({eng.n_chunks} chunks of {chunk})")
        k2[f"cohort 1000 chunk {chunk} vgg16 qint8"] = launches
        runs[chunk] = ({p: x.clone() for p, x in fed.params.items()},
                       list(fed.server.sel_history), fed.comm_summary(),
                       [r.loss for r in hist], eng.fleet)
        del fed, eng
        torch.cuda.empty_cache()
    (pa, sa, ca, la, fa), (pb, sb, cb, lb, fb) = runs[4], runs[8]
    check(all(torch.equal(pa[p], pb[p]) for p in pa) and la == lb
          and ca == cb and all(np.array_equal(x, y) for x, y in zip(sa, sb))
          and np.array_equal(fa.loss_ema, fb.loss_ema)
          and np.array_equal(fa.counts, fb.counts),
          "cohort: chunks of 4 and of 8 differ")
    print(f"[cohort-round] chunks of 4 == one chunk of 8, bitwise: "
          f"{len(pa)} leaves, selections, losses, bill, fleet EMAs "
          f"({int(fa.counts.sum())} participations over "
          f"{int((fa.counts > 0).sum())} fleet members)")
    fed = paper_round.build(dev, cohort_chunk=4, **COHORT_KW)
    qops.reset_launch_counts()
    (rec,) = fed.fit(1)
    torch.cuda.synchronize()
    check(qops.quantize_pack_group.launches == 2 and _finite(fed),
          "cohort uniform sampler: K2 launches or params")
    k2["cohort 1000 chunk 4 vgg16 qint8 uniform"] = 2
    print(f"[cohort-round] uniform sampler, chunk 4: {rec.seconds:.3f} s, "
          f"K2 2 launches")
    del fed
    sync = paper_round.build(dev, packed=True)
    sync.fit(2)
    eng = paper_round.build(dev, packed=True, n_registered=8, cohort_chunk=4)
    eng.fit(2)
    torch.cuda.synchronize()
    check(all(torch.equal(sync.params[p], eng.params[p]) for p in sync.params)
          and [r.loss for r in sync.history] == [r.loss for r in eng.history]
          and sync.comm_summary() == eng.comm_summary(),
          "cohort R == C differs from the synchronous packed round")
    print(f"[cohort-round] R == C (8 registered, chunks of 4) == the sync "
          f"packed round, 2 rounds, bitwise: params, losses, bill")
    del sync, eng
    torch.cuda.empty_cache()
    return k2


def phase_chaos(dev):
    """Faults on the VGG16 round: crashes on the dense hub (K1, the
    crashed clients' weights zeroed); NaN / Inf / exponent-flip
    corruption on the packed qint8 hub behind the gate; the async chaos
    mix; zero-rate chaos against clean, bitwise.  Returns K1's and K2's
    launches by path."""
    from repro_torch import paper_round
    from repro_torch.kernels.codec import ops as qops
    from repro_torch.kernels.masked_agg import ops as aops

    fed = paper_round.build(dev, faults="crash:0.25")
    aops.reset_launch_counts()
    hist = fed.fit(ENGINE_ROUNDS)
    torch.cuda.synchronize()
    inj = fed.server.fault_injector
    k1 = aops.masked_agg.launches
    crashed = 0
    for r in hist:
        want = inj.crash_mask(r.round, range(fed.fl.n_clients))
        check(np.array_equal(np.asarray(r.effective_weights) == 0, want),
              f"chaos crash round {r.round}: zeroed weights != crash mask")
        crashed += int(want.sum())
    check(k1 == sum(not r.skipped for r in hist) and crashed > 0,
          f"chaos crash: K1 launched {k1} times, {crashed} crashes")
    check(_finite(fed), "chaos crash: non-finite params")
    print(f"[chaos] dense hub crash:0.25, {ENGINE_ROUNDS} rounds: {crashed} "
          f"crashed clients zeroed as the injector drew them, K1 launches "
          f"{k1} (one a round), params finite; round s "
          + ", ".join(f"{r.seconds:.3f}" for r in hist))
    del fed
    fed = paper_round.build(dev, packed=True, codec="qint8",
                            faults=SYNC_DELTA_FAULTS,
                            max_delta_norm=MAX_DELTA_NORM)
    cap = Capture()
    fed.server.add_hook(cap)
    qops.reset_launch_counts()
    hist = fed.fit(ENGINE_ROUNDS)
    torch.cuda.synchronize()
    k2 = {"hub vgg16 packed qint8 delta faults": qops.quantize_pack_group
          .launches}
    inj = fed.server.fault_injector
    hits = 0
    for rec, m in cap.rounds:
        want = inj.corrupt_plan(rec.round, range(fed.fl.n_clients))["mode"]
        got = np.asarray(m["quarantined"]) > 0
        check(np.array_equal(got, want != 0), f"chaos round {rec.round}: "
              f"quarantined {got.astype(int)} != injected {want}")
        hits += int(got.sum())
    check(hits > 0 and _finite(fed) and
          k2["hub vgg16 packed qint8 delta faults"] == ENGINE_ROUNDS,
          f"chaos delta faults: {hits} quarantined, K2 {k2}")
    print(f"[chaos] packed qint8 hub {SYNC_DELTA_FAULTS}, max_delta_norm "
          f"{MAX_DELTA_NORM:g}: quarantined == injected in every round "
          f"({hits} uploads), params finite, wasted "
          + ", ".join(f"{r.wasted_bytes:.0f}" for r in hist)
          + f" B, K2 {ENGINE_ROUNDS} launches")
    del fed, cap
    fed, cap, seqs, k2["async hub vgg16 qint8 chaos"] = _async_run(
        dev, "async", "chaos", client_drop_prob=0.1, faults=ASYNC_FAULTS,
        max_delta_norm=MAX_DELTA_NORM)
    inj = fed.server.fault_injector
    hits = 0
    for (rec, m), entries in zip(cap.rounds, seqs):
        want = np.asarray([inj.corrupt_async(c, s)[0] != 0 or inj.torn(c, s)
                           for c, s in entries])
        got = np.asarray(m["quarantined"]) > 0
        check(np.array_equal(got, want), f"async chaos flush {rec.round}: "
              f"quarantined {got.astype(int)} != injected {want.astype(int)}")
        hits += int(got.sum())
    wasted = fed.comm_summary()["total_wasted_bytes"]
    check(wasted > 0, "async chaos: no wasted bytes")
    print(f"[chaos] async {ASYNC_FAULTS}, drop 0.1: quarantined == "
          f"corrupted or torn in every flush ({hits} entries), params "
          f"finite, {wasted:.0f} B wasted in all")
    del fed, cap
    runs = []
    for faults in ("", "crash:0,nan:0,kill:0"):
        fed = paper_round.build(dev, packed=True, codec="qint8",
                                faults=faults)
        fed.fit(2)
        torch.cuda.synchronize()
        runs.append(({p: x.clone() for p, x in fed.params.items()},
                     fed.comm_summary(), [r.loss for r in fed.history]))
        del fed
    (pa, ca, la), (pb, cb, lb) = runs
    check(all(torch.equal(pa[p], pb[p]) for p in pa) and ca == cb
          and la == lb, "zero-rate chaos differs from the clean run")
    print(f"[chaos] zero-rate chaos (crash:0,nan:0,kill:0) == clean, packed "
          f"qint8, 2 rounds, bitwise: {len(pa)} leaves, losses, bill")
    torch.cuda.empty_cache()
    return {"hub vgg16 crash:0.25": k1}, k2


def phase_engine_resume(dev, smi):
    """Kill + resume through ``run_with_restarts`` (``kill:0.5``, a
    ``Checkpointer`` every round) against the uninterrupted run, VGG16
    at full width: the async engine (3 flushes), the cohort engine
    (1,000 registered, chunks of 4, 3 rounds) and ``history_cap=2`` on
    the dense hub (6 rounds, whose capped bill also equals Table 4 of
    every round's selections); all bitwise."""
    import shutil
    import tempfile
    from repro_torch import paper_round
    from repro_torch.core import Checkpointer, run_with_restarts
    from repro_torch.core.comm import table4_row

    cases = [("async", ASYNC_KW, ENGINE_ROUNDS),
             ("cohort", dict(COHORT_KW, cohort_chunk=4), ENGINE_ROUNDS),
             ("history_cap", dict(history_cap=2), 6)]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_engine_")
    try:
        for tag, kw, rounds in cases:
            full = paper_round.build(dev, **kw)
            cap = Capture()
            full.server.add_hook(cap)
            full.fit(rounds)
            path = os.path.join(tmp, tag)

            def make(inc, kw=kw, path=path):
                return paper_round.build(
                    dev, faults="kill:0.5", incarnation=inc,
                    hooks=[Checkpointer(path, every=1)], **kw)

            t0 = time.perf_counter()
            fed = run_with_restarts(make, rounds, path)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            restarts = fed.server.fault_injector.incarnation
            check(restarts > 0, f"{tag}: kill:0.5 never fired")
            check(_same_state(full.params, fed.params), f"{tag}: resumed "
                  f"params differ from the uninterrupted run")
            # a Checkpointer saves between a round's append and its
            # history_cap trim (as the reference's does), so a run killed
            # right after a save keeps a row more than the cap until its
            # next round: compare the rows both kept, and that each run
            # accounts for every round once
            sa, sb = full.server.sel_history, fed.server.sel_history
            k = min(len(sa), len(sb))
            check([r.loss for r in full.history] ==
                  [r.loss for r in fed.history] and k > 0 and
                  all(np.array_equal(a, b) for a, b in zip(sa[-k:],
                                                           sb[-k:])) and
                  all(s._sel_base + len(s.sel_history) == rounds
                      for s in (full.server, fed.server)) and
                  full.comm_summary() == fed.comm_summary(),
                  f"{tag}: losses, selections or bill differ")
            extra = ""
            if tag == "history_cap":
                srv = full.server
                check(srv._sel_base == rounds - 2 and
                      len(srv.sel_history) == 2, "history_cap: retention")
                t4 = table4_row(full.assign, full.params, np.stack(
                    [np.asarray(m["sel"]) for _, m in cap.rounds]))
                summ = full.comm_summary()
                check(all(math.isclose(summ[k], v, rel_tol=1e-12)
                          for k, v in t4.items()),
                      f"history_cap: {summ} != table4_row {t4}")
                extra = (f"; 2 of {rounds} selection rows kept, bill == "
                         f"Table 4 of all {rounds} rounds")
            nbytes = os.path.getsize(path + ".npz")
            print(f"[engine-resume] {tag}: {rounds} rounds straight == "
                  f"{restarts} kills + resumes (kill:0.5, checkpoint every "
                  f"round, {nbytes} B), bitwise: params, losses, "
                  f"selections, bill{extra}; {secs:.2f} s with restarts "
                  f"({smi})")
            del full, fed, cap
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs a CUDA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "-i", CARD, "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")
    phase_build()
    k1 = phase_kernel(dev)
    phase_parity(dev)
    k1_paths = {"hub vgg16": phase_round(dev)}
    phase_round_repeat(dev)
    k2 = phase_codec_kernel(dev)
    k2_paths = {"hub vgg16 packed qint8": phase_packed_round(dev)}
    phase_codec_rounds(dev)
    k1_paths.update(phase_paper_tasks(dev))
    phase_paper_tasks_parity(dev)
    (k1_paths["hierarchical vgg16"],
     k2_paths["hierarchical vgg16 packed qint8"], hier) = phase_hier_round(dev)
    phase_gossip_round(dev)
    k1_paths.update(phase_scored_round(dev))
    k2_paths["hub vgg16 packed qint8 score_weighted"] = \
        phase_scored_packed(dev)
    phase_ckpt_resume(dev, smi)
    k2_async, k2["dispatch_1client"] = phase_async_round(dev, smi)
    k2_paths.update(k2_async)
    k2_paths.update(phase_cohort_round(dev))
    k1_chaos, k2_chaos = phase_chaos(dev)
    k1_paths.update(k1_chaos)
    k2_paths.update(k2_chaos)
    phase_engine_resume(dev, smi)
    k1["plans"] = phase_k1_plans(dev, hier)
    del hier
    torch.cuda.empty_cache()
    k1_paths.update({"hierarchical vgg16 packed qint8": 0, "gossip vgg16": 0})
    for k, paths in ((k1, k1_paths), (k2, k2_paths)):
        k["launches"] = sum(paths.values())
        k["launches_by_path"] = paths
    k3 = phase_decode_kernel(dev)
    w, k3["launches"] = phase_serve(dev)
    phase_serve_parity(w)
    del w                                 # free qwen3 before rwkv6's build
    torch.cuda.empty_cache()
    k5, k6 = phase_attention_kernels(dev)
    k4 = phase_decode_dense(dev)
    k7 = phase_wkv_kernel(dev)
    w, k7["launches"] = phase_serve_rwkv6(dev)
    phase_serve_rwkv6_parity(w)
    print(smi)
    print(json.dumps({"kernels": [k1, k2, k3, k4, k5, k6, k7]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
