#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root.  It drives ``repro_torch`` only (no JAX,
nothing of the ``repro`` package) in sixty-eight phases, in the order
below except that 17-20, then 22-28, then 56-57, then 21 run after 8,
62 after 11, 63, then 34-35 and 66, then 40-41, then 45, 64, 46 and 67,
then 50, 54, 55 and 65 after 16, 59-60 after 31, and 42, 53, 43-44,
then 47, 68 and 48-49, then 51-52 and 61 after 38 (39, then 58 last),
and any failure exits
non-zero.  Phases 56-57 start ranks of their own, as
``python3 chip_smoke.py --worker ...``, and wait for every one.
Each phase's wall seconds are printed before the kernels line:

1. build — compiles every CUDA kernel of the port from the sources in
   the checkout with ``nvcc`` (``repro_torch/kernels/_build.py``).
2. kernel — ``masked_agg`` at the round's shapes (VGG16 at full width,
   8 clients, tile 2048, the selection drawn as the round draws it
   (``uniform``, 7 of 14 units a client) with unit 1 then selected by
   nobody, a client of weight 0 and leaves that are not a multiple of
   the tile) against its plain PyTorch version on the card, at the
   reference's own bar (atol = rtol = 2e-5), the rows of unit 1
   bitwise the global tiles; with a NaN planted in a plane whose unit its client did not
   select, the output bitwise the clean one; the tree-level fused FedAvg
   against the plain ``masked_fedavg``; bitwise repeatability; median
   times of the kernel, the plain version, an empty kernel and a
   ``torch.bmm`` yardstick beside two bounds the card's memory rate
   sets: the live planes' bytes (this run's work) and every plane's.
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
   sequences of 129-175 tokens) and at 8 x 4,096 tokens, on
   hymba-1.5b's (25 over 5 of 64, a GQA group of 5) at the serving shape
   and on a ring of 1,024 (8 sequences past it, valid lengths clamped
   to the ring), and on qwen2.5-14b's (40 over 8 of 128) and
   granite-moe-1b-a400m's (16 over 8 of 64) and stablelm-3b's (32 over
   32 of 80) at the serving shape, pages
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
   in fp32, the forward's time against the previous design's.  Then the
   zoo's own shapes at B=1 in fp32 (qwen3-1.7b at S=4,096, gemma3-12b's
   local and global layers at S=2,048, hymba-1.5b's windowed (1,024) and
   global layers at S=2,048, head dim 64 in groups of 5,
   granite-moe-1b-a400m's at S=4,096, 16 heads over 8 of 64,
   stablelm-3b's at S=4,096, 32 over 32 of 80, fp32 and bf16,
   internvl2-26b's round at S=5,120, 48 over 8 of 128), held and
   timed the same way but
   reached through the model's wrapper ``models.attention.attend``
   (chunked, ``q_chunk`` 1024, a causal window of 1,024 on the local
   layer) and differentiated through an output projection, so that K6
   gets the gradient layout a model gives it.  Last, whisper-medium's
   non-causal shapes (16 heads of 64, B=1, fp32): Sq = Sk = 1,500 and Sq
   = 4,096 over Sk = 1,500 through ``attention.pad_noncausal`` (zero rows
   to whole blocks, ``kv_len`` masking the padded keys), held to the
   plain version on the unpadded inputs at the fp32 bars, the zero keys
   counted failing them; kernel, route, plain and SDPA times beside the
   bound of the real pairs.
13. decode-dense — ``decode_attention`` (K4, launched on K3's kernel)
   at qwen3-1.7b width in ``decode_32k`` (8 caches of 32,768 positions,
   ragged valid lengths, fp32 and bf16), on a gemma3-12b ring cache
   (1,024 slots, window 1,024, valid lengths beyond it; also through
   ``flash_decode`` in the reference kernel's layout, and valid length 0
   giving zeros) and on a cache of 1,000 positions with ``blk_k`` 512
   (positions 512.. never read), and on whisper-medium's caches (8 x
   1,500 cross positions, all valid, fp32 and bf16; 8 x 200 self
   positions; ``blk_k`` the cache's length, 16 heads of 64, timed as
   ``decode_32k``): within 2e-5 of the plain version (3e-2
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
   deltas, selections drawn as the round draws them with unit 1 then
   selected by nobody, a client of weight 0) and at the hierarchical hub combine (the 2 edge planes of 19's
   last round) against its plain version at 2e-5, an unselected NaN
   skipped bitwise, bitwise repeatable; device medians (L2 flushed) of
   the kernel, the plain version, an empty kernel and a ``torch.bmm``
   yardstick beside both bounds in bytes (live planes, every plane).
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
   generator) and gossip (8 stacked replicas), VGG16 at full width: 2
   rounds straight against 1 round, ``Federation.save``, a new
   ``Federation`` restored, 1 more round (4 and 2 + 2 before a cut for
   the smoke's time): state, ``sel_state``, codec
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

29. zoo-round — the paper's round on qwen3-1.7b at full width
   (1,720,574,976 fp32 params, 30 units: ``embed``, ``layer0-27``,
   ``head``) through ``Federation.from_config`` with the pod step's loss
   keywords (``launch.steps.default_loss_kwargs``: chunked attention,
   remat per layer): 2 clients training 15 of 30 units (``uniform``,
   hub, Adam at the launcher's lr 2e-3), 2 local steps of one
   ``lm_batch`` sequence of ``train_4k``'s 4,096 tokens, 2 rounds.
   Launches counted against the prediction from the code: K1 once a
   round; K5 twice per layer and step (the forward and its remat
   recompute) and K6's dQ and dK/dV once per layer and step (the
   backward reaches layer 0: every stacked leaf is live).  Frozen
   (client, unit row) deltas exactly zero, the bill equal to Table 4;
   each round's seconds, uplink and loss, the peak memory; then one
   round under ``torch.profiler``: the device's busy share, cuBLAS's
   share and the kernels' in-run device ms.
30. zoo-packed — the same with ``packed=True, codec="qint8"``: K2 once a
   round, K1 never, the same K5/K6 counts (the slots are written into a
   full-shape leaf that requires grad whole, so the backward reaches
   layer 0 here too); pads and untrained slots exactly zero; claimed ==
   encoded == billed bytes; K2's in-run time beside its byte bound.
31. zoo-train-step — gemma3-12b at full width cut to its first macro
   block (6 of 48 layers: five of window 1,024, one global; 2.35 B
   params), ``launch.steps.make_train_step`` at S = 2,048, batch 1, 2
   steps: K5 12 and K6 6 + 6 a step; the local and the global layers'
   in-run times from one profiled step.
32. zoo-parity — qwen3-1.7b at full width cut to 2 layers, one hub round
   of SGD at rate ZOO_PARITY_LR and S = 544 (the chunked route), 2
   clients, on the card (K5, K6, K1) and on the host CPU (plain
   versions), same params, batches and replayed selections (each client trains exactly ``n_train_units``
   = 2 units, both layers trained by some client): every parameter
   within ZOO_PARITY_TOL, and every macro row of the attention
   projections (wq, wk, wv, wo) moved by at least 10 x ZOO_PARITY_TOL,
   so that a wrong K6 gradient could not hide under the tolerance.
33. train-launcher — ``python -m repro_torch.launch.train --arch
   qwen3-1.7b --clients 2 --rounds 1 --batch-size 1 --steps-per-round 1
   --seq 64`` as a subprocess on the card: exit 0, the reference's
   header line, a JSON comm summary.  Then ``[zoo-kernels]``: K5 and K6
   at the zoo's shapes (phase 12's B=1 cases: alone, plain and
   ``scaled_dot_product_attention`` in fp32) beside the in-run times and
   bounds; K1 at the qwen3 hub plan and K2 over the qwen3 slot rows
   against their byte bounds.

34. serve-hymba — hymba-1.5b at full width in fp32 (1,476,611,200
   params, random weights) through ``DecodeEngine`` under both traffics
   of ``serve_workload.py``: ``serving`` ([serve]'s: 8 slots, 16
   requests of 128 prompt tokens, no ring, the prefill on the plain
   attention) and ``long`` (4 slots, 4 requests of 1,536 tokens
   generating 64, the windowed sub-layers' caches rings of 1,024 that
   wrap, the prefill on K5).  Checks the parameter count, the decode
   steps the traffic gives (84, 63), K3 launched once per layer per
   decode step, K5 once per layer per prefill call on ``long`` and never
   on ``serving``, every request's token count, one decode input
   signature; prints tokens/s, decode ms per step, TTFT, latency and
   peak memory.
35. serve-hymba-parity — each traffic's measured engine run (its logits
   recorded) against ``static_generate`` on the card, as
   ``[serve-parity]`` (logits 1e-3, tokens equal barring near ties).
36. zoo-round-hymba — the paper's round on hymba-1.5b at full width cut
   to 16 of 32 layers (789,711,200 params; 18 units, 9 trained a
   client), [zoo-round]'s setup at S = 2,048 (past
   the window, so the windowed and the global layers' K5/K6 do
   different work): 2 rounds, the second under ``torch.profiler``
   (host and device events; the profile must hold every launch the
   counters saw in that round).  Launches as the code predicts (K1 2,
   K5 256, K6 128 + 128), frozen (client, unit row) deltas exactly
   zero, the bill equal to Table 4, peak memory; the device's busy
   share, the kernels' in-run times, windowed and global apart.
37. zoo-parity-hymba — [zoo-parity] on hymba-1.5b at full width cut to
   one macro block of 2 sub-layers (window cut to 256, one global),
   S = 544: card vs CPU at ZOO_PARITY_TOL with its per-row move checks.
38. train-launcher-hymba — [train-launcher] with ``--arch hymba-1.5b
   --rounds 2``.
39. k1-qwen3-plan — K1 alone at qwen3-1.7b's hub plan (840,177 rows of
   2,048, 2 clients, the round's row -> unit table) on random tile
   buffers with the selection drawn as the round draws it (15 of 30
   units a client): against its plain version on every row, the rows
   of the units nobody selected unchanged, an unselected NaN skipped
   bitwise; device medians of the kernel,
   the plain version, an empty kernel and ``torch.bmm`` with the guard
   beside both byte bounds.

40. serve-moe — granite-moe-1b-a400m at full width in fp32
   (1,334,756,352 params, random weights; every layer's MLP a MoE of 32
   experts, top 8, capacity factor 1.25) through ``DecodeEngine`` under
   both traffics, as ``[serve-hymba]`` (no ring): 84 and 63 decode
   steps, K3 24 x 84 and 24 x 63, K5 0 and 24 (one prefill of 4 x 1,536
   tokens); prints tokens/s, decode ms per step, TTFT and the token
   copies dropped at capacity (``models.moe``'s device counter: prefill
   groups only, a decode step over 8 slots has 8 slots an expert).
41. serve-moe-parity — under each traffic, the engine against
   ``static_generate`` on the card on as many requests as slots,
   admitted in one group (the same prefill batch, 8 x 128 or 4 x 1,536
   on K5; 8 or 4 decode rows): each run's dropped copies equal to its
   routing records' and to the other run's, logits 1e-3, tokens equal
   barring near ties; a token routed differently in the two runs must
   lie within ROUTE_TIE of a tie (``moe.trace_routing``), a copy kept
   by one run alone must sit in a call where such a token moved, and
   that request's stream is compared up to that step.
42. zoo-round-moe — [zoo-round]'s setup on granite-moe-1b-a400m at
   full width cut to 12 of 24 layers (14 units, 7 trained a client) at
   S = 4,096: launches K1 2, K5 192, K6 96 + 96; frozen (client, unit row) deltas exactly zero, the bill
   equal to Table 4, peak memory, the second round profiled (host and
   device events, every launch present); then the federation built
   again from the same seed, 2 rounds: every parameter bitwise equal.
43. zoo-parity-moe — [zoo-parity] on granite-moe-1b-a400m cut to 2
   layers at full width, S = 544, routing made decisive
   (``_decisive_routing``): card vs CPU at ZOO_PARITY_TOL, the CPU run's
   least router gap at least 100 x ZOO_PARITY_TOL.
44. train-launcher-moe — [train-launcher] with ``--arch
   granite-moe-1b-a400m``.

45. serve-stablelm — stablelm-3b at full width in fp32 (2,795,443,200
   params, random weights; 32 heads over 32 of 80) under [serve]'s
   traffic: 84 decode steps, K3 at head dim 80 launched 32 x 84 times,
   every request's token count, one decode input signature; tokens/s,
   decode ms per step, TTFT, latency, peak memory; then the engine
   against ``static_generate`` as [serve-parity] (logits 1e-3).
46. serve-whisper — whisper-medium at full width in fp32 (760,348,672
   params, random weights, ``frames`` (8, 1,500, 1,024) from the seed)
   through ``static_generate``: 8 sequences of 64 prompt tokens, each
   generating 64 greedily (max_len 200); K5 24 launches (the encoder's
   1,500 frames through the padded non-causal route), K4 48 a decode
   step (self and cross cache in 24 layers); tokens/s, ms a step, peak
   memory; then the same loop on the plain attention: logits within
   1e-3, tokens equal barring near ties.
47. zoo-round-whisper — [zoo-round-moe]'s setup on whisper-medium (50
   units: embed, 24 encoder and 24 decoder layers, head; 25 trained a
   client) at 4,096 decoder tokens over 1,500 frames: launches K1 2, K5
   960 (per local step the encoder's 24, the decoder's self and cross
   in the forward and the remat recompute), K6 576 + 576; frozen deltas
   exactly zero, the bill equal to Table 4, the second round profiled
   (K5/K6 in-run by attention: encoder, self, cross), then built again
   from one seed and held bitwise.
48. zoo-parity-whisper — [zoo-parity] on whisper-medium at full width cut
   to 2 encoder and 2 decoder layers, 1,500 frames, S = 544, SGD at
   WHISPER_PARITY_LR: card vs CPU at ZOO_PARITY_TOL, every row of the
   self- and cross-attention projections moved by 10 x that.
49. zoo-parity-stablelm — [zoo-parity] on stablelm-3b at full width cut to
   2 layers, S = 544 (K5/K6 at head dim 80).
50. serve-vlm — internvl2-26b at full width in fp32 cut to 12 of 48 layers
   (5,826,048,000 params, random weights; 48 layers, 79.5 GB, do not
   fit the card in fp32; phase 54 serves them in bf16), ``patches`` (8,
   1,024, 1,024) from the seed, through
   ``static_generate``: 8 sequences of 1,024 patches and 128 prompt
   tokens, each generating 64 greedily (max_len 1,224); K5 12 launches
   (one a layer over 1,152 positions), K3/K4 none; tokens/s, prefill ms,
   ms a step, peak memory; the prefill profiled (K5 in-run); then the
   same loop on the plain attention (logits within 1e-3, tokens equal
   barring near ties); K5 alone at the prefill's shape beside its plain
   version, SDPA and the bound.
51. zoo-round-vlm — [zoo-round-moe]'s setup on internvl2-26b cut to 2
   layers at full width (1,925,222,400 params; 4 units: embed with the
   projector, layer0, layer1, head; 2 trained a client) at 4,096 text
   tokens after 1,024 patches: launches K1 2, K5 32, K6 16 + 16; frozen
   deltas exactly zero, the bill equal to Table 4, peak memory, the
   second round profiled, then built again from one seed and held
   bitwise.
52. zoo-parity-vlm — [zoo-parity] on internvl2-26b at full width cut to 1
   layer and 416 patches, 128 text tokens (K5/K6 over 544 positions),
   one client training every unit, the projector included: card vs CPU
   at ZOO_PARITY_TOL.

53. zoo-packed-moe — [zoo-round-moe] with ``packed=True,
   codec="qint8"``: launches K2 2 (one grouped call a round over every
   leaf's slot rows; the expert leaves' rows of 32 x 1,024 x 512
   elements take K2's two-visit route), K1 0, K5 192, K6 96 + 96; the
   first round's expert slot rows' codes and scales bitwise equal to
   K2's plain version on the same rows and uniforms; claimed ==
   encoded == billed bytes every round; frozen slots exactly zero; the
   second round profiled (K2's in-run time against its byte bound);
   peak memory; rebuilt from one seed and held bitwise.
54. serve-vlm-bf16 — internvl2-26b whole (48 layers, 19,869,020,160
   params, 39.7 GB) in bf16 (``param_dtype="bfloat16"``) under [serve-vlm]'s
   traffic through ``static_generate``: K5 48 launches, all on
   ``flash_attention_sm90.cu`` (``ops.SOURCE_LAUNCHES``), K3/K4 none;
   tokens/s, prefill ms, ms a step, peak memory.  Bars, stated as
   BAR_FACTOR x a yardstick's distance from the same oracle (the largest
   over logits rows of ||x - y|| / ||y||): (a1) every layer's K5 output
   in the prefill within ``ref.rounding_error_ratio``'s bar of the
   rounding plain version on the same q, k, v; (a2) the prefill's text
   logits and VLM_FORCED teacher-forced decode steps against the loop on
   the plain attention in bf16, within BAR_FACTOR x the distance of the
   loop whose attention runs in fp32; (b) [serve-vlm]'s 12-layer fp32
   model and its weights cast to bf16: the bf16 run on K5 within
   BAR_FACTOR x the distance of the bf16 run on the plain attention from
   the fp32 run; (c) a planted fault, layer 0's key tile 0 left out of
   every later query tile, outside all three bars; (e) K5 alone at (8,
   1,152, 48 over 8, 128) in bf16 against its rounding plain version,
   with cuDNN's SDPA and the bound at 989 TFLOP/s.
55. serve-gemma3 — gemma3-12b at full width in fp32 (11,765,419,776
   params, random weights; 48 layers, 5 windowed (1,024) and 1 global a
   macro block, 16 heads over 8 of 256) through ``DecodeEngine`` under
   both traffics, as [serve-hymba]: K3 48 x 84 and 48 x 63 at head dim
   256 (the long traffic's windowed sub-layers on rings of 1,024 that
   wrap), K5 48 in the long prefill (windowed and global); each traffic's
   engine (logits recorded) against ``static_generate``: logits within
   1e-3, tokens equal barring near ties; then K3 alone at both traffics'
   decode shapes, fp32 and bf16, as [decode-kernel].
56. mesh-round — cell 1 ([round]), its packed qint8 round
   ([packed-round]) and the cohort of 8 from 1,000 in chunks of 4
   ([cohort-round]), each with ``client_shards=2``: 2 ranks, processes
   of their own (``chip_smoke.py --worker``) joined over gloo, share the
   card (NCCL refuses two ranks on one device); each trains its half of
   every cohort and all-gathers the other's rows.  Every rank's final
   params and selections (digests), losses and bill equal the
   single-process run's; K1 3 launches a rank on the dense path, K2 one
   a round or chunk on each rank; each rank's round seconds beside the
   single-process run's.
57. moe-ep — ``apply_moe_sharded`` on one MoE layer of
   granite-moe-1b-a400m at full width (d 1,024, 32 experts of 512, top
   8, capacity factor 1.25) at 2 x 2,048 tokens with decisive routing,
   on meshes (data 1, model 2) and (data 2, model 2) of gloo ranks on
   the card and a (1, 1) mesh over NCCL, all side by side: on every rank
   y within 1e-5 and aux within 1e-6 of ``apply_moe`` on the card, every
   gradient within 1e-5 of its largest entry, the copies dropped over
   the ranks equal to ``apply_moe``'s, the least routing gap at least
   100 x the y bar, and a planted fault (ranks past model index 0 one
   expert off) outside the y bar; forward + backward seconds a rank.
58. k1-zoo-plans — [k1-qwen3-plan] at the plans of the hymba-1.5b
   (16 layers), whisper-medium, granite-moe-1b-a400m and internvl2-26b
   (2 layers) rounds, each taken from the plan its round built: the
   kernel, its plain version and ``torch.bmm`` + guard beside both byte
   bounds.
59. dryrun — ``repro_torch.launch.dryrun`` on the ``meta`` device over
   exactly [zoo-train-step]'s configuration, held to that phase's
   readings: (a) argument bytes equal the card's params, Adam moments
   and batch bytes exactly; (b) the predicted peak within 25% of
   ``torch.cuda.max_memory_allocated()``; (c) the roofline's dominant
   term at most the fastest measured step; (d) measured / roofline
   printed.  Then the ``--mesh one`` records of qwen3-1.7b at
   ``train_4k`` (batch 1), ``decode_32k`` and the ``fl_round`` step (the
   last through the CLI in a host-only process of its own, started
   before phase 12 and waited for after phase 60), printed without
   bars.
60. analysis — ``python -m repro_torch.analysis.cli --level trace
   --device cuda``, in process: zero unsuppressed findings, the same
   program list as the CPU run of the same registry, K1 launched in the
   dense round step, K2 in the qint8 round step and K3 in the reduced
   qwen3 decode; the decode program also runs once under
   ``torch.cuda.set_sync_debug_mode("error")``.
61. zoo-round-bf16 — qwen3-1.7b at full width in bf16
   (``param_dtype="bfloat16"``, 1,720,574,976 params, 3.44 GB drawn on
   the card), [zoo-round]'s setup with 4 clients (the launcher's
   default): (d) one local step from the initial params on the first
   client batch with the round's loss keywords, (d1) on K5/K6 bf16
   against the same step on the plain attention in bf16 within
   BAR_FACTOR x the distance of the step whose attention runs in fp32,
   the largest over leaves of ||g - g_plain|| / ||g_plain||, (d2) every
   layer's K6 dq, dk, dv within ``ref.rounding_error_ratio``'s bar of
   the rounding plain backward on the same inputs, (d3) a planted fault
   (layer 0's key tile 0 left out) outside both; then 2 rounds counted
   and a third profiled: (a) launches K1 2, all on ``masked_agg_bf16``, K5
   896, K6 448 + 448, all on ``flash_attention_sm90.cu``; (b) every
   param bf16 after each round, bf16 client planes and global tiles, the
   global read in place from round 2 on, frozen deltas exactly zero, the
   bill Table 4's; (c) K1 bf16 alone on round 3's own planes within one
   bf16 step of its plain version (or fp32 rounding where the update
   cancels the global value), an unselected NaN skipped, the fp32
   instance on the same tiles cast up bitwise the same after one
   rounding, its time beside the fp32 instance's, the plain version's,
   ``torch.bmm`` + guard in bf16 and both byte bounds; (e) round
   seconds, peak memory, busy share, cuBLAS's share, K1/K5/K6 in-run
   beside their bounds, set beside [zoo-round]'s fp32 figures; then
   rebuilt from the seed, its first round held bitwise.
62. serve-bf16 — qwen3-1.7b in bf16 (``param_dtype="bfloat16"``, the
   reference's switch): [serve]'s weights cast leaf by leaf
   (``serve_workload.cast``, 3.44 GB), through ``DecodeEngine`` under
   [serve]'s traffic and ``TRAFFIC["long"]``, each as
   ``_bf16_serving``: (e3) a greedy run, counters zeroed just before it:
   K3's bf16 instance 28 x 84 and 28 x 63, K5's on
   ``flash_attention_sm90.cu`` 28 in the long prefill, no fp32 launch,
   no plain version; its tokens/s, decode ms a step, TTFT, latency,
   peak memory; (e4) bf16 params and page pool, one decode signature;
   (e1) the first 8 (4) requests forced to the fp32 run's first 8
   tokens ([serve-parity]'s rows; an fp32 long run's), rows recorded,
   on the kernel (profiled: device ms a step by kind, K3 ms a call and
   K5 ms beside their bounds), on the plain gather + attention in bf16
   (the first decode step's calls also held, the kernel's output to the
   plain version in fp32 element by element, ``ref.bf16_error_ratio``),
   and (e2) with layer
   0's first page of every sequence left out: the kernel within 2 x the
   plain run's distance from the fp32 rows, of both; the fault outside
   both bars; the greedy stream parts from fp32's only at a near tie.
63. serve-rwkv6-bf16 — rwkv6-3b in bf16 on [serve-rwkv6]'s weights, the
   decay's base set to RWKV-6's own init (the reference's zeros carry
   nothing across a chunk), served in fp32 (8 requests, 8 tokens,
   rows recorded), cast (6.15 GB), then ``_bf16_serving`` under
   [serve]'s traffic: K7's bf16 instance 32 a prefill call, 288 (r, k,
   v bf16, the log-decay fp32; mixes bf16, WKV state fp32); the plain
   version ``chunked_linear_scan``; the element-wise bar against K7's
   fp32 instance; the fault drops layer 0's carry between chunks.
64. serve-stablelm-bf16 — stablelm-3b in bf16 on [serve-stablelm]'s
   weights cast (5.59 GB) and its parity's rows, as 62 under [serve]'s
   traffic: K3 bf16 at head dim 80, 32 x 84.
65. serve-gemma3-bf16 — gemma3-12b in bf16 on [serve-gemma3]'s long
   run: its rows recorded, then its weights cast leaf by leaf (23.53
   GB), as 62 under ``TRAFFIC["long"]``: K3 bf16 48 x 63 at head dim
   256 on the global sub-layers' pages and the windowed ones' rings of
   1,024 that wrap, K5 bf16 48 (windowed and global) in the prefill.
66. serve-hymba-bf16 — hymba-1.5b in bf16 on [serve-hymba]'s long run:
   its rows recorded, then its weights cast leaf by leaf (2.95 GB), as
   62 under ``TRAFFIC["long"]``: K3 bf16 32 x 63 at a GQA group of 5 (25
   heads over 5 of 64) on the global sub-layers' pages and the windowed
   ones' rings of 1,024 that wrap, K5 bf16 32 in the prefill; the conv
   state bf16 and the SSM state fp32; K3's first checked call timed
   alone beside its plain version and a gather + SDPA yardstick.
67. serve-whisper-bf16 — whisper-medium in bf16 on [serve-whisper]'s
   weights and frames cast (1.52 GB; the frames bf16, as the model takes
   them): a greedy ``static_generate`` of 32 tokens (K5 bf16 24 in the
   encoder's padded non-causal prefill, K4 bf16 48 a decode step, none of
   fp32, no plain version), the caches bf16; the 8 sequences forced to
   [serve-whisper]'s fp32 streams for 8 tokens on the kernels (profiled),
   on the plain attention (the first decode step's 48 K4 calls, self and
   cross, also held element by element to the plain version in fp32) and
   with layer 0 leaving out K4's first ring stage of the self cache and
   its first split of the cross cache: the bars of 62; K4 alone at the
   self and cross caches
   and K5 at the encoder's shape beside their plain versions and SDPA.
68. zoo-round-whisper-bf16 — [zoo-round-whisper]'s setup in bf16
   (760,348,672 params, the frames bf16) as 61: (d) the step bars, the
   K6 bar by attention (encoder, decoder self, cross; the fault at the
   encoder's layer 0), one counted round (K1 bf16 1, K5 bf16 480, K6
   bf16 288 + 288, all on ``flash_attention_sm90.cu``), one profiled,
   K1 bf16 alone at whisper's plan, the rebuild held bitwise on its
   first round.

It runs on one card: the first of ``CUDA_VISIBLE_DEVICES`` (card 0 if
that is unset), and it hides the others.  Before the last line it prints
the card's name and power limit (as ``nvidia-smi`` reports them) and a
JSON line of per-kernel numbers (K1's and K2's launches summed over the
paths that ran them, [mesh-round]'s ranks' included, each path's count
in ``launches_by_path``, K1's
other plans in ``plans``, its ``bound_ms`` the live planes' bytes (the
work this run's selections need) beside ``bound_all_planes_ms``, K2's single-client dispatch in
``dispatch_1client``; K3's those of the serving runs (10, 34, 40, 45,
55, and in bf16 62, 64, 65, 66, their in-run times in ``bf16_in_run``)
and gemma3-12b's shapes in ``cases``;
K4's those of whisper's decode steps (46, and in bf16 67, its in-run
time in ``bf16_in_run``), ``[decode-dense]``'s direct
calls beside them and its cases in ``cases``; K5's and K6's launches
those of the zoo's model paths (29-31, 36, 42, 47, 51, 53), the long
prefills (34, 40, 55, and in bf16 62, 65, 66), the bf16 rounds (61,
68), whisper's encoder prefill (46, and in bf16 67) and internvl2-26b's
prefills (50, 54),
with ``[attention-kernels]``' direct calls listed
beside them and the other shapes (head dim 80, whisper's
non-causal, internvl2-26b's round and its prefill in fp32 and bf16) in
``cases``; the zoo call sites' numbers in ``zoo``; K7's those of
rwkv6's prefills (15, and in bf16 63, its in-run time in
``bf16_in_run``); K1's bf16 instance, whose main paths are phases 61's
and 68's rounds, as an eighth entry, whisper's plan in ``plans``); the
last line
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

# one card: set before torch initialises CUDA (a rank of [mesh-round] or
# [moe-ep] sees the cards its parent gave it)
CARD = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
if sys.argv[1:2] != ["--worker"]:
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


FIRST_SOURCES = ("masked_agg.cu", "quantize_pack.cu")   # K1, K2


def _print_build(logs):
    for name, log in logs.items():
        print(f"[build] {name}:")
        for line in log.strip().splitlines():
            print(f"    {line}")


def phase_build():
    """Build K1's and K2's libraries, which the VGG16 phases run, and
    start ``nvcc`` for every other library in a thread (all together, as
    ``_build.build`` does); ``finish_build`` waits for them.  Returns
    ``(thread, result)``."""
    import threading
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    first = [s for s in _build.kernel_sources() if s.name in FIRST_SOURCES]
    check(len(first) == len(FIRST_SOURCES), f"[build] sources {first}")
    _print_build(_build.build(first))
    rest = [s for s in _build.kernel_sources() if s not in first]
    res = {"t0": t0}

    def run():
        try:
            res["logs"] = _build.build(rest)
        except BaseException as e:             # raised in finish_build
            res["error"] = e
        res["secs"] = time.perf_counter() - t0

    thread = threading.Thread(target=run, name="build")
    thread.start()
    return thread, res


def finish_build(started):
    """Wait for the libraries ``phase_build`` left building, print their
    compiler output and raise if one failed."""
    from repro_torch.kernels import _build
    thread, res = started
    thread.join()
    if "error" in res:
        raise res["error"]
    _print_build(res["logs"])
    n = len(_build.units(_build.kernel_sources()))
    print(f"[build] {n} kernel libraries from "
          f"{len(_build.kernel_sources())} sources in {res['secs']:.2f} s "
          f"(K1's and K2's first; the rest beside the first phases)")


def _k1_case(dev, params, assign, c, n_train):
    """K1's inputs at ``params``' tile plan for ``c`` clients: random
    deltas, the selection drawn as the round draws it (``uniform``, each
    client ``n_train`` units) with unit 1 then taken from every client
    (a unit nobody selected: its rows must keep the global value),
    client ``c // 2`` of weight 0 (a crashed client: its selected planes
    are still read); zero padding, so that whole tile buffers can be
    compared."""
    from repro_torch.kernels.masked_agg import ops
    from repro_torch.kernels.masked_agg.ref import draw_selection

    plan = ops.build_agg_plan(assign, params)
    sel = draw_selection(c, assign.n_units, n_train, 0)
    sel[:, 1] = 0.0                                  # a unit nobody selected
    rng = np.random.default_rng(0)
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
    k1_in = (g_t, d_t, sel.to(dev), weights.to(dev), plan.row_unit_on(dev))
    return plan, sel, weights, deltas, k1_in


def _k1_check(tag, k1_in, nobody=True):
    """K1 on ``k1_in = (g_t, d_t, sel, w, row_unit)`` against its plain
    version at TOL on every row, bitwise repeatable, the rows of a unit
    nobody selected unchanged (such rows required unless ``nobody`` is
    False), and a NaN planted in a plane whose unit its client did not
    select never reaching the output (``ops.check_kernel``).  Returns the
    max abs error."""
    from repro_torch.kernels.masked_agg.ops import check_kernel

    try:
        res = check_kernel(k1_in, TOL, nobody=nobody)
    except RuntimeError as e:
        raise RuntimeError(f"chip_smoke: {tag} {e}") from e
    if res["nan_at"] is None:
        print(f"{tag} every client plane is live: no unselected NaN to "
              f"plant")
    else:
        c0, t0 = res["nan_at"]
        print(f"{tag} a NaN in client {c0}'s row {t0} (a unit it did not "
              f"select): the output bitwise the clean one, the plain "
              f"version's within {TOL}")
    return res["max_abs_err"]


def phase_kernel(dev):
    from repro_torch.core import build_units_flat
    from repro_torch.core.aggregation import masked_fedavg
    from repro_torch.kernels.masked_agg import ops
    from repro_torch.models import paper_models as pm
    from repro_torch.paper_round import N_CLIENTS, N_TRAIN, WIDTH

    gen = torch.Generator().manual_seed(0)
    params = {p: x.to(dev) for p, x in
              pm.init_vgg16(gen, width_mult=WIDTH).items()}
    assign = build_units_flat(params, pm.vgg16_units(params))
    c = N_CLIENTS
    plan, sel, weights, deltas, k1_in = _k1_case(dev, params, assign, c,
                                                 N_TRAIN)
    ragged = [s for s in plan.segments if s.n % plan.tile]
    check(ragged, "no leaf off the tile multiple in the plan")
    t, tile = k1_in[0].shape
    err = _k1_check("[kernel]", k1_in)
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

    m = _k1_measure(k1_in, median_ms)
    print(f"[kernel] median ms: kernel {m['ms']:.4f}, plain "
          f"{m['plain_ms']:.4f}, torch.bmm {m['library_ms']:.4f}: {m['text']}")
    return {"name": "masked_agg", "route": "cuda",
            "source": "src/repro_torch/kernels/masked_agg/csrc/masked_agg.cu",
            "replaces": "src/repro/kernels/masked_agg/kernel.py:41",
            "max_abs_err": err, "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"],
            "bound_all_planes_ms": m["bound_all_ms"],
            "live_planes": m["live"], "empty_kernel_ms": m["empty_ms"]}


def _k1_measure(k1_in, timer):
    """K1's time, its plain version's and a ``torch.bmm`` yardstick's on
    the same inputs (``timer`` is ``median_ms`` or ``device_ms``), beside
    the bound of this run's work (the live planes' bytes over the memory
    rate, or their FLOPs over the fp32 peak), the bound of every client
    plane (the previous design's work) and an empty kernel's time (the
    launch floor)."""
    from repro_torch.kernels.masked_agg import ops
    from repro_torch.kernels.masked_agg.ref import masked_agg_ref
    from repro_torch.kernels.masked_agg.ref import k1_bytes

    g_t, d_t, sel, w, ru = k1_in
    t, tile = g_t.shape
    w_t = (sel[:, ru.long()] * w[:, None]).t().contiguous()   # (T, C)
    d_tct = d_t.permute(1, 0, 2).contiguous()        # (T, C, tile)

    def library():
        num = torch.bmm(w_t.unsqueeze(1), d_tct).squeeze(1)
        den = w_t.sum(1, keepdim=True)
        return g_t + torch.where(den > 0, num / den.clamp_min(1e-9),
                                 torch.zeros_like(num))

    lib_err = float((library() - masked_agg_ref(*k1_in)).abs().max())
    check(lib_err <= 1e-4, f"torch.bmm yardstick disagrees: {lib_err}")
    nb = k1_bytes(ru.cpu().numpy(), sel, tile)
    flops = 2 * nb["live"] * t * tile
    name = torch.cuda.get_device_name(0)
    rate = memory_rate(name)
    by_bytes, by_ops = nb["live_bytes"] / rate, flops / FP32_PEAK
    launches0 = ops.masked_agg.launches
    ms = timer(lambda: ops.masked_agg(*k1_in))
    plain_ms = timer(lambda: masked_agg_ref(*k1_in))
    library_ms = timer(library)
    empty_ms = timer(lambda: torch.cuda._sleep(0))
    check(ops.masked_agg.launches > launches0, "timing did not launch")
    bound = max(by_bytes, by_ops) * 1e3
    all_ms = nb["all"] / rate * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound, "bound_all_ms": all_ms, "live": nb["live"],
            "empty_ms": empty_ms,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "text": f"live planes {nb['live']:.3f} of {nb['planes']} a row "
                    f"({nb['live'] / nb['planes']:.1%}); bound of the live "
                    f"planes {nb['live_bytes'] / 1e6:.1f} MB at "
                    f"{rate / 1e12:.2f} TB/s = {by_bytes * 1e3:.4f} ms "
                    f"({flops / 1e9:.2f} GFLOP at {FP32_PEAK / 1e12:.0f} "
                    f"TFLOP/s {by_ops * 1e3:.4f}), the kernel at "
                    f"{bound / ms:.1%}; bound of every plane "
                    f"{nb['all'] / 1e6:.1f} MB = {all_ms:.4f} ms, the kernel "
                    f"at {all_ms / ms:.1%}; an empty kernel {empty_ms:.4f} "
                    f"ms (the kernel {ms / empty_ms:.2f}x it)"}


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
    MESH_WANT["dense"] = _run_record(fed)
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
    """Server hook: keeps each round's metrics for the checks below (only
    the ``keep`` entries when given)."""

    def __init__(self, keep=None):
        self.rounds, self.keep = [], keep

    def on_round_start(self, server, round_idx, weights):
        return None

    def on_round_end(self, server, record, metrics):
        if self.keep is not None:
            metrics = {k: metrics[k] for k in self.keep}
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
    params = {p: x.to("meta") for p, x in fed.params.items()}
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
    MESH_WANT["packed qint8"] = _run_record(fed)
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
    hier_in = (g_t, d_t, e_den.to(dev), torch.ones(2, device=dev),
               plan.row_unit_on(dev))
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
    return k1, k2, hier_in


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


CKPT_ROUNDS = 2          # straight, against 1 + save + restore + 1


def phase_ckpt_resume(dev, smi):
    """Four runs of VGG16 at full width (score_weighted hub; packed
    topk_ef, with its error-feedback residual; packed qint8, with its
    device generator; gossip, 8 stacked replicas), each CKPT_ROUNDS rounds
    straight against half of them, ``Federation.save``, a new
    ``Federation`` restored, the rest: the state, the selection state,
    the codec state, ``sel_history`` and ``comm_summary()`` bitwise
    equal.  Prints each
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
            full.fit(CKPT_ROUNDS)
            half = paper_round.build(dev, **kw)
            half.fit(CKPT_ROUNDS // 2)
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
            check(meta["round"] == CKPT_ROUNDS // 2,
                  f"{tag}: restored round {meta['round']}")
            resumed.fit(CKPT_ROUNDS - CKPT_ROUNDS // 2)
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
            check(len(a.sel_history) == len(b.sel_history) == CKPT_ROUNDS
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
            print(f"[ckpt-resume] {tag}: {CKPT_ROUNDS} rounds straight == "
                  f"{CKPT_ROUNDS // 2} + save + restore into a new "
                  f"Federation + {CKPT_ROUNDS - CKPT_ROUNDS // 2}, "
                  f"bitwise: state ({len(a.params)} leaves), "
                  + ", ".join(extra + ["sel_history", "comm_summary"])
                  + f"; checkpoint {nbytes} B, save {t_save:.3f} s, restore "
                  f"{t_restore:.3f} s ({smi})")
            del full, resumed, a, b
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_k1_plans(dev, hier_inputs):
    """K1 at the IMDB and CASA hub plans (10 clients, selections drawn as
    the round draws them) and at the hierarchical hub combine (VGG16, 2
    edge planes from ``[hier-round]``): against its plain version, an
    unselected NaN skipped, device medians (L2 flushed) beside both
    bounds, an empty kernel and a ``torch.bmm`` yardstick."""
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
        *_, k1_in = _k1_case(dev, params, assign, paper_tasks.N_CLIENTS,
                             paper_tasks.N_TRAIN[task])
        cases.append((task, k1_in))
    cases.append(("vgg16 hierarchical combine", hier_inputs))
    for tag, k1_in in cases:
        # the combine's edge planes come from a real round, which may
        # leave no unit without a participant
        err = _k1_check(f"[k1-plans] {tag}:", k1_in,
                        nobody=tag in paper_tasks.TASKS)
        m = _k1_measure(k1_in, device_ms)
        t, _ = k1_in[0].shape
        print(f"[k1-plans] {tag}: T={t} planes={k1_in[1].shape[0]}: max abs "
              f"err {err:.3e}; device median ms "
              f"kernel {m['ms']:.4f}, plain {m['plain_ms']:.4f}, torch.bmm "
              f"{m['library_ms']:.4f}: {m['text']}")
        out.append({"plan": tag, "rows": t, "planes": int(k1_in[1].shape[0]),
                    "live_planes": m["live"], "max_abs_err": err,
                    "ms": m["ms"], "plain_ms": m["plain_ms"],
                    "bound_ms": m["bound_ms"],
                    "bound_all_planes_ms": m["bound_all_ms"],
                    "empty_kernel_ms": m["empty_ms"],
                    "library_ms": m["library_ms"]})
    return out

# -- K3 and the serving path ---------------------------------------------------

QWEN3_PARAMS = 1_720_574_976     # the reference's init at full width
LOGIT_TOL = 1e-3                 # card: continuous (K3) vs static (plain)


def device_ms(fn, iters=20, warmup=3):
    """Median device time of ``fn`` with L2 flushed before each call
    (``repro_torch.profiling.device_ms``)."""
    from repro_torch.profiling import device_ms as timed
    return timed(fn, iters, warmup)


def _paged_case(dev, b, mp, lo, hi, dtype, seed, h=16, hkv=8, hd=128, ps=16,
                ring=False):
    """qwen3's heads unless given; sequence i owns mp pages scattered over
    the pool by a random permutation (8 pages nobody owns, page 0 the
    trash page); ragged valid lengths in [lo, hi], clamped to the table's
    mp * ps tokens when ``ring`` (a ring allocation past its window, as
    the model passes it); table entries past them -> 0."""
    n_pages = 1 + b * mp + 8
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, 1, h, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(n_pages, ps, hkv, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(n_pages, ps, hkv, hd, generator=gen, device=dev).to(dtype)
    rng = np.random.default_rng(seed)
    valid = rng.integers(lo, hi + 1, b)
    if ring:
        valid = np.minimum(valid, mp * ps)
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


def _decode_cases():
    """``[decode-kernel]``'s cases: (label, B, table width, valid lo, hi,
    H, Hkv, hd, ring).  qwen3's heads (16 over 8 of 128) at the serving
    shape and at 8 x 4,096 tokens; hymba-1.5b's (25 over 5 of 64, a GQA
    group of 5) at the serving shape and on a ring of 1,024 (the
    windowed sub-layers past the window: 8 sequences of 1,025-1,600
    tokens, valid lengths clamped to the ring); qwen2.5-14b's (40 over 8
    of 128, a group of 5), granite-moe-1b-a400m's (16 over 8 of 64, a
    group of 2) and stablelm-3b's (32 over 32 of 80: a row on 32 fp32 /
    16 bf16 lanes) at the serving shape."""
    from repro_torch import serve_workload as sw
    from repro_torch.configs.base import get_config

    max_len = sw.PROMPT_LEN + sw.GEN + sw.GEN_SPREAD - 1 + 8
    serving = (sw.N_SLOTS, -(-max_len // sw.PAGE_SIZE), sw.PROMPT_LEN + 1,
               sw.PROMPT_LEN + sw.GEN + sw.GEN_SPREAD - 1)
    hy, q14, gr, st = (get_config(HYMBA_ARCH), get_config("qwen2.5-14b"),
                       get_config(MOE_ARCH), get_config(STABLELM_ARCH))
    hy_heads = (hy.n_heads, hy.n_kv_heads, hy.head_dim)
    window = hy.sliding_window
    return [("serving", *serving, 16, 8, 128, False),
            ("long", 8, 256, 3072, 4096, 16, 8, 128, False),
            ("hymba serving", *serving, *hy_heads, False),
            ("hymba ring", 8, window // sw.PAGE_SIZE, window + 1,
             window + 576, *hy_heads, True),
            ("qwen2.5-14b serving", *serving, q14.n_heads, q14.n_kv_heads,
             q14.head_dim, False),
            ("granite serving", *serving, gr.n_heads, gr.n_kv_heads,
             gr.head_dim, False),
            ("stablelm serving", *serving, st.n_heads, st.n_kv_heads,
             st.head_dim, False)]


def _decode_case(dev, shape, b, mp, lo, hi, h, hkv, hd, ring, dtype, tol,
                 tag_name="decode-kernel"):
    """K3 alone on one ``_paged_case``: held to its plain version (bf16
    also element by element, with planted wrong outputs), bitwise
    repeatable, NaN trash and unowned pages never read, no host sync;
    device medians (L2 flushed) of the kernel, the plain version and
    gather + SDPA beside the bound.  Returns the case's row."""
    from repro_torch.kernels.flash_decode import ops as fops
    from repro_torch.kernels.flash_decode.ref import paged_decode_ref

    name = torch.cuda.get_device_name(0)
    q, k, v, pt, valid = _paged_case(dev, b, mp, lo, hi, dtype, 1,
                                     h=h, hkv=hkv, hd=hd, ring=ring)
    out = _no_sync(lambda: fops.paged_decode_attention(
        q, k, v, pt, valid))
    kf, vf = k.float(), v.float()
    want = paged_decode_ref(q.float(), kf, vf, pt, valid)
    torch.cuda.synchronize()
    err = float((out.float() - want).abs().max())
    tag = f"[{tag_name}] {shape} {str(dtype)[6:]}"
    check(out.dtype == dtype and err <= tol,
          f"{tag}: max abs err vs plain {err} > {tol}")
    ps = k.shape[1]
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
    del kn, vn, nan_out
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
          f"{int(valid.max())} ({ntok} tokens"
          + (", clamped to the ring" if ring else "")
          + f"): max abs err vs plain "
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
    return {"B": b, "H": h, "Hkv": hkv, "hd": hd, "splits": pl.n_splits,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": library_ms}


def phase_decode_kernel(dev):
    row, cases = None, {}
    for shape, b, mp, lo, hi, h, hkv, hd, ring in _decode_cases():
        for dtype, tol in ((torch.float32, TOL), (torch.bfloat16, 3e-2)):
            case = _decode_case(dev, shape, b, mp, lo, hi, h, hkv, hd, ring,
                                dtype, tol)
            cases[f"{shape} {str(dtype)[6:]}"] = case
            if shape == "serving" and dtype == torch.float32:
                row = {"name": "flash_decode_paged", "route": "cuda",
                       "splits": case["splits"],
                       "source": "src/repro_torch/kernels/flash_decode/csrc/"
                                 "flash_decode_paged.cu",
                       "replaces": "src/repro/kernels/flash_decode/kernel.py"
                                   ":111",
                       **{k: case[k] for k in ("max_abs_err", "ms",
                                               "plain_ms", "bound_ms",
                                               "bound_by", "library_ms")}}
    row["cases"] = cases
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
                       ran=None, flips=None, **overrides):
    """The continuous engine (qwen3: paged decode through K3) against the
    static loop (dense cache, plain attention) on the same prompts, on the
    card.  Logits rows agree to LOGIT_TOL; tokens agree, except at a step
    where the static loop's top-2 logit gap is below LOGIT_TOL (a near
    tie that rounding may break either way), after which that request's
    streams are no longer comparable.  ``overrides`` replace the engine's
    ServeConfig fields; ``static`` is a finished static run, ``ran`` a
    finished engine run ``(engine, results)``; ``flips`` maps a request to
    the step (and layer and router gap) where the two runs routed it
    differently at a near tie: its stream is compared up to that step.
    Returns the engine run ``(engine, results)``, its rows recorded."""
    from repro_torch import serve_workload as sw

    if ran is None:
        eng = sw.engine(w, record_logits=True, **overrides)
        res = eng.run()
    else:
        eng, res = ran
    out, rows = static or _static(w)
    worst, compared, diverged = 0.0, 0, []
    for i, g in enumerate(w.gens):
        mine = np.stack(eng.logits_rows[i])
        check(mine.shape[0] == g, f"request {i}: {mine.shape[0]} rows")
        for t in range(g):
            if flips and i in flips and flips[i][0] == t:
                _, layer, gap = flips[i]
                diverged.append((i, t, gap))
                why = (f"routes differently (router gap {gap:.3e} < "
                       f"{ROUTE_TIE})" if gap is not None else
                       "keeps a copy the other run drops, beside a near-tie "
                       "flip in the same call")
                print(f"[{tag}] request {i} {why} at step {t} (layer "
                      f"{layer}): not compared from there")
                break
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
    return eng, res


# -- hymba-1.5b: the hybrid family served (K3 at a GQA group of 5, K5) -------

HYMBA_ARCH = "hymba-1.5b"
HYMBA_PARAMS = 1_476_611_200     # the reference's init at full width
# the scheduler's decode steps under each traffic of serve_workload.py: a
# function of the traffic alone (slots, prompt and generation lengths,
# pages of 16: a micro-run stops at a finish or a page boundary), the
# same for every model (qwen3-1.7b's serving run takes 84;
# tests/test_torch_hymba.py counts both on the reduced model)
TRAFFIC_STEPS = {"serving": 84, "long": 63}


def _serve_traffics(dev, arch, n_params, tag, header, rings, after=None):
    """``arch`` at full width through ``DecodeEngine`` under both
    traffics of ``serve_workload.py``: ``serving`` (8 slots, 16 requests
    of 128 prompt tokens; the prefill on the plain attention) and
    ``long`` (4 slots, 4 requests of 1,536 tokens; the prefill on K5).
    ``header(cfg)`` describes the model; ``rings(cfg, traffic)`` is the
    expected ring flag of each sub-layer.  On the MoE family each run's
    dropped copies are counted (``models.moe``'s device counter).  With
    ``after``, the measured runs record their logits rows to the host
    (one (slots, V) copy a step) and ``after(traffic, w, engine,
    results)`` runs once each has finished."""
    from repro_torch import serve_workload as sw
    from repro_torch.common import param_count
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.kernels.flash_decode import ops as fops
    from repro_torch.models import moe

    out, params = {}, None
    for traffic in ("serving", "long"):
        label = f"[{tag}] {traffic}"
        t0 = time.perf_counter()
        w = sw.build(dev, arch=arch, traffic=traffic, params=params)
        torch.cuda.synchronize()
        cfg, t = w.cfg, w.traffic
        if params is None:
            n = param_count(w.params)
            check(n == n_params, f"{arch} has {n} params, expected "
                  f"{n_params}")
            check(all(x.dtype == torch.float32 and x.device == dev
                      for x in w.params.values()),
                  "params are not fp32 on the card")
            print(f"{label}: {cfg.name} at full width: {header(cfg)}, vocab "
                  f"{cfg.padded_vocab}, {n} fp32 params ({n * 4 / 1e9:.2f} "
                  f"GB) drawn on the card in {time.perf_counter() - t0:.2f}"
                  f" s")
            sw.engine(w, n_requests=2, gen=3).run()  # warm-up, not measured
        params = w.params
        eng = sw.engine(w, record_logits=after is not None)
        got_rings = [s.ring for s in eng.layout.subs]
        check(got_rings == rings(cfg, traffic),
              f"{label}: ring subs {got_rings}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fops.reset_launch_counts()
        aops.reset_launch_counts()
        moe.reset_dropped()
        res = eng.run()
        torch.cuda.synchronize()
        k3 = fops.paged_decode_attention.launches
        k5 = aops.LAUNCHES["fwd"]
        dropped = moe.dropped_copies()
        st = eng.stats()
        steps_ = st["n_decode_steps"]
        m = cfg.moe
        slots = m and moe.capacity_for(w.serve.n_slots, m.num_experts,
                                       m.top_k, m.capacity_factor)
        want_k5 = cfg.n_layers * st["n_prefill_calls"] \
            if t.attn_impl == "chunked" else 0
        check(steps_ == TRAFFIC_STEPS[traffic],
              f"{label}: {steps_} decode steps, predicted "
              f"{TRAFFIC_STEPS[traffic]}")
        check(k3 == cfg.n_layers * steps_, f"{label}: K3 launched {k3} times "
              f"in {steps_} decode steps of {cfg.n_layers} layers")
        check(k5 == want_k5 and aops.LAUNCHES["dq"] == 0,
              f"{label}: K5 launched {k5} times in {st['n_prefill_calls']} "
              f"prefill calls, predicted {want_k5}")
        check(all(len(res[i]) == g for i, g in enumerate(w.gens)),
              f"{label}: a request did not finish with its token count")
        check(eng.decode_cache_size == 1,
              f"{label}: decode step saw {eng.decode_cache_size} input "
              f"signatures")
        peak = torch.cuda.max_memory_allocated()
        print(f"{label}: {st['n_requests']} requests of {t.prompt_len} "
              f"prompt tokens over {w.serve.n_slots} slots (pages of "
              f"{w.serve.page_size}, max_len {eng.layout.max_len}, ring "
              f"subs {sum(got_rings)} of {len(got_rings)}), prefill "
              f"attention {t.attn_impl}: {st['total_tokens']} tokens in "
              f"{st['wall_s']:.3f} s: {st['tokens_per_sec']:.1f} tok/s; "
              f"decode {st['decode_ms_per_step']:.3f} ms per step over "
              f"{steps_} steps; {st['n_prefill_calls']} prefill calls; "
              f"TTFT p50 {st['ttft_p50_s']:.3f} s p99 {st['ttft_p99_s']:.3f}"
              f" s; latency p50 {st['latency_p50_s']:.3f} s p99 "
              f"{st['latency_p99_s']:.3f} s; {st['n_preemptions']} "
              f"preemptions; peak pages {st['peak_pages']}/"
              f"{st['n_pages'] - 1}; peak memory {peak / 2**30:.2f} GiB")
        print(f"{label}: flash_decode_paged (K3) launches {k3} = "
              f"{cfg.n_layers} x {steps_} decode steps; flash_attention_fwd"
              f" (K5) launches {k5} = {cfg.n_layers} x "
              f"{st['n_prefill_calls']} prefill calls"
              + (" (the plain attention)" if not want_k5 else "")
              + f"; every request finished with its requested token count;"
              f" decode input signatures {eng.decode_cache_size}"
              + (f"; token copies dropped at capacity {dropped} (prefill "
                 f"groups only: a decode step over {w.serve.n_slots} slots "
                 f"has {slots} slots an expert)" if m else ""))
        out[traffic] = (w, {"K3": k3, "K5": k5, "dropped": dropped}, st,
                        peak)
        if after is not None:
            after(traffic, w, eng, res)
        del eng, res
    return out


def phase_serve_hymba(dev):
    """hymba-1.5b under both traffics: on ``long`` the windowed
    sub-layers' caches are rings of 1,024."""
    def header(cfg):
        return (f"{cfg.n_layers} layers ({cfg.n_layers // cfg.global_every} "
                f"macro blocks of {cfg.global_every - 1} windowed "
                f"({cfg.sliding_window}) and 1 global), d_model "
                f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV "
                f"heads of {cfg.head_dim} beside {cfg.n_heads} SSM heads, "
                f"d_ff {cfg.d_ff}")

    ran = {}
    runs = _serve_traffics(
        dev, HYMBA_ARCH, HYMBA_PARAMS, "serve-hymba", header,
        lambda cfg, t: [t == "long"] * (cfg.global_every - 1) + [False],
        after=lambda t, w, eng, res: ran.__setitem__(t, (eng, res)))
    return runs, ran


def phase_serve_hymba_parity(runs, ran):
    """Each traffic's measured engine run (K3; K5 in the long prefill; its
    logits recorded) against ``static_generate`` (dense cache, plain
    attention) on the card."""
    for traffic, (w, *_rest) in runs.items():
        phase_serve_parity(
            w, "serve-hymba-parity", f"{HYMBA_ARCH} {traffic}: continuous "
            f"(K3" + (", K5 prefill" if w.serve.attn_impl == "chunked"
                      else "") + ") vs static (plain)", ran=ran[traffic])


# -- granite-moe-1b-a400m: the MoE family served (K3 at a GQA group of 2, K5)

MOE_ARCH = "granite-moe-1b-a400m"
MOE_PARAMS = 1_334_756_352       # the reference's init at full width
# [zoo-round-moe] and [zoo-packed-moe] cut to 12 of 24 layers for the
# smoke's time: every width as published
MOE_ROUND_LAYERS, MOE_ROUND_PARAMS = 12, 692_610_048
# two card runs route a token differently only at a near tie: a routing
# difference where the static run's k-th and (k+1)-th router
# probabilities lie further apart than this fails the phase
ROUTE_TIE = 1e-4


def phase_serve_moe(dev):
    """granite-moe-1b-a400m under both traffics (one full-attention
    sub-layer a block: no ring)."""
    def header(cfg):
        m = cfg.moe
        return (f"{cfg.n_layers} layers, d_model {cfg.d_model}, "
                f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV heads of "
                f"{cfg.head_dim}, every MLP a MoE of {m.num_experts} experts "
                f"of {m.expert_d_ff}, top {m.top_k}, capacity factor "
                f"{m.capacity_factor}, tied embeddings")

    return _serve_traffics(dev, MOE_ARCH, MOE_PARAMS, "serve-moe", header,
                           lambda cfg, t: [False])


def _routing_flips(eng, stat, n_layers, prompt_len, gens, tag):
    """The engine's routing records (``moe.trace_routing``) against the
    static loop's, call by call (the prefill's ``n_layers`` calls, then
    each decode step's): {request: (step, layer, gap)}, the first call
    where a request still generating is routed or dropped differently.
    A request's first routing difference must lie within ROUTE_TIE of a
    tie in the static run (its ``gap``).  From there its rows differ by
    whole experts and are not compared.  The call's tokens share each
    expert's capacity, so a routing difference can move another token's
    copy across it: a copy kept by one run and dropped by the other is
    allowed only in a call where some token routed differently, and its
    request then diverges too (``gap`` None).  Returns the flips and each
    run's dropped copies over the requests that never diverged."""
    check(len(eng) == len(stat), f"[{tag}] {len(eng)} MoE calls in the "
          f"engine, {len(stat)} in the static loop")
    n = len(gens)
    gen_t = torch.tensor(list(gens) + [0])
    gone = torch.zeros(n + 1, dtype=torch.bool)      # row n: idle rows
    flips, calls = {}, []
    for c, (a, b) in enumerate(zip(eng, stat)):
        step, layer = divmod(c, n_layers)
        rows, k = a["topi"].shape
        req = torch.arange(rows) // (prompt_len if step == 0 else 1)
        req = req.clamp(max=n)
        live = (req < n) & (step < gen_t[req])
        ta, tb = a["topi"].sort(-1).values, b["topi"].sort(-1).values
        moved = (ta != tb).any(-1).cpu()
        kept = [torch.where(x["keep"].view(rows, k), x["topi"], -1)
                .sort(-1).values for x in (a, b)]
        shifted = (kept[0] != kept[1]).any(-1).cpu() & ~moved
        for r in (moved & live & ~gone[req]).nonzero().flatten().tolist():
            q, gap = int(req[r]), float(b["gap"][r])
            check(gap < ROUTE_TIE, f"[{tag}] request {q} step {step} "
                  f"layer {layer}: routed differently at a router gap of "
                  f"{gap} >= {ROUTE_TIE}")
            flips.setdefault(q, (step, layer, gap))
        if flips:
            gone[list(flips)] = True
        for r in (shifted & live & ~gone[req]).nonzero().flatten().tolist():
            q = int(req[r])
            check(bool(moved.any()), f"[{tag}] request {q} step {step} "
                  f"layer {layer}: a copy kept by one run and dropped by "
                  f"the other, with every token routed alike")
            flips.setdefault(q, (step, layer, None))
        if flips:
            gone[list(flips)] = True
        calls.append((req, live, a["keep"].view(rows, k),
                      b["keep"].view(rows, k)))
    drops = [0, 0]
    for req, live, ka, kb in calls:
        ok = (req < n) & ~gone[req]
        for i, keep in enumerate((ka, kb)):
            drops[i] += int((~keep.cpu())[ok].sum())
    return flips, drops


def phase_serve_moe_parity(runs):
    """The engine (K3; K5 in the long prefill) against ``static_generate``
    (dense cache, plain attention) on the card, under each traffic, on as
    many requests as the traffic has slots: admitted in one group, so
    that both runs prefill the same batch (``serving``: 8 x 128, capacity
    320 an expert; ``long``: all 4 of 1,536, capacity 1,920) and decode
    as many rows (8 or 4: 8 slots an expert, nothing dropped).  A copy is
    dropped at capacity depending on the other tokens of its call, so the
    16-request serving traffic is not held to the static loop: the engine
    prefills 8 prompts and then one at a time (capacity 320, then 40 an
    expert), the static loop all 16 at once (640), and they drop
    different copies.  The device counter's dropped copies must equal
    each run's routing records', and the two runs' must be equal over
    the requests that never diverged (all of them when nothing flipped).
    A token routed differently at a near tie, or a copy moved across
    capacity by such a token in the same call (``_routing_flips``), is
    reported like a logits near tie, and that request's stream is not
    compared from there."""
    from repro_torch import serve_workload as sw
    from repro_torch.models import moe

    tag = "serve-moe-parity"
    for traffic, (w, *_rest) in runs.items():
        n, cfg, plen = w.serve.n_slots, w.cfg, w.traffic.prompt_len
        w1 = w._replace(prompts=w.prompts[:n], gens=w.gens[:n])
        moe.reset_dropped()
        with moe.trace_routing() as stat:
            static = _static(w1)
        stat_drop = moe.dropped_copies()
        moe.reset_dropped()
        with moe.trace_routing() as routed:
            eng = sw.engine(w1, record_logits=True)
            res = eng.run()
        eng_drop = moe.dropped_copies()
        st = eng.stats()
        check(st["n_prefill_calls"] == 1, f"[{tag}] {traffic}: "
              f"{st['n_prefill_calls']} prefill calls")
        for who, recs, got in (("engine", routed, eng_drop),
                               ("static", stat, stat_drop)):
            traced = sum(int((~r["keep"]).sum()) for r in recs)
            check(got == traced, f"[{tag}] {traffic}: the {who}'s counter "
                  f"dropped {got} copies, its routing records {traced}")
        flips, (eng_kept, stat_kept) = _routing_flips(
            routed, stat, cfg.n_layers, plen, w1.gens, tag)
        check(eng_kept == stat_kept and (bool(flips) or eng_drop == stat_drop),
              f"[{tag}] {traffic}: dropped copies engine {eng_drop}, "
              f"static {stat_drop}; over the requests that never diverged "
              f"{eng_kept}, {stat_kept}")
        m = cfg.moe

        def cap(t):
            return moe.capacity_for(t, m.num_experts, m.top_k,
                                    m.capacity_factor)

        print(f"[{tag}] {traffic}: {n} requests of {plen} tokens admitted "
              f"in one group: both runs prefill the same {n} x {plen} batch"
              f" (capacity {cap(n * plen)} an expert) and decode {n} rows "
              f"(capacity {cap(n)}); dropped copies engine {eng_drop}, "
              f"static {stat_drop} (each == its routing records), over the "
              f"requests that never diverged {eng_kept} == {stat_kept}; "
              f"{len(routed)} MoE calls compared, {len(flips)} request(s) "
              f"diverged at a near tie")
        del routed, stat
        phase_serve_parity(
            w1, tag, f"{MOE_ARCH} {traffic}: continuous (K3"
            + (", K5 prefill" if w.serve.attn_impl == "chunked" else "")
            + ") vs static (plain)", static=static, ran=(eng, res),
            flips=flips)
        del eng, res, static

# -- stablelm-3b (head dim 80 on K3) and whisper-medium (K4, K5) served -------

STABLELM_ARCH = "stablelm-3b"
STABLELM_PARAMS = 2_795_443_200  # by the config's dims (the meta-device init)
WHISPER_ARCH = "whisper-medium"
WHISPER_PARAMS = 760_348_672     # the reference's eval_shape at full width
# [serve-whisper]: 8 sequences of 64 prompt tokens, each generating 64
# (128 until the bf16 phases needed the smoke's time), over self caches
# of 200 positions (under the decoder's 448)
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_GEN = 8, 64, 64
WHISPER_MAX_LEN = 200


def phase_serve_stablelm(dev):
    """stablelm-3b at full width in fp32 (32 layers, 32 heads over 32 of
    80, LayerNorm, 25% rotary) through ``DecodeEngine`` under
    ``[serve]``'s traffic: K3 at head dim 80 once per layer per decode
    step; then the engine against ``static_generate`` as
    ``[serve-parity]``.  Returns the launches, the workload and the
    parity's engine run."""
    from repro_torch import serve_workload as sw
    from repro_torch.common import param_count
    from repro_torch.kernels.flash_decode import ops as fops

    tag = "[serve-stablelm]"
    t0 = time.perf_counter()
    w = sw.build(dev, arch=STABLELM_ARCH)
    torch.cuda.synchronize()
    cfg, n = w.cfg, param_count(w.params)
    check(n == STABLELM_PARAMS, f"{tag} {n} params, expected "
          f"{STABLELM_PARAMS}")
    check(cfg.head_dim == 80 and cfg.n_heads == cfg.n_kv_heads == 32,
          f"{tag} heads {cfg.n_heads} / {cfg.n_kv_heads} of {cfg.head_dim}")
    print(f"{tag} {cfg.name} at full width: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV heads "
          f"of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.padded_vocab}, "
          f"{n} fp32 params ({n * 4 / 1e9:.2f} GB) drawn on the card in "
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
    steps_ = st["n_decode_steps"]
    check(steps_ == TRAFFIC_STEPS["serving"], f"{tag} {steps_} decode "
          f"steps, predicted {TRAFFIC_STEPS['serving']}")
    check(launches == cfg.n_layers * steps_, f"{tag} K3 launched "
          f"{launches} times in {steps_} decode steps of {cfg.n_layers} "
          f"layers")
    check(all(len(res[i]) == g for i, g in enumerate(w.gens)),
          f"{tag} a request did not finish with its token count")
    check(eng.decode_cache_size == 1,
          f"{tag} decode step saw {eng.decode_cache_size} input signatures")
    print(f"{tag} {st['n_requests']} requests of {sw.PROMPT_LEN} prompt "
          f"tokens over {w.serve.n_slots} slots (pages of "
          f"{w.serve.page_size}), {st['total_tokens']} tokens in "
          f"{st['wall_s']:.3f} s: {st['tokens_per_sec']:.1f} tok/s; decode "
          f"{st['decode_ms_per_step']:.3f} ms per step over {steps_} steps; "
          f"TTFT p50 {st['ttft_p50_s']:.3f} s p99 {st['ttft_p99_s']:.3f} s; "
          f"latency p50 {st['latency_p50_s']:.3f} s p99 "
          f"{st['latency_p99_s']:.3f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"{tag} flash_decode_paged (K3) at 32 over 32 heads of 80: "
          f"launches {launches} = {cfg.n_layers} x {steps_} decode steps "
          f"(its time alone at this shape: [decode-kernel] stablelm "
          f"serving)")
    del eng
    run = phase_serve_parity(w, "serve-stablelm", f"{STABLELM_ARCH}: "
                             f"continuous (K3 at head dim 80) vs static "
                             f"(plain)")
    return launches, w, run


def phase_serve_whisper(dev):
    """whisper-medium at full width in fp32 (random weights, ``frames``
    from the seed) through ``static_generate`` (the audio family's only
    serving loop, as in the reference): 8 sequences of 64 prompt tokens
    each generating 64 greedily over self caches of 200 positions.  The
    prefill encodes 1,500 frames on K5 (``attn_impl="chunked"``: 24
    launches through the padded non-causal route; the decoder's 64 rows
    take the plain attention), and every decode step runs K4 48 times
    (self and cross in 24 layers).  Then the same loop on the plain
    attention (the encoder's ``attend_reference``, ``decode_attend`` in
    the decode step): every logits row within LOGIT_TOL, tokens equal
    barring near ties.  Returns the figures and, under ``"bf16_in"``,
    the model, prompts, frames, tokens and rows that
    ``[serve-whisper-bf16]`` casts and holds itself to."""
    from unittest import mock
    from repro_torch.common import param_count
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.kernels.flash_decode import ops as fops
    from repro_torch.models import attention, get_model, whisper
    from repro_torch.serve.engine import static_generate

    tag = "[serve-whisper]"
    cfg = get_config(WHISPER_ARCH)
    model = get_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n = param_count(params)
    check(n == WHISPER_PARAMS, f"{tag} {n} params, expected "
          f"{WHISPER_PARAMS}")
    b, gen = WHISPER_BATCH, WHISPER_GEN
    prompts = torch.randint(0, cfg.vocab, (b, WHISPER_PROMPT),
                            generator=torch.Generator().manual_seed(1),
                            dtype=torch.int32).numpy()
    frames = torch.randn((b, cfg.enc_seq, cfg.d_model), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3))
    print(f"{tag} {cfg.name} at full width: {cfg.n_enc_layers} encoder and "
          f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.padded_vocab}, {n} fp32 params ({n * 4 / 1e9:.2f} GB) drawn "
          f"on the card in {time.perf_counter() - t0:.2f} s; frames "
          f"{tuple(frames.shape)} from the seed")

    def run(attn_impl, k=b, steps=gen):
        return static_generate(cfg, params, prompts[:k], steps,
                               max_len=WHISPER_MAX_LEN, attn_impl=attn_impl,
                               collect_logits=True, device=dev,
                               extra={"frames": frames[:k]})

    run("chunked", 2, 3)                             # warm-up, not measured
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fops.reset_launch_counts()
    aops.reset_launch_counts()
    t0 = time.perf_counter()
    out, rows = run("chunked")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k4, k5 = fops.paged_decode_attention.launches, dict(aops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(k4 == 2 * cfg.n_layers * (gen - 1), f"{tag} K4 launched {k4} "
          f"times in {gen - 1} decode steps of {cfg.n_layers} layers")
    check(k5 == {"fwd": cfg.n_enc_layers, "dq": 0, "dkv": 0},
          f"{tag} K5/K6 launches {k5}, predicted {cfg.n_enc_layers} "
          f"forward (the encoder)")
    check(out.shape == (b, gen) and all(np.isfinite(r).all() for r in rows),
          f"{tag} tokens {out.shape} or non-finite logits")
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, torch.as_tensor(prompts, device=dev),
                      frames=frames, max_len=WHISPER_MAX_LEN,
                      attn_impl="chunked", last_only=True)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    step_ms = (wall - prefill_s) / (gen - 1) * 1e3
    print(f"{tag} {b} sequences x {WHISPER_PROMPT} prompt tokens, {gen} "
          f"generated each (max_len {WHISPER_MAX_LEN}), greedy: {b * gen} "
          f"tokens in {wall:.3f} s: {b * gen / wall:.1f} tok/s; prefill "
          f"(encoder + prompt) {prefill_s * 1e3:.1f} ms; decode "
          f"{step_ms:.3f} ms per step over {gen - 1} steps; peak memory "
          f"{peak / 2**30:.2f} GiB")
    print(f"{tag} flash_decode (K4) launches {k4} = 2 x {cfg.n_layers} "
          f"layers x {gen - 1} decode steps (self cache blk_k "
          f"{WHISPER_MAX_LEN}, cross cache blk_k {cfg.enc_seq}); "
          f"flash_attention_fwd (K5) launches {k5['fwd']} = "
          f"{cfg.n_enc_layers} encoder layers x 1 prefill (1,500 frames "
          f"padded to 1,536, kv_len 1,500)")

    def plain(q, k_cache, v_cache, valid):
        return attention.decode_attend(q, k_cache, v_cache, valid)

    fops.reset_launch_counts()
    aops.reset_launch_counts()
    with mock.patch.object(whisper, "_decode_attend", plain):
        out_p, rows_p = run("reference")
    check(fops.paged_decode_attention.launches == 0 and
          aops.LAUNCHES["fwd"] == 0, f"{tag} the plain run launched a "
          f"kernel")
    worst, compared, diverged = 0.0, 0, []
    for i in range(b):
        for t in range(gen):
            err = float(np.abs(rows[t][i] - rows_p[t][i]).max())
            check(err <= LOGIT_TOL, f"{tag} sequence {i} step {t}: logits "
                  f"differ by {err} > {LOGIT_TOL}")
            worst = max(worst, err)
            compared += 1
            if out[i, t] != out_p[i, t]:
                top2 = np.sort(rows_p[t][i])[-2:]
                gap = float(top2[1] - top2[0])
                check(gap < LOGIT_TOL, f"{tag} sequence {i} step {t}: "
                      f"tokens {out[i, t]} vs {out_p[i, t]} with a top-2 "
                      f"gap {gap}")
                diverged.append((i, t, gap))
                print(f"{tag} sequence {i} diverges at step {t}: plain "
                      f"top-2 gap {gap:.3e} < {LOGIT_TOL}")
                break
    print(f"{tag} K4/K5 vs the plain attention on the card: {compared} "
          f"logits rows of {b} sequences, max abs err {worst:.3e} (tol "
          f"{LOGIT_TOL}); token streams equal"
          + (f" up to {len(diverged)} near-tie divergence(s)" if diverged
             else ""))
    del out_p, rows_p
    return {"K4": k4, "K5": k5["fwd"], "tok_s": b * gen / wall,
            "step_ms": step_ms, "peak": peak,
            "bf16_in": {"cfg": cfg, "params": params, "prompts": prompts,
                        "frames": frames, "tokens": out, "rows": rows}}


VLM_ARCH = "internvl2-26b"
VLM_PARAMS = 19_869_020_160      # the reference's eval_shape at full width
# 48 layers in fp32 take 79.5 GB, more than the card: every width as
# published, the depth cut to 12 layers to serve in fp32 (the 48 serve in
# bf16, [serve-vlm-bf16]) and 2 to train
VLM_SERVE_LAYERS, VLM_SERVE_PARAMS = 12, 5_826_048_000
VLM_ROUND_LAYERS, VLM_ROUND_PARAMS = 2, 1_925_222_400
# [serve-vlm]: 8 sequences of 1,024 patches and 128 prompt tokens, each
# generating 64, over caches of launch/serve.py's s + gen + 8 + n_patches
VLM_BATCH, VLM_PROMPT, VLM_GEN = 8, 128, 64
VLM_MAX_LEN = VLM_PROMPT + VLM_GEN + 8 + 1024
VLM_PARITY_S = 128               # text tokens after the patches
VLM_PARITY_PATCHES = 416         # [zoo-parity-vlm]'s patches (544 positions)
VLM_ROUND_S = 1024 + 4096        # the round's positions: patches + train_4k


def phase_serve_vlm(dev, smi):
    """internvl2-26b at full width in fp32 cut to 12 of 48 layers (random
    weights, ``patches`` (8, 1,024, 1,024) from the seed) through
    ``static_generate`` (the vlm family's only serving loop, as in the
    reference): 8 sequences of 1,024 patches and 128 prompt tokens, each
    generating 64 greedily (max_len 1,224).  The prefill runs K5 once a
    layer over 1,152 positions (9 blocks of 128, no padding); the decode
    steps launch no kernel (the plain ``decode_attend``, as the
    reference's).  Then the prefill alone under the profiler (K5's
    in-run time), the same loop on the plain attention (every logits row
    within LOGIT_TOL, tokens equal barring near ties), and K5 alone at
    the prefill's shape beside its plain version, SDPA and the bound.
    Returns the readings and, for ``[serve-vlm-bf16]``, the params, the
    prompts, the patches and the generated tokens."""
    from repro_torch.common import param_count
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_fwd_ref
    from repro_torch.kernels.flash_decode import ops as fops
    from repro_torch.models import get_model
    from repro_torch.models.transformer import vit_width
    from repro_torch.serve.engine import static_generate

    tag = "[serve-vlm]"
    cfg = get_config(VLM_ARCH).replace(n_layers=VLM_SERVE_LAYERS)
    model = get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s, init_peak = time.perf_counter() - t0, \
        torch.cuda.max_memory_allocated()
    n = param_count(params)
    check(n == VLM_SERVE_PARAMS, f"{tag} {n} params, expected "
          f"{VLM_SERVE_PARAMS}")
    b, gen, h, hkv, hd = (VLM_BATCH, VLM_GEN, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim)
    s = cfg.n_patches + VLM_PROMPT
    prompts = torch.randint(0, cfg.vocab, (b, VLM_PROMPT),
                            generator=torch.Generator().manual_seed(1),
                            dtype=torch.int32).numpy()
    patches = torch.randn((b, cfg.n_patches, vit_width(cfg)), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(2))
    print(f"{tag} {cfg.name} at full width cut to {cfg.n_layers} of 48 "
          f"layers: d_model {cfg.d_model}, {h} heads / {hkv} KV heads of "
          f"{hd}, d_ff {cfg.d_ff}, vocab {cfg.padded_vocab}, projector "
          f"{vit_width(cfg)} -> {cfg.d_model}; {n:,} fp32 params "
          f"({n * 4 / 1e9:.2f} GB; 48 layers: {VLM_PARAMS:,}, "
          f"{VLM_PARAMS * 4 / 1e9:.2f} GB) drawn on the card in "
          f"{init_s:.2f} s, peak memory after init "
          f"{init_peak / 1e9:.2f} GB; patches {tuple(patches.shape)} from "
          f"the seed")

    def run(attn_impl, k=b, steps=gen):
        return static_generate(cfg, params, prompts[:k], steps,
                               max_len=VLM_MAX_LEN, attn_impl=attn_impl,
                               collect_logits=True, device=dev,
                               extra={"patches": patches[:k]})

    run("chunked", 2, 2)                             # warm-up, not measured
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fops.reset_launch_counts()
    aops.reset_launch_counts()
    t0 = time.perf_counter()
    out, rows = run("chunked")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k34, k5 = fops.paged_decode_attention.launches, dict(aops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(k5 == {"fwd": cfg.n_layers, "dq": 0, "dkv": 0},
          f"{tag} K5/K6 launches {k5}, predicted {cfg.n_layers} forward "
          f"(one a layer in the prefill)")
    check(k34 == 0, f"{tag} the decode steps launched K3/K4 {k34} times")
    check(out.shape == (b, gen) and all(np.isfinite(r).all() for r in rows),
          f"{tag} tokens {out.shape} or non-finite logits")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, torch.as_tensor(prompts, device=dev),
                      patches=patches, max_len=VLM_MAX_LEN,
                      attn_impl="chunked", last_only=True)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    events = _kernel_events(prof)
    del prof
    k5_us = [t for nm, t in events if "fwd_kernel" in nm]
    check(len(k5_us) == cfg.n_layers, f"{tag} the profiled prefill holds "
          f"{len(k5_us)} K5 events, predicted {cfg.n_layers}")
    busy = sum(t for _, t in events) / 1e3
    gemm = sum(t for nm, t in events if "gemm" in nm.lower()) / 1e3
    in_run = float(np.mean(k5_us)) / 1e3
    step_ms = (wall - prefill_s) / (gen - 1) * 1e3
    print(f"{tag} {b} sequences x ({cfg.n_patches:,} patches + "
          f"{VLM_PROMPT} prompt tokens), {gen} generated each (max_len "
          f"{VLM_MAX_LEN}), greedy: {b * gen} tokens in {wall:.3f} s: "
          f"{b * gen / wall:.1f} tok/s; prefill ({s:,} positions, "
          f"profiled) {prefill_s * 1e3:.1f} ms, device busy {busy:.1f} ms "
          f"(cuBLAS gemm {gemm:.1f}, K5 {sum(k5_us) / 1e3:.1f}); decode "
          f"{step_ms:.3f} ms per step over {gen - 1} steps; peak memory "
          f"{peak / 1e9:.2f} GB ({peak / 2**30:.2f} GiB)")
    print(f"{tag} flash_attention_fwd (K5) launches {k5['fwd']} = "
          f"{cfg.n_layers} layers x 1 prefill over {s:,} positions; K3/K4 "
          f"{k34} (the decode step's attention is the plain decode_attend)")

    aops.reset_launch_counts()
    out_p, rows_p = run("reference")
    check(aops.LAUNCHES["fwd"] == 0 and
          fops.paged_decode_attention.launches == 0,
          f"{tag} the plain run launched a kernel")
    worst, compared, diverged = 0.0, 0, []
    for i in range(b):
        for t in range(gen):
            err = float(np.abs(rows[t][i] - rows_p[t][i]).max())
            check(err <= LOGIT_TOL, f"{tag} sequence {i} step {t}: logits "
                  f"differ by {err} > {LOGIT_TOL}")
            worst = max(worst, err)
            compared += 1
            if out[i, t] != out_p[i, t]:
                top2 = np.sort(rows_p[t][i])[-2:]
                gap = float(top2[1] - top2[0])
                check(gap < LOGIT_TOL, f"{tag} sequence {i} step {t}: "
                      f"tokens {out[i, t]} vs {out_p[i, t]} with a top-2 "
                      f"gap {gap}")
                diverged.append((i, t, gap))
                print(f"{tag} sequence {i} diverges at step {t}: plain "
                      f"top-2 gap {gap:.3e} < {LOGIT_TOL}")
                break
    print(f"{tag} K5 vs the plain attention on the card: {compared} logits "
          f"rows of {b} sequences, max abs err {worst:.3e} (tol "
          f"{LOGIT_TOL}); token streams equal"
          + (f" up to {len(diverged)} near-tie divergence(s)" if diverged
             else ""))
    del rows, rows_p
    _free_card("serve-vlm")

    # K5 alone at the prefill's shape: (8, 1,152, 48 over 8, 128), causal
    g = torch.Generator(device=dev).manual_seed(s)
    q = torch.randn(b, s, h, hd, generator=g, device=dev)
    k, v = (torch.randn(b, s, hkv, hd, generator=g, device=dev)
            for _ in range(2))
    o, lse = aops.attention_fwd(q, k, v, causal=True, window=0)
    o_ref, lse_ref = flash_attention_fwd_ref(q, k, v, causal=True, window=0)
    err = max(float((o - o_ref).abs().max()),
              float((lse - lse_ref).abs().max()))
    check(err <= TOL, f"{tag} K5 at the prefill's shape: max abs err vs "
          f"plain {err} > {TOL}")
    lib_err = float((_sdpa_attn(q, k, v, 0) - o_ref).abs().max())
    check(lib_err <= 1e-3, f"{tag} the sdpa yardstick disagrees by "
          f"{lib_err}")
    del o, lse, o_ref, lse_ref
    t = {"ms": device_ms(lambda: aops.attention_fwd(
            q, k, v, causal=True, window=0), ATTN_ITERS),
         "plain_ms": device_ms(lambda: flash_attention_fwd_ref(
             q, k, v, causal=True, window=0), ATTN_ITERS),
         "library_ms": device_ms(lambda: _sdpa_attn(q, k, v, 0),
                                 ATTN_ITERS)}
    backend = _sdpa_backend(q, k, v, torch.randn_like(q), 0)
    bound = _attn_bound(torch.cuda.get_device_name(0), b, s, h, hkv, hd,
                        0)["fwd"]
    print(f"{tag} K5 at ({b}, {s:,}, {h} over {hkv}, {hd}) fp32 causal: "
          f"max abs err vs plain {err:.3e}, sdpa yardstick {lib_err:.3e}; "
          f"device ms in-run {in_run:.4f} (mean of {len(k5_us)} launches), "
          f"alone (L2 flushed) {t['ms']:.4f}, plain {t['plain_ms']:.4f}, "
          f"sdpa {t['library_ms']:.4f} [{backend}]; bound {bound[0]:.4f} ms "
          f"({bound[4] / 1e9:.2f} GFLOP at {FP32_PEAK / 1e12:.0f} TFLOP/s, "
          f"{bound[1]}); kernel at {bound[0] / t['ms']:.1%} alone, "
          f"{bound[0] / in_run:.1%} in-run; kernel / sdpa "
          f"{t['ms'] / t['library_ms']:.2f}x; on {smi}")
    del q, k, v
    return {"K5": k5["fwd"], "tok_s": b * gen / wall,
            "prefill_ms": prefill_s * 1e3, "step_ms": step_ms, "peak": peak,
            "case": dict(t, in_run_ms=in_run, bound_ms=bound[0],
                         bound_by=bound[1], max_abs_err=err),
            "cfg": cfg, "params": params, "prompts": prompts,
            "patches": patches, "tokens": out}


# -- internvl2-26b whole in bf16: K5 on the tensor-core source ---------------

VLM_BF16_PARAMS = VLM_PARAMS     # 48 layers, 2 bytes a param: 39.7 GB
VLM_FORCED = 4                   # teacher-forced decode steps of the bars
# the bars: a bf16 run is held to BAR_FACTOR x a yardstick's distance from
# the same oracle, each distance the largest over logits rows of
# ||x - y|| / ||y|| (``_rel``)
BAR_FACTOR = 2.0
FAULT_TILE = 128                 # the planted fault: key tile 0 of layer 0


def _rel(got, want):
    """The largest, over logits rows, of ``||got - want|| / ||want||``
    (lists of logits tensors compared pair by pair)."""
    worst = 0.0
    for g, w in zip(got, want):
        g = g.reshape(-1, g.shape[-1]).float()
        w = w.reshape(-1, w.shape[-1]).float()
        worst = max(worst, float(((g - w).norm(dim=1)
                                  / w.norm(dim=1)).max()))
    return worst


@contextlib.contextmanager
def _attention_swap(kind, record=None, remat_layers=None):
    """``flash_attention`` (K5/K6's entry point, which
    ``models.attention`` imports at each call) replaced for the block:
    ``"fp32"`` the same call on q, k, v in fp32 (the SIMT kernels:
    attention without bf16's rounding), cast back; ``"fault"`` layer 0's
    first key tile left out of every query tile past the first (the
    kernel's own launch on the rows and keys from FAULT_TILE on: a key
    loop that starts one tile late); ``"check"`` the kernel, its output
    held to the plain version that rounds where it rounds
    (``ref.rounding_error_ratio``, appended to ``record`` per layer, and
    at layer 0 that of the planted fault's output too).  With
    ``remat_layers`` = n, calls past the n-th are a remat backward's
    recomputes, last layer first, and count as the layer they recompute
    (the fault then also reaches layer 0's recompute)."""
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_fwd_ref, rounding_error_ratio)

    real, calls = aops.flash_attention, []

    def swapped(q, k, v, causal=True, window=0, *a, **kw):
        layer = n = len(calls)
        if remat_layers is not None and n >= remat_layers:
            layer = 2 * remat_layers - 1 - n
        calls.append(layer)
        if kind == "fp32":
            return real(q.float(), k.float(), v.float(), causal, window, *a,
                        **kw).to(q.dtype)
        o = real(q, k, v, causal, window, *a, **kw)
        planted = None
        if layer == 0 and kind in ("fault", "check"):
            t = FAULT_TILE
            planted = o.clone()
            late = dict(kw)
            if late.get("kv_len") is not None:      # padded keys stay out
                late["kv_len"] -= t
            planted[:, t:] = real(q[:, t:], k[:, t:], v[:, t:], causal,
                                  window, *a, **late)
            if kind == "fault":
                return planted
        if kind == "check":
            want = flash_attention_fwd_ref(q, k, v, causal=causal,
                                           window=window,
                                           round_to=torch.bfloat16,
                                           kv_len=kw.get("kv_len"))[0]
            record.append((rounding_error_ratio(o, want),
                           None if planted is None else
                           rounding_error_ratio(planted, want)))
            del want
        return o

    aops.flash_attention = swapped
    try:
        yield calls
    finally:
        aops.flash_attention = real


@torch.no_grad()
def _vlm_forced(cfg, params, prompts, patches, feed, attn_impl="chunked",
                swap=None):
    """The prefill's logits at every text position, then ``len(feed)``
    decode steps fed ``feed``'s tokens (teacher-forced), as a list of
    fp32 logits tensors; ``swap`` an ``_attention_swap`` kind for the
    prefill."""
    from repro_torch.models import get_model
    model = get_model(cfg)
    dev = patches.device
    ctx = _attention_swap(swap) if swap else contextlib.nullcontext()
    with ctx:
        logits, cache = model.prefill(
            params, torch.as_tensor(prompts, device=dev), patches=patches,
            max_len=VLM_MAX_LEN, attn_impl=attn_impl, last_only=False)
    rows = [logits[:, cfg.n_patches:].float()]
    del logits
    for t in feed:
        out, cache = model.decode_step(params, cache,
                                       torch.as_tensor(t, device=dev)[:, None])
        rows.append(out[:, -1].float())
    del cache
    return rows


def _vlm_bf16_vs_fp32(fp32_run, smi):
    """(b): ``[serve-vlm]``'s fp32 model (12 layers) and the same weights
    cast to bf16, on its prompts and patches, the prefill's text logits
    and VLM_FORCED decode steps fed the fp32 run's greedy tokens.  Bar:
    the bf16 run on K5 lies within BAR_FACTOR x the distance of the bf16
    run on the plain attention (the reference's own bf16 path) from the
    fp32 run; the planted fault must lie outside it."""
    tag = "[serve-vlm-bf16] (b)"
    cfg32, p32 = fp32_run["cfg"], fp32_run["params"]
    prompts, patches = fp32_run["prompts"], fp32_run["patches"]
    feed = [fp32_run["tokens"][:, t] for t in range(VLM_FORCED)]
    f32 = _vlm_forced(cfg32, p32, prompts, patches, feed)
    cfg16 = cfg32.replace(param_dtype="bfloat16")
    p16 = {p: x.to(torch.bfloat16) for p, x in p32.items()}
    fp32_run["params"] = p32 = None
    runs = {"kernel": _vlm_forced(cfg16, p16, prompts, patches, feed),
            "plain": _vlm_forced(cfg16, p16, prompts, patches, feed,
                                 "reference"),
            "fault": _vlm_forced(cfg16, p16, prompts, patches, feed,
                                 swap="fault")}
    del p16
    dist = {k: _rel(v, f32) for k, v in runs.items()}
    bar = BAR_FACTOR * dist["plain"]
    rows = sum(r.numel() // r.shape[-1] for r in f32)
    print(f"{tag} {cfg16.name} cut to {cfg16.n_layers} layers, the fp32 "
          f"weights and the same cast to bf16: {rows} logits rows (the "
          f"prefill's {VLM_PROMPT} text positions of {VLM_BATCH} sequences "
          f"and {VLM_FORCED} teacher-forced decode steps), largest "
          f"||x - fp32|| / ||fp32|| over rows: bf16 on K5 "
          f"{dist['kernel']:.4e}, bf16 on the plain attention "
          f"{dist['plain']:.4e}; bar {BAR_FACTOR:g} x the plain's = "
          f"{bar:.4e}; planted fault (layer 0's key tile 0 left out) "
          f"{dist['fault']:.4e} ({dist['fault'] / bar:.1f}x the bar)")
    check(0 < dist["kernel"] <= bar, f"{tag}: bf16 on K5 lies "
          f"{dist['kernel']} from fp32, outside {bar}")
    check(dist["fault"] > bar, f"{tag}: the planted fault passes the bar "
          f"({dist['fault']} <= {bar})")
    del f32, runs
    _free_card("serve-vlm-bf16 (b)")
    return dict(dist, bar=bar)


def phase_serve_vlm_bf16(dev, smi, fp32_run):
    """internvl2-26b whole, 48 layers at full width, in bf16
    (``param_dtype="bfloat16"``, the reference's switch: 19,869,020,160
    params, 39.7 GB), through ``static_generate`` under ``[serve-vlm]``'s
    traffic: 8 x (1,024 patches + 128 prompt tokens), 64 generated each.
    K5 runs in the prefill on ``flash_attention_sm90.cu`` (48 launches
    over 1,152 positions at a GQA group of 6), the decode steps on the
    plain ``decode_attend`` in bf16, as in the reference.  Then (a1)
    every layer's K5 output in the prefill inside
    ``ref.rounding_error_ratio``'s bar of the rounding plain version on
    the same inputs; (a2) the prefill's text logits and VLM_FORCED
    teacher-forced decode steps (the run's own tokens) against the same
    loop on the plain attention in bf16, within BAR_FACTOR x the
    distance of the loop whose attention runs in fp32 from it; (b)
    against fp32 (``_vlm_bf16_vs_fp32``); (c) the planted fault (layer
    0's key tile 0 left out) outside every bar; (e) K5 alone at the
    prefill's shape in bf16 beside its rounding plain version, cuDNN's
    SDPA and the bound at 989 TFLOP/s."""
    from repro_torch.common import param_count
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_fwd_ref, rounding_error_ratio)
    from repro_torch.kernels.flash_decode import ops as fops
    from repro_torch.models import get_model
    from repro_torch.serve.engine import static_generate

    tag = "[serve-vlm-bf16]"
    bars = {"b": _vlm_bf16_vs_fp32(fp32_run, smi)}
    prompts, patches = fp32_run["prompts"], fp32_run["patches"]
    del fp32_run
    cfg = get_config(VLM_ARCH).replace(param_dtype="bfloat16")
    model = get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s, init_peak = time.perf_counter() - t0, \
        torch.cuda.max_memory_allocated()
    n = param_count(params)
    check(n == VLM_BF16_PARAMS and all(
        x.dtype == torch.bfloat16 and x.device == dev
        for x in params.values()), f"{tag} {n} params, expected "
        f"{VLM_BF16_PARAMS} bf16 on the card")
    b, gen, h, hkv, hd = (VLM_BATCH, VLM_GEN, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim)
    s = cfg.n_patches + VLM_PROMPT
    print(f"{tag} {cfg.name} whole at full width in bf16: {cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, {h} heads / {hkv} KV heads of "
          f"{hd}, d_ff {cfg.d_ff}, vocab {cfg.padded_vocab}; {n:,} bf16 "
          f"params ({n * 2 / 1e9:.2f} GB) drawn on the card in "
          f"{init_s:.2f} s, peak memory after init {init_peak / 1e9:.2f} "
          f"GB; patches {tuple(patches.shape)} fp32 (cast to bf16 before "
          f"the projector)")

    def run(k=b, steps=gen):
        return static_generate(cfg, params, prompts[:k], steps,
                               max_len=VLM_MAX_LEN, attn_impl="chunked",
                               collect_logits=True, device=dev,
                               extra={"patches": patches[:k]})

    run(2, 2)                                        # warm-up, not measured
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fops.reset_launch_counts()
    aops.reset_launch_counts()
    t0 = time.perf_counter()
    out, rows = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k34, k5 = fops.paged_decode_attention.launches, dict(aops.LAUNCHES)
    by_source = dict(aops.SOURCE_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    sm90 = aops.SOURCES[torch.bfloat16].name
    check(k5 == {"fwd": cfg.n_layers, "dq": 0, "dkv": 0},
          f"{tag} K5/K6 launches {k5}, predicted {cfg.n_layers} forward")
    check(by_source == {aops.SOURCES[torch.float32].name: 0,
                        sm90: cfg.n_layers},
          f"{tag} launches by source {by_source}: K5 must run on {sm90}")
    check(k34 == 0, f"{tag} the decode steps launched K3/K4 {k34} times")
    check(out.shape == (b, gen) and all(np.isfinite(r).all() for r in rows),
          f"{tag} tokens {out.shape} or non-finite logits")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        model.prefill(params, torch.as_tensor(prompts, device=dev),
                      patches=patches, max_len=VLM_MAX_LEN,
                      attn_impl="chunked", last_only=True)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    step_ms = (wall - prefill_s) / (gen - 1) * 1e3
    print(f"{tag} {b} sequences x ({cfg.n_patches:,} patches + "
          f"{VLM_PROMPT} prompt tokens), {gen} generated each (max_len "
          f"{VLM_MAX_LEN}), greedy: {b * gen} tokens in {wall:.3f} s: "
          f"{b * gen / wall:.1f} tok/s; prefill ({s:,} positions) "
          f"{prefill_s * 1e3:.1f} ms; decode {step_ms:.3f} ms per step over "
          f"{gen - 1} steps; peak memory {peak / 1e9:.2f} GB "
          f"({peak / 2**30:.2f} GiB)")
    print(f"{tag} flash_attention_fwd (K5) launches {k5['fwd']} = "
          f"{cfg.n_layers} layers x 1 prefill, by source {by_source} (the "
          f"bf16 tensor-core kernels); K3/K4 {k34}")

    # (a1) every layer's K5 output against its rounding plain version
    record = []
    with _attention_swap("check", record), torch.no_grad():
        model.prefill(params, torch.as_tensor(prompts, device=dev),
                      patches=patches, max_len=VLM_MAX_LEN,
                      attn_impl="chunked", last_only=True)
    ratios = [r for r, _ in record]
    planted = record[0][1]
    print(f"{tag} (a1) K5 in each of the {len(ratios)} layers' prefill vs "
          f"the rounding plain version on the same q, k, v "
          f"(ref.rounding_error_ratio, bar 1): largest {max(ratios):.4f} "
          f"(layer {int(np.argmax(ratios))}), median "
          f"{float(np.median(ratios)):.4f}; the planted fault at layer 0 "
          f"{planted:.1f}")
    check(len(ratios) == cfg.n_layers and max(ratios) <= 1.0,
          f"{tag} (a1) a layer's K5 output lies outside the bar: {ratios}")
    check(planted > 1.0, f"{tag} (a1) the planted fault passes the bar "
          f"({planted})")
    del record

    # (a2) the 48 layers against the same loop on the plain attention
    feed = [out[:, t] for t in range(VLM_FORCED)]
    runs = {"kernel": _vlm_forced(cfg, params, prompts, patches, feed),
            "plain": _vlm_forced(cfg, params, prompts, patches, feed,
                                 "reference"),
            "fp32 attention": _vlm_forced(cfg, params, prompts, patches,
                                          feed, swap="fp32"),
            "fault": _vlm_forced(cfg, params, prompts, patches, feed,
                                 swap="fault")}
    plain = runs.pop("plain")
    dist = {k: _rel(v, plain) for k, v in runs.items()}
    bar = BAR_FACTOR * dist["fp32 attention"]
    print(f"{tag} (a2) {cfg.n_layers} layers, {VLM_BATCH * (VLM_PROMPT + VLM_FORCED)} "
          f"logits rows (prefill text positions, {VLM_FORCED} teacher-forced "
          f"steps), largest ||x - plain|| / ||plain|| over rows, plain = the "
          f"loop on the plain attention in bf16: K5 {dist['kernel']:.4e}, "
          f"the attention in fp32 {dist['fp32 attention']:.4e}; bar "
          f"{BAR_FACTOR:g} x the latter = {bar:.4e}; K5 vs the fp32 "
          f"attention {_rel(runs['kernel'], runs['fp32 attention']):.4e}; "
          f"planted fault {dist['fault']:.4e} ({dist['fault'] / bar:.1f}x "
          f"the bar)")
    check(0 < dist["kernel"] <= bar, f"{tag} (a2) K5's run lies "
          f"{dist['kernel']} from the plain run, outside {bar}")
    check(dist["fault"] > bar, f"{tag} (a2) the planted fault passes the "
          f"bar ({dist['fault']} <= {bar})")
    bars["a1"] = {"largest": max(ratios), "planted": planted}
    bars["a2"] = dict(dist, bar=bar)
    del runs, plain, params, rows
    _free_card("serve-vlm-bf16")

    # (e) K5 alone at the prefill's shape in bf16
    g = torch.Generator(device=dev).manual_seed(s + 1)
    q = torch.randn(b, s, h, hd, generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(b, s, hkv, hd, generator=g, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    o, lse = aops.attention_fwd(q, k, v, causal=True, window=0)
    o_emu, lse_emu = flash_attention_fwd_ref(q, k, v, round_to=torch.bfloat16)
    ratio = rounding_error_ratio(o, o_emu)
    lse_err = float((lse - lse_emu).abs().max())
    t = FAULT_TILE
    wrong = o.clone()
    wrong[:, t:] = aops.attention_fwd(q[:, t:], k[:, t:], v[:, t:])[0]
    wrong_ratio = rounding_error_ratio(wrong, o_emu)
    del o_emu, wrong
    o_ref = flash_attention_fwd_ref(q, k, v)[0]
    err = float((o.float() - o_ref.float()).abs().max())
    lib_err = float((_sdpa_attn(q, k, v, 0).float() - o_ref.float())
                    .abs().max())
    check(ratio <= 1.0 and lse_err <= 1e-5 and wrong_ratio > 1.0,
          f"{tag} (e) K5 bf16 at the prefill's shape: rounding ratio "
          f"{ratio}, lse {lse_err}, the planted output's ratio "
          f"{wrong_ratio}")
    check(lib_err <= 3e-2, f"{tag} (e) the sdpa yardstick disagrees by "
          f"{lib_err}")
    del o, lse, o_ref, lse_emu
    tm = {"ms": device_ms(lambda: aops.attention_fwd(q, k, v), ATTN_ITERS),
          "plain_ms": device_ms(lambda: flash_attention_fwd_ref(
              q, k, v, round_to=torch.bfloat16), ATTN_ITERS),
          "library_ms": device_ms(lambda: _sdpa_attn(q, k, v, 0),
                                  ATTN_ITERS)}
    backend = _sdpa_backend(q, k, v, torch.randn_like(q), 0)
    bound = _attn_bound(torch.cuda.get_device_name(0), b, s, h, hkv, hd, 0,
                        esz=2, peak=BF16_PEAK)["fwd"]
    print(f"{tag} (e) K5 at ({b}, {s:,}, {h} over {hkv}, {hd}) bf16 "
          f"causal on {sm90}: rounding ratio vs the rounding plain version "
          f"{ratio:.4f} (bar 1; planted, key tile 0 left out of every later "
          f"query tile: {wrong_ratio:.1f}), lse {lse_err:.2e}, max abs err "
          f"vs the fp32 plain version {err:.3e}, sdpa {lib_err:.3e}; device "
          f"ms (L2 flushed) kernel {tm['ms']:.4f}, plain (rounding) "
          f"{tm['plain_ms']:.4f}, sdpa {tm['library_ms']:.4f} [{backend}]; "
          f"bound {bound[0]:.4f} ms ({bound[4] / 1e9:.2f} GFLOP at "
          f"{BF16_PEAK / 1e12:.0f} TFLOP/s, {bound[1]}); kernel at "
          f"{bound[0] / tm['ms']:.1%}; kernel / sdpa "
          f"{tm['ms'] / tm['library_ms']:.2f}x; on {smi}")
    del q, k, v, patches
    return {"K5": k5["fwd"], "tok_s": b * gen / wall,
            "prefill_ms": prefill_s * 1e3, "step_ms": step_ms, "peak": peak,
            "bars": bars,
            "case": dict(tm, bound_ms=bound[0], bound_by=bound[1],
                         max_abs_err=err, rounding_ratio=ratio)}


# -- gemma3-12b served at full width (K3 at head dim 256, K5 in the long
#    prefill) -----------------------------------------------------------------

GEMMA_ARCH = "gemma3-12b"
GEMMA_PARAMS = 11_765_419_776    # by the config's dims (the meta-device init)


def _gemma3_decode_cases():
    """K3 alone at gemma3-12b's heads (16 over 8 of 256): the serving
    traffic's shape (8 slots of 129-175 tokens) and the long traffic's
    rings (4 sequences past the window: all 1,024 of a ring's slots
    valid), as ``_decode_cases`` rows."""
    from repro_torch import serve_workload as sw
    from repro_torch.configs.base import get_config
    cfg = get_config(GEMMA_ARCH)
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    top = sw.PROMPT_LEN + sw.GEN + sw.GEN_SPREAD - 1
    long = sw.TRAFFIC["long"]
    return [("gemma3 serving", sw.N_SLOTS, -(-(top + 8) // sw.PAGE_SIZE),
             sw.PROMPT_LEN + 1, top, *heads, False),
            ("gemma3 ring", long.n_slots,
             cfg.sliding_window // sw.PAGE_SIZE, long.prompt_len + 1,
             long.prompt_len + long.gen, *heads, True)]


def phase_serve_gemma3(dev):
    """gemma3-12b at full width in fp32 (random weights: 48 layers in 8
    macro blocks of 5 windowed (1,024) and 1 global sub-layers, 16 query
    heads over 8 KV heads of 256, qk-norm, tied embeddings, vocab
    262,144) through the paged ``DecodeEngine`` under both traffics: K3
    on every sub-layer of every decode step at head dim 256; under
    ``long`` the windowed sub-layers' rings of 1,024 wrap and the prefill
    runs on K5, windowed and global.  Each traffic's engine against
    ``static_generate`` (logits within LOGIT_TOL, streams equal barring
    near ties), then K3 alone at both traffics' decode shapes, fp32 and
    bf16."""
    def header(cfg):
        return (f"{cfg.n_layers} layers ({cfg.n_layers // cfg.global_every} "
                f"macro blocks of {cfg.global_every - 1} windowed "
                f"({cfg.sliding_window}) and 1 global), d_model "
                f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV "
                f"heads of {cfg.head_dim}, qk-norm, d_ff {cfg.d_ff}, tied "
                f"embeddings")

    kept = {}

    def parity(traffic, w, eng, res):
        phase_serve_parity(
            w, "serve-gemma3", f"{GEMMA_ARCH} {traffic}: continuous (K3"
            + (", K5 prefill" if w.serve.attn_impl == "chunked" else "")
            + ") vs static (plain)", ran=(eng, res))
        if traffic == "long":
            kept["long"] = (w, eng, res)

    runs = _serve_traffics(
        dev, GEMMA_ARCH, GEMMA_PARAMS, "serve-gemma3", header,
        lambda cfg, t: [t == "long"] * (cfg.global_every - 1) + [False],
        after=parity)
    out = {t: (c, st, peak) for t, (_, c, st, peak) in runs.items()}
    del runs
    _free_card("serve-gemma3")
    cases = {}
    for shape, *rest in _gemma3_decode_cases():
        for dtype, tol in ((torch.float32, TOL), (torch.bfloat16, 3e-2)):
            cases[f"{shape} {str(dtype)[6:]}"] = _decode_case(
                dev, shape, *rest, dtype, tol, "serve-gemma3")
    return out, cases, kept.pop("long")


def phase_serve_gemma3_bf16(dev, smi, fp32_long):
    """gemma3-12b in bf16 (configuration 39) under ``TRAFFIC["long"]``:
    ``[serve-gemma3]``'s long run (``fp32_long``: its workload and engine
    run, rows recorded), its weights then cast leaf by leaf (47.06 GB in
    fp32 beside 23.53 GB in bf16 would leave little room), through
    ``_bf16_serving``: K3 bf16 at head dim 256 on the global sub-layers'
    pages and the windowed ones' rings of 1,024 that wrap, K5 bf16
    windowed and global in the prefill."""
    from repro_torch.serve.paged_cache import build_layout
    tag = "[serve-gemma3-bf16]"
    w, eng, res = fp32_long
    fp32 = _engine_rows(eng, res)
    del eng, res, fp32_long
    w16 = _bf16_twin(tag, w, GEMMA_PARAMS)
    cfg = w16.cfg
    rings = [s.ring for s in build_layout(cfg, w16.serve.page_size,
                                          w16.serve.max_len).subs]
    check(rings == [True] * (cfg.global_every - 1) + [False],
          f"{tag} ring subs {rings}")
    return {"long": _bf16_serving(f"{tag} long", w16, "long", fp32, smi,
                                  "[serve-gemma3] long")}


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


def _attn_bound(name, b, s, h, hkv, hd, window, esz=4, peak=FP32_PEAK,
                sk=None, causal=True):
    """Causal attention's fwd / bwd bounds at Sq = Sk = s (or over ``sk``
    keys, non-causal with ``causal=False``): ``{part: (ms, what bounds
    it, seconds by operations, seconds by bytes, operations, bytes)}``,
    the work ``launch.roofline.attention_work`` counts (the dry run's
    formula) on the real, unpadded shapes: each input read once and each
    output written once."""
    from repro_torch.launch.roofline import attention_work
    out = {}
    for part, (ops_, nbytes) in attention_work(b, s, sk or s, h, hkv, hd,
                                               causal, window,
                                               esz=esz).items():
        by_ops, by_bytes = ops_ / peak, nbytes / memory_rate(name)
        out[part] = (max(by_ops, by_bytes) * 1e3,
                     "bytes" if by_bytes >= by_ops else "operations",
                     by_ops, by_bytes, ops_, nbytes)
    return out


def _attn_configs():
    from repro_torch.configs.base import get_config
    qwen, gemma = get_config("qwen3-1.7b"), get_config("gemma3-12b")
    return [("qwen3-1.7b", qwen, 0),
            ("gemma3-12b local", gemma, gemma.sliding_window),
            ("gemma3-12b global", gemma, 0)]


def _attn_cases():
    """``[attention-kernels]``' cases: (label, cfg, window, B, S, dtype,
    through ``attend``).  ``train_4k`` at B=2 through ``flash_attention``
    in fp32 and bf16; then the zoo's shapes at B=1 in fp32 (qwen3 at
    4,096 tokens, gemma3's local and global layers at its macro block's
    2,048) through the model's wrapper ``attend`` (chunked, ``q_chunk``
    1024, as ``steps.default_loss_kwargs``), whose output goes through an
    output projection as in ``layers.attention_block``, so that K6 gets
    the gradient layout the model gives it."""
    from repro_torch.configs.base import get_config
    cases = [(n, cfg, w, TRAIN_B, TRAIN_S, dt, False)
             for n, cfg, w in _attn_configs()
             for dt in (torch.float32, torch.bfloat16)]
    for n, cfg, w in _attn_configs():
        s = TRAIN_S if n == ZOO_ARCH else GEMMA_MACRO_S
        cases.append((f"{n} B=1 S={s}", cfg, w, 1, s, torch.float32, True))
    for n, cfg, w in _hymba_attn_configs():
        cases.append((f"{n} B=1 S={HYMBA_S}", cfg, w, 1, HYMBA_S,
                      torch.float32, True))
    cases.append((f"{MOE_ARCH} B=1 S={TRAIN_S}", _moe_cfg(), 0, 1, TRAIN_S,
                  torch.float32, True))
    # stablelm-3b's head dim 80 (32 over 32 heads), both dtypes: the
    # kernels run head dim 128's tiles on zero columns
    st = get_config(STABLELM_ARCH)
    for dt in (torch.float32, torch.bfloat16):
        cases.append((f"{STABLELM_ARCH} B=1 S={TRAIN_S}"
                      + ("" if dt == torch.float32 else " bf16"), st, 0, 1,
                      TRAIN_S, dt, True))
    # internvl2-26b's round: 4,096 text tokens after 1,024 patches, 48
    # heads over 8 of 128 (a GQA group of 6)
    cases.append((f"{VLM_ARCH} B=1 S={VLM_ROUND_S}", get_config(VLM_ARCH),
                  0, 1, VLM_ROUND_S, torch.float32, True))
    return cases


def _moe_cfg():
    """granite-moe-1b-a400m's attention (16 heads over 8 of 64, a GQA
    group of 2, causal): the MoE round's K5/K6 shape at ``train_4k``."""
    from repro_torch.configs.base import get_config
    return get_config(MOE_ARCH)


def _hymba_attn_configs():
    """hymba-1.5b's two attention layers (25 heads over 5 of 64, a GQA
    group of 5): a windowed one (1,024) and the global one."""
    from repro_torch.configs.base import get_config
    hy = get_config(HYMBA_ARCH)
    return [(f"{HYMBA_ARCH} local", hy, hy.sliding_window),
            (f"{HYMBA_ARCH} global", hy, 0)]


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
    from repro_torch.models.attention import attend

    name = torch.cuda.get_device_name(0)
    rows, zoo, driven = {}, {}, {"fwd": 0, "dq": 0, "dkv": 0}
    cases = _attn_cases()
    for cfg_name, cfg, window, b, s, dtype, via_attend in cases:
        h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        tag = f"[attention-kernels] {cfg_name} {str(dtype)[6:]}" + (
            " through attend" if via_attend else "")
        gen = torch.Generator(device=dev).manual_seed(
            s + window if via_attend else hd + window)
        q, g = (torch.randn(b, s, h, hd, generator=gen, device=dev)
                .to(dtype) for _ in range(2))
        k, v = (torch.randn(b, s, hkv, hd, generator=gen, device=dev)
                .to(dtype) for _ in range(2))
        if via_attend:
            wo = (torch.randn(h, hd, cfg.d_model, generator=gen,
                              device=dev) / math.sqrt(h * hd)).to(dtype)
            gy = torch.randn(b, s, cfg.d_model, generator=gen,
                             device=dev).to(dtype)
            # the gradient the projection hands attend's output: the
            # plain versions take it as their dO
            g = torch.einsum("bsd,hkd->bshk", gy, wo).contiguous()

            def train(q=q, k=k, v=v, wo=wo, gy=gy, window=window):
                qs, ks, vs = (x.detach().requires_grad_()
                              for x in (q, k, v))
                o = attend(qs, ks, vs, impl="chunked", causal=True,
                           window=window, q_chunk=1024)
                return (o.detach(),) + torch.autograd.grad(
                    torch.einsum("bshk,hkd->bsd", o, wo), (qs, ks, vs),
                    gy)
        else:
            def train(q=q, k=k, v=v, g=g, window=window):
                qs, ks, vs = (x.detach().requires_grad_()
                              for x in (q, k, v))
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
        peak = FP32_PEAK if dtype == torch.float32 else BF16_PEAK
        bound = _attn_bound(name, b, s, h, hkv, hd, window,
                            q.element_size(), peak)
        fwd_ops, fwd_bytes = bound["fwd"][4:]
        bwd_ops = bound["bwd"][4]
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
              f"{t['train']:.4f}"
              + (" (attend and the projection)" if via_attend else "")
              + f"; plain fwd {t['plain_fwd']:.4f}, bwd "
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
                 if dtype == torch.float32 and not via_attend else ""))
        if via_attend:
            zoo[cfg_name] = dict(t, errs=errs, bound=bound)
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
    extra = _attn_noncausal(dev, name, driven)
    check(driven["fwd"] == len(cases) + len(extra),
          f"[attention-kernels] launches {driven}")
    rows["fwd"]["launches"] = driven["fwd"]
    rows["bwd"]["launches"] = driven["dq"] + driven["dkv"]
    # the shapes of the later slices: head dim 80, whisper's non-causal
    # padded-key route and internvl2-26b's round, each kernel's numbers
    # alone
    for label, t in list(zoo.items()) + list(extra.items()):
        if not label.startswith((STABLELM_ARCH, WHISPER_ARCH, VLM_ARCH)):
            continue
        for part, outs in (("fwd", ("o", "lse")), ("bwd", ("dq", "dk", "dv"))):
            rows[part].setdefault("cases", {})[label] = {
                "ms": t[part], "plain_ms": t[f"plain_{part}"],
                "bound_ms": t["bound"][part][0],
                "bound_by": t["bound"][part][1],
                "library_ms": t[f"lib_{part}"],
                "max_abs_err": max(t["errs"][n] for n in outs)}
    return rows["fwd"], rows["bwd"], zoo

# whisper's non-causal attention (16 heads of 64): the encoder over its
# 1,500 frames, and the decoder's 4,096 training tokens over them
WHISPER_ATTN = ((1500, 1500), (TRAIN_S, 1500))


def _attn_noncausal(dev, name, driven):
    """``[attention-kernels]``' non-causal cases at whisper's shapes
    (``WHISPER_ATTN``, B=1, fp32), through ``attention.pad_noncausal``:
    q, k, v padded with zero rows to whole 128-row blocks, the keys past
    Sk masked by the kernels' ``kv_len``, the output sliced back.  One
    launch of each kernel a call, two calls bitwise equal; o, lse and
    the gradients against the plain version on the unpadded inputs at the
    fp32 bars (2e-5, 5e-4); the same call with the zero keys counted
    (``kv_len`` left at the padded length) must fail the 2e-5 bar.  Times
    of each kernel alone on the padded inputs, of the route (padding,
    kernels, slice), of the plain version and of SDPA (non-causal, on the
    unpadded inputs) beside the bound, which counts the real Sq x Sk
    pairs."""
    import torch.nn.functional as F
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_fwd_ref)
    from repro_torch.models.attention import FLASH_BLOCK, pad_noncausal

    cfg = get_config(WHISPER_ARCH)
    h, hd = cfg.n_heads, cfg.head_dim
    out = {}
    for sq, sk in WHISPER_ATTN:
        label = f"{WHISPER_ARCH} non-causal B=1 Sq={sq} Sk={sk}"
        tag = f"[attention-kernels] {label} float32 through pad_noncausal"
        gen = torch.Generator(device=dev).manual_seed(sq + sk)
        q, g = (torch.randn(1, sq, h, hd, generator=gen, device=dev)
                for _ in range(2))
        k, v = (torch.randn(1, sk, h, hd, generator=gen, device=dev)
                for _ in range(2))

        def train(q=q, k=k, v=v, g=g):
            qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
            o = pad_noncausal(qs, ks, vs)
            return (o.detach(),) + torch.autograd.grad((o * g).sum(),
                                                       (qs, ks, vs))

        aops.reset_launch_counts()
        got = train()
        torch.cuda.synchronize()
        step = dict(aops.LAUNCHES)
        check(step == {"fwd": 1, "dq": 1, "dkv": 1},
              f"{tag}: launches {step}, expected one of each")
        for key in driven:
            driven[key] += step[key]
        check(all(torch.equal(x, y) for x, y in zip(got, train())),
              f"{tag}: two calls are not bitwise equal")
        o_ref, lse_ref = flash_attention_fwd_ref(q, k, v, causal=False)
        want = (o_ref,) + flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, g,
                                                  causal=False)
        errs = {n: float((x - y).abs().max()) for n, x, y in
                zip(ATTN_OUTS, got, want)}
        qp, kp, vp, gp = (F.pad(x, (0, 0, 0, 0, 0, -x.shape[1] % FLASH_BLOCK))
                          for x in (q, k, v, g))
        o, lse = aops.attention_fwd(qp, kp, vp, causal=False, kv_len=sk)
        errs["lse"] = float((lse[..., :sq] - lse_ref).abs().max())
        for n, err in errs.items():
            tol = TOL if n in ("o", "lse") else 5e-4
            check(err <= tol, f"{tag}: {n} max abs err vs plain {err} > "
                  f"{tol}")
        counted = aops.attention_fwd(qp, kp, vp, causal=False)[0][:, :sq]
        planted = float((counted - o_ref).abs().max()) / TOL
        check(planted > 1.0, f"{tag}: o with the {kp.shape[1] - sk} zero "
              f"keys counted passes the {TOL} bar ({planted:.3f} of it)")
        del counted, want
        t = {"fwd": device_ms(lambda: aops.attention_fwd(
                 qp, kp, vp, causal=False, kv_len=sk), ATTN_ITERS),
             "bwd": device_ms(lambda: aops.attention_bwd(
                 qp, kp, vp, o, lse, gp, causal=False, kv_len=sk),
                 ATTN_ITERS),
             "train": device_ms(train, ATTN_ITERS),
             "plain_fwd": device_ms(lambda: flash_attention_fwd_ref(
                 q, k, v, causal=False), ATTN_ITERS),
             "plain_bwd": device_ms(lambda: flash_attention_bwd_ref(
                 q, k, v, o_ref, lse_ref, g, causal=False), ATTN_ITERS)}

        def sdpa(q, k, v):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2),
                v.transpose(1, 2)).transpose(1, 2)

        lib_err = float((sdpa(q, k, v) - o_ref).abs().max())
        check(lib_err <= 1e-3, f"{tag}: the sdpa yardstick disagrees by "
              f"{lib_err}")
        qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
        lib_o = sdpa(qs, ks, vs)
        t["lib_fwd"] = device_ms(lambda: sdpa(q, k, v), ATTN_ITERS)
        t["lib_bwd"] = device_ms(lambda: torch.autograd.grad(
            lib_o, (qs, ks, vs), g, retain_graph=True), ATTN_ITERS)
        pairs, q_n, k_n = h * sq * sk, sq * h * hd, sk * h * hd
        bound = {}
        for part, ops_, nbytes in (
                ("fwd", 4 * hd * pairs, 4 * (2 * q_n + 2 * k_n) + 4 * h * sq),
                ("bwd", 10 * hd * pairs,
                 4 * (4 * q_n + 4 * k_n) + 8 * h * sq)):
            by_ops, by_bytes = ops_ / FP32_PEAK, nbytes / memory_rate(name)
            bound[part] = (max(by_ops, by_bytes) * 1e3,
                           "bytes" if by_bytes >= by_ops else "operations",
                           by_ops, by_bytes, ops_, nbytes)
        print(f"{tag}: H={h} hd={hd}, padded to Sq {qp.shape[1]} Sk "
              f"{kp.shape[1]} with kv_len {sk}: max abs err vs plain "
              + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
              + f"; the zero keys counted: o at {planted:.1f}x the bar; "
              f"sdpa yardstick o {lib_err:.3e}; launches fwd 1, dQ 1, "
              f"dK/dV 1 per call; two calls bitwise equal")
        print(f"{tag}: median device ms (L2 flushed): kernel fwd "
              f"{t['fwd']:.4f}, bwd {t['bwd']:.4f} (padded inputs), the "
              f"route fwd+bwd {t['train']:.4f}; plain fwd "
              f"{t['plain_fwd']:.4f}, bwd {t['plain_bwd']:.4f}; sdpa fwd "
              f"{t['lib_fwd']:.4f}, bwd {t['lib_bwd']:.4f}; bound fwd "
              f"{bound['fwd'][0]:.4f} ms ({bound['fwd'][4] / 1e9:.2f} GFLOP "
              f"of the real pairs at {FP32_PEAK / 1e12:.0f} TFLOP/s), bwd "
              f"{bound['bwd'][0]:.4f} ms ({bound['bwd'][4] / 1e9:.2f} "
              f"GFLOP); kernel at {bound['fwd'][0] / t['fwd']:.1%} (fwd) and "
              f"{bound['bwd'][0] / t['bwd']:.1%} (bwd) of the bound; kernel "
              f"/ sdpa {t['fwd'] / t['lib_fwd']:.2f}x (fwd), "
              f"{t['bwd'] / t['lib_bwd']:.2f}x (bwd)")
        out[label] = dict(t, errs=errs, bound=bound)
        del q, k, v, g, qp, kp, vp, gp, o, lse, o_ref, lse_ref, lib_o
        torch.cuda.empty_cache()
    return out


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
    wh = get_config(WHISPER_ARCH)
    w = gemma.sliding_window
    both = (torch.float32, torch.bfloat16)
    cases = [  # tag, config, B, S, window, valid range, blk_k, dtypes
        ("decode_32k", qwen, 8, DECODE_S, 0, (1, DECODE_S), 512, both),
        ("gemma3 ring", gemma, 8, w, w, (1, 4 * w), 512, (torch.float32,)),
        ("S=1000", qwen, 4, 1000, 0, (1, 1000), 512, (torch.float32,)),
        # whisper's decode step (``[serve-whisper]``): the cross cache of
        # 1,500 frames, every position valid, and the self cache of
        # max_len 200 at the steps of 128 generated tokens, blk_k the
        # cache's length
        ("whisper cross", wh, WHISPER_BATCH, wh.enc_seq, 0,
         (wh.enc_seq, wh.enc_seq), wh.enc_seq, both),
        ("whisper self", wh, WHISPER_BATCH, WHISPER_MAX_LEN, 0,
         (WHISPER_PROMPT + 1, WHISPER_PROMPT + 127), WHISPER_MAX_LEN,
         (torch.float32,))]
    timed = ("decode_32k", "whisper cross", "whisper self")
    row, launches, rows = None, 0, {}
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
            if tag0 not in timed:
                continue
            lib = _sdpa_decode(q, k, v, valid)
            lib_err = float((lib.float() - want).abs().max())
            check(lib_err <= (1e-3 if dtype == torch.float32 else 5e-2),
                  f"{tag}: the sdpa yardstick disagrees by {lib_err}")
            del want, lib
            ms = device_ms(lambda: fops.decode_attention(q, k, v, valid,
                                                         blk_k=blk))
            plain_ms = device_ms(lambda: decode_attention_ref(
                q, k, v, valid, blk_k=blk), ATTN_ITERS)
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
            rows[f"{tag0} {str(dtype)[6:]}"] = {
                "B": b, "S": s, "H": h, "Hkv": hkv, "hd": hd, "blk_k": blk,
                "splits": pl.n_splits, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": "bytes" if by_bytes >= by_ops else "operations",
                "library_ms": library_ms}
            if tag0 == "decode_32k" and dtype == torch.float32:
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
    row["direct_launches"] = launches
    row["cases"] = rows
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


# -- bf16 serving through the paged engine (K3's, K5's and K7's bf16
#    instances on model paths) -----------------------------------------------

FORCE = 1e4                      # a forced token's noise: above any logit
FORCED_GEN = 8                   # tokens a request in the forced runs
CHECKED_LAYERS = 1               # calls of the plain run held one by one,
                                 # in units of the model's layers
# profiler ranges around the engine's prefill (with its first-token
# sample) and commit, each ending in a device sync: a kernel that starts
# inside one is its, any other the decode steps'
SERVE_RANGES = {"serve/prefill": "prefill", "serve/commit": "commit"}


def _engine_rows(eng, res):
    """A finished engine run's (tokens, float32 rows), by request."""
    return ({i: np.asarray(t) for i, t in res.items()},
            {i: np.stack(r) for i, r in eng.logits_rows.items()})


def _forcing(streams, device):
    """The engine's injected sampling noise at temperature 1 that forces
    request r's token g to ``streams[r][g]``: a one-hot of FORCE (zeros
    on a slot with nothing to force), so every run follows one token
    history and its rows stay comparable at every step."""
    def noise(rids, gidx, vocab):
        at = [(j, int(streams[r][g])) for j, (r, g) in
              enumerate(zip(rids.tolist(), gidx.tolist()))
              if r in streams and g < len(streams[r])]
        out = torch.zeros((len(rids), vocab), device=device)
        if at:
            idx = torch.as_tensor(at, device=device)
            out[idx[:, 0], idx[:, 1]] = FORCE
        return out
    return noise


def _ranged(fn, name):
    """``fn`` inside the profiler range ``name``, which it leaves only
    once the device has run what it launched."""
    def run(*a, **kw):
        with torch.profiler.record_function(name):
            out = fn(*a, **kw)
            torch.cuda.synchronize()
        return out
    return run


def _by_range(prof):
    """``prof``'s device kernels by SERVE_RANGES kind (by device start
    within a range's span on the profile's clock; ``"decode"`` outside
    them), each ``{kernel kind: ms}``.  A kernel launched through a
    ctypes entry point carries no host op to match it to, so its start
    is what places it."""
    from repro_torch.profile_serve import _kind
    from repro_torch.profiling import device_kernels
    cuda = torch.autograd.DeviceType.CUDA
    spans = [(e.start_ns(), e.end_ns(), SERVE_RANGES[e.name()])
             for e in prof.profiler.kineto_results.events()
             if e.device_type() != cuda and e.name() in SERVE_RANGES]
    out = {}
    for k in device_kernels(prof):
        if k.name in SERVE_RANGES:             # the ranges' own device rows
            continue
        where = next((kind for a, b, kind in spans
                      if a <= k.start_ns <= b), "decode")
        kinds = out.setdefault(where, {})
        kinds[_kind(k.name)] = kinds.get(_kind(k.name), 0.0) + k.us / 1e3
    return out


@contextlib.contextmanager
def _plain_calls():
    """Counts, by name, the calls of K3's, K4's, K5's and K7's plain
    versions made while the block runs: where their wrappers run them (a
    CPU tensor) and rwkv6's training scan."""
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.kernels.flash_decode import ops as fops
    from repro_torch.kernels.rwkv6_scan import ops as wops
    from repro_torch.models import rwkv6
    sites = ((fops, "paged_decode_ref"), (fops, "decode_attention_ref"),
             (aops, "flash_attention_fwd_ref"),
             (wops, "rwkv6_scan_chunked_ref"), (rwkv6, "chunked_linear_scan"))
    calls = {name: 0 for _, name in sites}
    real = {name: getattr(mod, name) for mod, name in sites}

    def counted(name):
        def fn(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return fn

    for mod, name in sites:
        setattr(mod, name, counted(name))
    try:
        yield calls
    finally:
        for mod, name in sites:
            setattr(mod, name, real[name])


@contextlib.contextmanager
def _serve_swap(kind, cfg, record=None, keep=None):
    """The model's one kernel call site replaced for the block: K3's
    (``transformer.paged_decode_attention``, hymba's own
    ``hymba.paged_decode_attention``) or, on rwkv6, K7's (``rwkv6.wkv``).  ``"plain"`` returns the kernel's plain version on
    the same bf16 tensors (K3: ``ref.paged_decode_ref``, the gather and
    the attention; K7: ``linear_scan.chunked_linear_scan``); with
    ``record`` it appends each call's work and, on its first
    CHECKED_LAYERS x n_layers calls, also runs the kernel and the planted
    fault on the same inputs and records how far each lies, element by
    element (``ref.bf16_error_ratio``; the fault only at layer 0), from
    the plain version in fp32 (K3) or from K7's fp32 instance on the
    inputs cast up (K7; its distance from the plain version in fp32
    too); None on the calls past them.  ``"fault"`` returns the kernel with
    layer 0's call wrong: K3 with the first page of every sequence left
    out, K7 with the carry between chunks dropped (every chunk scanned
    from a zero state).  With ``keep`` (a dict) the first checked K3
    call's inputs are kept under ``"K3"``, for timing alone."""
    from repro_torch.kernels.flash_decode import ref as fref
    from repro_torch.kernels.rwkv6_scan import ref as wref
    from repro_torch.models import hymba, rwkv6, transformer
    from repro_torch.models.linear_scan import chunked_linear_scan
    n = [0]
    if cfg.family == "ssm":
        mod, name = rwkv6, "wkv"
        real = mod.wkv

        def faulty(r, k, v, ld, u, chunk):
            b, s, h, dk = r.shape
            m = s // chunk

            def split(x):
                return x.reshape(b * m, chunk, h, x.shape[-1])
            o, st = real(split(r), split(k), split(v), split(ld), u,
                         chunk=chunk)
            return (o.reshape(b, s, h, -1),
                    st.reshape(b, m, h, dk, -1)[:, -1].contiguous())

        def swapped(r, k, v, ld, u, *, chunk):
            layer = n[0] % cfg.n_layers
            n[0] += 1
            if kind == "fault" and layer == 0:
                return faulty(r, k, v, ld, u, chunk)
            if kind == "fault":
                return real(r, k, v, ld, u, chunk=chunk)
            out = chunked_linear_scan(r, k, v, ld, decay_on="k", bonus=u,
                                      chunk=chunk)
            work = (*r.shape, v.shape[-1], chunk, r.element_size(),
                    ld.element_size())
            if record is not None and n[0] > CHECKED_LAYERS * cfg.n_layers:
                record.append((*work, None, None, None))
            elif record is not None:
                # against K7's fp32 instance on the same inputs cast up
                # (the same order of sums: the plain version's differs by
                # fp32's order of sums at the size a state that carries
                # ~100 tokens reaches), and the plain version in fp32
                want = real(r.float(), k.float(), v.float(), ld, u,
                            chunk=chunk)[0]
                got = real(r, k, v, ld, u, chunk=chunk)[0]
                plain32 = chunked_linear_scan(
                    r.float(), k.float(), v.float(), ld, decay_on="k",
                    bonus=u, chunk=chunk)[0]
                record.append((*work, wref.bf16_error_ratio(got, plain32),
                               wref.bf16_error_ratio(got, want),
                               wref.bf16_error_ratio(faulty(
                                   r, k, v, ld, u, chunk)[0], want)
                               if layer == 0 else None))
            return out
    else:
        mod = hymba if cfg.family == "hybrid" else transformer
        name = "paged_decode_attention"
        real = mod.paged_decode_attention

        def faulty(q, kp, vp, pt, valid):
            ps = kp.shape[1]
            return real(q, kp, vp, pt[:, 1:].contiguous(),
                        torch.where(valid > ps, valid - ps, valid))

        def swapped(q, kp, vp, pt, valid):
            layer = n[0] % cfg.n_layers
            n[0] += 1
            if kind == "fault" and layer == 0:
                return faulty(q, kp, vp, pt, valid)
            if kind == "fault":
                return real(q, kp, vp, pt, valid)
            out = fref.paged_decode_ref(q, kp, vp, pt, valid)
            ps = kp.shape[1]
            b, _, h, hd = q.shape
            work = (valid.sum(), ((valid + ps - 1) // ps).sum(), b, h,
                    kp.shape[2], hd, q.element_size())
            if record is not None and n[0] > CHECKED_LAYERS * cfg.n_layers:
                record.append((*work, None, None))
            elif record is not None:
                if keep is not None and "K3" not in keep:
                    keep["K3"] = (q.clone(), kp, vp, pt.clone(),
                                  valid.clone())
                want = fref.paged_decode_ref(q.float(), kp.float(),
                                             vp.float(), pt, valid)
                record.append((
                    *work,
                    fref.bf16_error_ratio(real(q, kp, vp, pt, valid), want),
                    fref.bf16_error_ratio(faulty(q, kp, vp, pt, valid),
                                          want) if layer == 0 else None))
            return out
    setattr(mod, name, swapped)
    try:
        yield n
    finally:
        setattr(mod, name, real)


def _near_tie_steps(rows32, *rows16):
    """Per request, the steps up to and including the first where the
    fp32 row's two largest logits lie closer than the largest elementwise
    difference between a bf16 run's row (of ``rows16``) and the fp32 row
    there."""
    n = {}
    for i, r32 in rows32.items():
        n[i] = len(r32)
        for t in range(len(r32)):
            top2 = np.partition(r32[t], -2)[-2:]
            if abs(top2[1] - top2[0]) < max(np.abs(r[i][t] - r32[t]).max()
                                            for r in rows16):
                n[i] = t + 1
                break
    return n


def _rows_dist(got, want):
    """The largest, over every row of every request, of ``||got - want||
    / ||want||``."""
    return max(float((np.linalg.norm(got[i] - want[i], axis=1)
                      / np.linalg.norm(want[i], axis=1)).max())
               for i in want)


def _k3_bound(record, name, peak):
    """K3's bound a call, averaged over ``record``'s calls: each call's K
    and V rows of its valid tokens, q, the output, its table rows and
    valid lengths moved once, or its 4 ops a token a head a channel at
    ``peak``; (ms, what bounds it)."""
    tok = int(torch.stack([r[0] for r in record]).sum())
    pages = int(torch.stack([r[1] for r in record]).sum())
    b, h, hkv, hd, esz = record[0][2:7]
    nbytes = esz * (2 * tok * hkv * hd + len(record) * 2 * b * h * hd) \
        + 4 * (pages + len(record) * b)
    by_bytes = nbytes / memory_rate(name)
    by_ops = 4 * tok * h * hd / peak
    return (max(by_bytes, by_ops) * 1e3 / len(record),
            "bytes" if by_bytes >= by_ops else "operations")


def _k7_bound(record, name):
    """K7's bound over ``record``'s calls, as ``[wkv-kernel]``'s: (ms in
    all, what bounds it)."""
    nbytes = flops = 0
    for b, s, h, dk, dv, chunk, esz, dsz, *_ in record:
        tokens = b * s * h
        nbytes += (tokens * (dk * (3 * esz + dsz) + dv * esz) + 4 * h * dk
                   + 4 * b * h * dk * dv)
        flops += tokens * 2 * (2 * chunk * dk + 2 * dk * dv)
    by_bytes, by_ops = nbytes / memory_rate(name), flops / FP32_PEAK
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def _k5_bound(cfg, b, s, name):
    """K5's bf16 forward bound over one prefill's layers (each sub-layer's
    window), at 989 TFLOP/s: ms in all."""
    from repro_torch.models.transformer import block_layout, n_macro
    return sum(_attn_bound(name, b, s, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim, sub.window, esz=2,
                           peak=BF16_PEAK)["fwd"][0]
               for sub in block_layout(cfg)) * n_macro(cfg)


def _bf16_serving(tag, w, traffic, fp32, smi, fp32_tag, time_k3=False):
    """One bf16 configuration under one traffic, on ``w`` (the bf16 twin
    of a workload served in fp32 under ``TRAFFIC[traffic]``: ``fp32`` is
    that engine run's tokens and logits rows by request, ``fp32_tag`` the
    phase that ran it).

    (e3) A greedy run, counters zeroed just before it: K3 bf16 once a
    layer a decode step (K7 bf16 once a layer a prefill call on rwkv6),
    K5 bf16 once a layer a prefill call on ``flash_attention_sm90.cu`` on
    the long traffic, nothing of fp32, no plain version; its tokens/s,
    decode ms a step, TTFT, latency and peak memory.  (e4) bf16 params
    and pools (rwkv6: bf16 mixes, fp32 WKV state; hymba: bf16 conv
    state, fp32 SSM state), one decode signature.  (e1)
    Three runs of the first ``n_slots`` requests (one admission group),
    each forced to the fp32 run's first FORCED_GEN tokens (``_forcing``;
    random weights part greedy streams at near ties within a few
    steps), their rows recorded: the kernel (under the profiler: device
    ms a decode step by kind, K3 ms a call, K7's and K5's ms beside
    their bounds), the plain version in its place (``_serve_swap``,
    which also holds the kernel's output on its first CHECKED_LAYERS x
    n_layers calls element by element), and (e2) the planted fault.
    Every row is compared: the kernel within BAR_FACTOR x the plain
    run's distance from the fp32 rows, of the plain run and of the fp32
    rows; the fault outside.  The greedy run's streams equal the fp32
    run's up to each request's first near tie (``_near_tie_steps``), the
    count printed.  With ``time_k3``, K3's first checked call (layer 0,
    the first decode step) is timed alone on its own inputs (device
    medians, L2 flushed) beside its plain version and a gather + SDPA
    yardstick.
    Returns the figures."""
    from repro_torch import serve_workload as sw
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.kernels.flash_decode import ops as fops
    from repro_torch.kernels.rwkv6_scan import ops as wops

    bf16, f32 = torch.bfloat16, torch.float32
    cfg, t, dev = w.cfg, w.traffic, w.device
    name = torch.cuda.get_device_name(0)
    ssm = cfg.family == "ssm"
    check(cfg.param_dtype == "bfloat16" and all(
        x.dtype == bf16 and x.device == dev for x in w.params.values()),
        f"{tag} params are not bf16 on the card")
    sw.engine(w, n_requests=2, gen=3).run()          # warm-up, not measured

    def reset():
        for ops in (aops, fops, wops):
            ops.reset_launch_counts()

    eng = sw.engine(w)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    with _plain_calls() as plain:
        res = eng.run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    st = eng.stats()
    steps_, calls_ = st["n_decode_steps"], st["n_prefill_calls"]
    k3 = {str(k)[6:]: v for k, v in fops.DTYPE_LAUNCHES.items()}
    k7 = {str(k)[6:]: v for k, v in wops.DTYPE_LAUNCHES.items()}
    k5 = dict(aops.SOURCE_LAUNCHES)
    sm90 = aops.SOURCES[bf16].name
    want = {"K3": 0 if ssm else cfg.n_layers * steps_,
            "K7": cfg.n_layers * calls_ if ssm else 0,
            "K5": cfg.n_layers * calls_ if t.attn_impl == "chunked"
            and not ssm else 0}
    check(steps_ == TRAFFIC_STEPS[traffic], f"{tag} {steps_} decode steps,"
          f" predicted {TRAFFIC_STEPS[traffic]}")
    check(k3 == {"float32": 0, "bfloat16": want["K3"]} and
          fops.paged_decode_attention.launches == want["K3"],
          f"{tag} K3 launches {k3}, predicted {want['K3']} bf16")
    check(k7 == {"float32": 0, "bfloat16": want["K7"]} and
          wops.rwkv6_scan.launches == want["K7"],
          f"{tag} K7 launches {k7}, predicted {want['K7']} bf16")
    check(k5 == {aops.SOURCES[f32].name: 0, sm90: want["K5"]} and
          aops.LAUNCHES == {"fwd": want["K5"], "dq": 0, "dkv": 0},
          f"{tag} K5 launches {aops.LAUNCHES} by source {k5}, predicted "
          f"{want['K5']} forward on {sm90}")
    check(not any(plain.values()), f"{tag} plain versions ran: {plain}")
    check(all(len(res[i]) == g for i, g in enumerate(w.gens)),
          f"{tag} a request did not finish with its token count")
    check(eng.decode_cache_size == 1, f"{tag} decode step saw "
          f"{eng.decode_cache_size} input signatures")
    types = {p: x.dtype for p, x in eng.paged.items()}
    want_types = ({"state/sub0/x_tmix": bf16, "state/sub0/x_cmix": bf16,
                   "state/sub0/wkv": f32} if ssm else
                  {"pool/k": bf16, "pool/v": bf16})
    if cfg.family == "hybrid":          # conv state bf16, SSM state fp32
        from repro_torch.models.transformer import block_layout
        for i in range(len(block_layout(cfg))):
            want_types.update({f"state/sub{i}/conv": bf16,
                               f"state/sub{i}/ssm": f32})
    check(types == want_types, f"{tag} engine state dtypes {types}")
    print(f"{tag} {st['n_requests']} requests of {t.prompt_len} prompt "
          f"tokens over {w.serve.n_slots} slots (max_len "
          f"{eng.layout.max_len}), prefill attention {t.attn_impl}: "
          f"{st['total_tokens']} tokens in {st['wall_s']:.3f} s: "
          f"{st['tokens_per_sec']:.1f} tok/s; decode "
          f"{st['decode_ms_per_step']:.3f} ms per step (host) over "
          f"{steps_} steps; {calls_} prefill calls; TTFT p50 "
          f"{st['ttft_p50_s']:.3f} s p99 {st['ttft_p99_s']:.3f} s; latency "
          f"p50 {st['latency_p50_s']:.3f} s p99 {st['latency_p99_s']:.3f} "
          f"s; peak memory {peak / 2**30:.2f} GiB; on {smi}")
    print(f"{tag} (e3) launches: K3 {k3} (predicted {want['K3']} = "
          f"{cfg.n_layers} x {steps_} decode steps in bf16), K7 {k7} "
          f"(predicted {want['K7']}), K5 by source {k5} (predicted "
          f"{want['K5']} on {sm90}); plain versions {plain}; (e4) params "
          f"bf16, engine state " + ", ".join(
              f"{p} {str(d)[6:]}" for p, d in types.items())
          + f"; decode input signatures {eng.decode_cache_size}")
    del eng

    # (e1), (e2): the first n_slots requests (one admission group), each
    # forced to the fp32 run's first FORCED_GEN tokens; the kernel's run
    # under the profiler (device time of its steps by kind)
    n_req = w.serve.n_slots
    toks32 = {i: fp32[0][i][:FORCED_GEN] for i in range(n_req)}
    rows32 = {i: fp32[1][i][:FORCED_GEN] for i in range(n_req)}
    rows, record, kinds, f_steps, secs = {}, [], {}, 0, {}
    keep = {} if time_k3 else None
    for kind in ("kernel", "plain", "fault"):
        eng = sw.engine(w, n_requests=n_req, gen=FORCED_GEN,
                        record_logits=True, temperature=1.0)
        eng.gumbel = _forcing(toks32, dev)
        swap, prof = contextlib.nullcontext(), contextlib.nullcontext()
        if kind == "kernel":
            eng._prefill = _ranged(eng._prefill, "serve/prefill")
            eng._commit = _ranged(eng._commit, "serve/commit")
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
        else:
            swap = _serve_swap(kind, cfg, record if kind == "plain"
                               else None, keep if kind == "plain" else None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with swap, prof:
            got = eng.run()
            torch.cuda.synchronize()
        secs[kind] = time.perf_counter() - t0
        check(all(np.array_equal(got[i], toks32[i]) for i in toks32),
              f"{tag} the {kind} run did not follow the forced streams")
        rows[kind] = _engine_rows(eng, got)[1]
        if kind == "kernel":
            f_steps = eng.stats()["n_decode_steps"]
            kinds = _by_range(prof)
        del eng, prof
    dec, pre = kinds.get("decode", {}), kinds.get("prefill", {})
    step_dev = sum(v for k, v in dec.items() if k != "memcpy / memset") \
        / f_steps
    dist = {"kernel vs plain": _rows_dist(rows["kernel"], rows["plain"]),
            "plain vs fp32": _rows_dist(rows["plain"], rows32),
            "kernel vs fp32": _rows_dist(rows["kernel"], rows32),
            "fault vs plain": _rows_dist(rows["fault"], rows["plain"])}
    bar = BAR_FACTOR * dist["plain vs fp32"]
    n_rows = sum(len(r) for r in rows32.values())
    ratios = [r[-2] for r in record if r[-2] is not None]
    planted = [r[-1] for r in record if r[-1] is not None]
    # K7: the ratio the bar reads is against its fp32 instance; the one
    # against the plain version in fp32 is printed beside it
    to_plain = [r[-3] for r in record if r[-3] is not None] if ssm \
        else ratios
    near = _near_tie_steps(rows32, rows["plain"])
    either = _near_tie_steps(rows32, rows["plain"], rows["kernel"])
    parted = {}
    for i, k in either.items():
        other = np.flatnonzero(res[i][:FORCED_GEN] != toks32[i])
        parted[i] = int(other[0]) if len(other) else None
        check(parted[i] is None or parted[i] >= k - 1, f"{tag} request {i}"
              f": the greedy bf16 stream parts from the fp32 one at step "
              f"{parted[i]}, before its first near tie at step {k - 1}")
    what = ("layer 0 drops the carry between chunks" if ssm else
            "layer 0 leaves out the first page of every sequence")
    kname = "K7" if ssm else "K3"
    print(f"{tag} (e1) the first {n_req} requests forced to the fp32 "
          f"streams of {fp32_tag}, {FORCED_GEN} tokens each: {n_rows} "
          f"logits rows, every step compared; largest ||x - y|| / ||y|| "
          f"over rows: kernel vs plain {dist['kernel vs plain']:.4e}, "
          f"kernel vs fp32 {dist['kernel vs fp32']:.4e}, plain vs fp32 "
          f"{dist['plain vs fp32']:.4e}; bar {BAR_FACTOR:g} x the last = "
          f"{bar:.4e}; (e2) planted fault ({what}) vs plain "
          f"{dist['fault vs plain']:.4e} ({dist['fault vs plain'] / bar:.1f}"
          f"x the bar); the runs' seconds " + ", ".join(
              f"{k} {v:.1f}" for k, v in secs.items()))
    print(f"{tag} (e1) in the model, the plain run's first {len(ratios)} "
          f"{kname} calls of {len(record)}: the kernel on the same bf16 "
          f"inputs against "
          + ("its fp32 instance on them cast up" if ssm else
             "the plain version in fp32")
          + f", element by element (ref.bf16_error_ratio, bar 1): largest "
          f"{max(ratios):.4f}, median {float(np.median(ratios)):.4f}"
          + (f" (against the plain version in fp32: largest "
             f"{max(to_plain):.4f}, median {float(np.median(to_plain)):.4f}"
             f", not held)" if ssm else "")
          + f"; (e2) the planted fault at layer 0: least {min(planted):.1f}")
    print(f"{tag} (e1) greedy streams over those steps: up to each "
          f"request's first near tie (fp32 top-2 gap below the largest "
          f"|plain - fp32|) {sum(near.values())} of {n_rows} ({near}); the "
          f"greedy bf16 stream (the kernel's) parts from the fp32 one at "
          f"steps {parted} (None: not within {FORCED_GEN}), each at or "
          f"after its first near tie by the plain or the kernel rows")
    check(0 < dist["kernel vs plain"] <= bar and dist["kernel vs fp32"]
          <= bar, f"{tag} (e1) the kernel's rows lie {dist} apart, outside "
          f"{bar}")
    check(max(ratios) <= 1.0, f"{tag} (e1) a {kname} call lies outside the "
          f"element-wise bar: {max(ratios)}")
    check(dist["fault vs plain"] > bar and min(planted) > 1.0,
          f"{tag} (e2) the planted fault passes a bar ("
          f"{dist['fault vs plain']} <= {bar}, or element-wise "
          f"{min(planted)} <= 1)")
    print(f"{tag} device ms a decode step {step_dev:.4f} over the kernel "
          f"run's {f_steps} steps of {n_req} sequences (the recorded rows' "
          f"copies left out; busy share "
          f"{step_dev / st['decode_ms_per_step']:.1%} of the greedy run's "
          f"host ms a step {st['decode_ms_per_step']:.3f}),"
          f" by kind: " + ", ".join(f"{k} {v / f_steps:.4f}" for k, v in
                                    sorted(dec.items(), key=lambda x: -x[1]))
          + "; prefill device ms by kind: " + ", ".join(
              f"{k} {v:.3f}" for k, v in sorted(pre.items(),
                                                 key=lambda x: -x[1]))
          + f"; on {smi}")
    out = {"tok_s": st["tokens_per_sec"], "step_ms": st["decode_ms_per_step"],
           "step_device_ms": step_dev,
           "busy": step_dev / st["decode_ms_per_step"],
           "ttft_p50_s": st["ttft_p50_s"], "ttft_p99_s": st["ttft_p99_s"],
           "latency_p50_s": st["latency_p50_s"],
           "latency_p99_s": st["latency_p99_s"], "peak_GiB": peak / 2**30,
           "steps": steps_, "prefill_calls": calls_,
           "launches": {"K3": want["K3"], "K5": want["K5"],
                        "K7": want["K7"]},
           "bars": dict(dist, bar=bar, rows=n_rows,
                        element_ratio=max(ratios),
                        element_ratio_to_plain=max(to_plain),
                        planted_element_ratio=min(planted),
                        near_tie_steps=sum(near.values()))}
    k3_name, k7_name, k5_name = ("flash_decode_paged (K3)", "rwkv6_scan (K7)",
                                 "flash_attention_fwd (K5)")
    if ssm:
        bound, by = _k7_bound(record, name)
        calls = len(record)
        ms = pre.get(k7_name, 0.0)
        out["K7"] = {"in_run_ms": ms / calls, "bound_ms": bound / calls,
                     "bound_by": by, "launches": want["K7"]}
        print(f"{tag} rwkv6_scan (K7) bf16 in the kernel run's prefills: "
              f"{ms:.4f} ms device for its {calls} calls ({ms / calls:.4f} a "
              f"call), bound {bound:.4f} ms ({by}), kernel at "
              f"{bound / max(ms, 1e-9):.1%} of it; on {smi}")
    else:
        bound, by = _k3_bound(record, name, BF16_PEAK)
        calls = len(record)
        ms = dec.get(k3_name, 0.0) / calls
        out["K3"] = {"in_run_ms": ms, "bound_ms": bound, "bound_by": by,
                     "launches": want["K3"]}
        print(f"{tag} flash_decode_paged (K3) bf16 in the kernel run's "
              f"decode steps: {ms:.4f} ms a call ({calls} calls, "
              f"{ms * cfg.n_layers:.4f} ms a step of {cfg.n_layers}), bound "
              f"{bound:.4f} ms a call ({by}, the run's valid lengths), "
              f"kernel at {bound / max(ms, 1e-9):.1%} of it; on {smi}")
        if keep:
            from repro_torch.kernels.flash_decode.ref import paged_decode_ref
            q, kp, vp, pt, valid = keep.pop("K3")
            alone = {"ms": device_ms(lambda: fops.paged_decode_attention(
                         q, kp, vp, pt, valid)),
                     "plain_ms": device_ms(lambda: paged_decode_ref(
                         q, kp, vp, pt, valid)),
                     "library_ms": device_ms(lambda: _sdpa(q, kp, vp, pt,
                                                           valid))}
            one = _k3_bound([(valid.sum(), ((valid + kp.shape[1] - 1)
                                            // kp.shape[1]).sum(),
                              *q.shape[:1], q.shape[2], kp.shape[2],
                              q.shape[3], q.element_size())], name,
                            BF16_PEAK)
            out["K3"].update(alone, call_bound_ms=one[0])
            print(f"{tag} K3 bf16 alone on layer 0's first decode call's own "
                  f"inputs ({len(valid)} sequences, valid "
                  f"{valid.min().item()}-{valid.max().item()}): device median "
                  f"ms (L2 flushed) kernel {alone['ms']:.4f}, plain "
                  f"{alone['plain_ms']:.4f}, gather + SDPA "
                  f"{alone['library_ms']:.4f}; bound {one[0]:.4f} ms (kernel "
                  f"at {one[0] / alone['ms']:.1%}); on {smi}")
            del q, kp, vp, pt, valid
        if want["K5"]:
            k5_ms = pre.get(k5_name, 0.0)
            k5_bound = _k5_bound(cfg, n_req, t.prompt_len, name)
            out["K5"] = {"in_run_ms": k5_ms / cfg.n_layers,
                         "bound_ms": k5_bound / cfg.n_layers,
                         "launches": want["K5"], "source": sm90}
            print(f"{tag} flash_attention_fwd (K5) bf16 in the kernel "
                  f"run's prefill: {k5_ms:.4f} ms for its {cfg.n_layers} "
                  f"launches ({k5_ms / cfg.n_layers:.4f} a launch), bound "
                  f"{k5_bound:.4f} ms at 989 TFLOP/s, kernel at "
                  f"{k5_bound / max(k5_ms, 1e-9):.1%}; on {smi}")
    del rows
    return out


def _bf16_twin(tag, w, n_params):
    """``serve_workload.cast`` of ``w`` (its fp32 leaves freed one by
    one), checked and reported: the bf16 twin."""
    from repro_torch import serve_workload as sw
    from repro_torch.common import param_count
    t0 = time.perf_counter()
    w16 = sw.cast(w)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = param_count(w16.params)
    check(n == n_params and not w.params and all(
        x.dtype == torch.bfloat16 for x in w16.params.values()),
        f"{tag} the bf16 twin has {n} params (expected {n_params}), the "
        f"fp32 workload {len(w.params)} leaves left")
    print(f"{tag} {w16.cfg.name} at full width in bf16 "
          f"(param_dtype=\"bfloat16\", the reference's switch): the fp32 "
          f"phase's {n:,} params cast leaf by leaf on the card in "
          f"{secs:.2f} s ({n * 2 / 1e9:.2f} GB; "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated after)")
    return w16


def phase_serve_bf16(dev, smi, w, parity_run):
    """qwen3-1.7b in bf16 (configuration 38): ``[serve]``'s weights cast,
    under ``[serve]``'s traffic and ``TRAFFIC["long"]`` (the prefill on K5
    bf16), each through ``_bf16_serving``; the long traffic's fp32 rows
    from an fp32 engine run on the same weights first.  ``parity_run`` is
    ``[serve-parity]``'s engine run (its rows recorded)."""
    from repro_torch import serve_workload as sw
    tag = "[serve-bf16]"
    wl = sw.build(dev, traffic="long", params=w.params)
    eng = sw.engine(wl, record_logits=True, gen=FORCED_GEN)
    fp32 = {"serving": _engine_rows(*parity_run),
            "long": _engine_rows(eng, eng.run())}
    del eng, parity_run
    w16 = _bf16_twin(tag, w, QWEN3_PARAMS)
    del wl
    out = {}
    for traffic in ("serving", "long"):
        wt = w16 if traffic == "serving" else sw.build(
            dev, traffic=traffic, params=w16.params, param_dtype="bfloat16")
        out[traffic] = _bf16_serving(
            f"{tag} {traffic}", wt, traffic, fp32.pop(traffic), smi,
            "[serve-parity]" if traffic == "serving" else "an fp32 long run")
    return out


def phase_serve_rwkv6_bf16(dev, smi, w):
    """rwkv6-3b in bf16 (configuration 41) under ``[serve]``'s traffic:
    ``[serve-rwkv6]``'s weights with the decay's base set to RWKV-6's own
    init (``rwkv6.decay_base_init``; the reference draws zeros, under
    which a token's decay is near exp(-1) and no state carries across a
    chunk: K7's carry would go unseen), served in fp32 (8 slots, rows recorded),
    cast, then ``_bf16_serving``: the prefill's scan on K7 bf16 (r, k, v
    bf16, the log-decay fp32), the decode steps on
    ``linear_scan_decode``."""
    from repro_torch import serve_workload as sw
    from repro_torch.models import rwkv6
    tag = "[serve-rwkv6-bf16]"
    cfg = w.cfg
    w.params["blocks/sub0/wkv/decay_base"].copy_(rwkv6.decay_base_init(
        cfg.n_layers, cfg.n_heads, cfg.head_dim))
    eng = sw.engine(w, n_requests=w.serve.n_slots, gen=FORCED_GEN,
                    record_logits=True)
    fp32 = _engine_rows(eng, eng.run())
    del eng
    w16 = _bf16_twin(tag, w, RWKV_PARAMS)
    return {"serving": _bf16_serving(f"{tag} serving", w16, "serving", fp32,
                                     smi, "an fp32 run on the same weights")}


def phase_serve_stablelm_bf16(dev, smi, w, parity_run):
    """stablelm-3b in bf16 (configuration 40): ``[serve-stablelm]``'s
    weights cast, under its traffic, through ``_bf16_serving``: K3 bf16
    at head dim 80 (10 16-byte chunks a row on 16 lanes)."""
    tag = "[serve-stablelm-bf16]"
    fp32 = _engine_rows(*parity_run)
    del parity_run
    w16 = _bf16_twin(tag, w, STABLELM_PARAMS)
    return {"serving": _bf16_serving(f"{tag} serving", w16, "serving", fp32,
                                     smi, "[serve-stablelm]'s parity")}


def phase_serve_hymba_bf16(dev, smi, runs, ran):
    """hymba-1.5b in bf16 (configuration 42): ``[serve-hymba]``'s weights
    cast leaf by leaf after its long run's rows were recorded, under
    ``TRAFFIC["long"]`` only, through ``_bf16_serving``: K3 bf16 at a GQA
    group of 5 (25 heads over 5 of 64) on the global sub-layers' pages and
    the windowed ones' rings of 1,024 that wrap, K5 bf16 32 (windowed and
    global) in the prefill; the SSM branch's conv state bf16, its SSM
    state fp32; K3's first checked call timed alone."""
    tag = "[serve-hymba-bf16]"
    w = runs["long"][0]
    fp32 = _engine_rows(*ran.pop("long"))
    runs.clear()
    w16 = _bf16_twin(tag, w, HYMBA_PARAMS)
    del w
    return {"long": _bf16_serving(f"{tag} long", w16, "long", fp32, smi,
                                  "[serve-hymba] long", time_k3=True)}


# [serve-whisper-bf16]'s greedy run: tokens a sequence (the fp32 run's 128,
# cut for the smoke's time)
WHISPER_BF16_GEN = 32


@contextlib.contextmanager
def _whisper_swap(kind, cfg, cuts, record=None, keep=None):
    """whisper's K4 call site (``whisper._decode_attend``; a decode step
    calls it self, cross, in each layer) replaced for the block.
    ``"plain"`` returns K4's plain version (``ref.decode_attention_ref``)
    on the same bf16 tensors; with ``record`` it appends each call's
    work, and on the first decode step's calls also runs the kernel (and
    at layer 0's cross-attention the planted fault) on the same inputs
    and records how far each lies, element by element, from the plain
    version in fp32 (``ref.bf16_error_ratio``); ``keep`` takes layer 0's
    first self and cross inputs.  ``"fault"`` returns the kernel with
    layer 0's two calls leaving out the first ``cuts`` = (self, cross)
    positions of their caches (a key loop that starts late: K4's first
    ring stage of the self cache, its first split of the cross cache)."""
    from repro_torch.kernels.flash_decode import ref as fref
    from repro_torch.models import whisper
    real, n, per_step = whisper._decode_attend, [0], 2 * cfg.n_layers

    def faulty(q, k, v, valid, cut):
        return real(q, k[:, cut:], v[:, cut:], valid - cut)

    def swapped(q, k, v, valid):
        i = n[0]
        n[0] += 1
        layer0 = i % per_step < 2
        cut = cuts[i % per_step] if layer0 else 0
        if kind == "fault":
            return faulty(q, k, v, valid, cut) if layer0 \
                else real(q, k, v, valid)
        out = fref.decode_attention_ref(q, k, v, valid, blk_k=k.shape[1])
        if record is not None:
            b, _, h, hd = q.shape
            work = (valid.sum(), valid.new_tensor(b), b, h, k.shape[2], hd,
                    q.element_size())
            if i < per_step:
                if keep is not None and i < 2:
                    keep["cross" if i else "self"] = (q.clone(), k.clone(),
                                                      v.clone(),
                                                      valid.clone())
                want = fref.decode_attention_ref(q.float(), k.float(),
                                                 v.float(), valid,
                                                 blk_k=k.shape[1])
                record.append((*work, fref.bf16_error_ratio(
                    real(q, k, v, valid), want), fref.bf16_error_ratio(
                    faulty(q, k, v, valid, cut), want) if layer0 else None))
            else:
                record.append((*work, None, None))
        return out

    whisper._decode_attend = swapped
    try:
        yield n
    finally:
        whisper._decode_attend = real


def phase_serve_whisper_bf16(dev, smi, fp32_run):
    """whisper-medium in bf16 (configuration 43): ``[serve-whisper]``'s
    weights and frames cast leaf by leaf (``param_dtype="bfloat16"``, the
    reference's switch; the frames bf16, as the model takes them),
    through ``static_generate`` (``fp32_run``: [serve-whisper]'s model,
    prompts, frames, tokens and rows).  (e3) A greedy run of
    WHISPER_BF16_GEN tokens, counters zeroed just before it: K5 bf16 24
    in the encoder's prefill on ``flash_attention_sm90.cu`` (1,500 frames
    padded to 1,536, ``kv_len``), K4 bf16 48 a decode step (self and
    cross caches), nothing of fp32, no plain version; tokens/s, ms a
    decode step, peak memory.  (e4) the params, the self and cross caches
    bf16, the rows float32.  (e1) Three runs forced to the fp32 run's
    first FORCED_GEN tokens (``_forcing``), rows recorded: the kernels
    (profiled: device ms a decode step by kind, K4 ms a call and K5 ms a
    launch beside their bounds), the plain attention (the encoder's
    ``attend_reference``, K4's plain version in each decode step, the
    first step's K4 calls also held element by element, the kernel's
    output to the plain version in fp32), and (e2) the planted fault,
    layer 0's first self-cache ring stage (64 tokens) and first
    cross-cache split (320 of 1,500 frames) left out; every row compared
    (the cross cut alone moves the rows less than bf16's own noise on
    random frames, so the self cut carries the rows' bar and the cross
    cut the element-wise one): the
    kernels within BAR_FACTOR x the plain run's distance from the fp32
    rows, of both; the fault outside; the greedy stream parts from the
    fp32 one only at a near tie.  K4 alone (self and cross) and K5 alone
    (the encoder's call) on the run's own shapes beside their plain
    versions and SDPA."""
    import torch.nn.functional as F
    from repro_torch.common import param_count
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.kernels.flash_attention.ref import flash_attention_fwd_ref
    from repro_torch.kernels.flash_decode import ops as fops
    from repro_torch.kernels.flash_decode.ref import decode_attention_ref
    from repro_torch.models import get_model, whisper
    from repro_torch.models.attention import FLASH_BLOCK
    from repro_torch.serve.engine import static_generate

    tag = "[serve-whisper-bf16]"
    bf16, f32 = torch.bfloat16, torch.float32
    name = torch.cuda.get_device_name(0)
    cfg32, params, prompts, frames32, out32, rows32_t = (
        fp32_run.pop(k) for k in ("cfg", "params", "prompts", "frames",
                                  "tokens", "rows"))
    cfg = cfg32.replace(param_dtype="bfloat16")
    t0 = time.perf_counter()
    p16 = {}
    for p in list(params):
        p16[p] = params.pop(p).to(bf16)
    frames = frames32.to(bf16)
    del frames32
    torch.cuda.synchronize()
    n = param_count(p16)
    check(n == WHISPER_PARAMS and all(x.dtype == bf16 for x in p16.values()),
          f"{tag} the bf16 twin has {n} params, expected {WHISPER_PARAMS}")
    print(f"{tag} {cfg.name} at full width in bf16 (param_dtype=\"bfloat16\""
          f", the reference's switch): [serve-whisper]'s {n:,} params cast "
          f"leaf by leaf on the card in {time.perf_counter() - t0:.2f} s "
          f"({n * 2 / 1e9:.2f} GB), its frames {tuple(frames.shape)} cast "
          f"to bf16 (the model takes the params' dtype; it never casts them)")
    b, gen = WHISPER_BATCH, WHISPER_BF16_GEN

    def run(attn_impl="chunked", k=b, steps=gen, forced=None):
        kw = {} if forced is None else dict(temperature=1.0,
                                            gumbel=_forcing(forced, dev))
        toks, rows = static_generate(
            cfg, p16, prompts[:k], steps, max_len=WHISPER_MAX_LEN,
            attn_impl=attn_impl, collect_logits=True, device=dev,
            extra={"frames": frames[:k]}, **kw)
        return toks, {i: np.stack([r[i] for r in rows]) for i in range(k)}

    run(k=2, steps=3)                                # warm-up, not measured
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for ops in (aops, fops):
        ops.reset_launch_counts()
    t0 = time.perf_counter()
    with _plain_calls() as plain:
        toks, rows = run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    k4 = {str(k)[6:]: v for k, v in fops.DTYPE_LAUNCHES.items()}
    k5 = dict(aops.SOURCE_LAUNCHES)
    sm90 = aops.SOURCES[bf16].name
    want = {"K4": 2 * cfg.n_layers * (gen - 1), "K5": cfg.n_enc_layers}
    check(k4 == {"float32": 0, "bfloat16": want["K4"]},
          f"{tag} K4 launches {k4}, predicted {want['K4']} bf16")
    check(k5 == {aops.SOURCES[f32].name: 0, sm90: want["K5"]} and
          aops.LAUNCHES == {"fwd": want["K5"], "dq": 0, "dkv": 0},
          f"{tag} K5 launches {aops.LAUNCHES} by source {k5}, predicted "
          f"{want['K5']} forward on {sm90}")
    check(not any(plain.values()), f"{tag} plain versions ran: {plain}")
    check(toks.shape == (b, gen) and all(
        r.dtype == np.float32 and r.shape == (gen, cfg.padded_vocab) and
        np.isfinite(r).all() for r in rows.values()),
        f"{tag} tokens {toks.shape} or rows not finite float32")
    model = get_model(cfg)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cache = model.prefill(p16, torch.as_tensor(prompts, device=dev),
                                 frames=frames, max_len=WHISPER_MAX_LEN,
                                 attn_impl="chunked", last_only=True)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    types = {p: str(x.dtype)[6:] for p, x in cache.items() if p != "step"}
    check(set(types.values()) == {"bfloat16"} and len(types) == 4,
          f"{tag} cache dtypes {types}")
    del cache
    step_ms = (wall - prefill_s) / (gen - 1) * 1e3
    print(f"{tag} (e3) {b} sequences x {WHISPER_PROMPT} prompt tokens, {gen} "
          f"generated each (max_len {WHISPER_MAX_LEN}), greedy: {b * gen} "
          f"tokens in {wall:.3f} s: {b * gen / wall:.1f} tok/s; prefill "
          f"(encoder + prompt) {prefill_s * 1e3:.1f} ms; decode {step_ms:.3f}"
          f" ms per step (host) over {gen - 1} steps; peak memory "
          f"{peak / 2**30:.2f} GiB; launches: K4 {k4} (predicted "
          f"{want['K4']} = 2 x {cfg.n_layers} layers x {gen - 1} decode "
          f"steps in bf16), K5 by source {k5} (predicted {want['K5']} on "
          f"{sm90}: the encoder's 1,500 frames padded to 1,536, kv_len "
          f"1,500); plain versions {plain}; (e4) params bf16, caches "
          + ", ".join(f"{p} {d}" for p, d in types.items())
          + f", rows float32; on {smi}")

    # (e1), (e2): every sequence forced to the fp32 run's first FORCED_GEN
    # tokens; the kernels' run under the profiler
    toks32 = {i: out32[i, :FORCED_GEN] for i in range(b)}
    rows32 = {i: np.stack([r[i] for r in rows32_t[:FORCED_GEN]])
              for i in range(b)}
    # the fault's cuts: K4's first ring stage of the self cache (64 tokens
    # in bf16), its first split of the cross cache (320 of 1,500)
    pl = fops.plan(b, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, 1,
                   cfg.enc_seq, cfg.head_dim, bf16, dev)
    cuts = (pl.tile, pl.span)
    f_rows, record, keep, secs = {}, [], {}, {}
    real_prefill = whisper.prefill
    for kind in ("kernel", "plain", "fault"):
        swap, prof = contextlib.nullcontext(), contextlib.nullcontext()
        if kind == "kernel":
            whisper.prefill = _ranged(real_prefill, "serve/prefill")
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
        else:
            swap = _whisper_swap(kind, cfg, cuts, record if kind == "plain"
                                 else None, keep)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            with swap, prof:
                got, f_rows[kind] = run(
                    "reference" if kind == "plain" else "chunked",
                    steps=FORCED_GEN, forced=toks32)
                torch.cuda.synchronize()
        finally:
            whisper.prefill = real_prefill
        secs[kind] = time.perf_counter() - t0
        check(all(np.array_equal(got[i], toks32[i]) for i in toks32),
              f"{tag} the {kind} run did not follow the forced streams")
        if kind == "kernel":
            kinds = _by_range(prof)
        del prof
    dec, pre = kinds.get("decode", {}), kinds.get("prefill", {})
    f_steps = FORCED_GEN - 1
    step_dev = sum(v for k, v in dec.items() if k != "memcpy / memset") \
        / f_steps
    dist = {"kernel vs plain": _rows_dist(f_rows["kernel"], f_rows["plain"]),
            "plain vs fp32": _rows_dist(f_rows["plain"], rows32),
            "kernel vs fp32": _rows_dist(f_rows["kernel"], rows32),
            "fault vs plain": _rows_dist(f_rows["fault"], f_rows["plain"])}
    bar = BAR_FACTOR * dist["plain vs fp32"]
    n_rows = sum(len(r) for r in rows32.values())
    ratios = [r[-2] for r in record if r[-2] is not None]
    planted = [r[-1] for r in record if r[-1] is not None]
    near = _near_tie_steps(rows32, f_rows["plain"])
    either = _near_tie_steps(rows32, f_rows["plain"], f_rows["kernel"])
    parted = {}
    for i, k in either.items():
        other = np.flatnonzero(toks[i, :FORCED_GEN] != toks32[i])
        parted[i] = int(other[0]) if len(other) else None
        check(parted[i] is None or parted[i] >= k - 1, f"{tag} sequence {i}"
              f": the greedy bf16 stream parts from the fp32 one at step "
              f"{parted[i]}, before its first near tie at step {k - 1}")
    print(f"{tag} (e1) the {b} sequences forced to [serve-whisper]'s fp32 "
          f"streams, {FORCED_GEN} tokens each: {n_rows} logits rows, every "
          f"step compared; largest ||x - y|| / ||y|| over rows: kernels vs "
          f"plain {dist['kernel vs plain']:.4e}, kernels vs fp32 "
          f"{dist['kernel vs fp32']:.4e}, plain vs fp32 "
          f"{dist['plain vs fp32']:.4e}; bar {BAR_FACTOR:g} x the last = "
          f"{bar:.4e}; (e2) planted fault (layer 0 leaves out the first "
          f"{cuts[0]} self-cache positions, K4's first ring stage, and the "
          f"first {cuts[1]} of {cfg.enc_seq:,} cross-cache positions, its "
          f"first split) vs plain {dist['fault vs plain']:.4e} "
          f"({dist['fault vs plain'] / bar:.1f}x the bar); the runs' seconds "
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    print(f"{tag} (e1) in the model, the plain run's first decode step's "
          f"{len(ratios)} K4 calls (self and cross, every layer) of "
          f"{len(record)}: the kernel on the same bf16 inputs against the "
          f"plain version in fp32, element by element (ref.bf16_error_ratio,"
          f" bar 1): largest {max(ratios):.4f}, median "
          f"{float(np.median(ratios)):.4f}; (e2) the planted fault at layer "
          f"0's self / cross call: "
          + " / ".join(f"{x:.1f}" for x in planted))
    print(f"{tag} (e1) greedy streams over those steps: up to each "
          f"sequence's first near tie (fp32 top-2 gap below the largest "
          f"|plain - fp32|) {sum(near.values())} of {n_rows} ({near}); the "
          f"greedy bf16 stream parts from the fp32 one at steps {parted} "
          f"(None: not within {FORCED_GEN}), each at or after its first near "
          f"tie by the plain or the kernels' rows")
    check(0 < dist["kernel vs plain"] <= bar and dist["kernel vs fp32"]
          <= bar, f"{tag} (e1) the kernels' rows lie {dist} apart, outside "
          f"{bar}")
    check(len(ratios) == 2 * cfg.n_layers and max(ratios) <= 1.0,
          f"{tag} (e1) {len(ratios)} K4 calls checked, the largest at "
          f"{max(ratios)} of the element-wise bar")
    check(dist["fault vs plain"] > bar and len(planted) == 2 and
          min(planted) > 1.0, f"{tag} (e2) the planted fault passes a bar ("
          f"{dist['fault vs plain']} <= {bar}, or element-wise {planted} "
          f"<= 1)")
    k4_calls = 2 * cfg.n_layers * f_steps
    k4_ms = dec.get("flash_decode_paged (K3)", 0.0) / k4_calls
    k4_bound, k4_by = _k3_bound(record, name, BF16_PEAK)
    k5_ms = pre.get("flash_attention_fwd (K5)", 0.0) / cfg.n_enc_layers
    k5_b = _attn_bound(name, b, cfg.enc_seq, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, 0, esz=2, peak=BF16_PEAK, causal=False)
    print(f"{tag} device ms a decode step {step_dev:.4f} over the kernels' "
          f"run's {f_steps} steps of {b} sequences (busy share "
          f"{step_dev / step_ms:.1%} of the greedy run's host ms a step "
          f"{step_ms:.3f}), by kind: " + ", ".join(
              f"{k} {v / f_steps:.4f}" for k, v in
              sorted(dec.items(), key=lambda x: -x[1]))
          + "; prefill device ms by kind: " + ", ".join(
              f"{k} {v:.3f}" for k, v in sorted(pre.items(),
                                                 key=lambda x: -x[1]))
          + f"; K4 bf16 in the steps {k4_ms:.4f} ms a call ({k4_calls} "
          f"calls; bound {k4_bound:.4f} ms a call, {k4_by}, kernel at "
          f"{k4_bound / max(k4_ms, 1e-9):.1%}); K5 bf16 in the prefill "
          f"{k5_ms:.4f} ms a launch (bound {k5_b['fwd'][0]:.4f} at 989 "
          f"TFLOP/s on the real 1,500 x 1,500 pairs, at "
          f"{k5_b['fwd'][0] / max(k5_ms, 1e-9):.1%}); on {smi}")
    # K4 alone at layer 0's first self and cross calls, K5 alone at the
    # encoder's call, each beside its plain version and SDPA
    alone = {}
    for which, (q, k, v, valid) in keep.items():
        want_ = decode_attention_ref(q.float(), k.float(), v.float(), valid,
                                     blk_k=k.shape[1])
        lib = _sdpa_decode(q, k, v, valid)
        check(_rel([lib], [want_]) <= 2e-2, f"{tag} the SDPA yardstick at "
              f"the {which} cache lies {_rel([lib], [want_])} from the "
              f"plain version")
        one = _k3_bound([(valid.sum(), valid.new_tensor(b), b, cfg.n_heads,
                          cfg.n_kv_heads, cfg.head_dim, 2)], name, BF16_PEAK)
        alone[which] = {
            "ms": device_ms(lambda: fops.decode_attention(
                q, k, v, valid, blk_k=k.shape[1])),
            "plain_ms": device_ms(lambda: decode_attention_ref(
                q, k, v, valid, blk_k=k.shape[1])),
            "library_ms": device_ms(lambda: _sdpa_decode(q, k, v, valid)),
            "bound_ms": one[0], "bound_by": one[1],
            "valid": [int(valid.min()), int(valid.max())]}
    gen_ = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn((b, cfg.enc_seq, cfg.n_heads, cfg.head_dim),
                    generator=gen_, device=dev).to(bf16)
    xp = F.pad(x, (0, 0, 0, 0, 0, -cfg.enc_seq % FLASH_BLOCK))

    def sdpa():
        t = x.transpose(1, 2)
        return F.scaled_dot_product_attention(t, t, t).transpose(1, 2)

    alone["encoder"] = {
        "ms": device_ms(lambda: aops.attention_fwd(
            xp, xp, xp, causal=False, kv_len=cfg.enc_seq), 10),
        "plain_ms": device_ms(lambda: flash_attention_fwd_ref(
            x, x, x, causal=False, round_to=bf16), 5, 1),
        "library_ms": device_ms(sdpa, 10),
        "bound_ms": k5_b["fwd"][0], "bound_by": k5_b["fwd"][1]}
    print(f"{tag} alone, device median ms (L2 flushed), kernel / plain / "
          f"SDPA (bound): " + "; ".join(
              f"{w_} {a['ms']:.4f} / {a['plain_ms']:.4f} / "
              f"{a['library_ms']:.4f} ({a['bound_ms']:.4f}, kernel at "
              f"{a['bound_ms'] / a['ms']:.1%})" for w_, a in alone.items())
          + f" (K4 at layer 0's first self and cross calls, masked SDPA; "
          f"K5 at the encoder's shape, {b} x {cfg.enc_seq:,} non-causal, "
          f"padded to 1,536 with kv_len, SDPA on the unpadded inputs); on "
          f"{smi}")
    del p16, frames, keep, x, xp
    return {"K4": want["K4"], "K5": want["K5"], "tok_s": b * gen / wall,
            "step_ms": step_ms, "step_device_ms": step_dev, "peak": peak,
            "bars": dict(dist, bar=bar, rows=n_rows,
                         element_ratio=max(ratios),
                         planted_element_ratio=min(planted),
                         near_tie_steps=sum(near.values())),
            "K4_in_run": {"in_run_ms": k4_ms, "bound_ms": k4_bound,
                          "bound_by": k4_by, "launches": want["K4"],
                          "alone": {w_: alone[w_] for w_ in ("self",
                                                             "cross")}},
            "K5_in_run": {"in_run_ms": k5_ms, "bound_ms": k5_b["fwd"][0],
                          "launches": want["K5"], "source": sm90,
                          "alone": alone["encoder"]}}


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
        if chunk == MESH_CHUNK:
            MESH_WANT[f"cohort chunk {chunk}"] = _run_record(fed)
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


# ---------------------------------------------------------------------------
# the zoo: the federated round and the training step of the zoo LMs at full
# width, with kernels K5/K6 inside ``attend`` (phases 29-33)
# ---------------------------------------------------------------------------

ZOO_ARCH = "qwen3-1.7b"
ZOO_PARAMS = 1_720_574_976        # the reference's init at full width
ZOO_CLIENTS, ZOO_STEPS, ZOO_ROUNDS = 2, 2, 2
ZOO_LR = 2e-3                     # launch/train.py's default
ZOO_PARITY_TOL = 1e-6             # card vs CPU params after one SGD step
# the parity round's SGD rate: at the launcher's 2e-3 the first layer's wk
# moves by under 1e-5, too little for a 1e-6 bar to see a wrong gradient
ZOO_PARITY_LR = 0.1
# the 2-layer parities' text length on qwen3-1.7b and stablelm-3b: past
# 512, so the chunked route (K5/K6) runs; cut from 1,024 to shorten the
# host CPU's side
ZOO_PARITY_S = 544                # past 512: the chunked route, K5/K6
# whisper's: its encoder's q and k rows see a near-uniform softmax over
# 1,500 frames, and at 0.1 they move by 3.5e-6-4.7e-6 (an H100 run), under
# the 10 x ZOO_PARITY_TOL the phase asks of every attention row
WHISPER_PARITY_LR = 1.0
GEMMA_MACRO_S = 2048
# device kernels of the zoo path, by the names they launch under
ZOO_KERNELS = {"K1": ("masked_agg_kernel",),
               "K2": ("quantize_pack_group_kernel",),
               "K5": ("fwd_kernel",), "K6": ("dq_kernel", "dkv_kernel")}


def _free_card(tag):
    """Collect cyclic garbage (a Federation and its hooks) and return the
    cached blocks: a full-width zoo round needs most of the card.  Prints
    the process's peak host memory too: the parity phases hold
    full-width leaves on the host."""
    import gc
    import resource
    gc.collect()
    torch.cuda.empty_cache()
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    print(f"[{tag}] {torch.cuda.memory_allocated() / 1e9:.2f} GB still "
          f"allocated on the card; host peak resident {peak / 2**30:.1f} GiB")


def _zoo_counts():
    from repro_torch.kernels.codec import ops as qops
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.kernels.masked_agg import ops as kops
    return {"K1": kops.masked_agg.launches,
            "K2": qops.quantize_pack_group.launches,
            "K5": aops.LAUNCHES["fwd"], "K6 dq": aops.LAUNCHES["dq"],
            "K6 dkv": aops.LAUNCHES["dkv"]}


def _zoo_reset():
    from repro_torch.kernels.codec import ops as qops
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.kernels.masked_agg import ops as kops
    for mod in (qops, aops, kops):
        mod.reset_launch_counts()


def _kernel_events(prof):
    """Device kernel events of a profile in start order: (name, us), read
    by ``profiling.device_kernels`` (the MoE ranges left out)."""
    from repro_torch.profiling import device_kernels
    return [(k.name, k.us) for k in device_kernels(prof)]


# cuBLAS's kernels, by name: ``*gemm*`` and, on Hopper in bf16, ``nvjet_*``
CUBLAS_NAMES = ("gemm", "nvjet")


def _in_run(events):
    """Per kernel kind: launches and device ms per launch (K6: a dQ and a
    dK/dV launch per call, ms per call), the device's busy ms and the
    matmul (cuBLAS, CUBLAS_NAMES) ms."""
    out = {}
    for kind, names in ZOO_KERNELS.items():
        us = [t for n, t in events if any(k in n for k in names)]
        calls = len(us) // len(names)
        out[kind] = {"launches": len(us),
                     "ms": sum(us) / max(calls, 1) / 1e3,
                     "total_ms": sum(us) / 1e3}
    out["busy_ms"] = sum(t for _, t in events) / 1e3
    out["gemm_ms"] = sum(t for n, t in events
                         if any(k in n.lower() for k in CUBLAS_NAMES)) / 1e3
    return out


def _top_kernels(events, n=8):
    """The ``n`` kernel names (cut to 48 characters) with the most device
    time in ``events``: ``[(name, ms, launches)]``."""
    tot = {}
    for name, us in events:
        ms, k = tot.get(name[:48], (0.0, 0))
        tot[name[:48]] = (ms + us / 1e3, k + 1)
    return sorted(((k, ms, c) for k, (ms, c) in tot.items()),
                  key=lambda x: -x[1])[:n]


def _zoo_fed(dev, cfg, s=None, clients=ZOO_CLIENTS, **fl_kw):
    """``Federation.from_config`` on a zoo config as the launcher wires it
    (``lm_batch`` data by ``iid_partition``; the audio family's
    ``frames`` and the vlm family's ``patches`` standard normals from the
    seed, as ``launch/train.py`` draws them; on bf16 params the frames
    that draw rounded once to bf16, a CPU tensor the loader indexes, as
    the model takes them), with the pod step's loss
    keywords (chunked attention, remat): one sequence of ``s`` text
    tokens (``train_4k``'s length unless given) per client and local
    step, ``clients`` clients."""
    from repro_torch.core import FLConfig, Federation
    from repro_torch.data import FederatedLoader, iid_partition, lm_batch
    from repro_torch.launch import steps
    from repro_torch.launch.shapes import SHAPES

    from repro_torch.models.transformer import vit_width

    s = s or SHAPES["train_4k"].seq_len
    n = clients * ZOO_STEPS * (ZOO_ROUNDS + 1)
    data = lm_batch(n, s, cfg.vocab, key=0)
    if cfg.family == "audio":
        data["frames"] = np.random.default_rng(0).normal(
            0, 1, (n, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        if cfg.param_dtype == "bfloat16":
            data["frames"] = torch.from_numpy(data["frames"]).to(BF16)
    if cfg.family == "vlm":
        data["patches"] = np.random.default_rng(0).normal(
            0, 1, (n, cfg.n_patches, vit_width(cfg))).astype(np.float32)
    shards = iid_partition(n, clients, key=1)
    loader = FederatedLoader([{k: v[i] for k, v in data.items()}
                              for i in shards], batch_size=1,
                             steps_per_round=ZOO_STEPS, key=0)
    fl = FLConfig(n_clients=clients, train_fraction=0.5,
                  strategy="uniform", topology="hub", lr=ZOO_LR, **fl_kw)
    return Federation.from_config(cfg, fl, data=loader, device=dev,
                                  loss_kwargs=steps.default_loss_kwargs(cfg))


class ZooFrozenCheck:
    """Server hook: every client's frozen units ship exact zeros, per
    macro row of a stacked leaf; on the packed path every slot of a unit
    the client did not train (``valid`` 0) is exactly zero."""

    def __init__(self, assign, fl):
        self.assign, self.fl = assign, fl
        self.checked = self.moved = 0

    def on_round_start(self, server, round_idx, weights):
        return None

    def on_round_end(self, server, record, metrics):
        from repro_torch.core.masking import cohort_slot_plans, leaf_unit_ids
        sel, deltas = metrics["sel"], metrics["deltas"]
        valid = None
        if self.fl.packed:
            like = {p: x.to("meta") for p, x in server.params.items()}
            _, valid = cohort_slot_plans(
                self.assign, sel, self.fl.resolve_n_slots(
                    self.assign.n_units), like)
        for p, d in deltas.items():
            lu = self.assign.leaf_units[p]
            if lu.kind == "scalar":
                peak = d.flatten(1).abs().amax(1).cpu()[:, None]   # (C, 1)
                keep = sel[:, [lu.base]] if valid is None \
                    else valid[p].reshape(-1, 1)
            else:
                peak = d.flatten(2).abs().amax(2).cpu()            # (C, L)
                keep = sel[:, leaf_unit_ids(lu, server.params[p].shape)] \
                    if valid is None else valid[p]
            frozen = keep == 0
            check(bool((peak[frozen] == 0).all()),
                  f"round {record.round}: {p} has a non-zero delta on a "
                  f"frozen unit")
            self.checked += int(frozen.sum())
            self.moved += int((peak[~frozen] > 0).sum())

    def on_fit_end(self, server, history):
        pass


def _zoo_rounds(dev, smi, tag, packed):
    """2 rounds of the qwen3-1.7b zoo federation counted, then one more
    under ``torch.profiler`` for the kernels' in-run device times."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.comm import table4_row

    cfg = get_config(ZOO_ARCH)
    kw = dict(packed=True, codec="qint8") if packed else {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fed = _zoo_fed(dev, cfg, **kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in fed.params.values())
    check(n_params == ZOO_PARAMS, f"{tag}: {n_params} params, expected "
          f"{ZOO_PARAMS}")
    n_units = cfg.n_layers + 2
    check(fed.assign.n_units == n_units and
          fed.fl.resolve_n_train(n_units) == n_units // 2,
          f"{tag}: units {fed.assign.n_units}")
    check(packed or fed.fl.resolve_fused_agg(fed.device),
          f"{tag}: fused_agg did not resolve on")
    frozen, cap = ZooFrozenCheck(fed.assign, fed.fl), Capture()
    fed.server.add_hook(frozen)
    if packed:
        fed.server.add_hook(cap)
    _zoo_reset()
    secs = []
    with _K2Tap(None, timing=packed) as tap:
        for _ in range(ZOO_ROUNDS):
            t0 = time.perf_counter()
            fed.fit(1)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
    counts = _zoo_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = fed.history
    check(all(math.isfinite(r.loss) for r in hist), f"{tag}: non-finite loss")
    steps_ = ZOO_ROUNDS * ZOO_CLIENTS * ZOO_STEPS
    n_layers = cfg.n_layers
    # every local step: one K5 per layer in the forward and one in its
    # remat recompute; K6 (dQ, dK/dV) once per layer in the backward, which
    # reaches layer 0 on both paths (module docstring, phase 29)
    want = {"K1": 0 if packed else ZOO_ROUNDS,
            "K2": ZOO_ROUNDS if packed else 0,
            "K5": 2 * n_layers * steps_, "K6 dq": n_layers * steps_,
            "K6 dkv": n_layers * steps_}
    check(counts == want, f"{tag}: launches {counts}, predicted {want}")
    check(frozen.checked > 0 and frozen.moved > 0,
          f"{tag}: frozen {frozen.checked}, moved {frozen.moved}")
    if packed:
        wire = _check_wire_bytes(fed, cap, tag)
        cap.rounds.clear()
    else:
        summ = fed.comm_summary()
        t4 = table4_row(fed.assign, {p: x.to("meta") for p, x in
                                     fed.params.items()},
                        np.stack(fed.server.sel_history))
        check(all(summ[k] == v for k, v in t4.items()),
              f"{tag}: comm_summary {summ} != table4_row {t4}")
        wire = [(r.uplink_bytes, r.uplink_bytes) for r in hist]
    for r, s, (billed, fp32) in zip(hist, secs, wire):
        print(f"[{tag}] round {r.round}: loss {r.loss:.4f} {s:.3f} s wall "
              f"({r.seconds:.3f} s in the server) uplink {billed:.0f} B"
              + (f" (qint8; fp32 on the same selections {fp32:.0f} B)"
                 if packed else ""))
    print(f"[{tag}] {cfg.name} full width ({n_params:,} fp32 params, "
          f"{n_units} units, {n_units // 2} trained a client), "
          f"{ZOO_CLIENTS} clients x "
          f"{ZOO_STEPS} local steps of 1 x 4,096 tokens, Adam lr {ZOO_LR}: "
          f"built in {build_s:.2f} s; launches {counts} == predicted; "
          f"frozen (client, unit row) deltas exactly zero: {frozen.checked},"
          f" trained rows that moved: {frozen.moved}; peak memory "
          f"{peak / 1e9:.2f} GB ({peak / 2**30:.2f} GiB) of "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB"
          f" on {smi}")
    # one more round under the profiler: the kernels' device time in-run.
    # The fp32 round peaks at 65 of the card's 79 GiB; once, the cached
    # segments the earlier rounds left held 15.6 GiB too fragmented for
    # this round's 1.3 GiB Adam moments: it starts from the live tensors
    torch.cuda.empty_cache()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    _zoo_reset()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fed.fit(1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    run = _in_run(_kernel_events(prof))
    del prof
    run["wall_ms"] = wall * 1e3
    run["busy_share"] = run["busy_ms"] / run["wall_ms"]
    if packed:
        # K2's work in that round: every client's slot rows of every leaf
        # (x and u read as fp32, int8 codes and an fp32 scale a row written)
        deltas = cap.rounds[-1][1]["deltas"]
        n = sum(d.numel() for d in deltas.values())
        rows = sum(d.shape[0] * (d.shape[1] if fed.assign.leaf_units[p]
                                 .kind == "stacked" else 1)
                   for p, d in deltas.items())
        run["K2"]["elements"], run["K2"]["bytes"] = n, 9 * n + 4 * rows
        run["K2"]["alone_ms"], run["K2"]["plain_ms"] = tap.ms, tap.plain_ms
        del deltas
    if not packed:
        _k1_plan_record(fed, run)
    print(f"[{tag}] profiled round: wall {wall:.3f} s, device busy "
          f"{run['busy_ms']:.1f} ms ({run['busy_share']:.1%}), cuBLAS gemm "
          f"{run['gemm_ms']:.1f} ms; in-run device ms: "
          + ", ".join(f"{k} {run[k]['launches']} launches "
                      f"{run[k]['total_ms']:.2f} ms ({run[k]['ms']:.4f} a "
                      f"{'call' if k == 'K6' else 'launch'})"
                      for k in ZOO_KERNELS if run[k]["launches"])
          + (f"; the first round's K2 call alone (L2 flushed) "
             f"{tap.ms:.4f} ms, its plain version {tap.plain_ms:.4f} ms"
             if packed else ""))
    del fed, frozen, cap
    _free_card(tag)
    return counts, run, peak, secs


def _k1_plan_record(fed, run):
    """K1's plan in a zoo round, into ``run["K1"]``: its rows ``T``,
    ``row_unit`` table, ``units`` and ``train`` a client (what
    ``k1_qwen3_plan`` rebuilds it from), and the bounds of the profiled
    round's work (its selection's live planes, and every plane)."""
    from repro_torch.kernels.masked_agg import ops as kops
    from repro_torch.kernels.masked_agg.ref import k1_bytes

    plan = kops.build_agg_plan(fed.assign, fed.params)
    nb = k1_bytes(plan.row_unit, torch.as_tensor(fed.server.sel_history[-1]),
                  plan.tile)
    rate = memory_rate(torch.cuda.get_device_name(0))
    run["K1"].update(T=plan.n_rows, row_unit=plan.row_unit,
                     units=fed.assign.n_units,
                     train=fed.fl.resolve_n_train(fed.assign.n_units),
                     live=nb["live"], bound_ms=nb["live_bytes"] / rate * 1e3,
                     bound_all_ms=nb["all"] / rate * 1e3)
    return run["K1"]


def _k1_in_run_text(k1):
    return (f"live planes {k1['live']:.3f} of {ZOO_CLIENTS} a row, bound of "
            f"the live planes {k1['bound_ms']:.4f} ms (in-run at "
            f"{k1['bound_ms'] / k1['ms']:.1%}), of every plane "
            f"{k1['bound_all_ms']:.4f} ms (at "
            f"{k1['bound_all_ms'] / k1['ms']:.1%})")


def phase_zoo_round(dev, smi):
    return _zoo_rounds(dev, smi, "zoo-round", packed=False)


def phase_zoo_packed(dev, smi):
    return _zoo_rounds(dev, smi, "zoo-packed", packed=True)


def phase_zoo_train_step(dev, smi):
    """gemma3-12b at full width cut to one macro block (6 of 48 layers:
    five local layers of window 1,024 and one global), ``make_train_step``
    at S = 2,048, batch 1, 2 steps: K5/K6 with the window and without."""
    from repro_torch.configs.base import get_config
    from repro_torch.data import lm_batch
    from repro_torch.launch import steps
    from repro_torch.models import get_model
    from repro_torch.optim.masked import adam_init

    full = get_config("gemma3-12b")
    cfg = full.replace(n_layers=full.global_every)
    tag = "zoo-train-step"
    torch.cuda.reset_peak_memory_stats()
    params = get_model(cfg).init_params(torch.Generator(device=dev)
                                        .manual_seed(0))
    n_params = sum(x.numel() for x in params.values())
    opt = adam_init(params)
    step = steps.make_train_step(cfg, lr=ZOO_LR)
    data = lm_batch(3, GEMMA_MACRO_S, cfg.vocab, key=2)
    batches = [{k: torch.as_tensor(v[i:i + 1], device=dev)
                for k, v in data.items()} for i in range(3)]
    # what a step takes as arguments: params, Adam moments, one batch
    arg_bytes = sum(x.nbytes for tree in (params, opt.mu, opt.nu,
                                          batches[0])
                    for x in tree.values())
    _zoo_reset()
    losses, secs = [], []
    for b in batches[:2]:
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, b)
        losses.append(float(loss))
        secs.append(time.perf_counter() - t0)
    counts = _zoo_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {"K1": 0, "K2": 0, "K5": 2 * 2 * cfg.n_layers,
            "K6 dq": 2 * cfg.n_layers, "K6 dkv": 2 * cfg.n_layers}
    check(counts == want, f"{tag}: launches {counts}, predicted {want}")
    check(all(math.isfinite(x) for x in losses), f"{tag}: losses {losses}")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, batches[2])
        float(loss)
        wall = time.perf_counter() - t0
    events = _kernel_events(prof)
    del prof
    run = _in_run(events)
    run["wall_ms"] = wall * 1e3
    run["busy_share"] = run["busy_ms"] / run["wall_ms"]
    # the forward and its recompute launch K5 layer by layer (5 local, then
    # the global one); the backward runs K6 from the global layer down
    fwd = [t for n, t in events if "fwd_kernel" in n]
    dq = [t for n, t in events if "dq_kernel" in n]
    dkv = [t for n, t in events if "dkv_kernel" in n]
    n = cfg.n_layers
    check(len(fwd) == 2 * n and len(dq) == len(dkv) == n,
          f"{tag}: profiled launches fwd {len(fwd)}, dq {len(dq)}, dkv "
          f"{len(dkv)}")
    fwd, dq, dkv = fwd or [0.0] * 2 * n, dq or [0.0] * n, dkv or [0.0] * n
    run["K5 local ms"] = float(np.mean([t for i, t in enumerate(fwd)
                                        if i % n != n - 1])) / 1e3
    run["K5 global ms"] = float(np.mean(fwd[n - 1::n])) / 1e3
    bwd = [a + b for a, b in zip(dq, dkv)]
    run["K6 global ms"] = bwd[0] / 1e3
    run["K6 local ms"] = float(np.mean(bwd[1:])) / 1e3
    print(f"[{tag}] {cfg.name} at full width cut to one macro block "
          f"({cfg.n_layers} of {full.n_layers} layers: window "
          f"{cfg.sliding_window} x{cfg.n_layers - 1}, global x1; "
          f"{n_params:,} params), "
          f"make_train_step at S={GEMMA_MACRO_S}, batch 1, Adam lr {ZOO_LR}:"
          f" losses " + ", ".join(f"{x:.4f}" for x in losses)
          + ", step seconds " + ", ".join(f"{x:.3f}" for x in secs)
          + f"; launches {counts} == predicted; peak memory "
          f"{peak / 1e9:.2f} GB")
    print(f"[{tag}] profiled step: wall {wall:.3f} s, device busy "
          f"{run['busy_share']:.1%}, gemm {run['gemm_ms']:.1f} ms; K5 "
          f"{run['K5 local ms']:.4f} ms a local launch, "
          f"{run['K5 global ms']:.4f} ms a global one; K6 "
          f"{run['K6 local ms']:.4f} / {run['K6 global ms']:.4f} ms a call")
    del params, opt, step, batches
    _free_card(tag)
    return counts, run, peak, secs, arg_bytes


def start_fl_round_dryrun():
    """[dryrun]'s ``fl_round`` record, qwen3-1.7b's 16 clients' local
    steps on ``meta`` (50-75 s of host time), as the CLI in a process of
    its own on no card, started before [attention-kernels] (device-timed
    kernels) so that it is done before [dryrun];
    ``finish_fl_round_dryrun`` waits, and an exit kills it if it still
    runs."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-1.7b", "--shape", "train_4k", "--step", "fl_round",
         "--out", os.path.join(root, "results", "dryrun")],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, CUDA_VISIBLE_DEVICES="",
                            PYTHONPATH=os.path.join(root, "src")))
    atexit.register(_stop, proc)
    return proc


def _stop(proc):
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def phase_dryrun(peak, secs, arg_bytes, smi):
    """[zoo-train-step]'s configuration through the dry run on ``meta``,
    held to that phase's readings; then qwen3-1.7b's records (the
    ``fl_round`` one from ``start_fl_round_dryrun``)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import SHAPES

    tag = "dryrun"
    full = get_config("gemma3-12b")
    cfg = full.replace(n_layers=full.global_every)
    shape = dataclasses.replace(SHAPES["train_4k"], name="train_2k",
                                seq_len=GEMMA_MACRO_S, global_batch=1)
    t0 = time.perf_counter()
    rec = dryrun.run_dryrun(cfg, shape, verbose=False)
    secs_dry = time.perf_counter() - t0
    ma, r = rec["memory_analysis"], rec["roofline"]
    check(ma["argument_size_in_bytes"] == arg_bytes,
          f"{tag}: argument bytes {ma['argument_size_in_bytes']:,.0f} vs the "
          f"card's params, moments and batch {arg_bytes:,}")
    ratio = ma["peak_bytes"] / peak
    check(abs(ratio - 1.0) <= 0.25,
          f"{tag}: predicted peak {ma['peak_bytes'] / 1e9:.2f} GB vs "
          f"measured {peak / 1e9:.2f} GB (ratio {ratio:.3f})")
    bound = r[r["dominant"] + "_s"]
    step = min(secs)
    check(bound <= step,
          f"{tag}: the roofline's {r['dominant']} term {bound:.3f} s is "
          f"above the measured step {step:.3f} s: the count is wrong")
    print(f"[{tag}] {cfg.name} cut to {cfg.n_layers} layers, train at "
          f"S={GEMMA_MACRO_S}, batch 1, on meta in {secs_dry:.1f} s: (a) "
          f"argument bytes {ma['argument_size_in_bytes']:,.0f} == the "
          f"card's {arg_bytes:,}; (b) predicted peak "
          f"{ma['peak_bytes'] / 1e9:.2f} GB vs max_memory_allocated "
          f"{peak / 1e9:.2f} GB, ratio {ratio:.3f}; (c) "
          f"{rec['cost_analysis']['flops_per_device']:.4e} FLOPs "
          f"(attention {rec['cost_analysis']['attention']['flops']:.4e}), "
          f"{rec['cost_analysis']['bytes_per_device']:.4e} B: roofline "
          f"compute {r['compute_s']:.4f} s, memory {r['memory_s']:.4f} s, "
          f"{r['dominant']}-bound {bound:.4f} s <= the fastest measured step "
          f"{step:.4f} s; (d) measured / roofline {step / bound:.3f} "
          f"(H100 fp32 peak, {smi})")
    for shape_name, kw in (("train_4k", {"batch": 1}), ("decode_32k", {})):
        t0 = time.perf_counter()
        rec = dryrun.run_dryrun("qwen3-1.7b", shape_name, verbose=False, **kw)
        ma, r = rec["memory_analysis"], rec["roofline"]
        print(f"[{tag}] qwen3-1.7b x {shape_name} x {rec['step']}"
              f"{' (batch 1)' if kw.get('batch') else ''} --mesh one: "
              f"{rec['cost_analysis']['flops_per_device']:.4e} FLOPs, "
              f"{rec['cost_analysis']['bytes_per_device']:.4e} B, model "
              f"FLOPs {rec['model_flops_global']:.4e} (useful ratio "
              f"{rec['useful_flops_ratio']:.3f}); argument "
              f"{ma['argument_size_in_bytes'] / 1e9:.2f} GB, peak "
              f"{ma['peak_bytes'] / 1e9:.2f} GB, fits 80 GB "
              f"{rec['fits_hbm_80gb']}; roofline compute "
              f"{r['compute_s']:.4f} s, memory {r['memory_s']:.4f} s -> "
              f"{r['dominant']}-bound ({time.perf_counter() - t0:.1f} s on "
              f"meta)")


def finish_fl_round_dryrun(proc):
    """Wait for [dryrun]'s fl_round process and print its record."""
    try:
        out, _ = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    print("\n".join(f"[dryrun] {line}" for line in out.splitlines()))
    check(proc.returncode == 0,
          f"dryrun: the fl_round dry run exited {proc.returncode}")


# the trace level's registered programs, in registry order
ANALYSIS_KERNELS = {"trace:sync/round_step_dense": "K1",
                    "trace:sync/round_step_qint8": "K2",
                    "trace:serve/decode": "K3"}


def phase_analysis():
    """The analysis gate's trace level on the card, in process."""
    from repro_torch.analysis import cli
    from repro_torch.analysis import tracecheck as T

    tag = "analysis"
    root = os.path.dirname(os.path.abspath(__file__))
    report = os.path.join(root, "results", "analysis_torch.json")
    t0 = time.perf_counter()
    rc = cli.main(["--level", "trace", "--device", "cuda", "--report",
                   report])
    check(rc == 0, f"{tag}: the trace level reported findings on the card "
                   f"(see {report})")
    reg = T.traced_programs("cuda")
    secs = time.perf_counter() - t0
    cpu = [p.name for p in T.traced_programs("cpu").programs]
    names = [p.name for p in reg.programs]
    check(names == cpu, f"{tag}: programs on the card {names} vs the CPU's "
                        f"{cpu}")
    launches = {p.name: p.launches for p in reg.programs}
    for prog, k in ANALYSIS_KERNELS.items():
        check(launches[prog][k] > 0,
              f"{tag}: {k} never launched in {prog}: {launches[prog]}")
    print(f"[{tag}] {len(names)} programs on the card, 0 findings, the "
          f"decode under set_sync_debug_mode('error') too, in {secs:.1f} s; "
          f"launches " + ", ".join(
              f"{k} {launches[p][k]} in {p}" for p, k in
              ANALYSIS_KERNELS.items()))
    return {k: {f"analysis {p}": launches[p][k]}
            for p, k in ANALYSIS_KERNELS.items()}


def _zoo_launches(cfg, steps_):
    """The launches ``steps_`` local steps of the zoo round make (2 rounds:
    K1 2), as the code runs them: as in phase 29, K5 per layer in the
    forward and in its remat recompute and K6 once per layer, the
    backward reaching layer 0.  whisper's decoder layer has two
    attentions (causal self, non-causal cross over the frames), and its
    encoder layer one, without remat (the reference checkpoints the
    decoder's blocks only)."""
    dec = 2 if cfg.family == "audio" else 1
    n, n_enc = dec * cfg.n_layers, cfg.n_enc_layers
    return {"K1": 2, "K2": 0, "K5": (2 * n + n_enc) * steps_,
            "K6 dq": (n + n_enc) * steps_, "K6 dkv": (n + n_enc) * steps_}


class _K2Tap:
    """``core.codecs.quantize_pack_group`` (the codec's one grouped K2
    call a round) wrapped for the block: each call's elements and rows
    recorded, and on the first call the codes and scales of every leaf
    whose rows hold ``p`` elements held bitwise to the plain version
    (``ref.quantize_pack_ref``) on the same rows and uniforms, the card's
    peak memory read before that check; with ``timing``, device medians
    (L2 flushed) of the kernel and of the plain version on that call's
    own leaves (the kernel's timing launches not counted)."""

    def __init__(self, p, timing=False):
        self.p, self.calls, self.leaves, self.peak = p, [], [], None
        self.timing, self.ms, self.plain_ms = timing, None, None

    def __enter__(self):
        from repro_torch.core import codecs
        self.real = codecs.quantize_pack_group
        codecs.quantize_pack_group = self
        return self

    def __exit__(self, *exc):
        from repro_torch.core import codecs
        codecs.quantize_pack_group = self.real

    def __call__(self, xs, us, bits):
        from repro_torch.kernels.codec.ref import quantize_pack_ref
        out = self.real(xs, us, bits)
        self.calls.append((sum(x.numel() for x in xs),
                           sum(x.shape[0] for x in xs), len(xs)))
        if self.peak is None:
            self.peak = torch.cuda.max_memory_allocated()
            for x, u, (codes, scale) in zip(xs, us, out):
                if x.shape[1] == self.p:
                    want, want_s = quantize_pack_ref(x, u, bits)
                    self.leaves.append((tuple(x.shape), torch.equal(
                        codes, want) and torch.equal(scale, want_s)))
                    del want, want_s
            if self.timing:
                from repro_torch.kernels.codec import ops as qops
                from repro_torch.kernels.codec.ref import \
                    quantize_pack_group_ref
                n = qops.quantize_pack_group.launches
                self.ms = device_ms(lambda: self.real(xs, us, bits), 5, 1)
                qops.quantize_pack_group.launches = n
                self.plain_ms = device_ms(
                    lambda: quantize_pack_group_ref(xs, us, bits), 5, 1)
        return out


def _zoo_round_arch(dev, smi, arch, n_params, s, tag, repeat=False,
                    layers=None, **fl_kw):
    """The paper's round on ``arch`` at full width (a unit a layer, plus
    embed and head; half trained a client), 2 clients x 2 local steps of
    one ``lm_batch`` sequence of ``s`` tokens, Adam at 2e-3, hub, with
    the pod step's loss keywords (chunked attention, remat per macro
    block): 2 rounds, the second under ``torch.profiler`` with host and
    device events, as ``[zoo-round]`` (profiles of the device's events
    alone lost a round's last kernels on an H100).  The profile must hold
    every kernel launch the counters saw in that round.  With ``repeat``
    the federation is built again from the same seed and run 2 rounds:
    every parameter and selection bitwise equal.  ``layers`` cuts the
    depth (every width as published).  ``fl_kw`` (``packed=True,
    codec="qint8"``) runs the packed round: K2 once a round, no K1, the
    bill the codec's, and on a MoE model the first round's expert slot
    rows (``E·d·ff`` elements) held bitwise to K2's plain version
    (``_K2Tap``)."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.comm import table4_row
    from repro_torch.models import moe
    from repro_torch.models.transformer import vit_width

    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    packed = fl_kw.get("packed", False)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fed = _zoo_fed(dev, cfg, s=s, **fl_kw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    got = sum(x.numel() for x in fed.params.values())
    check(got == n_params, f"{tag}: {got} params, expected {n_params}")
    n_units = cfg.n_layers + cfg.n_enc_layers + 2
    check(fed.assign.n_units == n_units and
          fed.fl.resolve_n_train(n_units) == n_units // 2 and
          (packed or fed.fl.resolve_fused_agg(fed.device)),
          f"{tag}: units {fed.assign.n_units}, fused_agg off")
    frozen, cap = ZooFrozenCheck(fed.assign, fed.fl), Capture(keep=("sel",))
    fed.server.add_hook(frozen).add_hook(cap)
    expert = cfg.moe and cfg.moe.num_experts * cfg.d_model * \
        cfg.moe.expert_d_ff
    _zoo_reset()
    moe.reset_dropped()
    t0 = time.perf_counter()
    with _K2Tap(expert, timing=packed) as tap:
        fed.fit(1)
        torch.cuda.synchronize()
        secs = [time.perf_counter() - t0]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof, tap:
        t0 = time.perf_counter()
        fed.fit(1)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    events = _kernel_events(prof)
    del prof
    parse_s = time.perf_counter() - t0
    counts = _zoo_counts()
    dropped = moe.dropped_copies()
    peak = torch.cuda.max_memory_allocated()
    hist = fed.history
    check(all(math.isfinite(r.loss) for r in hist), f"{tag}: non-finite loss")
    want = _zoo_launches(cfg, 2 * ZOO_CLIENTS * ZOO_STEPS)
    if packed:
        want.update(K1=0, K2=2)
    check(counts == want, f"{tag}: launches {counts}, predicted {want}")
    check(frozen.checked > 0 and frozen.moved > 0,
          f"{tag}: frozen {frozen.checked}, moved {frozen.moved}")
    check(len(tap.calls) == counts["K2"], f"{tag}: {len(tap.calls)} "
          f"grouped codec calls, K2 launched {counts['K2']} times")
    if packed:
        wire = _check_wire_bytes(fed, cap, tag)
        check(len(tap.leaves) == (3 if expert else 0) and
              all(same for _, same in tap.leaves),
              f"{tag}: expert slot rows vs K2's plain version {tap.leaves}")
    else:
        summ = fed.comm_summary()
        t4 = table4_row(fed.assign, {p: x.to("meta") for p, x in
                                     fed.params.items()},
                        np.stack(fed.server.sel_history))
        check(all(summ[k] == v for k, v in t4.items()),
              f"{tag}: comm_summary {summ} != table4_row {t4}")
    cap.rounds.clear()
    run = _in_run(events)
    run["wall_ms"] = secs[1] * 1e3
    run["busy_share"] = run["busy_ms"] / run["wall_ms"]
    # the profiled round's half of the counted launches
    profiled = {k: run[k]["launches"] for k in ZOO_KERNELS}
    half = {"K1": want["K1"] // 2, "K2": want["K2"] // 2,
            "K5": want["K5"] // 2,
            "K6": (want["K6 dq"] + want["K6 dkv"]) // 2}
    check(profiled == half, f"{tag}: the profile holds {profiled} kernel "
          f"events, the counters saw {half} launches in that round (the "
          f"profile's last kernels: {[nm[:60] for nm, _ in events[-8:]]})")
    k1 = _k1_plan_record(fed, run)
    rate = memory_rate(torch.cuda.get_device_name(0))
    if packed:
        # K2's work in the profiled round: the slot rows of every leaf (x
        # and u read as fp32, int8 codes and an fp32 scale a row written)
        n, rows, _ = tap.calls[-1]
        run["K2"].update(elements=n, rows=rows, bytes=9 * n + 4 * rows,
                         bound_ms=(9 * n + 4 * rows) / rate * 1e3,
                         alone_ms=tap.ms, plain_ms=tap.plain_ms)
    fwd = [t for nm, t in events if "fwd_kernel" in nm]
    bwd = [a + b for a, b in zip([t for nm, t in events if "dq_kernel" in nm],
                                 [t for nm, t in events
                                  if "dkv_kernel" in nm])]
    split = ""
    if cfg.global_every:
        # the profiled round's half of the launches: K5 in blocks of one
        # macro block's sub-layers (the forward, then each recompute), the
        # global sub-layer last; K6 per macro block from the global
        # sub-layer down
        macro = cfg.global_every
        for kind, ts, glob in (("K5", fwd, macro - 1), ("K6", bwd, 0)):
            for where, pick in (("global", lambda i: i % macro == glob),
                                ("local", lambda i: i % macro != glob)):
                sel_ = [t for i, t in enumerate(ts) if pick(i)]
                run[f"{kind} {where} ms"] = float(np.mean(sel_)) / 1e3
        split = (f"; K5 local {run['K5 local ms']:.4f} / global "
                 f"{run['K5 global ms']:.4f} ms a launch, K6 local "
                 f"{run['K6 local ms']:.4f} / global "
                 f"{run['K6 global ms']:.4f} ms a call")
    if cfg.family == "audio":
        # a local step's K5 launches: the encoder's layers, then per
        # decoder layer self and cross, then their remat recomputes; its
        # K6 calls: per decoder layer (last first) cross and self, then
        # the encoder's layers
        n_enc, n_dec = cfg.n_enc_layers, cfg.n_layers
        k5_kind = ["enc"] * n_enc + ["self", "cross"] * (2 * n_dec)
        for kind, ts, order in (("K5", fwd, k5_kind),
                                ("K6", bwd, _k6_kinds(cfg))):
            for where in ("enc", "self", "cross"):
                sel_ = [t for i, t in enumerate(ts)
                        if order[i % len(order)] == where]
                run[f"{kind} {where} ms"] = float(np.mean(sel_)) / 1e3
        split = "; " + ", ".join(
            f"{kind} {where} {run[f'{kind} {where} ms']:.4f}"
            for kind in ("K5", "K6") for where in ("enc", "self", "cross")) \
            + (" ms a launch (K5) / call (K6): encoder 1,500 frames "
               f"non-causal, decoder self causal at {s:,}, cross {s:,} over "
               "1,500 frames")
    for i, (r, sec) in enumerate(zip(hist, secs)):
        print(f"[{tag}] round {r.round}: loss {r.loss:.4f} {sec:.3f} s wall "
              f"({r.seconds:.3f} s in the server) uplink "
              f"{r.uplink_bytes:.0f} B"
              + (f" ({fl_kw['codec']} = claimed = encoded; fp32 on the same "
                 f"selections {wire[i][1]:.0f} B)" if packed else ""))
    print(f"[{tag}] {cfg.name} full width"
          + (f" cut to {cfg.n_layers} layers" if layers else "")
          + f" ({got:,} fp32 params, "
          f"{n_units} units, {n_units // 2} trained a client), "
          + (f"{cfg.enc_seq:,} frames a sequence, " if cfg.n_enc_layers
             else "")
          + (f"{cfg.n_patches:,} patches of {vit_width(cfg):,} before "
             f"the text ({cfg.n_patches + s:,} positions), "
             if cfg.n_patches else "")
          + f"{ZOO_CLIENTS} clients x {ZOO_STEPS} local steps of 1 x "
          f"{s:,} tokens, Adam lr {ZOO_LR}: built in {build_s:.2f} s;"
          f" launches {counts} == predicted; frozen (client, unit row) "
          f"deltas exactly zero: {frozen.checked}, trained rows that moved: "
          f"{frozen.moved}; bill == "
          + (f"the codec's (rows x (P + 4) bytes of the selected units)"
             if packed else "Table 4")
          + f"; peak memory {peak / 1e9:.2f} "
          f"GB ({peak / 2**30:.2f} GiB, {peak / got:.1f} B a param) on "
          f"{smi}"
          + (f"; token copies dropped at capacity in the 2 rounds (forward "
             f"and remat recompute): {dropped}" if cfg.moe is not None
             else ""))
    print(f"[{tag}] profiled round: wall {secs[1]:.3f} s, device busy "
          f"{run['busy_ms']:.1f} ms ({run['busy_share']:.1%}), "
          f"{len(events):,} device kernels ({len(events) / secs[1]:,.0f} a "
          f"second; the profile parsed in {parse_s:.1f} s), cuBLAS gemm "
          f"{run['gemm_ms']:.1f} ms; in-run device ms: "
          + ", ".join(f"{k} {run[k]['launches']} launches "
                      f"{run[k]['total_ms']:.2f} ms ({run[k]['ms']:.4f} a "
                      f"{'call' if k == 'K6' else 'launch'})"
                      for k in ZOO_KERNELS if run[k]["launches"])
          + split + (
              f"; K2 over {run['K2']['elements']:,} slot elements in "
              f"{run['K2']['rows']:,} rows: bound "
              f"{run['K2']['bound_ms']:.4f} ms ({run['K2']['bytes'] / 1e9:.2f}"
              f" GB), in-run at "
              f"{run['K2']['bound_ms'] / max(run['K2']['ms'], 1e-9):.1%} of "
              f"it; the first round's call alone (L2 flushed) "
              f"{tap.ms:.4f} ms, its plain version {tap.plain_ms:.4f} ms"
              if packed else
              f"; K1 at the plan's T={k1['T']} C={ZOO_CLIENTS}: "
              f"{_k1_in_run_text(k1)}"))
    if expert and packed:
        print(f"[{tag}] the first round's grouped K2 call ({tap.calls[0][2]} "
              f"leaves, {tap.calls[0][0]:,} elements; peak memory before the "
              f"check {tap.peak / 1e9:.2f} GB): the codes and scales of the "
              f"expert slot rows " + ", ".join(
                  f"{r:,} x {c:,}" for (r, c), _ in tap.leaves)
              + " bitwise equal to K2's plain version "
              f"(ref.quantize_pack_ref) on the same rows and uniforms")
    if repeat:
        first = {p: x.cpu() for p, x in fed.params.items()}
        sels = [np.array(x) for x in fed.server.sel_history]
        losses = [r.loss for r in hist]
        del fed, frozen, events
        _free_card(tag)
        t0 = time.perf_counter()
        fed = _zoo_fed(dev, cfg, s=s, **fl_kw)
        fed.fit(2)
        torch.cuda.synchronize()
        again = time.perf_counter() - t0
        check([r.loss for r in fed.history] == losses and
              all(np.array_equal(a, b) for a, b in
                  zip(fed.server.sel_history, sels)),
              f"{tag}: the rebuilt run's losses or selections differ")
        same = [p for p, x in fed.params.items()
                if not torch.equal(x.cpu(), first[p])]
        check(not same, f"{tag}: rebuilt from the same seed, {len(same)} "
              f"leaves differ after 2 rounds, e.g. {same[:3]}")
        print(f"[{tag}] built again from the same seed, 2 rounds in "
              f"{again:.1f} s: losses, selections and all {len(first)} "
              f"leaves bitwise equal")
        del first
    del fed
    _free_card(tag)
    return counts, run, peak, secs


HYMBA_S = 2048                    # past the window: local != global work
# the round's depth, cut from 32 to keep the smoke within its time: the
# SSM scan's state loop made 309,000 kernels a round at 32 layers (58 s a
# phase, 16 s of it the profile's parse)
HYMBA_ROUND_LAYERS, HYMBA_ROUND_PARAMS = 16, 789_711_200


def phase_zoo_round_hymba(dev, smi):
    """hymba-1.5b at full width cut to 16 of 32 layers, 2 macro blocks
    (18 units: embed, layer0-15, head; 9 trained a client) at S = 2,048:
    the windowed and the global layers' K5/K6 apart (the SSM scan's state
    loop launches ~10^5 kernels a round)."""
    return _zoo_round_arch(dev, smi, HYMBA_ARCH, HYMBA_ROUND_PARAMS,
                           HYMBA_S, "zoo-round-hymba",
                           layers=HYMBA_ROUND_LAYERS)


def phase_zoo_round_moe(dev, smi):
    """granite-moe-1b-a400m at full width cut to 12 of its 24 layers (14
    units: embed, layer0-11, head, the head unit ``final_norm`` alone as
    the embeddings are tied; 7 trained a client) at ``train_4k``'s S =
    4,096, built twice from one seed."""
    return _zoo_round_arch(dev, smi, MOE_ARCH, MOE_ROUND_PARAMS, TRAIN_S,
                           "zoo-round-moe", repeat=True,
                           layers=MOE_ROUND_LAYERS)


def phase_zoo_packed_moe(dev, smi):
    """The MoE round packed: ``[zoo-round-moe]``'s setup with
    ``packed=True, codec="qint8"``: one grouped K2 launch a round over
    every leaf's slot rows (the expert leaves' rows of E·d·ff = 16,777,216
    elements take K2's two-visit route), no K1; the first round's expert
    slot rows bitwise K2's plain version; the bill the codec's; rebuilt
    from one seed and held bitwise.  12 of 24 layers, as
    ``[zoo-round-moe]``."""
    return _zoo_round_arch(dev, smi, MOE_ARCH, MOE_ROUND_PARAMS, TRAIN_S,
                           "zoo-packed-moe", repeat=True, packed=True,
                           codec="qint8", layers=MOE_ROUND_LAYERS)


def phase_zoo_parity_moe(dev):
    """granite-moe-1b-a400m at full width cut to 2 layers, S = 544 (the
    chunked route), decisive routing: card against the host CPU."""
    from repro_torch.configs.base import get_config
    phase_zoo_parity(dev, get_config(MOE_ARCH).replace(n_layers=2),
                     s=ZOO_PARITY_S, tag="zoo-parity-moe")


def phase_zoo_parity_hymba(dev):
    """hymba-1.5b at full width cut to 2 layers (one macro block: a
    windowed sub-layer, window cut to 256, and a global one), S = 544:
    both K5/K6 routes, card against the host CPU."""
    from repro_torch.configs.base import get_config
    cfg = get_config(HYMBA_ARCH).replace(n_layers=2, global_every=2,
                                         sliding_window=256)
    phase_zoo_parity(dev, cfg, s=ZOO_PARITY_S, tag="zoo-parity-hymba")


def phase_zoo_round_whisper(dev, smi):
    """whisper-medium (50 units: embed, enc0-23, layer0-23, head; 25
    trained a client) at ``train_4k``'s 4,096 decoder tokens over 1,500
    frames: K5/K6 on the encoder (non-causal, padded keys), the decoder's
    causal self-attention and its cross-attention (4,096 over 1,500),
    built twice from one seed."""
    return _zoo_round_arch(dev, smi, WHISPER_ARCH, WHISPER_PARAMS, TRAIN_S,
                           "zoo-round-whisper", repeat=True)


def phase_zoo_parity_whisper(dev):
    """whisper-medium at full width cut to 2 encoder and 2 decoder layers,
    1,500 frames, S = 544: the padded non-causal route (encoder, cross)
    and the causal one on the card against the host CPU."""
    from repro_torch.configs.base import get_config
    phase_zoo_parity(dev, get_config(WHISPER_ARCH).replace(
        n_layers=2, n_enc_layers=2), s=ZOO_PARITY_S,
        tag="zoo-parity-whisper", lr=WHISPER_PARITY_LR)


def phase_zoo_parity_stablelm(dev):
    """stablelm-3b at full width cut to 2 layers, S = 544: K5/K6 at head
    dim 80 on the card against the host CPU."""
    from repro_torch.configs.base import get_config
    phase_zoo_parity(dev, get_config(STABLELM_ARCH).replace(n_layers=2),
                     s=ZOO_PARITY_S, tag="zoo-parity-stablelm")


def phase_zoo_round_vlm(dev, smi):
    """internvl2-26b at full width cut to 2 layers (4 units: embed with
    the projector, layer0, layer1, head; 2 trained a client) at
    ``train_4k``'s 4,096 text tokens after 1,024 patches (5,120
    positions): K5/K6 at 48 heads over 8 of 128, K1 on the hub
    aggregate, built twice from one seed."""
    return _zoo_round_arch(dev, smi, VLM_ARCH, VLM_ROUND_PARAMS, TRAIN_S,
                           "zoo-round-vlm", repeat=True,
                           layers=VLM_ROUND_LAYERS)


def phase_zoo_parity_vlm(dev):
    """internvl2-26b at full width cut to 1 layer and to 416 patches
    (the config's 1,024 cut, as a length: the host CPU's side of 1,152
    positions took 59-71 s) and 128 text tokens (544 positions: past 512,
    the chunked route, K5/K6 on the card), one client training every
    unit, the projector included (with two clients the host CPU's side
    took 37-75 s): card against the host CPU.  With every unit selected,
    K1's per-unit masking at internvl2-26b's plan is checked on the card
    only by ``[k1-zoo-plans]``."""
    from repro_torch.configs.base import get_config
    phase_zoo_parity(dev, get_config(VLM_ARCH).replace(
        n_layers=1, n_patches=VLM_PARITY_PATCHES), s=VLM_PARITY_S,
        tag="zoo-parity-vlm", clients=1)


# -- the zoo round in bf16: K1's bf16 instance, K5/K6 bf16 trained through --

BF16 = torch.bfloat16
BF16_CLIENTS = 4                  # launch/train.py's default cohort
# [zoo-round-whisper-bf16]'s counted rounds, cut from 2 for the smoke's
# time (a profiled round follows, and the rebuild holds the first)
WHISPER_BF16_ROUNDS = 1
# the torch.bmm yardstick in bf16 rounds its numerator, its quotient and
# its sum (a bf16 step, 2^-8, of each's own size): it is held to the plain
# version within 2^-6 of |out| + |update| at every element
BF16_LIB_TOL = 2.0 ** -6


class _K1Tap:
    """``ops.tile_source`` and ``ops.masked_agg`` wrapped for the block:
    for each aggregate, whether the global tiles were read in place (the
    buffer ``tile_source`` found) and the dtypes of the global tiles and
    the client planes; with ``keep`` set, the call's inputs are kept (K1
    alone at the round's own planes; set it for the last round only, so
    that no round holds another's planes).  The wrapper counts its
    launches on the name ``masked_agg``, which is the tap in the block:
    ``launches`` passes them on to it."""

    def __init__(self):
        self.calls, self.keep, self.last = [], False, None

    def __enter__(self):
        from repro_torch.kernels.masked_agg import ops
        self.ops, self.real = ops, (ops.tile_source, ops.masked_agg)
        ops.tile_source, ops.masked_agg = self._source, self
        return self

    @property
    def launches(self):
        return self.real[1].launches

    @launches.setter
    def launches(self, n):
        self.real[1].launches = n

    def __exit__(self, *exc):
        self.ops.tile_source, self.ops.masked_agg = self.real

    def _source(self, plan, tree):
        found = self.real[0](plan, tree)
        self.calls.append({"in_place": found is not None})
        return found

    def __call__(self, g_t, d_t, *rest):
        self.calls[-1].update(global_dtype=g_t.dtype, planes_dtype=d_t.dtype)
        if self.keep:
            self.last = (g_t, d_t) + rest
        return self.real[1](g_t, d_t, *rest)


class _Bf16Params:
    """Server hook: every global param bf16 after each round."""

    def __init__(self):
        self.rounds = 0

    def on_round_start(self, server, round_idx, weights):
        return None

    def on_round_end(self, server, record, metrics):
        bad = [p for p, x in server.params.items() if x.dtype != BF16]
        check(not bad, f"round {record.round}: {len(bad)} params left bf16, "
              f"e.g. {bad[:3]}")
        self.rounds += 1

    def on_fit_end(self, server, history):
        pass


def _grad_dist(got, want):
    """The largest, over leaves, of ``||got - want|| / ||want||`` in fp32."""
    return max(float((got[p].float() - w.float()).norm() / w.float().norm())
               for p, w in want.items())


def _attn_calls(cfg):
    """Attention calls in one forward: a layer's one, whisper's decoder
    layer's two (causal self, cross over the frames) and its encoder
    layers'."""
    return (2 if cfg.family == "audio" else 1) * cfg.n_layers + \
        cfg.n_enc_layers


def _k6_kinds(cfg):
    """Each K6 call's attention, in a whisper step's backward order: per
    decoder layer, last first, cross and self, then the encoder's."""
    return ["cross", "self"] * cfg.n_layers + ["enc"] * cfg.n_enc_layers


def _bf16_step_bars(fed, cfg, tag):
    """(d): one local step at full width on the round's first client
    batch with the round's loss keywords, from the round's initial
    params: loss and every gradient.  (d1) the step on K5/K6 bf16
    against the same step on the plain attention in bf16, within
    BAR_FACTOR x the distance of the step whose attention runs in fp32
    (q, k, v cast up, the output cast down) from it, each distance the
    largest over leaves of ||g - g_plain|| / ||g_plain||; (d2) in the K5/K6
    step every layer's K6 dq, dk, dv against the plain backward that
    rounds where the kernel rounds (``ref.rounding_error_ratio``, bar 1),
    read at ``ops.attention_bwd``, the kernels' own autograd call; (d3)
    the planted fault, layer 0's key tile 0 left out of every later query
    tile (forward and remat recompute; for (d2) each layer's K6 launched
    on the rows and keys from FAULT_TILE on), outside both bars.  On
    whisper every attention call counts as a layer (``_attn_calls``):
    layer 0 is the encoder's first, which has no remat recompute; a
    padded non-causal call's ``kv_len`` moves with its keys; (d2)'s fault
    must pass the bar in every output of a causal layer and in the
    largest output of a non-causal one."""
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, rounding_error_ratio)
    from repro_torch.launch import steps
    from repro_torch.models import get_model

    model, kw = get_model(cfg), steps.default_loss_kwargs(cfg)
    first = fed.loader.client_batches(0, [0])
    batch = {k: torch.as_tensor(v[0, 0], device=fed.device)
             for k, v in first.items()}
    params, n = fed.params, _attn_calls(cfg)

    def step(swap=None, **over):
        leaves = {p: x.detach().requires_grad_(True)
                  for p, x in params.items()}
        ctx = _attention_swap(swap, remat_layers=n) if swap \
            else contextlib.nullcontext()
        with ctx:
            loss, _ = model.loss_fn(leaves, batch, **dict(kw, **over))
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return float(loss.detach()), dict(zip(leaves, grads))

    record, real_bwd = [], aops.attention_bwd

    def checked(q, k, v, o, lse, do, *, causal=True, window=0, kv_len=None):
        out = real_bwd(q, k, v, o, lse, do, causal=causal, window=window,
                       kv_len=kv_len)
        want = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window, round_to=BF16,
                                       kv_len=kv_len)
        t = FAULT_TILE
        kv_t = None if kv_len is None else kv_len - t
        o_t, lse_t = aops.attention_fwd(q[:, t:], k[:, t:], v[:, t:],
                                        causal=causal, window=window,
                                        kv_len=kv_t)
        late = real_bwd(q[:, t:], k[:, t:], v[:, t:], o_t, lse_t,
                        do[:, t:].contiguous(), causal=causal, window=window,
                        kv_len=kv_t)
        planted = []
        for x, y in zip(out, late):
            x = x.clone()
            x[:, t:] = y
            planted.append(x)
        record.append(([rounding_error_ratio(x, y) for x, y in zip(out, want)],
                       [rounding_error_ratio(x, y)
                        for x, y in zip(planted, want)], causal))
        del want, late, planted
        return out

    t0 = time.perf_counter()
    plain_loss, plain = step(attn_impl="reference")
    aops.attention_bwd = checked
    try:
        kern_loss, grads = step()
    finally:
        aops.attention_bwd = real_bwd
    dist, losses = {"kernel": _grad_dist(grads, plain)}, {"kernel": kern_loss}
    check(all(g.dtype == BF16 for g in grads.values()),
          f"{tag} (d) gradients not bf16")
    del grads
    for kind in ("fp32", "fault"):
        losses[kind], grads = step(kind)
        dist[kind] = _grad_dist(grads, plain)
        del grads
    secs = time.perf_counter() - t0
    del plain
    bar = BAR_FACTOR * dist["fp32"]
    ratios = np.array([r for r, _, _ in record])          # (layers, 3)
    planted = np.array([p for _, p, _ in record])
    # the fault must show in each layer's K6 outputs: in all three on a
    # causal layer; on a non-causal one (whisper's encoder and cross over
    # 1,500 near-uniformly attended frames) the dK/dV rows that lose only
    # the first 128 queries' share move less than the rounding bar, so
    # there in the largest of the three
    seen = np.where(np.array([c for _, _, c in record]), planted.min(1),
                    planted.max(1))
    print(f"{tag} (d1) one local step at full width in bf16, the round's "
          f"first client batch (1 x {TRAIN_S:,} tokens"
          + (f" over {cfg.enc_seq:,} frames" if cfg.n_enc_layers else "")
          + f", loss keywords "
          f"{kw}), from the round's initial params: loss on K5/K6 "
          f"{kern_loss:.6f}, on the plain attention {plain_loss:.6f}, with "
          f"the attention in fp32 {losses['fp32']:.6f}, planted fault "
          f"{losses['fault']:.6f}; largest ||g - g_plain|| / ||g_plain|| "
          f"over the {len(params)} leaves: K5/K6 {dist['kernel']:.4e}, the "
          f"attention in fp32 {dist['fp32']:.4e}; bar {BAR_FACTOR:g} x the "
          f"latter = {bar:.4e}; planted fault {dist['fault']:.4e} "
          f"({dist['fault'] / bar:.1f}x the bar); 4 steps in {secs:.1f} s")
    by_kind = ""
    if cfg.family == "audio" and len(record) == n:
        kinds = np.array(_k6_kinds(cfg))
        by_kind = "; by attention, largest of dq / dk / dv: " + ", ".join(
            f"{where} " + " / ".join(f"{x:.4f}" for x in
                                     ratios[kinds == where].max(0))
            for where in ("enc", "self", "cross")) + \
            "; the planted fault's least dq / dk / dv: " + ", ".join(
                f"{where} " + " / ".join(f"{x:.1f}" for x in
                                         planted[kinds == where].min(0))
                for where in ("enc", "self", "cross"))
    print(f"{tag} (d2) K6 in each of the {len(record)} layers' backward vs "
          f"the plain backward that rounds where it rounds "
          f"(ref.rounding_error_ratio, bar 1): largest dq "
          f"{ratios[:, 0].max():.4f}, "
          f"dk {ratios[:, 1].max():.4f}, dv {ratios[:, 2].max():.4f} (layer "
          f"order of the backward: last first){by_kind}; the planted "
          f"fault's outputs at the least {planted.min():.1f}, each layer's "
          f"(causal: its least output; non-causal: its largest) at the "
          f"least {seen.min():.1f}")
    check(0 < dist["kernel"] <= bar, f"{tag} (d1) the K5/K6 step lies "
          f"{dist['kernel']} from the plain step, outside {bar}")
    check(dist["fault"] > bar, f"{tag} (d1) the planted fault passes the "
          f"bar ({dist['fault']} <= {bar})")
    check(len(record) == n and ratios.max() <= 1.0,
          f"{tag} (d2) {len(record)} K6 calls, ratios {ratios.max(0)}")
    check(seen.min() > 1.0, f"{tag} (d2) a planted fault passes the bar in a "
          f"layer ({seen.min()})")
    return {"d1": dict(dist, bar=bar, losses=dict(losses, plain=plain_loss)),
            "d2": {"largest": float(ratios.max()),
                   "planted_least": float(planted.min()),
                   "planted_seen_least": float(seen.min())}}


def _k1_bf16_alone(k1_in, plan, smi, tag):
    """(c): K1's bf16 instance alone on the round's own planes (the last
    aggregate's global tiles, client planes, selection, weights and row
    table; the padding past each segment, never set by a round, zeroed
    first, so that whole outputs compare): agreeing with its plain
    version at every element by ``ref.bf16_agrees`` (one bf16 step, or
    the fp32 sums' own rounding where the update cancels the global
    value), two launches bitwise equal, an unselected NaN skipped bitwise
    (``ops.check_kernel``); the fp32 instance on the same tiles cast up,
    its output rounded once bitwise the bf16 call's; device medians, L2
    flushed, of the kernel, the fp32 instance on the cast-up tiles (what
    the dtype saves), the plain version and ``torch.bmm`` + the guard in
    bf16 (the library yardstick, held to the plain version within
    BF16_LIB_TOL), beside both byte bounds in bf16 and the live bound in
    fp32."""
    from repro_torch.kernels.masked_agg import ops
    from repro_torch.kernels.masked_agg.ref import k1_bytes, masked_agg_ref

    g_t, d_t, sel, w, ru = k1_in
    t, tile = g_t.shape
    c = d_t.shape[0]
    for seg in plan.segments:
        g_t[seg.row + seg.n_tiles - 1, seg.n - (seg.n_tiles - 1) * tile:] = 0
        d_t[:, seg.row + seg.n_tiles - 1,
            seg.n - (seg.n_tiles - 1) * tile:] = 0
    try:
        res = ops.check_kernel(k1_in, TOL)
    except RuntimeError as e:
        raise RuntimeError(f"chip_smoke: {tag} (c) {e}") from e
    out = ops.masked_agg(*k1_in)
    g32, d32 = g_t.float(), d_t.float()
    same = torch.equal(ops.masked_agg(g32, d32, sel, w, ru).to(BF16), out)
    check(same, f"{tag} (c) the fp32 instance on the tiles cast up, "
          f"rounded once, differs from the bf16 call")
    fp32_ms = device_ms(lambda: ops.masked_agg(g32, d32, sel, w, ru), 10)
    del g32, d32
    torch.cuda.empty_cache()
    ms = device_ms(lambda: ops.masked_agg(*k1_in), 10)
    plain_ms = device_ms(lambda: masked_agg_ref(*k1_in), 3, 1)
    w_t = (sel[:, ru.long()] * w[:, None]).t().contiguous().to(BF16)
    d_tct = d_t.permute(1, 0, 2).contiguous()            # (T, C, tile)

    def library():
        num = torch.bmm(w_t.unsqueeze(1), d_tct).squeeze(1)
        den = w_t.sum(1, keepdim=True)
        return g_t + torch.where(den > 0, num / den.clamp_min(1e-9),
                                 torch.zeros_like(num))

    lib, lib_ratio = library(), 0.0
    for a in range(0, t, ops.CHECK_ROWS):
        b = min(a + ops.CHECK_ROWS, t)
        want = masked_agg_ref(g_t[a:b], d_t[:, a:b], sel, w, ru[a:b]).float()
        bar = BF16_LIB_TOL * (want.abs() + (want - g_t[a:b].float()).abs())
        err = (lib[a:b].float() - want).abs()
        lib_ratio = max(lib_ratio, float((err / bar.clamp_min(1e-30))
                                         .max()))
    del lib, want, bar, err
    check(lib_ratio <= 1.0, f"{tag} (c) the torch.bmm yardstick lies "
          f"{lib_ratio:.2f}x its bar from the plain version")
    library_ms = device_ms(library, 10)
    del w_t, d_tct
    rate = memory_rate(torch.cuda.get_device_name(0))
    ru_np = ru.cpu().numpy()
    nb, nb32 = k1_bytes(ru_np, sel, tile, 2), k1_bytes(ru_np, sel, tile, 4)
    bound, bound_all = nb["live_bytes"] / rate * 1e3, nb["all"] / rate * 1e3
    bound32 = nb32["live_bytes"] / rate * 1e3
    nan = res["nan_at"]
    print(f"{tag} (c) K1 bf16 (masked_agg_bf16) alone on the round's own "
          f"planes, T={t} C={c} tile {tile}: within one bf16 step of its "
          f"plain version at every element, or fp32 rounding where the "
          f"update cancels the global value (max abs err "
          f"{res['max_abs_err']:.3e}), two launches bitwise equal, "
          + (f"a NaN in client {nan[0]}'s unselected row {nan[1]} skipped "
             f"bitwise" if nan else "every plane live (no NaN planted)")
          + f"; the fp32 instance on the tiles cast up, rounded once, "
          f"bitwise the bf16 call; torch.bmm + guard in bf16 at "
          f"{lib_ratio:.3f} of its bar; live planes {nb['live']:.3f} of {c} "
          f"a row; device median ms (L2 flushed): kernel {ms:.4f}, fp32 "
          f"instance on the tiles cast up {fp32_ms:.4f} (its live bound "
          f"{bound32:.4f}), plain {plain_ms:.4f}, torch.bmm + guard "
          f"{library_ms:.4f}; bf16 bound of the live planes {bound:.4f} "
          f"({nb['live_bytes'] / 1e9:.2f} GB; kernel at {bound / ms:.1%}), "
          f"of every plane {bound_all:.4f} ({nb['all'] / 1e9:.2f} GB; at "
          f"{bound_all / ms:.1%}) on {smi}")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "fp32_cast_up_ms": fp32_ms, "max_abs_err": res["max_abs_err"],
            "bound_ms": bound, "bound_all_planes_ms": bound_all,
            "fp32_bound_ms": bound32, "live_planes": nb["live"], "T": t,
            "C": c}


def _whisper_attn_split(cfg, events, run, name):
    """A whisper round's profiled K5 launches and K6 calls by attention
    (encoder, decoder self, cross; as [zoo-round-whisper] splits its fp32
    round) into ``run["K5 enc"]`` ...: in-run ms, launches and the bf16
    bound at 989 TFLOP/s on the real (unpadded) shapes; and, after the
    round's launches are counted, each
    kernel alone on random bf16 inputs of that shape (padded as the
    model pads them; device medians, L2 flushed) beside one SDPA call's
    forward or backward (cuDNN's, on the unpadded inputs); returns the
    text printed."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.models.attention import FLASH_BLOCK
    n_enc, n_dec, h, hd = (cfg.n_enc_layers, cfg.n_layers, cfg.n_heads,
                           cfg.head_dim)
    shapes = {"enc": (cfg.enc_seq, cfg.enc_seq, False),
              "self": (TRAIN_S, TRAIN_S, True),
              "cross": (TRAIN_S, cfg.enc_seq, False)}
    fwd = [t for nm, t in events if "fwd_kernel" in nm]
    bwd = [a + b for a, b in zip([t for nm, t in events if "dq_kernel" in nm],
                                 [t for nm, t in events
                                  if "dkv_kernel" in nm])]
    k5_kind = ["enc"] * n_enc + ["self", "cross"] * (2 * n_dec)
    for kind, ts, order, part in (("K5", fwd, k5_kind, "fwd"),
                                  ("K6", bwd, _k6_kinds(cfg), "bwd")):
        for where, (sq, sk, causal) in shapes.items():
            sel_ = [t for i, t in enumerate(ts)
                    if order[i % len(order)] == where]
            bnd = _attn_bound(name, 1, sq, h, h, hd, 0, esz=2,
                              peak=BF16_PEAK, sk=sk, causal=causal)
            run[f"{kind} {where}"] = {
                "in_run_ms": float(np.mean(sel_)) / 1e3,
                "launches": len(sel_), "bound_ms": bnd[part][0],
                "bound_by": bnd[part][1]}
    gen = torch.Generator(device="cuda").manual_seed(11)
    for where, (sq, sk, causal) in shapes.items():
        q, g = (torch.randn(1, sq, h, hd, generator=gen, device="cuda")
                .to(BF16) for _ in range(2))
        k, v = (torch.randn(1, sk, h, hd, generator=gen, device="cuda")
                .to(BF16) for _ in range(2))
        pad = [F.pad(x, (0, 0, 0, 0, 0, -x.shape[1] % FLASH_BLOCK))
               for x in (q, k, v, g)]
        kw = dict(causal=causal, kv_len=None if causal else sk)
        o, lse = aops.attention_fwd(*pad[:3], **kw)
        qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
        lib_o = F.scaled_dot_product_attention(
            qs.transpose(1, 2), ks.transpose(1, 2), vs.transpose(1, 2),
            is_causal=causal)
        gt = g.transpose(1, 2)
        run[f"K5 {where}"].update(
            ms=device_ms(lambda: aops.attention_fwd(*pad[:3], **kw), 10),
            library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal), 10))
        run[f"K6 {where}"].update(
            ms=device_ms(lambda: aops.attention_bwd(
                *pad[:3], o, lse, pad[3], **kw), 10),
            library_ms=device_ms(lambda: torch.autograd.grad(
                lib_o, (qs, ks, vs), gt, retain_graph=True), 10))
        del q, k, v, g, pad, o, lse, qs, ks, vs, lib_o, gt
    return ("; by attention, a launch (K5) / call (K6) in-run beside its "
            "bound at 989 TFLOP/s, then alone and one SDPA call (bf16, "
            "cuDNN) on random inputs of its shape: " + ", ".join(
                f"{kind} {where} {r['in_run_ms']:.4f} (bound "
                f"{r['bound_ms']:.4f}, at {r['bound_ms'] / r['in_run_ms']:.1%};"
                f" alone {r['ms']:.4f}, SDPA {r['library_ms']:.4f})"
                for kind in ("K5", "K6") for where in shapes
                for r in (run[f"{kind} {where}"],))
            + f" (encoder {cfg.enc_seq:,} frames non-causal, decoder self "
            f"causal at {TRAIN_S:,}, cross {TRAIN_S:,} over "
            f"{cfg.enc_seq:,} frames)")


def phase_zoo_round_bf16(dev, smi, fp32_round):
    """qwen3-1.7b at full width in bf16 (cell 37) as ``_zoo_round_bf16``,
    with BF16_CLIENTS (4, the launcher's default) clients over 2 counted
    rounds: K1 2, K5 896, K6 448 + 448."""
    return _zoo_round_bf16(dev, smi, fp32_round, "[zoo-round-bf16]",
                           ZOO_ARCH, ZOO_PARAMS, BF16_CLIENTS, ZOO_ROUNDS,
                           "[zoo-round]")


def phase_zoo_round_whisper_bf16(dev, smi, fp32_round):
    """whisper-medium at full width in bf16 (configuration 44):
    ``[zoo-round-whisper]``'s setup (2 clients, 4,096 decoder tokens over
    1,500 frames, the frames bf16) as ``_zoo_round_bf16``, one counted
    round and one profiled (cut for the smoke's time), the rebuild held
    bitwise on its first: K1 bf16 1, K5 bf16 480, K6 bf16 288 + 288 a
    round, every K5/K6 launch on ``flash_attention_sm90.cu`` (the
    encoder's and the cross-attention's padded non-causal calls, the
    decoder's causal ones); (d2) K6 by attention."""
    return _zoo_round_bf16(dev, smi, fp32_round, "[zoo-round-whisper-bf16]",
                           WHISPER_ARCH, WHISPER_PARAMS, ZOO_CLIENTS,
                           WHISPER_BF16_ROUNDS, "[zoo-round-whisper]")


def _zoo_round_bf16(dev, smi, fp32_round, tag, arch, n_params, c, rounds,
                    fp32_tag):
    """``arch`` at full width in bf16 (``param_dtype="bfloat16"``, the
    reference's switch; drawn on the card from a seed),
    ``Federation.from_config`` as [zoo-round] with ``c`` clients: (d) the
    step bars (``_bf16_step_bars``) from the initial params; then
    ``rounds`` rounds counted: (a) launches K1 one a round
    (``masked_agg_bf16``, none of ``masked_agg_f32``), K5 and K6 as
    ``_zoo_launches`` predicts, every K5/K6 launch on
    ``flash_attention_sm90.cu``; (b) every param bf16 after each round,
    frozen (client, unit row) deltas exactly zero, the bill Table 4's, the
    client planes and global tiles bf16, the global read in place from
    round 2 on, then the federation rebuilt from the seed and its first
    round held bitwise (loss, selection, every leaf); one more round
    under the profiler (counted apart, as [zoo-round] does); (c) K1 alone
    on that round's own planes (``_k1_bf16_alone``); (e) each round's
    seconds, the peak memory of the counted rounds, the profiled round's
    busy share, cuBLAS's share, its kernels with the most device time and
    K1's, K5's and K6's in-run ms beside their bounds (on whisper by
    attention: encoder, decoder self, cross), set beside ``fp32_tag``'s
    fp32 figures (``fp32_round``: its counts, profiled run, peak and
    counted rounds' seconds at ZOO_CLIENTS clients)."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.comm import table4_row
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.kernels.masked_agg import ops as kops
    from repro_torch.kernels.masked_agg.ref import k1_bytes

    cfg = get_config(arch).replace(param_dtype="bfloat16")
    name = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    fed = _zoo_fed(dev, cfg, clients=c)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n = sum(x.numel() for x in fed.params.values())
    check(n == n_params and all(x.dtype == BF16 and x.device == dev
                                for x in fed.params.values()),
          f"{tag} {n} params, expected {n_params} bf16 on the card")
    n_units = cfg.n_layers + cfg.n_enc_layers + 2
    check(fed.assign.n_units == n_units and
          fed.fl.resolve_n_train(n_units) == n_units // 2 and
          fed.fl.resolve_fused_agg(fed.device),
          f"{tag} units {fed.assign.n_units}, fused_agg off")
    bars = _bf16_step_bars(fed, cfg, tag)
    _free_card("zoo-round-bf16 (d)")
    frozen, bf16_hook = ZooFrozenCheck(fed.assign, fed.fl), _Bf16Params()
    fed.server.add_hook(frozen).add_hook(bf16_hook)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.reset_peak_memory_stats()
    _zoo_reset()
    secs = []
    with _K1Tap() as tap:
        for r in range(rounds):
            t0 = time.perf_counter()
            fed.fit(1)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if r == 0:      # the rebuild's reference, off the clock
                first = {p: x.cpu() for p, x in fed.params.items()}
                first_sel = np.array(fed.server.sel_history[0])
        peak = torch.cuda.max_memory_allocated()
        counts = _zoo_counts()
        by_entry, by_source = dict(kops.LAUNCHES), dict(aops.SOURCE_LAUNCHES)
        # one more round under the profiler; K1 alone later reads its planes
        _zoo_reset()
        tap.keep = True
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fed.fit(1)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
    again_counts = _zoo_counts()
    t0 = time.perf_counter()
    events = _kernel_events(prof)
    del prof
    parse_s = time.perf_counter() - t0
    hist = fed.history
    check(all(math.isfinite(r.loss) for r in hist), f"{tag} non-finite loss")
    want = dict(_zoo_launches(cfg, rounds * c * ZOO_STEPS), K1=rounds)
    check(counts == want, f"{tag} launches {counts}, predicted {want}")
    sm90 = aops.SOURCES[BF16].name
    attn = want["K5"] + want["K6 dq"] + want["K6 dkv"]
    check(by_source == {aops.SOURCES[torch.float32].name: 0, sm90: attn},
          f"{tag} K5/K6 launches by source {by_source}: all {attn} must run "
          f"on {sm90}")
    check(by_entry == {"masked_agg_f32": 0, "masked_agg_bf16": rounds},
          f"{tag} K1 launches by entry point {by_entry}")
    check(bf16_hook.rounds == rounds + 1,
          f"{tag} {bf16_hook.rounds} rounds")
    check(tap.calls == [{"in_place": r > 0, "global_dtype": BF16,
                         "planes_dtype": BF16}
                        for r in range(rounds + 1)],
          f"{tag} aggregates {tap.calls}: bf16 tiles and planes, the global "
          f"read in place from round 2 on")
    check(frozen.checked > 0 and frozen.moved > 0,
          f"{tag} frozen {frozen.checked}, moved {frozen.moved}")
    summ = fed.comm_summary()
    t4 = table4_row(fed.assign, {p: x.to("meta") for p, x in
                                 fed.params.items()},
                    np.stack(fed.server.sel_history))
    check(all(summ[k] == v for k, v in t4.items()),
          f"{tag} comm_summary {summ} != table4_row {t4}")
    run = _in_run(events)
    run["wall_ms"] = secs[-1] * 1e3
    run["busy_share"] = run["busy_ms"] / run["wall_ms"]
    # the same round's work unprofiled: the second counted round's wall
    run["busy_share_unprofiled"] = run["busy_ms"] / (secs[rounds - 1] * 1e3)
    profiled = {k: run[k]["launches"] for k in ZOO_KERNELS}
    half = {"K1": 1, "K2": 0, "K5": want["K5"] // rounds,
            "K6": (want["K6 dq"] + want["K6 dkv"]) // rounds}
    check(profiled == half and again_counts == {
              "K1": 1, "K2": 0, "K5": half["K5"], "K6 dq": half["K6"] // 2,
              "K6 dkv": half["K6"] // 2},
          f"{tag} the profile holds {profiled} kernel events, the counters "
          f"saw {again_counts} launches in that round, {half} predicted")
    top = _top_kernels(events)
    plan = kops.build_agg_plan(fed.assign, fed.params)
    rate = memory_rate(name)
    nb = k1_bytes(plan.row_unit, torch.as_tensor(fed.server.sel_history[-1]),
                  plan.tile, 2)
    run["K1"].update(T=plan.n_rows, live=nb["live"],
                     bound_ms=nb["live_bytes"] / rate * 1e3,
                     bound_all_ms=nb["all"] / rate * 1e3)
    attn_b = _attn_bound(name, 1, TRAIN_S, cfg.n_heads, cfg.n_kv_heads,
                         cfg.head_dim, 0, esz=2, peak=BF16_PEAK)
    for kind, part in (("K5", "fwd"), ("K6", "bwd")):
        run[kind]["bound_ms"], run[kind]["bound_by"] = attn_b[part][:2]
    split = ""
    if cfg.family == "audio":
        split = _whisper_attn_split(cfg, events, run, name)
    for r, sec in zip(hist, secs):
        print(f"{tag} round {r.round}: loss {r.loss:.4f} {sec:.3f} s wall "
              f"({r.seconds:.3f} s in the server) uplink "
              f"{r.uplink_bytes:.0f} B"
              + (" (profiled)" if r.round == rounds else ""))
    print(f"{tag} {cfg.name} full width in bf16 ({n:,} params, "
          f"{n * 2 / 1e9:.2f} GB, {n_units} units, {n_units // 2} trained a "
          f"client), {c} clients x {ZOO_STEPS} local steps of 1 x "
          f"{TRAIN_S:,} tokens"
          + (f" over {cfg.enc_seq:,} bf16 frames" if cfg.n_enc_layers
             else "")
          + f", Adam lr {ZOO_LR}: built in {build_s:.2f} s; "
          f"launches {counts} == predicted, K5/K6 by source {by_source}, K1 "
          f"by entry point {by_entry}; every param bf16 after each round; "
          f"client planes and global tiles bf16, the global read in place "
          f"from round 2 on; frozen (client, unit row) deltas exactly zero: "
          f"{frozen.checked}, trained rows that moved: {frozen.moved}; bill "
          f"== Table 4 (4 B a param); peak memory {peak / 1e9:.2f} GB "
          f"({peak / 2**30:.2f} GiB, {peak / n:.1f} B a param) on {smi}")
    f_counts, f_run, f_peak, f_secs = fp32_round
    print(f"{tag} (e) profiled round: wall {secs[-1]:.3f} s, device busy "
          f"{run['busy_ms']:.1f} ms ({run['busy_share']:.1%}; "
          f"{run['busy_share_unprofiled']:.1%} of round {rounds - 1}'s "
          f"unprofiled wall), cuBLAS "
          f"{run['gemm_ms']:.1f} ms ({run['gemm_ms'] / run['busy_ms']:.1%} "
          f"of busy), {len(events):,} device kernels (parsed in "
          f"{parse_s:.1f} s); the most device time: "
          + "; ".join(f"{nm} {ms:.1f} ms x {k}" for nm, ms, k in top)
          + f"; in-run: K1 {run['K1']['ms']:.4f} ms (bf16 live "
          f"bound {run['K1']['bound_ms']:.4f}, at "
          f"{run['K1']['bound_ms'] / run['K1']['ms']:.1%}; live planes "
          f"{nb['live']:.3f} of {c} a row; every plane "
          f"{run['K1']['bound_all_ms']:.4f}), K5 {run['K5']['ms']:.4f} ms a "
          f"launch (bound {attn_b['fwd'][0]:.4f} at "
          f"{BF16_PEAK / 1e12:.0f} TFLOP/s, at "
          f"{attn_b['fwd'][0] / run['K5']['ms']:.1%}; "
          f"{run['K5']['total_ms']:.1f} ms in all), K6 {run['K6']['ms']:.4f} ms a call (bound "
          f"{attn_b['bwd'][0]:.4f}, at "
          f"{attn_b['bwd'][0] / run['K6']['ms']:.1%}; "
          f"{run['K6']['total_ms']:.1f} ms in all){split}.  Beside "
          f"{fp32_tag} in fp32 ({ZOO_CLIENTS} clients): round s "
          + ", ".join(f"{x:.3f}" for x in f_secs)
          + f" against {', '.join(f'{x:.3f}' for x in secs[:-1])} here; "
          f"peak "
          f"{f_peak / 1e9:.2f} GB against {peak / 1e9:.2f}; busy "
          f"{f_run['busy_share']:.1%}, gemm {f_run['gemm_ms']:.1f} of "
          f"{f_run['busy_ms']:.1f} ms; K1 {f_run['K1']['ms']:.4f} ms, K5 "
          f"{f_run['K5']['ms']:.4f} ms a launch, K6 {f_run['K6']['ms']:.4f} "
          f"ms a call"
          + (f"; the clients differ ({c} against {ZOO_CLIENTS}: "
             f"{c / ZOO_CLIENTS:g}x the local steps a round)"
             if c != ZOO_CLIENTS else ""))
    k1_in, tap.last = tap.last, None
    losses = [r.loss for r in hist]
    del fed, frozen, events, tap
    _free_card("zoo-round-bf16")
    k1 = _k1_bf16_alone(k1_in, plan, smi, tag)
    del k1_in
    _free_card("zoo-round-bf16 (c)")
    t0 = time.perf_counter()
    fed = _zoo_fed(dev, cfg, clients=c)
    fed.fit(1)
    torch.cuda.synchronize()
    again = time.perf_counter() - t0
    check(fed.history[0].loss == losses[0] and
          np.array_equal(fed.server.sel_history[0], first_sel),
          f"{tag} the rebuilt run's first loss or selection differs")
    same = [p for p, x in fed.params.items()
            if not torch.equal(x.cpu(), first[p])]
    check(not same, f"{tag} rebuilt from the same seed, {len(same)} leaves "
          f"differ after its first round, e.g. {same[:3]}")
    print(f"{tag} built again from the same seed, its first round in "
          f"{again:.1f} s: loss, selection and all {len(first)} leaves "
          f"bitwise equal to the first run's")
    del fed, first
    _free_card("zoo-round-bf16")
    k1.update(in_run_ms=run["K1"]["ms"], in_run_bound_ms=run["K1"]["bound_ms"],
              in_run_live_planes=run["K1"]["live"])
    run["top"] = top
    return counts, run, k1, bars, peak, secs


def k1_qwen3_plan(dev, k1_plan, smi, tag="[k1-qwen3-plan]"):
    """K1 alone at qwen3-1.7b's hub plan (840,177 rows of 2,048, 2
    clients), or another round's plan (``k1_plan``: the rows ``T``, the
    plan's ``row_unit`` table, ``units`` and ``train`` a client), on
    random tile buffers with the selection drawn as the round draws it
    (seed 0 leaves units nobody selected at every zoo plan): against its
    plain version on every row, an unselected NaN skipped and the rows of
    a unit nobody selected unchanged (``_k1_check``), its device time
    beside its plain version's and one ``torch.bmm`` call's with the guard
    (the yardstick of ``_k1_measure``, held to the plain version on every
    row), each timed alone and its inputs' other layout freed, so that
    the card holds them; both bounds and an empty kernel."""
    from repro_torch.kernels.masked_agg import ops
    from repro_torch.kernels.masked_agg.ref import (draw_selection,
                                                    k1_bytes, masked_agg_ref)

    c, tile, plan_rows = ZOO_CLIENTS, 2048, k1_plan["T"]
    gen = torch.Generator(device=dev).manual_seed(0)
    g_t = torch.randn(plan_rows, tile, generator=gen, device=dev)
    d_t = 0.05 * torch.randn(c, plan_rows, tile, generator=gen, device=dev)
    sel = draw_selection(c, k1_plan["units"], k1_plan["train"], 0).to(dev)
    w = (torch.rand(c, generator=gen, device=dev) + 0.5)
    ru = torch.as_tensor(k1_plan["row_unit"].astype(np.int32), device=dev)
    k1_in = (g_t, d_t, sel, w, ru)
    err = _k1_check(tag, k1_in)
    ms = device_ms(lambda: ops.masked_agg(*k1_in), 10)
    plain_ms = device_ms(lambda: masked_agg_ref(*k1_in), 10)
    empty_ms = device_ms(lambda: torch.cuda._sleep(0), 10)
    w_t = (sel[:, ru.long()] * w[:, None]).t().contiguous()   # (T, C)
    d_tct = d_t.permute(1, 0, 2).contiguous()        # (T, C, tile)
    del d_t, k1_in

    def library():
        num = torch.bmm(w_t.unsqueeze(1), d_tct).squeeze(1)
        den = w_t.sum(1, keepdim=True)
        return g_t + torch.where(den > 0, num / den.clamp_min(1e-9),
                                 torch.zeros_like(num))

    out_l, lib_err = library(), 0.0
    for a in range(0, plan_rows, ops.CHECK_ROWS):
        b = min(a + ops.CHECK_ROWS, plan_rows)
        want = masked_agg_ref(g_t[a:b], d_tct[a:b].permute(1, 0, 2), sel, w,
                              ru[a:b])
        lib_err = max(lib_err, float((out_l[a:b] - want).abs().max()))
    check(lib_err <= 1e-4, f"{tag} torch.bmm yardstick disagrees: {lib_err}")
    del out_l, want
    library_ms = device_ms(library, 10)
    nb = k1_bytes(k1_plan["row_unit"], sel, tile)
    rate = memory_rate(torch.cuda.get_device_name(0))
    bound, bound_all = nb["live_bytes"] / rate * 1e3, nb["all"] / rate * 1e3
    print(f"{tag} T={plan_rows} C={c} tile {tile}: max abs err vs plain "
          f"{err:.3e}, torch.bmm yardstick {lib_err:.3e} (every row); live "
          f"planes {nb['live']:.3f} of {c} a row "
          f"({nb['live'] / c:.1%}); device median ms (L2 flushed) kernel "
          f"{ms:.4f}, plain {plain_ms:.4f}, torch.bmm + guard "
          f"{library_ms:.4f}, an empty kernel {empty_ms:.4f}; bound of the "
          f"live planes {bound:.4f} ({nb['live_bytes'] / 1e9:.2f} GB; kernel "
          f"at {bound / ms:.1%}), of every plane {bound_all:.4f} "
          f"({nb['all'] / 1e9:.2f} GB; kernel at {bound_all / ms:.1%}) on "
          f"{smi}")
    del g_t, d_tct, w_t
    _free_card(tag[1:].replace("]", ""))
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "max_abs_err": err, "bound_ms": bound,
            "bound_all_planes_ms": bound_all, "live_planes": nb["live"],
            "empty_kernel_ms": empty_ms}


def _decisive_routing(cfg, params, spacing=0.02, scale=3.0):
    """``params`` with decisive routing: the first E coordinates of every
    embedding row a permutation of E codes ``spacing`` apart, no layer
    writing into them (their columns of ``attn/wo`` and ``w_down`` zero)
    and each router reading its expert's coordinate at ``scale``.  A
    random router puts some of a few thousand tokens within rounding of
    choosing another expert, and a card-vs-CPU comparison then differs by
    a whole expert's share; here each token's k-th and (k+1)-th router
    probabilities lie apart by far more than the parity bar."""
    e = cfg.moe.num_experts
    rng = np.random.default_rng(0)
    out = {p: x.clone() for p, x in params.items()}
    table = out["embed/table"]
    codes = np.stack([rng.permutation(e) for _ in range(table.shape[0])])
    table[:, :e] = torch.as_tensor((codes - (e - 1) / 2) * spacing,
                                   dtype=table.dtype)
    for p, x in out.items():
        if p.endswith("/attn/wo") or p.endswith("/w_down"):
            x[..., :e] = 0
        if p.endswith("/moe/router"):
            x.zero_()
            x[:, torch.arange(e), torch.arange(e)] = scale
    return out


def phase_zoo_parity(dev, cfg=None, s=1024, tag="zoo-parity",
                     lr=ZOO_PARITY_LR, clients=2):
    """qwen3-1.7b at full width cut to 2 layers (or ``cfg``), one hub
    round of SGD at S = 1,024 (or ``s`` text tokens, after a VLM's
    patches: the chunked route), 2 clients (or 1 training every unit),
    the same params (drawn on the card, copied to the host), batches and
    replayed selections on the card (K5/K6, K1) and on the host CPU
    (plain versions).  A MoE model's routing is
    made decisive (``_decisive_routing``), and the CPU run's least gap
    between a token's k-th and (k+1)-th router probability must be at
    least 100 x ZOO_PARITY_TOL."""
    import contextlib
    from repro_torch.models import moe
    from repro_torch.configs.base import get_config
    from repro_torch.core import FLConfig, Replay, build_round_step
    from repro_torch.core.masking import build_units_zoo
    from repro_torch.data import lm_batch
    from repro_torch.kernels.flash_attention import ops as aops
    from repro_torch.kernels.masked_agg import ops as kops
    from repro_torch.launch import steps
    from repro_torch.models import get_model
    from repro_torch.models.transformer import vit_width

    cfg = cfg or get_config(ZOO_ARCH).replace(n_layers=2)
    model = get_model(cfg)
    # drawn on the card: the host's generator took ~10 s for internvl2's
    # 1.5 B params
    params = {p: x.cpu() for p, x in model.init_params(
        torch.Generator(device=dev).manual_seed(4)).items()}
    if cfg.moe is not None:
        params = _decisive_routing(cfg, params)
    assign = build_units_zoo(cfg, params)
    c = clients
    data = lm_batch(c, s, cfg.vocab, key=5)
    if cfg.family == "audio":
        data["frames"] = np.random.default_rng(6).normal(
            0, 1, (c, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        data["patches"] = np.random.default_rng(6).normal(
            0, 1, (c, cfg.n_patches, vit_width(cfg))).astype(np.float32)
    batches = {k: v.reshape((c, 1, 1) + v.shape[1:]) for k, v in data.items()}
    # units embed, layer0, layer1, head (whisper: embed, enc0, enc1,
    # layer0, layer1, head; a 1-layer cut: embed, layer0, head): each
    # client trains n_train_units of them, and every layer is trained by
    # some client
    if c == 1:
        sel = np.ones((1, assign.n_units), np.float32)
    elif cfg.n_enc_layers:
        sel = np.asarray([[0, 1, 0, 1, 1, 0], [1, 0, 1, 0, 1, 0]], np.float32)
    elif cfg.n_layers == 1:
        sel = np.asarray([[0, 1, 1], [1, 1, 0]], np.float32)
    else:
        sel = np.asarray([[0, 1, 1, 0], [1, 1, 0, 0]], np.float32)
    n_train = int(sel.sum(1)[0])
    check(sel.shape[1] == assign.n_units and
          bool((sel.sum(1) == n_train).all()) and
          bool(sel[:, 1:-1].any(0).all()), f"{tag}: selection {sel}")
    out, secs, losses, gaps = {}, {}, {}, {}
    for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
        fl = FLConfig(n_clients=c, n_train_units=n_train, optimizer="sgd",
                      lr=lr)
        step = build_round_step(model.loss_fn, assign, fl,
                                steps.default_loss_kwargs(cfg),
                                strategy=Replay([sel]), device=d)
        _zoo_reset()
        t0 = time.perf_counter()
        traced = moe.trace_routing() if cfg.moe is not None \
            else contextlib.nullcontext([])
        with traced as routed:
            new, m = step({p: v.to(d) for p, v in params.items()},
                          {k: torch.as_tensor(v, device=d)
                           for k, v in batches.items()}, torch.ones(c), None)
        gaps[side] = min((float(r["gap"].min()) for r in routed),
                         default=math.inf)
        del routed
        losses[side] = float(m["loss_mean"])
        secs[side] = time.perf_counter() - t0
        if side == "card":
            check(aops.LAUNCHES["fwd"] > 0 and kops.masked_agg.launches == 1,
                  f"{tag}: card launches {aops.LAUNCHES}, K1 "
                  f"{kops.masked_agg.launches}")
            card_counts = dict(aops.LAUNCHES)
        out[side] = {p: v.cpu() for p, v in new.items()}
        del new, m
    err = {p: float((out["card"][p] - out["cpu"][p]).abs().max())
           for p in params}
    moved = {p: float((out["cpu"][p] - params[p]).abs().max())
             for p in params}
    worst = max(err, key=err.get)
    # where a wrong K6 dK/dV (or dQ) lands first: each macro row of the
    # attention projections must move by well over the tolerance, and its
    # card-vs-CPU difference is read against its own move
    rows = {}
    for p in params:
        if p.rsplit("/", 1)[-1] in ("wq", "wk", "wv", "wo") and \
                ("/attn/" in p or "/xattn/" in p):
            for r in range(params[p].shape[0]):
                mv = float((out["cpu"][p][r] - params[p][r]).abs().max())
                er = float((out["card"][p][r] - out["cpu"][p][r]).abs().max())
                rows[f"{p}[{r}]"] = (mv, er)
    least = min(rows, key=lambda r: rows[r][0])
    rel = max(rows, key=lambda r: rows[r][1] / max(rows[r][0], 1e-30))
    print(f"[{tag}] {cfg.name} at full width cut to {cfg.n_layers} "
          f"layer{'s' if cfg.n_layers > 1 else ''}"
          + (f" (and {cfg.n_enc_layers} encoder layers over "
             f"{cfg.enc_seq:,} frames)" if cfg.n_enc_layers else "")
          + (f" (window {cfg.sliding_window}, global_every "
             f"{cfg.global_every})" if cfg.sliding_window else "")
          + (f", {cfg.n_patches:,} patches before the text "
             f"({cfg.n_patches + s:,} positions)" if cfg.n_patches else "")
          + f", S={s}, "
          f"{c} clients, one SGD step at lr {lr}, selection "
          f"{sel.tolist()}"
          f": card (K5/K6 {card_counts}, K1) vs host CPU (plain) max abs err "
          f"{err[worst]:.3e} at {worst} (tol {ZOO_PARITY_TOL}; the round "
          f"moved params by up to {max(moved.values()):.3e}); attention "
          f"projection rows: least move {rows[least][0]:.3e} at {least}, "
          f"largest difference / move {rows[rel][1] / rows[rel][0]:.3e} at "
          f"{rel}; per row (move, difference): " + ", ".join(
              f"{r} {mv:.3e} {er:.3e}" for r, (mv, er) in rows.items())
          + f"; loss card "
          f"{losses['card']:.6f} CPU {losses['cpu']:.6f}; seconds card "
          f"{secs['card']:.2f}, CPU {secs['cpu']:.2f}"
          + (f"; least router gap (k-th less (k+1)-th probability) card "
             f"{gaps['card']:.3e}, CPU {gaps['cpu']:.3e}"
             if cfg.moe is not None else ""))
    check(gaps["cpu"] >= 100 * ZOO_PARITY_TOL, f"{tag}: a token lies "
          f"within {gaps['cpu']} of another expert set (< 100 x "
          f"{ZOO_PARITY_TOL})")
    check(err[worst] <= ZOO_PARITY_TOL,
          f"{tag} {worst}: card vs CPU max abs err {err[worst]} > "
          f"{ZOO_PARITY_TOL}")
    attn_layers = cfg.n_enc_layers + cfg.n_layers * (
        2 if cfg.family == "audio" else 1)
    check(len(rows) == 4 * attn_layers, f"{tag}: rows {sorted(rows)}")
    for r, (mv, _) in rows.items():
        check(mv >= 10 * ZOO_PARITY_TOL, f"{tag} {r}: moved by {mv}, "
              f"under 10 x {ZOO_PARITY_TOL}")
    del out
    _free_card(tag)


def phase_train_launcher(arch=ZOO_ARCH, rounds=1, units=30,
                         tag="train-launcher"):
    """The training launcher as a user runs it, on the card at full width
    (``units``: the arch's unit count, half of them trained)."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           arch, "--clients", "2", "--rounds", str(rounds), "--batch-size",
           "1", "--steps-per-round", "1", "--seq", "64"]
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    t0 = time.perf_counter()
    got = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                         env=env, cwd=root)
    secs = time.perf_counter() - t0
    check(got.returncode == 0, f"[{tag}] exit {got.returncode}: "
          f"{got.stderr[-3000:]}")
    out = got.stdout
    header = next((x for x in out.splitlines() if x.startswith("arch=")), "")
    check(header == f"arch={arch} reduced=False units={units} train="
          f"{units // 2} clients=2 topology=hub", f"[{tag}] header {header!r}")
    check(out.count("  round ") == rounds, f"[{tag}] round lines: {out}")
    check("comm summary:" in out, f"[{tag}] no comm summary")
    summ = json.loads(out[out.index("comm summary:\n") + 14:
                          out.rindex("}") + 1])
    check(summ["avg_uplink_bytes"] > 0 and 0 < summ["reduction_vs_full"] < 1,
          f"[{tag}] comm summary {summ}")
    print(f"[{tag}] {' '.join(cmd[1:])}: exit 0 in {secs:.1f} s; "
          f"{header}; " + " | ".join(x.strip() for x in out.splitlines()
                                     if x.startswith("  round"))
          + f"; comm summary {json.dumps(summ)}")


def zoo_kernel_rows(smi, dense_run, packed_run, gemma_run,
                    attn_zoo, hymba_run, k1_plan, moe_run, vlm_run):
    """The zoo call sites' numbers for the kernels line: in-run device
    ms beside the bound and, for K5/K6, ``[attention-kernels]``' readings
    at the same shapes (alone, plain, SDPA, max abs err); K1 at qwen3's
    plan alone (``k1_qwen3_plan``, with its own bounds) and in-run at
    qwen3's, granite's and internvl2-26b's (the profiled round's
    bounds)."""
    name = torch.cuda.get_device_name(0)
    rows = {"K1": {}, "K2": {}, "K5": {}, "K6": {}}
    k1_in_run = dense_run["K1"]
    rows["K1"]["hub qwen3-1.7b"] = dict(
        T=k1_in_run["T"], C=ZOO_CLIENTS, in_run_ms=k1_in_run["ms"],
        in_run_bound_ms=k1_in_run["bound_ms"],
        in_run_live_planes=k1_in_run["live"], bound_by="bytes", **k1_plan)
    k2_bytes = packed_run["K2"]["bytes"]
    rows["K2"]["hub qwen3-1.7b packed qint8"] = {
        "elements": packed_run["K2"]["elements"],
        "in_run_ms": packed_run["K2"]["ms"],
        "ms": packed_run["K2"]["alone_ms"],
        "plain_ms": packed_run["K2"]["plain_ms"], "library_ms": None,
        "bound_ms": k2_bytes / memory_rate(name) * 1e3, "bound_by": "bytes"}
    shapes = [(f"{ZOO_ARCH} B=1 S={TRAIN_S}", dense_run["K5"]["ms"],
               dense_run["K6"]["ms"]),
              (f"gemma3-12b local B=1 S={GEMMA_MACRO_S}",
               gemma_run["K5 local ms"], gemma_run["K6 local ms"]),
              (f"gemma3-12b global B=1 S={GEMMA_MACRO_S}",
               gemma_run["K5 global ms"], gemma_run["K6 global ms"])]
    shapes += [(f"{n} B=1 S={HYMBA_S}", hymba_run[f"K5 {where} ms"],
                hymba_run[f"K6 {where} ms"])
               for (n, _, _), where in zip(_hymba_attn_configs(),
                                           ("local", "global"))]
    shapes.append((f"{MOE_ARCH} B=1 S={TRAIN_S}", moe_run["K5"]["ms"],
                   moe_run["K6"]["ms"]))
    shapes.append((f"{VLM_ARCH} B=1 S={VLM_ROUND_S}", vlm_run["K5"]["ms"],
                   vlm_run["K6"]["ms"]))
    for arch, run in ((MOE_ARCH, moe_run), (VLM_ARCH, vlm_run)):
        k1m = run["K1"]
        rows["K1"][f"hub {arch}"] = dict(
            T=k1m["T"], C=ZOO_CLIENTS, in_run_ms=k1m["ms"],
            in_run_bound_ms=k1m["bound_ms"],
            in_run_bound_all_planes_ms=k1m["bound_all_ms"],
            in_run_live_planes=k1m["live"], bound_by="bytes")
        print(f"[zoo-kernels] K1 hub {arch} plan T={k1m['T']} C="
              f"{ZOO_CLIENTS}: in-run {k1m['ms']:.4f} ms, "
              f"{_k1_in_run_text(k1m)}")
    for label, k5_ms, k6_ms in shapes:
        t = attn_zoo[label]
        bound = t["bound"]
        for kind, part, in_run in (("K5", "fwd", k5_ms), ("K6", "bwd", k6_ms)):
            outs = ("o", "lse") if part == "fwd" else ("dq", "dk", "dv")
            rows[kind][label] = {
                "in_run_ms": in_run, "ms": t[part],
                "plain_ms": t[f"plain_{part}"], "bound_ms": bound[part][0],
                "bound_by": bound[part][1],
                "library_ms": t[f"lib_{part}"],
                "max_abs_err": max(t["errs"][n] for n in outs)}
            print(f"[zoo-kernels] {kind} {label}: in-run {in_run:.4f} ms a "
                  f"call, alone {t[part]:.4f} ms, plain "
                  f"{t[f'plain_{part}']:.4f} ms, sdpa fp32 "
                  f"{t[f'lib_{part}']:.4f} ms, bound {bound[part][0]:.4f} "
                  f"ms ({bound[part][1]}); kernel at "
                  f"{bound[part][0] / in_run if in_run else math.nan:.1%} "
                  f"of the bound in-run")
    k1 = rows["K1"]["hub qwen3-1.7b"]
    print(f"[zoo-kernels] K1 hub qwen3-1.7b plan T={k1['T']} C="
          f"{ZOO_CLIENTS}: in-run {k1['in_run_ms']:.4f} ms, "
          f"{_k1_in_run_text(k1_in_run)}; alone {k1['ms']:.4f} ms, plain "
          f"{k1['plain_ms']:.4f} ms, torch.bmm + guard "
          f"{k1['library_ms']:.4f} ms, bound of its live planes "
          f"{k1['bound_ms']:.4f} ms, of every plane "
          f"{k1['bound_all_planes_ms']:.4f} ms (at "
          f"{memory_rate(name) / 1e12:.2f} TB/s) on {smi}")
    k2 = rows["K2"]["hub qwen3-1.7b packed qint8"]
    print(f"[zoo-kernels] K2 hub qwen3-1.7b packed qint8, one grouped launch "
          f"over {k2['elements']:,} slot elements: in-run "
          f"{k2['in_run_ms']:.4f} ms, alone {k2['ms']:.4f} ms, plain "
          f"{k2['plain_ms']:.4f} ms, bound {k2['bound_ms']:.4f} ms "
          f"({k2_bytes / 1e9:.2f} GB), kernel at "
          f"{k2['bound_ms'] / k2['in_run_ms'] if k2['in_run_ms'] else math.nan:.1%}"
          f" of the bound")
    return rows


# ---------------------------------------------------------------------------
# the mesh: client shards and the expert-parallel MoE, on ranks spawned as
# ``python3 chip_smoke.py --worker ...`` (one process each, joined over a
# FileStore; gloo lets several ranks share the one card, NCCL refuses it)

MESH_CHUNK = 4
# the single-process runs' records (_run_record), filled by [round],
# [packed-round] and [cohort-round]
MESH_WANT = {}
MOE_EP_TOKENS = (2, 2048)        # train_4k's 4,096 tokens, 2 rows
MOE_EP_MESHES = (((1, 2), "gloo"), ((2, 2), "gloo"), ((1, 1), "nccl"))
MOE_EP_Y_TOL, MOE_EP_AUX_TOL, MOE_EP_GRAD_TOL = 1e-5, 1e-6, 1e-5


# [mesh-round]'s paths, (paper_round.build overrides, rounds): cell 1
# dense (as [round]), packed qint8 (as [packed-round]) and the cohort of 8
# from 1,000 in chunks of 4 (as [cohort-round])
MESH_PATHS = {"dense": (dict(eval_images=256), ROUNDS),
              "packed qint8": (dict(eval_images=256, packed=True,
                                    codec="qint8"), ROUNDS),
              f"cohort chunk {MESH_CHUNK}": (
                  dict(cohort_chunk=MESH_CHUNK, faults="crash:0.1",
                       client_sampler="loss_proportional", **COHORT_KW), 2)}


def _run_record(fed):
    """A run's final params and selections as digests, its losses, bill
    and round seconds (through JSON, as a rank hands them back)."""
    import hashlib
    h = hashlib.sha256()
    for p, x in fed.params.items():
        h.update(p.encode())
        h.update(x.detach().cpu().numpy().tobytes())
    sel = hashlib.sha256(b"".join(np.ascontiguousarray(x).tobytes()
                                  for x in fed.server.sel_history))
    return json.loads(json.dumps({
        "params": h.hexdigest(), "sel": sel.hexdigest(),
        "losses": [r.loss for r in fed.history],
        "seconds": [r.seconds for r in fed.history],
        "bill": fed.comm_summary()}))


def _start_ranks(target, world, backend="gloo", **kw):
    """``world`` ranks of ``target`` in processes of their own; their
    stdout and stderr are this script's, and an exit kills any still
    running."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    procs = []
    for rank in range(world):
        out = os.path.join(tmp, f"{rank}.json")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", target,
             str(rank), str(world), os.path.join(tmp, "store"), out,
             backend, json.dumps(kw)]), out))
        atexit.register(_stop, procs[-1][0])    # if a phase fails first
    return procs


def _wait_ranks(procs, timeout=600):
    """The ranks' results in rank order; every rank is stopped if one
    fails or the time runs out."""
    t_end = time.monotonic() + timeout
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, t_end - time.monotonic()))
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, (p, _) in enumerate(procs) if p.returncode]
    check(not bad, f"ranks {bad} failed (exit codes "
          f"{[procs[r][0].returncode for r in bad]})")
    out = []
    for _, path in procs:
        with open(path) as f:
            out.append(json.load(f))
    return out


def _worker(argv) -> int:
    """One rank: join the group, run the target, write its JSON."""
    target, rank, world, store, out, backend, kw = argv
    rank, world = int(rank), int(world)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    import torch.distributed as dist
    # a card a rank where there are as many (NCCL), else ranks share
    torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        res = {"mesh-round": _mesh_round_worker,
               "moe-ep": _moe_ep_worker}[target](rank, world,
                                                  **json.loads(kw))
    finally:
        dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)
    return 0


def _mesh_round_worker(rank, world):
    from repro_torch import paper_round
    from repro_torch.kernels.codec import ops as qops
    from repro_torch.kernels.masked_agg import ops

    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    for name, (kw, rounds) in MESH_PATHS.items():
        fed = paper_round.build(dev, client_shards=world, **kw)
        ops.reset_launch_counts()
        qops.reset_launch_counts()
        hist = fed.fit(rounds)
        torch.cuda.synchronize()
        rec = _run_record(fed)
        eng = fed.server.cohort_engine
        rec.update(K1=ops.masked_agg.launches,
                   K2=qops.quantize_pack_group.launches,
                   chunks=sum(eng.n_chunks for r in hist if not r.skipped)
                   if eng is not None else 0)
        out[name] = rec
        print(f"[mesh-round] rank {rank} of {world}, {name}: round seconds "
              + ", ".join(f"{x:.3f}" for x in rec["seconds"])
              + f"; K1 {rec['K1']}, K2 {rec['K2']} launches", flush=True)
        del fed, eng
        torch.cuda.empty_cache()
    return out


def start_mesh_round(world=2, backend="gloo"):
    """Start ``[mesh-round]``'s ranks: cell 1, its packed qint8 round and
    the cohort of 8 from 1,000 in chunks of 4, each with
    ``client_shards=world`` over ``world`` ranks (gloo: sharing the card;
    NCCL needs a card a rank).  They run beside phases that time nothing
    on the device; ``wait_mesh_round`` collects them."""
    return time.perf_counter(), world, backend, _start_ranks(
        "mesh-round", world, backend)


def wait_mesh_round(started):
    t0, world, backend, procs = started
    ranks = _wait_ranks(procs)
    return ranks, world, backend, time.perf_counter() - t0


def check_mesh_round(waited):
    """``[mesh-round]``: every rank's final params, selections, losses and
    bill equal to the single-process run's ([round], [packed-round],
    [cohort-round]), bitwise; K1 once a round on the dense path, K2 once a
    round or chunk, on every rank.  Returns the launches by (path,
    rank)."""
    ranks, world, backend, secs = waited
    check(sorted(MESH_WANT) == sorted(MESH_PATHS),
          f"single-process records {sorted(MESH_WANT)}")
    k1, k2 = {}, {}
    for name, want in MESH_WANT.items():
        for r, res in enumerate(ranks):
            got = res[name]
            for key in ("params", "sel", "losses", "bill"):
                check(got[key] == want[key], f"[mesh-round] {name} rank {r}: "
                      f"{key} differ from the single-process run's")
            k1_want = ROUNDS if name == "dense" else 0
            k2_want = 0 if name == "dense" else (
                got["chunks"] if name.startswith("cohort") else ROUNDS)
            check(got["K1"] == k1_want and got["K2"] == k2_want,
                  f"[mesh-round] {name} rank {r}: K1 {got['K1']} (want "
                  f"{k1_want}), K2 {got['K2']} (want {k2_want})")
            k1[f"mesh-round {name} vgg16 rank {r}"] = got["K1"]
            k2[f"mesh-round {name} vgg16 rank {r}"] = got["K2"]
        print(f"[mesh-round] {name}: every rank bitwise the single-process "
              f"run (params {want['params'][:12]}.., selections, losses, "
              f"bill); round seconds single-process "
              + ", ".join(f"{x:.3f}" for x in want["seconds"])
              + "".join(f"; rank {r} " + ", ".join(
                  f"{x:.3f}" for x in res[name]["seconds"])
                  for r, res in enumerate(ranks)))
    print(f"[mesh-round] {world} ranks over {backend}, 3 paths: "
          f"{secs:.1f} s with the ranks' start")
    return k1, k2


def _moe_ep_inputs(dev):
    """One MoE layer of granite-moe-1b-a400m at full width (d 1,024, 32
    experts of 512, top 8, capacity factor 1.25) drawn from seed 0 on the
    host, at 2 x 2,048 tokens with decisive routing (the first 32
    coordinates of each token a permutation of codes 0.05 apart, each
    router column reading its expert's coordinate at 3.0, the rest scaled
    by 0.01); the output weights g; the least gap between a token's k-th
    and (k+1)-th router probability."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import moe
    cfg = get_config(MOE_ARCH)
    mcfg, d, e = cfg.moe, cfg.d_model, cfg.moe.num_experts
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, d, mcfg, torch.float32)
    x = torch.randn(*MOE_EP_TOKENS, d, generator=gen)
    rng = np.random.default_rng(0)
    n = MOE_EP_TOKENS[0] * MOE_EP_TOKENS[1]
    codes = np.stack([rng.permutation(e) for _ in range(n)])
    x[..., :e] = torch.as_tensor((codes - (e - 1) / 2) * 0.05,
                                 dtype=torch.float32).view(*x.shape[:2], e)
    p["router"][:e] = 3.0 * torch.eye(e)
    p["router"][e:] *= 0.01
    g = torch.randn(*x.shape, generator=gen)
    p = {k: v.to(dev) for k, v in p.items()}
    x, g = x.to(dev), g.to(dev)
    top = torch.topk(torch.softmax(x.view(n, d) @ p["router"], -1),
                     mcfg.top_k + 1, dim=-1).values
    gap = float((top[:, -2] - top[:, -1]).min())
    return p, x, g, mcfg, gap


def _moe_ep_worker(rank, world, shape):
    from repro_torch.launch.mesh import _mesh
    from repro_torch.models import moe

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = _mesh(tuple(shape), ("data", "model"), "cuda")
    p, x, g, mcfg, gap = _moe_ep_inputs(dev)
    names = ("router", "w_gate", "w_up", "w_down")

    def run(fn):
        leaves = [p[n].detach().requires_grad_(True) for n in names] + \
            [x.detach().requires_grad_(True)]
        pp = dict(zip(names, leaves))
        moe.reset_dropped()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, aux = fn(pp, leaves[-1])
        grads = torch.autograd.grad((y * g).sum() + aux, leaves)
        torch.cuda.synchronize()
        return (y.detach(), aux.detach(), grads, moe.dropped_copies(),
                time.perf_counter() - t0)

    def plain(pp, xx):
        return moe.apply_moe(pp, xx, mcfg)

    def sharded(pp, xx):
        return moe.apply_moe_sharded(pp, xx, mcfg, mesh=mesh)

    # each timed on its second call (the first loads cuBLAS' kernels)
    run(plain)
    y0, aux0, g0, drop0, plain_s = run(plain)
    run(sharded)
    y1, aux1, g1, drop1, secs = run(sharded)
    out = {"y_err": float((y1 - y0).abs().max()),
           "aux_err": float((aux1 - aux0).abs()),
           "grad_errs": [float((a - b).abs().max() / b.abs().max())
                         for a, b in zip(g1, g0)],
           "dropped": drop1, "dropped_plain": drop0, "gap": gap,
           "seconds": secs, "plain_seconds": plain_s, "fault_y_err": None}
    if shape[1] > 1:
        # the planted fault: ranks past model index 0 take the expert
        # shard one expert further on
        shard = moe._ExpertShard.apply
        moe._ExpertShard.apply = lambda w, lo, hi, *a: shard(
            torch.roll(w, -1, 0) if lo else w, lo, hi, *a)
        try:
            yf = run(sharded)[0]
        finally:
            moe._ExpertShard.apply = shard
        out["fault_y_err"] = float((yf - y0).abs().max())
    return out


def start_moe_ep(meshes=MOE_EP_MESHES):
    """Start ``[moe-ep]``'s ranks, every mesh's together; they run beside
    phases that time nothing on the device."""
    return time.perf_counter(), [(shape, backend, _start_ranks(
        "moe-ep", shape[0] * shape[1], backend, shape=list(shape)))
        for shape, backend in meshes]


def phase_moe_ep(smi, started):
    """``apply_moe_sharded`` on one full-width granite MoE layer at
    train_4k's 4,096 tokens, on meshes (data 1, model 2) and (data 2,
    model 2) of gloo ranks sharing the card and a (1, 1) mesh over NCCL,
    side by side: on every rank y within 1e-5 and aux within 1e-6 of
    ``apply_moe`` on the card, every gradient within 1e-5 of its largest
    entry, the dropped copies summed over the ranks equal, decisive
    routing (the least gap >= 100 x the y bar), and the planted fault
    outside the y bar (the ranks from ``start_moe_ep``)."""
    t0, started = started
    for shape, backend, procs in started:
        ranks = _wait_ranks(procs)
        tag = f"[moe-ep] mesh (data {shape[0]}, model {shape[1]}) {backend}"
        gap = ranks[0]["gap"]
        check(gap >= 100 * MOE_EP_Y_TOL, f"{tag}: routing gap {gap}")
        for r, res in enumerate(ranks):
            check(res["y_err"] < MOE_EP_Y_TOL and
                  res["aux_err"] < MOE_EP_AUX_TOL and
                  max(res["grad_errs"]) < MOE_EP_GRAD_TOL,
                  f"{tag} rank {r}: y {res['y_err']:.3e}, aux "
                  f"{res['aux_err']:.3e}, grads {res['grad_errs']}")
            if res["fault_y_err"] is not None:
                check(res["fault_y_err"] > MOE_EP_Y_TOL,
                      f"{tag} rank {r}: the planted fault passed the y bar "
                      f"({res['fault_y_err']:.3e})")
        dropped = sum(res["dropped"] for res in ranks)
        check(dropped == ranks[0]["dropped_plain"],
              f"{tag}: {dropped} copies dropped against apply_moe's "
              f"{ranks[0]['dropped_plain']}")
        print(f"{tag}: y max err {max(r['y_err'] for r in ranks):.3e}, aux "
              f"{max(r['aux_err'] for r in ranks):.3e}, gradients "
              f"{max(max(r['grad_errs']) for r in ranks):.3e} (relative), "
              f"dropped copies {dropped} == apply_moe's; least routing gap "
              f"{gap:.3e}; planted fault y err "
              + (", ".join(f"{r['fault_y_err']:.3e}" for r in ranks)
                 if ranks[0]["fault_y_err"] is not None else "n/a")
              + "; forward + backward s per rank "
              + ", ".join(f"{r['seconds']:.3f}" for r in ranks)
              + f" (apply_moe {ranks[0]['plain_seconds']:.3f}) on {smi}")
    print(f"[moe-ep] {len(started)} meshes, "
          f"{sum(a * b for (a, b), _, _ in started)} ranks: "
          f"{time.perf_counter() - t0:.1f} s with the ranks' start")


def phase_k1_zoo_plans(dev, smi, runs):
    """``[k1-qwen3-plan]`` at every other plan K1 runs in the zoo rounds:
    ``runs`` maps a path to its round's record, whose plan (``T``,
    ``row_unit``, units) comes from the tiling plan the round built."""
    rows = {}
    for path, run in runs.items():
        res = k1_qwen3_plan(dev, run["K1"], smi,
                            tag=f"[k1-zoo-plans] {path}")
        rows[path] = dict(T=run["K1"]["T"], C=ZOO_CLIENTS,
                          in_run_ms=run["K1"]["ms"],
                          in_run_bound_ms=run["K1"]["bound_ms"],
                          in_run_bound_all_planes_ms=run["K1"]["bound_all_ms"],
                          in_run_live_planes=run["K1"]["live"],
                          bound_by="bytes", **res)
    check(len(rows) == 4, f"[k1-zoo-plans] {len(rows)} plans")
    return rows


def main() -> int:
    t_start = time.perf_counter()
    if sys.argv[1:2] == ["--worker"]:      # a rank of [mesh-round], [moe-ep]
        return _worker(sys.argv[2:])
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
    walls = {}

    def timed(tag, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[tag] = time.perf_counter() - t0
        return out

    build = timed("build", phase_build)
    # the mesh's ranks (cell 1's paths with client_shards=2 over 2 ranks
    # sharing the card; the expert-parallel MoE layer on 3 meshes) and the
    # rest of the build run beside the resume phases, which time nothing
    # on the device
    mesh = start_mesh_round()
    moe_ep = start_moe_ep()
    timed("ckpt-resume", phase_ckpt_resume, dev, smi)
    timed("engine-resume", phase_engine_resume, dev, smi)
    mesh = timed("mesh-round", wait_mesh_round, mesh)
    timed("moe-ep", phase_moe_ep, smi, moe_ep)
    timed("build-rest", finish_build, build)
    k1 = timed("kernel", phase_kernel, dev)
    timed("parity", phase_parity, dev)
    k1_paths = {"hub vgg16": timed("round", phase_round, dev)}
    timed("round-repeat", phase_round_repeat, dev)
    k2 = timed("codec-kernel", phase_codec_kernel, dev)
    k2_paths = {"hub vgg16 packed qint8": timed("packed-round",
                                                 phase_packed_round, dev)}
    timed("codec-rounds", phase_codec_rounds, dev)
    k1_paths.update(timed("paper-tasks", phase_paper_tasks, dev))
    timed("paper-tasks-parity", phase_paper_tasks_parity, dev)
    (k1_paths["hierarchical vgg16"],
     k2_paths["hierarchical vgg16 packed qint8"], hier) = timed(
        "hier-round", phase_hier_round, dev)
    timed("gossip-round", phase_gossip_round, dev)
    k1_paths.update(timed("scored-round", phase_scored_round, dev))
    k2_paths["hub vgg16 packed qint8 score_weighted"] = timed(
        "scored-packed", phase_scored_packed, dev)
    k2_async, k2["dispatch_1client"] = timed("async-round",
                                             phase_async_round, dev, smi)
    k2_paths.update(k2_async)
    k2_paths.update(timed("cohort-round", phase_cohort_round, dev))
    k1_chaos, k2_chaos = timed("chaos", phase_chaos, dev)
    k1_paths.update(k1_chaos)
    k2_paths.update(k2_chaos)
    # the mesh's ranks against the single-process runs
    k1_mesh, k2_mesh = check_mesh_round(mesh)
    k1_paths.update(k1_mesh)
    k2_paths.update(k2_mesh)
    k1["plans"] = timed("k1-plans", phase_k1_plans, dev, hier)
    del hier
    torch.cuda.empty_cache()
    k1_paths.update({"hierarchical vgg16 packed qint8": 0, "gossip vgg16": 0})
    k3 = timed("decode-kernel", phase_decode_kernel, dev)
    w, k3["launches"] = timed("serve", phase_serve, dev)
    run = timed("serve-parity", phase_serve_parity, w)
    # qwen3-1.7b in bf16 on [serve]'s weights cast (K3 bf16; K5 bf16 in
    # the long prefill)
    bf16_serve = {ZOO_ARCH: timed("serve-bf16", phase_serve_bf16, dev, smi,
                                  w, run)}
    del w, run                            # free qwen3 before rwkv6's build
    torch.cuda.empty_cache()
    fl_round = start_fl_round_dryrun()     # host only, runs alongside
    k5, k6, attn_zoo = timed("attention-kernels", phase_attention_kernels,
                             dev)
    k4 = timed("decode-dense", phase_decode_dense, dev)
    k7 = timed("wkv-kernel", phase_wkv_kernel, dev)
    w, k7["launches"] = timed("serve-rwkv6", phase_serve_rwkv6, dev)
    timed("serve-rwkv6-parity", phase_serve_rwkv6_parity, w)
    bf16_serve["rwkv6-3b"] = timed("serve-rwkv6-bf16",
                                   phase_serve_rwkv6_bf16, dev, smi, w)
    del w
    _free_card("serve-rwkv6")

    # hymba-1.5b served (K3 at a GQA group of 5; K5 in the long prefill)
    hymba, hymba_ran = timed("serve-hymba", phase_serve_hymba, dev)
    timed("serve-hymba-parity", phase_serve_hymba_parity, hymba, hymba_ran)
    k3_paths = {"serve qwen3-1.7b": k3["launches"]}
    k3_paths.update({f"serve hymba-1.5b {t}": c["K3"]
                     for t, (_, c, _, _) in hymba.items()})
    k5_serve = {"serve hymba-1.5b long prefill": hymba["long"][1]["K5"]}
    k5_bf16_serve = {}
    # hymba-1.5b in bf16 on those weights cast (K3 bf16 at a GQA group of
    # 5 on pages and wrapped rings, K5 bf16 in the long prefill)
    bf16_serve[HYMBA_ARCH] = timed("serve-hymba-bf16", phase_serve_hymba_bf16,
                                   dev, smi, hymba, hymba_ran)
    del hymba, hymba_ran
    _free_card("serve-hymba")
    # granite-moe-1b-a400m served (K3 at a GQA group of 2; K5 in the long
    # prefill), the MoE dispatch in plain PyTorch
    moe_serve = timed("serve-moe", phase_serve_moe, dev)
    timed("serve-moe-parity", phase_serve_moe_parity, moe_serve)
    k3_paths.update({f"serve {MOE_ARCH} {t}": c["K3"]
                     for t, (_, c, _, _) in moe_serve.items()})
    k5_serve[f"serve {MOE_ARCH} long prefill"] = moe_serve["long"][1]["K5"]
    del moe_serve
    _free_card("serve-moe")
    # stablelm-3b served (K3 at head dim 80), then whisper-medium through
    # the static loop (K4 on every decode step, K5 in the encoder)
    k3_paths[f"serve {STABLELM_ARCH}"], w, run = timed(
        "serve-stablelm", phase_serve_stablelm, dev)
    bf16_serve[STABLELM_ARCH] = timed("serve-stablelm-bf16",
                                      phase_serve_stablelm_bf16, dev, smi, w,
                                      run)
    del w, run
    _free_card("serve-stablelm")
    whisper_serve = timed("serve-whisper", phase_serve_whisper, dev)
    k5_serve[f"serve {WHISPER_ARCH} encoder prefill"] = whisper_serve["K5"]
    # whisper-medium in bf16 on those weights and frames cast (K4 bf16 in
    # every decode step, K5 bf16 in the encoder)
    whisper_bf16 = timed("serve-whisper-bf16", phase_serve_whisper_bf16, dev,
                         smi, whisper_serve.pop("bf16_in"))
    k5_serve[f"serve {WHISPER_ARCH} bf16 encoder prefill"] = \
        whisper_bf16["K5"]
    k5_bf16_serve[f"serve {WHISPER_ARCH} bf16 encoder prefill in-run"] = \
        whisper_bf16["K5_in_run"]
    _free_card("serve-whisper")
    # internvl2-26b cut to 12 layers in fp32 through the static loop (K5 in
    # the prefill over 1,024 patches and 128 prompt tokens), then whole in
    # bf16 (K5 on the tensor-core source), held to fp32 on the 12 layers
    vlm_serve = timed("serve-vlm", phase_serve_vlm, dev, smi)
    k5_serve[f"serve {VLM_ARCH} prefill"] = vlm_serve["K5"]
    vlm_bf16 = timed("serve-vlm-bf16", phase_serve_vlm_bf16, dev, smi,
                     vlm_serve)
    k5_serve[f"serve {VLM_ARCH} bf16 prefill"] = vlm_bf16["K5"]
    for key in ("cfg", "params", "prompts", "patches", "tokens"):
        vlm_serve.pop(key)
    _free_card("serve-vlm-bf16")
    # gemma3-12b at full width through the paged engine (K3 at head dim
    # 256 on full and ring pages; K5 windowed and global in the long
    # prefill)
    gemma_serve, gemma_cases, gemma_long = timed(
        "serve-gemma3", phase_serve_gemma3, dev)
    k3_paths[f"serve {GEMMA_ARCH}"] = gemma_serve["serving"][0]["K3"]
    k3_paths[f"serve {GEMMA_ARCH} long"] = gemma_serve["long"][0]["K3"]
    k5_serve[f"serve {GEMMA_ARCH} long prefill"] = \
        gemma_serve["long"][0]["K5"]
    k3["cases"].update(gemma_cases)
    _free_card("serve-gemma3")
    # gemma3-12b in bf16 on those weights cast (K3 bf16 at head dim 256,
    # K5 bf16 windowed and global in the long prefill)
    bf16_serve[GEMMA_ARCH] = timed("serve-gemma3-bf16",
                                   phase_serve_gemma3_bf16, dev, smi,
                                   gemma_long)
    del gemma_long
    # the bf16 serving paths: K3's, K5's and K7's bf16 instances in models
    k7_paths = {"serve rwkv6-3b": k7["launches"]}
    for arch, runs in bf16_serve.items():
        for traffic, r in runs.items():
            path = f"serve {arch} bf16" + (" long" if traffic == "long"
                                           else "")
            bars = {k: r["bars"][k] for k in ("kernel vs plain", "bar",
                                              "fault vs plain", "rows")}
            if "K3" in r:
                k3_paths[path] = r["launches"]["K3"]
                k3.setdefault("bf16_in_run", {})[path] = dict(r["K3"],
                                                              bars=bars)
            if "K7" in r:
                k7_paths[path] = r["launches"]["K7"]
                k7["bf16_in_run"] = {path: dict(r["K7"], bars=bars)}
            if "K5" in r:
                k5_serve[f"{path} prefill"] = r["launches"]["K5"]
                k5_bf16_serve[f"{path} prefill in-run"] = r["K5"]
    k7["launches"] = sum(k7_paths.values())
    k7["launches_by_path"] = k7_paths
    _free_card("zoo")
    # the zoo: the round and the train step of the zoo LMs (K1, K2, K5, K6)

    dense, dense_run, dense_peak, dense_secs = timed(
        "zoo-round", phase_zoo_round, dev, smi)
    packed, packed_run, _, _ = timed("zoo-packed", phase_zoo_packed, dev,
                                     smi)
    gemma, gemma_run, gemma_peak, gemma_secs, gemma_args = timed(
        "zoo-train-step", phase_zoo_train_step, dev, smi)
    # the dry run of that same step on meta, held to its readings; then
    # the analysis gate's trace level on the card
    timed("dryrun", phase_dryrun, gemma_peak, gemma_secs, gemma_args, smi)
    analysis = timed("analysis", phase_analysis)
    timed("dryrun-fl-round", finish_fl_round_dryrun, fl_round)
    timed("zoo-parity", phase_zoo_parity, dev, None, ZOO_PARITY_S)
    timed("train-launcher", phase_train_launcher)
    hymba_counts, hymba_run, _, _ = timed(
        "zoo-round-hymba", phase_zoo_round_hymba, dev, smi)
    timed("zoo-parity-hymba", phase_zoo_parity_hymba, dev)
    timed("train-launcher-hymba", phase_train_launcher, HYMBA_ARCH, 2, 34,
          "train-launcher-hymba")
    # the MoE family's round (K1, K5/K6 at a GQA group of 2), then packed
    # with qint8 (K2 over the expert leaves' slot rows, no K1)
    moe_counts, moe_run, _, _ = timed("zoo-round-moe", phase_zoo_round_moe,
                                      dev, smi)
    pmoe_counts, pmoe_run, pmoe_peak, _ = timed(
        "zoo-packed-moe", phase_zoo_packed_moe, dev, smi)
    timed("zoo-parity-moe", phase_zoo_parity_moe, dev)
    timed("train-launcher-moe", phase_train_launcher, MOE_ARCH, 1, 26,
          "train-launcher-moe")
    # whisper-medium's round (K1; K5/K6 on the encoder and the decoder's
    # self- and cross-attention) and the 2-layer parities at head dim 64
    # (whisper, the padded non-causal route) and 80 (stablelm-3b)
    whisper_counts, whisper_run, whisper_peak, whisper_secs = timed(
        "zoo-round-whisper", phase_zoo_round_whisper, dev, smi)
    # the same round in bf16 (K1 bf16, K5/K6 bf16 on the padded non-causal
    # route and the causal one, the step bars)
    wbf16_counts, wbf16_run, k1_wbf16, wbf16_bars, _, _ = timed(
        "zoo-round-whisper-bf16", phase_zoo_round_whisper_bf16, dev, smi,
        (whisper_counts, whisper_run, whisper_peak, whisper_secs))
    timed("zoo-parity-whisper", phase_zoo_parity_whisper, dev)
    timed("zoo-parity-stablelm", phase_zoo_parity_stablelm, dev)
    # internvl2-26b's round cut to 2 layers (K1; K5/K6 over 1,024 patches
    # and 4,096 text tokens) and its 1-layer parity
    vlm_counts, vlm_run, _, _ = timed("zoo-round-vlm", phase_zoo_round_vlm,
                                      dev, smi)
    timed("zoo-parity-vlm", phase_zoo_parity_vlm, dev)
    # qwen3-1.7b's round in bf16 at 4 clients: K1's bf16 instance, K5/K6
    # bf16 forward and backward under remat, the step bars
    bf16_counts, bf16_run, k1_bf16, bf16_bars, _, _ = timed(
        "zoo-round-bf16", phase_zoo_round_bf16, dev, smi,
        (dense, dense_run, dense_peak, dense_secs))
    k1_plan = timed("k1-qwen3-plan", k1_qwen3_plan, dev, dense_run["K1"],
                    smi)
    k1_zoo_plans = timed("k1-zoo-plans", phase_k1_zoo_plans, dev, smi, {
        "hub hymba-1.5b": hymba_run, f"hub {WHISPER_ARCH}": whisper_run,
        f"hub {MOE_ARCH}": moe_run, f"hub {VLM_ARCH}": vlm_run})
    groups = {"build": ("build", "build-rest"),
              "paper (kernel .. k1-plans)": (
                  "kernel", "parity", "round", "round-repeat", "codec-kernel",
                  "packed-round", "codec-rounds", "paper-tasks",
                  "paper-tasks-parity", "hier-round", "gossip-round",
                  "scored-round", "scored-packed", "ckpt-resume",
                  "async-round", "cohort-round", "chaos", "engine-resume",
                  "k1-plans"),
              "the mesh (client shards, expert-parallel MoE, K1 plans)": (
                  "mesh-round", "moe-ep", "k1-zoo-plans"),
              "kernels and qwen3 / rwkv6 serving": (
                  "decode-kernel", "serve", "serve-parity",
                  "attention-kernels", "decode-dense", "wkv-kernel",
                  "serve-rwkv6", "serve-rwkv6-parity"),
              "hymba-1.5b": ("serve-hymba", "serve-hymba-parity",
                             "zoo-round-hymba", "zoo-parity-hymba",
                             "train-launcher-hymba", "k1-qwen3-plan"),
              MOE_ARCH: ("serve-moe", "serve-moe-parity", "zoo-round-moe",
                         "zoo-parity-moe", "train-launcher-moe"),
              "stablelm-3b, whisper-medium": (
                  "serve-stablelm", "serve-whisper", "zoo-round-whisper",
                  "zoo-parity-whisper", "zoo-parity-stablelm"),
              "internvl2-26b": ("serve-vlm", "zoo-round-vlm",
                                "zoo-parity-vlm"),
              "qwen3-1.7b round in bf16": ("zoo-round-bf16",),
              "qwen3-1.7b zoo, gemma3 train step": (
                  "zoo-round", "zoo-packed", "zoo-train-step", "zoo-parity",
                  "train-launcher"),
              "gemma3-12b served, internvl2-26b in bf16, granite packed": (
                  "zoo-packed-moe", "serve-vlm-bf16", "serve-gemma3"),
              "dry run and analysis": ("dryrun", "analysis",
                                       "dryrun-fl-round"),
              "bf16 serving (qwen3, rwkv6, stablelm, gemma3)": (
                  "serve-bf16", "serve-rwkv6-bf16", "serve-stablelm-bf16",
                  "serve-gemma3-bf16"),
              "hymba-1.5b and whisper-medium in bf16": (
                  "serve-hymba-bf16", "serve-whisper-bf16",
                  "zoo-round-whisper-bf16")}
    check(sorted(sum(groups.values(), ())) == sorted(walls),
          f"wall groups {sorted(sum(groups.values(), ()))} vs phases "
          f"{sorted(walls)}")
    print("[zoo] wall seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                             walls.items())
          + "; by group: " + ", ".join(
              f"{g} {sum(walls[t] for t in tags):.1f}"
              for g, tags in groups.items()))
    zoo = zoo_kernel_rows(smi, dense_run, packed_run, gemma_run,
                          attn_zoo, hymba_run, k1_plan, moe_run, vlm_run)
    name = torch.cuda.get_device_name(0)
    for path, row in k1_zoo_plans.items():
        zoo["K1"].setdefault(path, {}).update(row)
        print(f"[zoo-kernels] K1 {path} plan T={row['T']} C={row['C']}: "
              f"in-run {row['in_run_ms']:.4f} ms, alone {row['ms']:.4f} ms, "
              f"plain {row['plain_ms']:.4f} ms, torch.bmm + guard "
              f"{row['library_ms']:.4f} ms; alone, live planes "
              f"{row['live_planes']:.3f} a row, bound of the live planes "
              f"{row['bound_ms']:.4f} ms (kernel at "
              f"{row['bound_ms'] / row['ms']:.1%}), of every plane "
              f"{row['bound_all_planes_ms']:.4f} ms (at "
              f"{row['bound_all_planes_ms'] / row['ms']:.1%}) on {smi}")
    zoo["K2"][f"hub {MOE_ARCH} packed qint8"] = {
        "elements": pmoe_run["K2"]["elements"],
        "in_run_ms": pmoe_run["K2"]["ms"], "ms": pmoe_run["K2"]["alone_ms"],
        "plain_ms": pmoe_run["K2"]["plain_ms"], "library_ms": None,
        "bound_ms": pmoe_run["K2"]["bound_ms"], "bound_by": "bytes",
        "peak_GB": pmoe_peak / 1e9}
    print(f"[zoo-kernels] K2 hub {MOE_ARCH} packed qint8, one grouped launch "
          f"over {pmoe_run['K2']['elements']:,} slot elements: in-run "
          f"{pmoe_run['K2']['ms']:.4f} ms, alone "
          f"{pmoe_run['K2']['alone_ms']:.4f} ms, plain "
          f"{pmoe_run['K2']['plain_ms']:.4f} ms, bound "
          f"{pmoe_run['K2']['bound_ms']:.4f} ms, kernel at "
          f"{pmoe_run['K2']['bound_ms'] / pmoe_run['K2']['ms']:.1%} of the "
          f"bound on {name}")
    k1_paths["hub qwen3-1.7b"] = dense["K1"]
    k1_paths["hub hymba-1.5b"] = hymba_counts["K1"]
    k1_paths[f"hub {MOE_ARCH}"] = moe_counts["K1"]
    k1_paths[f"hub {MOE_ARCH} packed qint8"] = pmoe_counts["K1"]
    k1_paths[f"hub {WHISPER_ARCH}"] = whisper_counts["K1"]
    k1_paths[f"hub {VLM_ARCH}"] = vlm_counts["K1"]
    k1_paths.update(analysis["K1"])
    k2_paths.update(analysis["K2"])
    k3_paths.update(analysis["K3"])
    k3["launches"] = sum(k3_paths.values())
    k3["launches_by_path"] = k3_paths
    k1_paths["hub qwen3-1.7b packed qint8"] = packed["K1"]
    k2_paths["hub qwen3-1.7b packed qint8"] = packed["K2"]
    k2_paths["hub qwen3-1.7b"] = dense["K2"]
    k2_paths[f"hub {MOE_ARCH} packed qint8"] = pmoe_counts["K2"]
    for k, paths in ((k1, k1_paths), (k2, k2_paths)):
        k["launches"] = sum(paths.values())
        k["launches_by_path"] = paths
    zoo_paths = (("hub qwen3-1.7b", dense), ("hub qwen3-1.7b packed qint8",
                                             packed),
                 ("train step gemma3-12b macro block", gemma),
                 ("hub hymba-1.5b", hymba_counts),
                 (f"hub {MOE_ARCH}", moe_counts),
                 (f"hub {MOE_ARCH} packed qint8", pmoe_counts),
                 (f"hub {WHISPER_ARCH}", whisper_counts),
                 (f"hub {VLM_ARCH}", vlm_counts),
                 ("hub qwen3-1.7b bf16", bf16_counts),
                 (f"hub {WHISPER_ARCH} bf16", wbf16_counts))
    for k, keys in ((k5, ("K5",)), (k6, ("K6 dq", "K6 dkv"))):
        paths = {p: sum(c[x] for x in keys) for p, c in zoo_paths}
        if k is k5:
            paths.update(k5_serve)
        paths["attention-kernels (direct calls)"] = k["launches"]
        k["launches"] = sum(v for p, v in paths.items()
                            if not p.startswith("attention-kernels"))
        k["launches_by_path"] = paths
    for kind in ("K5", "K6"):
        zoo[kind][f"hub {WHISPER_ARCH} B=1 S={TRAIN_S} in-run"] = {
            f"{where}_ms": whisper_run[f"{kind} {where} ms"]
            for where in ("enc", "self", "cross")}
    for kind in ("K5", "K6"):
        zoo[kind][f"hub qwen3-1.7b bf16 B=1 S={TRAIN_S} in-run"] = {
            "in_run_ms": bf16_run[kind]["ms"],
            "bound_ms": bf16_run[kind]["bound_ms"],
            "bound_by": bf16_run[kind]["bound_by"],
            "launches": (bf16_counts["K5"] if kind == "K5" else
                         bf16_counts["K6 dq"] + bf16_counts["K6 dkv"]),
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention_sm90.cu"}
    for kind in ("K5", "K6"):
        zoo[kind][f"hub {WHISPER_ARCH} bf16 B=1 S={TRAIN_S} in-run"] = dict(
            {where: wbf16_run[f"{kind} {where}"]
             for where in ("enc", "self", "cross")},
            source="src/repro_torch/kernels/flash_attention/csrc/"
                   "flash_attention_sm90.cu")
    k6["bf16_step_bars"] = {"hub qwen3-1.7b bf16": bf16_bars,
                            f"hub {WHISPER_ARCH} bf16": wbf16_bars}
    k1["zoo"], k2["zoo"], k5["zoo"], k6["zoo"] = (
        zoo["K1"], zoo["K2"], zoo["K5"], zoo["K6"])
    # K1's bf16 instance: its main path is the bf16 round's aggregate
    k1_bf16.update(
        name="masked_agg (bf16)", route="cuda",
        source="src/repro_torch/kernels/masked_agg/csrc/masked_agg.cu",
        replaces="src/repro/kernels/masked_agg/kernel.py:41",
        entry_point="masked_agg_bf16",
        launches=bf16_counts["K1"] + wbf16_counts["K1"],
        launches_by_path={"hub qwen3-1.7b bf16": bf16_counts["K1"],
                          f"hub {WHISPER_ARCH} bf16": wbf16_counts["K1"]},
        bound_by="bytes")
    k1_wbf16.update(in_run_ms=wbf16_run["K1"]["ms"],
                    in_run_bound_ms=wbf16_run["K1"]["bound_ms"])
    k1_bf16["plans"] = {f"hub {WHISPER_ARCH} bf16": k1_wbf16}
    # K5 at internvl2-26b's serving prefill: (8, 1,152, 48 over 8, 128),
    # fp32 on the SIMT source and bf16 on the tensor-core one
    s_vlm = 1024 + VLM_PROMPT
    k5.setdefault("cases", {})[
        f"serve {VLM_ARCH} prefill B={VLM_BATCH} S={s_vlm}"] = \
        vlm_serve["case"]
    k5["cases"][f"serve {VLM_ARCH} bf16 prefill B={VLM_BATCH} S={s_vlm}"] = \
        vlm_bf16["case"]
    k5["cases"].update(k5_bf16_serve)
    # K4's main path is whisper's decode step; [decode-dense]'s direct
    # calls are listed beside it
    k4["launches"] = whisper_serve["K4"] + whisper_bf16["K4"]
    k4["launches_by_path"] = {
        f"serve {WHISPER_ARCH}": whisper_serve["K4"],
        f"serve {WHISPER_ARCH} bf16": whisper_bf16["K4"],
        "decode-dense (direct calls)": k4.pop("direct_launches")}
    k4["bf16_in_run"] = {f"serve {WHISPER_ARCH} bf16": dict(
        whisper_bf16["K4_in_run"],
        bars={k: whisper_bf16["bars"][k] for k in (
            "kernel vs plain", "bar", "fault vs plain", "rows")})}
    print(f"[smoke] {time.perf_counter() - t_start:.1f} s of wall in all, "
          f"the build included")
    print(smi)
    print(json.dumps({"kernels": [k1, k2, k3, k4, k5, k6, k7, k1_bf16]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
