#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``device`` — the card's name and power limit (``nvidia-smi``), and the
   torch, CUDA and nvcc versions.
2. ``build`` — builds every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once) and reports the seconds taken
   and each kernel's registers and spills.
3. ``kernels`` — each kernel against its plain PyTorch version on the
   card, over a sweep of edge cases and at the full-width shapes of its
   path (the prediction bins; the training steps of ``train_path`` for
   ``segment_aggregate``, ``segment_scatter``, ``segment_gather`` and
   ``dense_aggregate``; ``lm_path``'s serving run for ``flash_attention``,
   at prefill and at decode, and ``ssd_scan``), and every
   ``autograd.Function``'s backward on the card against the same backward
   on the CPU. The LM stack's two kernels are swept in float32 and
   bfloat16: grouped heads, windows, the ring cache's negative key
   offset, fully masked rows, head dims 16 to 128, query tiles around
   the tensor-core path's 64 and 128 rows, one-row decode over one and
   several key splits and with no kept key, the non-causal calls of a
   cross layer (text rows over vision keys, a one-row step over 1,600
   keys) and of an encoder (a ragged last key tile); ragged chunks, sequences
   shorter than a chunk, an initial state, B/C per group, a d_state whose
   shared memory makes the float32 scan halve its chunk, and the edges of
   the scan's bf16 tensor-core kernel (S < 16, a last chunk that is not a
   multiple of 16, N = 128 at chunk 128, G = 2 with 4 heads, an initial
   state at 100x, steps with dt = 0, N and P not multiples of 8), every
   scan case at the float32 bar in both dtypes. The flash entry also
   carries each flash kernel's ptxas registers and spills, the counts of
   wgmma (HGMMA), TMA (UTMALDG) and mma.sync (HMMA, the bf16 route past
   D = 128) instructions in the built library (the run fails if any is 0,
   or if no ptxas report or no ``cuobjdump`` is found), the host µs of one
   decode call, the decode at shapes with more
   and with fewer CTAs than SMs under its split plan, under twice the
   plan's CTAs and under one split, and the same-function yardstick (SDPA's
   is_causal over the kept keys). The GAT kernels (``edge_softmax``,
   ``fused_gat_aggregate``) and their CSR build (``dst_csr``) are swept
   with the padding pile of a packed bin (562 and 2,048 masked edges at
   (0, 0)), a 1,200-edge hub, NaN in a padded source and on the pile, and
   B = 3; every case runs twice on a shared CSR and once on its own, the
   same bits required; their entries carry each kernel's time on the
   bin's shared CSR and building its own, the build alone, one bin's GAT
   kernels (the build and three layers of both) as one graph beside PR
   19's 0.0946 ms, and the atomics of each library's SASS (the run fails
   on a float one, as for ``segment_aggregate.cu``). The scan's entry
   carries each SSD kernel's ptxas registers and spills and the count of
   ``HMMA`` in its library (the run fails at 0), its dynamic shared
   memory a block and blocks an SM
   (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; the run fails below
   two at N = P = 64), its device µs by kernel, the float32
   FMA kernel timed on the same values, and, for the record, zamba2 at one
   sequence and mamba2-370m's N = 128 at lm_path's batch. The
   fused_mp_layer entry sweeps both node-phase routes (the tensor-core
   kernel's tile edges, the FMA kernel's odd widths and unaligned view,
   inf and NaN in x, in agg and in the weights), holds the full bin's ``split`` (GraphSAGE) and ``pre``
   (GCN, a [P] self scale) layers, and carries the route taken there, the
   node and edge phases' device µs, its bound at the TF32 and at the FMA
   peak, the ``HGMMA`` count of its library (the run fails at 0) and one
   float32 ``torch.mm`` of the node phase's product as its yardstick. The
   readout (``segment_readout``) and its gradient
   (``segment_readout_backward``) are swept over ``readout_cases`` (NaN in
   a real row, a column of NaN, ±inf, fractional masks, graphs of 800 and
   1,500 rows, ids in no order, a masked row inside the real ones, 40,000
   rows), every call twice with the same bits, NaN where the plain version
   puts it, and the route the kernel counted equal to ``readout_plan``'s;
   the readout's entry carries its bound over the real rows beside the
   bound over all rows, ``torch.segment_reduce`` mean plus max as a
   two-call yardstick, and its library's SASS atomics (the run fails on a
   float one); the gradient's entry carries the composition it replaced
   (two gathers and a scatter), timed in this run at the packed training
   step and at P=1024. Then the kernel's time (a
   CUDA graph of 20 back-to-back wrapper calls, replayed; median over many
   replays, per call), the plain version's time, one library call's time
   where one computes the same function, the least time the card could
   take (``bound_ms``) and the device µs of each CUDA kernel it launches
   (``torch.profiler``). Those times are warm: the replays find their
   buffers in L2. The gather, ``dense_aggregate`` and their library calls
   are also timed cold (``time_cold_ms``: a graph over copies of the
   inputs and outputs, 150 MB or more), the times the bytes bound
   applies to; ``dense_aggregate`` also on a random 10 % and an all-ones
   adjacency beside ``torch.bmm``.
4. ``main_path`` — ``DIPPM.from_params`` at the paper's width (GraphSAGE,
   packed, hidden 512, 3 + 3 blocks, random weights from a seed):
   ``warmup(rungs="all")``, seeded ``repro.opgraph.v1`` documents through
   ``predict_json`` / ``predict_many`` (the default ``PredictionService``),
   and a bulk of synthetic samples through ``engine().predict_samples``.
   The kernels' launch counts are zeroed before and read after, and must
   equal bins × layers; every fused_mp_layer launch must take the
   tensor-core route and every readout the runs route (the kernel's
   route counters). The card's predictions are held against the same
   ``DIPPM`` on ``device="cpu"``, which runs the plain versions.
5. ``gat_path`` — the same for GAT at the paper's width: each bin builds
   one destination-sorted CSR (``dst_csr``, once a bin) and every layer
   launches ``edge_softmax`` and ``fused_gat_aggregate`` once on it; the
   run fails unless every one of those launches used the bin's shared
   CSR, and unless the bulk's predictions repeat bit for bit.
6. ``serving`` — ``dippm.serve()`` on the GAT model answers a burst of
   ``submit_json`` requests from 8 threads, unique and repeated documents
   mixed: every future resolves, the counters conserve, cache hits are
   bit-equal to the cold prediction and every answer matches the direct
   engine's; p50/p99 latency and the hit rate are printed; every GAT
   kernel launch must have used its bin's shared CSR.
7. ``engine_layouts`` — GraphSAGE and GAT at the paper's width, from the
   packed path's seed-0 parameters, through the bucketed engine on
   ``layout="dense"`` and ``"sparse"`` (``DIPPM.from_params``, its
   default engine's ``warmup``, ``predict_many`` of the six documents and
   ``predict_samples`` of the 400 graphs): each held against the CPU's
   plain versions and against the card's packed engine at 1e-3 + 1e-3,
   its launches zeroed before and held to ``layout_launch_rule`` after
   (B7 once a layer a chunk on dense GraphSAGE, B5's aggregate on sparse
   GraphSAGE, B5's gather, B3 on its own CSR and B6 on sparse GAT, no
   kernel on dense GAT, never B1); ``EngineStats``, ms per chunk,
   predictions/s, the device busy ms a chunk, the staged bytes of a full
   chunk; and B7, B5's aggregate and B6 (F = 512) on the bucket-256 ×
   64 chunk against their plain versions, timed beside their bound,
   ``torch.bmm`` (B7) and a flattened ``index_add_`` (B6, warm and cold)
   (the kernels entries' ``inference_chunk``).
8. ``bf16`` — torch's bfloat16 rounding on this host's CPU against the
   integer round to nearest even (2^20 random patterns, ties,
   subnormals, ±inf); GraphSAGE and GAT predictors trained on the card
   as ``benchmarks/fused_mp.py`` trains its own, served by packed bf16
   engines on the main path's inputs: MAPE against float32 at most
   0.5 %, the CPU's bf16 run at 1e-3 + 1e-3, launches against bins ×
   layers, ``bf16_max_abs_delta``, bulk ms a bin in turns with float32,
   a full bin's float buffer bytes and upload ms in both, and two bf16
   artifacts through ``DIPPM.load`` (float32 weights: the engine's
   predictions; bfloat16 weights: the CPU's load's).
9. ``fleet`` — ``ServeConfig(replicas=2)`` and ``4`` on the one card
   (every replica on it, each on its own stream): an atomic
   ``predict_many`` of the serving documents, GAT bit-equal to one
   engine of the same plan and GraphSAGE within 1e-5 + 1e-5, every
   replica taking bins, launches on bins × layers; a
   ``FailureInjector`` kill of replica 0 mid-burst (no lost future, a
   requeue, the counters conserve), its revival by a breaker probe, and
   heartbeats of every replica; bins/s and p50/p99 at 1, 2 and 4
   replicas in turns, at the engine level and through the service.
10. ``train_path`` — ``train_pmgns`` on the card at the paper's Table 3
   settings over 400 synthetic graphs: GraphSAGE on the dense layout and
   on the packed one for 2 epochs each, each against the same run on the
   CPU's plain versions (per-epoch loss, the first step's gradients, the
   final parameters); one dense epoch with dropout 0.05; one packed GAT
   epoch; one sparse GraphSAGE epoch at depth 2. Every run's launch
   counts are zeroed before and must equal ``train_launch_rule`` after
   (a packed step: one readout and one readout gradient launch).
   It prints ms per step, steps/s and the host share of a step, and
   reloads the trained model through ``save_artifact`` / ``DIPPM.load``
   to hold one served bin against the trainer's own evaluation.
11. ``train_dp`` — ``TrainConfig(data_parallel=True)`` at train_path's
   settings, one epoch each of dense GraphSAGE and of sparse GraphSAGE at
   depth 2. World 1 over NCCL in this process (the default group given
   its rank and a ``file://`` store, ``cpu:gloo,cuda:nccl``), in turns
   with the single-device run (single, data-parallel, data-parallel,
   single): every run's parameters and losses bit-equal to the first
   single run's, launches on ``train_launch_rule``, ms per step in turns;
   the gradient all-reduce's device µs per step (``torch.profiler``, the
   NCCL kernels) and one all-reduce of the gradient's size timed alone;
   ``compressed_grad_allreduce`` on one real dense step's gradients, the
   card's bits against the CPU's. World 2 over ``gloo``: two spawned
   processes on the one card, gradients staged through the host; losses
   within 1e-4 relative of world 1, parameters within the trainer's bar
   save for Adam noise, both ranks the same bits, ms per step (not a
   scaling number). With two or more cards, NCCL with a rank a card under
   the same checks; else ``"multi_card": "one card"``. Every child is
   joined by a deadline and killed past it; a failed or hung child fails
   the phase.
12. ``zoo_path`` — the graph sources on the card: one ``family_variants``
   draw (seed 0) of each of the 11 zoo families at its Table-2 size and
   a ``variant_grid`` sweep (ViT depth × width × batch) traced on the
   meta device (host ms per trace, nodes per graph; each draw's raw node
   count the reference tracer's, ``ZOO_REF_RAW_NODES``); their labels from
   the cost model on both devices (finite, positive, the same twice);
   ``build_dataset(36, seed 0, convnext held out)``, a save and load
   round trip bit for bit, and one packed GraphSAGE training epoch at
   ``train_path``'s settings on the train split (loss within the
   trainer's bar of the CPU's, launches on ``train_launch_rule``);
   ``DIPPM.predict_zoo`` on the sweep and ``predict_many`` on the draws
   at full width, GraphSAGE and GAT, packed, against the CPU's plain
   versions at 1e-3 + 1e-3 with launches on bins × layers (GAT's B3 and
   B4 every one on the bin's shared CSR), predictions/s and ms per bin;
   and ``submit_torch`` through a started service, the same bits as
   ``predict_torch`` on a zoo forward and on a user ``nn.Module``.
13. ``factory`` — the dataset factory (``repro_torch.dataset.factory``)
   on the host, then its records on the card: a plan of 48 zoo graphs
   (shards of 16, seed 0, convnext held out) and one LM entry of each of
   nine archs the port traces (59 records, 4 shards; deepseek-v2 and
   grok-1 through the MoE and MLA graph forms, llama-3.2-vision with its
   vision memory spec; hubert-xlarge, which the JAX package's factory
   cannot trace, is left out), its
   hash ``FACTORY_PLAN_HASH``, built by two spawned worker processes;
   a copy of it that lost its last shard and the manifest resumed in the
   script's process (one shard built, the rest reused), every shard's
   sha256 equal to the first build's, and whether
   they equal the JAX package's (``FACTORY_REF_SHA256``) printed, not
   required; the records streamed with ``verify=True`` and split by
   fingerprint; packed GraphSAGE at hidden 512 trained two epochs on the
   train split (losses within 1e-4 relative of the CPU's, launches on
   ``train_launch_rule``: B2 and its gradient once a step); the test
   split, and apart the eight LM records, predicted on the card against
   the CPU at 1e-3 + 1e-3, B1 and B2 launches on bins × layers; host ms
   of an LM entry's trace against a zoo entry's; at each LM entry's
   attention and SSD shapes, B8 and B9 on the card against the graph
   forms (the JAX package's jnp steps) run on the card, float32, 1e-4
   relative (deepseek-v2's attention at MLA's full-sequence dims, D 24
   over Dv 16; llama-3.2-vision's cross layer, not causal, over its 16
   vision keys); at each MoE entry's tokens, the MoE block's graph form
   against its serving form on the card, at the config's capacity factor
   and at 0.5, the same expert ids and keep masks, output and aux loss
   within 1e-4 of their scale. The line carries build seconds,
   records/s, the sidecars' and the host's peak RSS, shards reused, the
   plan hash, each LM record's arch, batch, seq, nodes and fingerprint,
   and the launch counts.
14. ``lm_path`` — the LM stack serving zamba2-2.7b. Parity: at full width
   with the depth cut to 12 layers (2 groups), float32, weights from a
   seed, 2 prompts × 128 tokens through prefill and 16 greedy decode
   steps on the card against the same weights on the CPU: every step's
   logits within 1e-3 + 1e-3 relative and the same tokens. Then the full
   serving run: full width and depth in bfloat16, weights drawn on the
   card, 8 prompts × 512 tokens through ``make_prefill_step`` and 63
   ``make_serve_step`` calls (64 new tokens, ``max_len`` 576), the launch
   counts zeroed before and held to ``lm_launch_rule`` after (flash
   9 × 64, the scan 54); finite logits and caches; prefill ms, decode ms
   per step, tokens/s, peak device memory, parameter and cache bytes, and
   the device time of one prefill and one decode step by kernel.
15. ``lm_moe_path`` — the mixture-of-experts and MLA archs. Parity: the
   smoke configs of deepseek-v2 (MLA, a dense layer 0, eight experts top-2
   and a shared one) and grok-1 (GQA, four experts top-2) in float32, the
   same weights on the card and the CPU: ``forward``'s logits and aux loss
   within 1e-4 + 1e-4, a prefill and 12 greedy decode steps with every
   step's logits within the same bar and the same tokens, and every MoE
   layer's expert ids and keep mask equal (replicas are dropped, decode at
   B = 2 runs deepseek's experts at capacity 1). B8 at MLA's head dims
   against its plain version in both dtypes (``MLA_FLASH_SWEEP``: D / Dv
   24 / 16, 40 / 32, 192 / 128, 576 / 512; one row and many; one latent kv
   head under 128 query heads, GQA, query offsets, a part-filled decode
   group), and grok-1's own prefill and decode calls of the full run (4 ×
   512 queries over 528 cached rows, 48 heads over 8, D 128), each held
   in both dtypes. Then deepseek-v2 cut
   to 3 layers (the dense layer 0 and two MoE layers) and grok-1 cut to 2,
   full width in bfloat16, weights drawn on the card, one after the other
   with memory freed between: 4 prompts × 512 tokens through
   ``make_prefill_step`` and 15 ``make_serve_step`` calls (16 new tokens),
   the launch counts zeroed before and held to ``lm_launch_rule`` after (a
   flash launch a layer a step; the prefill's alone read after it); finite
   logits and caches, tokens in the vocabulary; prefill ms, decode ms per
   step, peak memory and the device time of one prefill and one decode
   step by kernel. Last, B8 at deepseek-v2's weight-absorbed prefill and
   decode shapes (q [4, S, 128, 576] over the latent cache [4, 528, 1,
   576], v its first 512 columns) against its plain version, timed beside
   its bound, the plain version and SDPA with ``enable_gqa``: the
   ``flash_attention_mla_prefill`` and ``flash_attention_mla_decode``
   entries of the ``kernels`` line, with the full run's launches.
16. ``lm_vision_audio_path`` — cross-attention and the audio frontend.
   Parity: the smoke configs of llama-3.2-vision (two groups of a self
   layer and a cross layer over a 16-row vision memory) and hubert-xlarge
   (two bidirectional layers over audio frames) in float32, the same
   weights and inputs on the card and the CPU: llama's ``forward``, a
   prefill (which seeds the cross K / V from the memory) and 12 greedy
   decode steps, every step's logits within 1e-4 + 1e-4 and the same
   tokens; hubert's ``make_encode_step`` logits within the same bar.
   Then llama-3.2-vision-11b at full width and depth (40 layers, 8 of them
   cross layers over a [4, 1600, 4096] seeded memory) in bfloat16,
   weights drawn on the card, 4 prompts × 512 tokens through
   ``make_prefill_step`` and 15 ``make_serve_step`` calls, the launches
   zeroed before and held to ``lm_launch_rule`` after and counted by shape
   (the cross layers' prefill and decode calls apart); finite logits and
   caches; prefill ms, decode ms a step, peak memory, the device time of
   one prefill and one step by kernel. hubert-xlarge at full width and
   depth (48 layers) in bfloat16 encodes 4 clips of 1,500 frames through
   ``make_encode_step``: 48 launches, finite logits [4, 1500, 504], encode
   ms and device ms by kernel. Last, B8 at the three new shapes, none
   causal (``VISION_AUDIO_FLASH``: q [4, 512, 32, 128] over 1,600 vision
   keys of 8 heads, its one-row decode, and hubert's [4, 1500, 16, 80]),
   held to its plain version in bfloat16 and, at batch 1, in float32,
   timed beside its bound, the plain version and SDPA with ``enable_gqa``:
   the ``flash_attention_cross_prefill``, ``flash_attention_cross_decode``
   and ``flash_attention_encoder`` entries of the ``kernels`` line, with
   the full runs' launches.
17. ``lm_train`` — LM training through the flash kernels: (a)
   ``flash_attention_bwd`` and the forward's log-sum-exp against their
   plain versions on the card (qwen2.5-3b's heads at 4 × 1024 causal,
   h2o-danube's 32 over 8 at D = 120 with window 256, a padded length, a
   query offset, rows with no kept key, not causal; and ``WIDE_BWD_CASES``:
   MLA's D 24 / Dv 16 and D 192 / Dv 128, its rows with no kept key, D =
   Dv = 192, a cross layer's 200 rows over 320 keys with GQA 4, an
   encoder's ragged 150 rows at D 80), float32 within 1e-5 and bf16
   within 2e-2 of each gradient's largest magnitude, every case twice with
   the same bits; timed beside its bound, its plain version and SDPA's
   forward + backward (``is_causal``; measured only, never on the path);
   (b) qwen2.5-3b at full width, depth 2, float32, 2 × 128 tokens, two
   ``make_train_step`` steps on the card against the CPU's plain versions
   (losses within 1e-4 relative, parameters on ROADMAP §C's bar); (c) the
   full model, bf16, ``default_optimizer()``, ``remat=True``, 4 × 1024
   tokens: ms per step, tokens/s, peak memory, the device-busy share, the
   backward's µs per launch, and the flash launches held to
   ``lm_train_launch_rule``. The parity runs' CPU reference steps skip
   the recomputation (remat changes no value) and the bar is read on the
   card.
18. ``lm_train_wide`` — training MLA, MoE, cross-attention and the audio
   frontend: the wide cases of ``lm_train``'s sweep; the smoke configs of
   deepseek-v2, grok-1, llama-3.2-vision and hubert-xlarge in float32, two
   AdamW steps on the card against the CPU (losses within 1e-4, parameters
   on ROADMAP §C's bar, the first step's expert ids and keep masks equal,
   launches on ``lm_train_launch_rule``); deepseek-v2 at full width cut to
   2 layers (dense and MoE, both MLA; 5.36 B parameters), llama-3.2-vision
   cut to one group of 4 self layers and a cross layer over a [2, 1600,
   4096] memory, hubert-xlarge at full depth over [4, 1500, 1280] frames,
   each bf16, ``default_optimizer()``, remat, one warm-up and two steps:
   finite losses and aux losses, launches on the rule (llama's also by
   shape), ms a step, tokens/s, peak memory, busy share, device ms by
   kernel. grok-1 is held by its parity run only: at one layer, full
   width, its parameters, gradients, states and the update's new
   parameters and states need 91 GB. Last, the ``kernels`` entries of B8's
   forward with lse at MLA's full-sequence shape and of 8′ at the three
   new shapes (MLA's, the cross layer's, hubert's), bf16, against their
   plain versions on the card, timed beside their bounds, the plain
   versions and SDPA.
19. ``accuracy`` — the paper's accuracy protocol on the card, the JAX
   package's CI gate (``benchmarks/accuracy_mape.py``) run by the port:
   the gate's plan (320 zoo graphs, convnext held out, qwen2.5-3b and
   mamba2-370m traced, shards of 64; its hash ``ACCURACY_PLAN_HASH``,
   checked) built by the port's factory with ``min(8, cpu_count)`` spawned
   workers, coverage at least 0.95, a second build that reuses every
   shard; ``run_accuracy`` with the default ``AccuracyProtocol``
   (GraphSAGE-512, 30 epochs in chunks of 15) on the card at each seed of
   ``ACCURACY_SEEDS``, the first seed twice with the same report and
   parameters bit for bit. At the protocol's 100x learning rate one run
   is one draw of a wide spread (the unseen split holds 6 graphs), so the
   gate reads the median over the seeds, and holds it to the JAX
   package's median over the same seeds on the same plan
   (``ACCURACY_REFERENCE``, written by ``scripts/accuracy_seeds.py
   --package jax --out`` on the CPU): each head's median on the test and
   unseen splits at most ``max(ref × rel, ref + abs)``, the JAX gate's
   rule with the tolerance of ``benchmarks/baselines/accuracy_mape.json``
   (read, never written). That file's baseline is one run on the JAX
   gate's own machine, which the JAX package's runs here do not
   reproduce; the phase prints its verdict beside the gate's. It prints
   the splits, epochs, best epoch, convergence, every seed's heads, each
   median beside the reference's, the baseline and both bounds, the
   unseen family's MAPE per head, and the build and train seconds.

After ``accuracy`` it prints ``{"kernels": [...]}`` and the ``nvidia-smi``
name and power limit, and prints, as the last line,
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result; it also exits non-zero without a
CUDA device. It imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

#: NVIDIA H100 SXM data sheet, dense, at the 700 W power limit.
PEAK_F32_FLOPS = 67e12      # float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12    # TF32 on the tensor cores
PEAK_BF16_FLOPS = 989e12    # bfloat16 on the tensor cores
PEAK_BYTES = 3.35e12        # HBM3
#: kernel vs plain version on the card: the atomics and the product sum in
#: another order than the plain version (see the notes in csrc/*.cu)
KERNEL_ATOL = KERNEL_RTOL = 1e-4
#: the card's predictions vs the CPU's plain versions at full width: three
#: message-passing layers of depth up to 1024, a head of depth 1029, then
#: expm1, which turns an absolute error in log space into a relative one
E2E_ATOL = E2E_RTOL = 1e-3
#: each path's bulk sweep runs this many times; its time is the median
#: (host time on a machine that shares its CPU cores varies run to run)
BULK_REPEATS = 3
#: the serving burst: threads × requests each, drawn from a pool of
#: documents that all threads share (repeats) and documents of their own
SERVE_THREADS, SERVE_PER_THREAD, SERVE_SHARED = 8, 50, 16
#: seconds any one request of the burst may take before the run fails
SERVE_TIMEOUT = 120
#: full packed bin of the engine's default budgets (batching.py:372-405)
FULL_P, FULL_Q, FULL_G = 4096, 6656, 256
#: engine_layouts and bf16 drive these variants; engine_layouts times B5,
#: B6 and B7 on the bucketed engines' full chunk at this node bucket
LAYOUT_VARIANTS, CHUNK_BUCKET = ("graphsage", "gat"), 256
#: bf16 staging against float32: the reference's bar
#: (benchmarks/fused_mp.py:245-292), on a predictor trained as it trains
#: its own (samples, epochs, batch, learning rate)
BF16_MAPE_BAR = 0.005
BF16_TRAIN_SAMPLES, BF16_TRAIN_EPOCHS, BF16_TRAIN_BATCH, BF16_TRAIN_LR = (
    96, 20, 16, 1e-3)
#: fleet: GraphSAGE's edge phase adds with float atomics, so its fleet
#: results are held to the kill drill's bar of tests/test_serve.py:603-605
#: (GAT's must be bit-equal); the replica counts compared, the turns, the
#: atomic bursts a turn and the bulk sweeps a turn; the drill's breaker
#: cooldown and mean gap between arrivals
FLEET_ATOL = FLEET_RTOL = 1e-5
FLEET_REPLICAS, FLEET_TURNS, FLEET_BURSTS = (1, 2, 4), 2, 5
FLEET_BULK_REPEATS = 3
FLEET_COOLDOWN_S, FLEET_GAP_S = 0.5, 0.0005
#: train_path: the paper's width, batch and learning rate (Table 3) over
#: this many synthetic graphs of 16–200 nodes
TRAIN_HIDDEN, TRAIN_SAMPLES, TRAIN_BATCH, TRAIN_LR = 512, 400, 32, 2.754e-5
#: the card's training run vs the same run on the CPU's plain versions:
#: per-epoch loss (relative) and final parameters, the bar of
#: tests/test_trainer.py:255-276
TRAIN_LOSS_RTOL, TRAIN_PARAM_ATOL, TRAIN_PARAM_RTOL = 1e-4, 1e-4, 1e-3
#: Adam's step is about lr whatever the gradient's size, so an element
#: whose gradient is near zero takes steps whose signs float32 noise (the
#: two devices' summation orders) decides at some steps. Such an element
#: may leave the bar above: one whose first-step CPU gradient is below
#: TRAIN_NOISE_FLOOR of its leaf's largest, and then by no more than
#: TRAIN_NOISE_ATOL. At hidden 512 the elements outside the bar are 17
#: weights of the head's first two layers: 16 had a first-step gradient
#: of exactly 0 and one 5.2e-5 of its leaf's largest; the largest
#: distance was 2.5e-4.
TRAIN_NOISE_FLOOR, TRAIN_NOISE_ATOL = 1e-4, 5e-4
#: one step's gradients, card vs CPU, relative to each leaf's largest:
#: float32 sums in another order through 3 layers, the readout and the head
TRAIN_GRAD_RTOL = 1e-5
#: train_dp: seconds a collective waits for a missing rank, and seconds the
#: spawned ranks of a world may take before they are killed
DP_PG_TIMEOUT, DP_CHILD_TIMEOUT = 120, 300
#: the cold timings (``time_cold_ms``) cycle through copies of a call's
#: inputs and outputs until they hold at least this many bytes, three times
#: the H100's 50 MB L2, so that every call reads and writes device memory
COLD_BYTES = 150e6
#: a bfloat16 kernel against its plain version on the same bfloat16 inputs:
#: both sum in float32, then the output rounds to 8 mantissa bits
KERNEL_BF16_TOL = 2e-2
#: zoo_path: the ``variant_grid`` sweep it traces and predicts (ViT at
#: its default resolution 224 and patch 16), the dataset it builds
#: (graphs, seed, the held-out family) and the wall-time repeats of its
#: bins
ZOO_GRID = {"depth": [6, 12], "dim": [192, 384], "batch": [1, 8]}
ZOO_DATASET, ZOO_SEED, ZOO_HELD_OUT = 36, 0, ("convnext",)
ZOO_REPEATS = 3
#: zoo_path: the reference tracer's raw node count (``meta["n_raw_nodes"]``)
#: of each family's seed-0 draw, which the port's traces must equal
#: (``tests/test_torch_zoo.py`` holds these against the JAX package)
ZOO_REF_RAW_NODES = {
    "efficientnet": 540, "mnasnet": 336, "mobilenet": 352, "resnet": 223,
    "vgg": 43, "swin": 1280, "vit": 615, "densenet": 795, "visformer": 259,
    "poolformer": 285, "convnext": 529}
#: factory: the zoo-only plan it builds (graphs, shard size; seed and
#: held-out family as zoo_path's), its worker processes, and the packed
#: GraphSAGE epochs it trains on the plan's train split
FACTORY_GRAPHS, FACTORY_SHARD, FACTORY_WORKERS = 48, 16, 2
FACTORY_EPOCHS = 2
#: factory: the LM archs of its plan (one entry each at the default
#: ``lm_fraction``), the plan's hash (a function of the config alone:
#: ``tests/test_torch_factory.py`` holds it to the JAX package's plan of
#: :func:`factory_config`), and the shard sha256 that the JAX package's
#: build of the plan wrote once on an x86-64 Linux host's CPU, copied in
#: by hand: nothing in the repo derives them again, and zlib and libm of
#: another host may differ, so the phase prints the comparison and does
#: not require it
FACTORY_LM_ARCHS = ("qwen2.5-3b", "mamba2-370m", "zamba2-2.7b", "yi-34b",
                    "h2o-danube-3-4b", "chatglm3-6b", "deepseek-v2-236b",
                    "grok-1-314b", "llama-3.2-vision-11b")
FACTORY_PLAN_HASH = ("9dd36e6cb46d7d62ea5ae1e8721dcf07e50fbe672a9688e895"
                     "1fdd787d528bab")
FACTORY_REF_SHA256 = {
    "shard00000.npz":
        "66b8362487218b5d9f1a3a7cd113e5fa2a9d746f45f88eb85ed950ff73a7d467",
    "shard00001.npz":
        "5db074b5ecd7fdb07878bf465b1f2f2635670a27eacc7490b8a4d2135b41e0ba",
    "shard00002.npz":
        "7bdc4b17ca89f00c70d2a5ee0971013966ab7c1ccfaca2b1ae680c645434516f",
    "shard00003.npz":
        "44571da2880970c806307beac84e8b428d134da28b720c173bd7c3f25aa1cbf0"}
#: factory: the zoo entries whose trace it times beside the LM entries',
#: and the bar of B8 / B9 against the graph forms on the card (float32,
#: relative to the output's largest magnitude)
FACTORY_TIMED_ZOO, GRAPH_FORM_RTOL = 6, 1e-4
#: lm_path: the model it serves (full width; LM_SMOKE_WIDTH swaps in the
#: smoke config, for rehearsing the script on the CPU), the full serving run
#: (prompts × prompt length, new tokens; max_len their sum) and the parity
#: run against the CPU (depth, prompts × prompt length, decode steps)
LM_ARCH, LM_SMOKE_WIDTH, LM_SEED = "zamba2-2.7b", False, 0
LM_BATCH, LM_PROMPT, LM_NEW = 8, 512, 64
LM_PARITY_LAYERS, LM_PARITY_BATCH, LM_PARITY_PROMPT, LM_PARITY_STEPS = (
    12, 2, 128, 16)
#: lm_moe_path: the MoE and MLA archs at full width in bfloat16, (arch,
#: depth) cut to deepseek-v2's dense layer 0 and two MoE layers and to two
#: of grok-1's MoE layers, one after the other (prompts × prompt length,
#: new tokens); the parity run of both smoke configs in float32 against
#: the CPU (prompts × prompt length, greedy steps after the prefill) and
#: its bar (float32 sums in another order through 2–3 small layers)
MOE_ARCHS = (("deepseek-v2-236b", 3), ("grok-1-314b", 2))
MOE_BATCH, MOE_PROMPT, MOE_NEW = 4, 512, 16
MOE_PARITY_BATCH, MOE_PARITY_PROMPT, MOE_PARITY_STEPS = 2, 40, 12
MOE_PARITY_TOL = 1e-4
#: B8 at the MoE archs' head dims, (B, Sq, Skv, H, Hkv, D, Dv, causal,
#: q_offset[, scale]; the scale 1 / sqrt(3 D / 4) where none is given):
#: the MLA smoke config's two forms (24 / 16, 40 / 32), deepseek's full
#: sequence (192 / 128), its weight-absorbed cached form (576 / 512) over
#: one latent kv head under 128 query heads, GQA, query offsets, a decode
#: group of 5 rows (a part-filled 8-row group); and grok-1's own calls in
#: the full run, the prefill over the cache of MOE_PROMPT + MOE_NEW rows
#: and the last decode row, 6 query heads a kv head, scale 1 / sqrt(128)
MLA_FLASH_SWEEP = [
    (2, 1, 64, 4, 1, 40, 32, True, 41),
    (2, 40, 64, 4, 1, 40, 32, True, 0),
    (2, 40, 40, 4, 4, 24, 16, True, 0),
    (2, 1, 40, 4, 2, 24, 16, True, 39),
    (1, 77, 77, 8, 8, 192, 128, True, 0),
    (1, 130, 130, 4, 4, 192, 128, False, 0),
    (1, 1, 300, 16, 4, 192, 128, True, 299),
    (1, 60, 120, 8, 2, 192, 128, True, 50),
    (2, 1, 300, 128, 1, 576, 512, True, 290),
    (1, 70, 96, 128, 1, 576, 512, True, 20),
    (1, 1, 100, 8, 2, 576, 512, True, 99),
    (2, 1, 200, 10, 2, 192, 128, True, 150),
    (MOE_BATCH, MOE_PROMPT, MOE_PROMPT + MOE_NEW, 48, 8, 128, 128, True, 0,
     1 / np.sqrt(128)),
    (MOE_BATCH, 1, MOE_PROMPT + MOE_NEW, 48, 8, 128, 128, True,
     MOE_PROMPT + MOE_NEW - 1, 1 / np.sqrt(128)),
]
#: lm_vision_audio_path: llama-3.2-vision-11b at full width and depth in
#: bfloat16 (every fifth layer a cross layer over the vision memory;
#: VISION_LAYERS of its 40), prompts × prompt length with a seeded memory
#: [B, vision_tokens, vision_dim], new tokens; hubert-xlarge at full width
#: and depth encoding a 30 s clip at 50 frames a second (clips × frames);
#: the parity runs of both smoke configs reuse lm_moe_path's sizes and bar
VISION_ARCH, VISION_LAYERS = "llama-3.2-vision-11b", 40
VISION_BATCH, VISION_PROMPT, VISION_NEW = 4, 512, 16
AUDIO_ARCH, AUDIO_BATCH, AUDIO_FRAMES = "hubert-xlarge", 4, 1500
#: B8's entries at the two archs' full-run calls: name → (B, Sq, Skv, H,
#: Hkv, D, q_offset), none causal; the float32 check cuts B to 1
VISION_AUDIO_FLASH = {
    "flash_attention_cross_prefill": (VISION_BATCH, VISION_PROMPT, 1600, 32,
                                      8, 128, 0),
    "flash_attention_cross_decode": (VISION_BATCH, 1, 1600, 32, 8, 128,
                                     VISION_PROMPT + VISION_NEW - 1),
    "flash_attention_encoder": (AUDIO_BATCH, AUDIO_FRAMES, AUDIO_FRAMES, 16,
                                16, 80, 0),
}


#: accuracy: the JAX package's CI gate (``benchmarks/accuracy_mape.py``:
#: ``CI_N_GRAPHS``, ``LM_ARCHS``, ``MIN_COVERAGE``), the hash of its plan
#: (``tests/test_torch_factory.py`` holds it to the JAX package's), its
#: baseline file (read, never written) and the build's worker cap
ACCURACY_GRAPHS, ACCURACY_SHARD = 320, 64
ACCURACY_LM_ARCHS = ("qwen2.5-3b", "mamba2-370m")
ACCURACY_MIN_COVERAGE, ACCURACY_MAX_WORKERS = 0.95, 8
ACCURACY_PLAN_HASH = ("0b66d35b68ff5427f1d7fb1174f2b2d55c8928b0dd6fc16252f0"
                      "4974c235fab7")
ACCURACY_BASELINE = "benchmarks/baselines/accuracy_mape.json"
#: the protocol's seeds (split, initial draw, shuffle and dropout); the
#: gate holds each head's median over them to the bound around the JAX
#: package's median over the same seeds, read from ``ACCURACY_REFERENCE``
ACCURACY_SEEDS = (0, 1, 2, 3, 4)
ACCURACY_REFERENCE = "scripts/accuracy_jax_seeds.json"
ACCURACY_HEADS = ("mape_latency", "mape_energy", "mape_memory", "mape")
#: lm_train: the model it trains (full width; LM_SMOKE_WIDTH swaps in the
#: smoke config), the full run (batch × sequence, measured steps after one
#: warm-up), the parity run against the CPU (depth, batch × sequence,
#: steps, the AdamW rate) and the bars: the flash backward against its
#: plain version (float32: sums in another order over up to 1,024 keys;
#: bf16: the gradients round to 8 bits and the forward's bf16 output
#: enters delta), the parity run's losses (float32 through two layers and
#: a 151,936-wide head)
LM_TRAIN_ARCH, LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = (
    "qwen2.5-3b", 4, 1024, 3)
LM_TRAIN_PARITY_LAYERS, LM_TRAIN_PARITY_BATCH, LM_TRAIN_PARITY_SEQ = 2, 2, 128
LM_TRAIN_PARITY_STEPS, LM_TRAIN_PARITY_LR = 2, 1e-4
BWD_F32_TOL, BWD_BF16_TOL, LM_TRAIN_LOSS_RTOL = 1e-5, 2e-2, 1e-4
#: flash_attention_bwd.cu's kernels by profiler name (sum_kernel: the bf16
#: route's head splits' sum)
FLASH_BWD_KERNELS = ("delta_kernel", "dkdv_kernel", "dq_kernel", "sum_kernel")
#: lm_train's SSD archs: the full run (mamba2-370m, the accuracy plan's
#: other LM tracing: batch × sequence, LM_TRAIN_STEPS measured steps after
#: one warm-up), the parity runs against the CPU ((arch, depth): zamba2 at
#: 6, one shared-block application; batch × sequence: two chunks of 128,
#: the last one padded), the backward kernel's timed shapes (each arch's
#: heads and widths at batch × sequence, the model's chunk) and its bars
#: against the plain twin, of each gradient's largest magnitude (float32:
#: sums in another order; bf16: dx, dB and dC round to 8 bits at the end)
LM_SSD_TRAIN_ARCH, LM_SSD_TRAIN_BATCH, LM_SSD_TRAIN_SEQ = (
    "mamba2-370m", 8, 2048)
LM_SSD_PARITY = (("mamba2-370m", 2), ("zamba2-2.7b", 6))
LM_SSD_PARITY_BATCH, LM_SSD_PARITY_SEQ = 2, 192
SSD_BWD_ARCHS, SSD_BWD_BATCH, SSD_BWD_SEQ = (
    ("mamba2-370m", "zamba2-2.7b"), 8, 2048)
SSD_BWD_F32_TOL, SSD_BWD_BF16_TOL = 1e-4, 1e-2
SSD_GRADS = ("dx", "ddt", "dA", "dB", "dC", "ds0")
#: (B, Sq, Skv, H, Hkv, D, Dv, causal, window, q_offset, kv_offset); the
#: last six are lm_train_wide's (WIDE_BWD_CASES): MLA's head dims at smoke
#: and full width, the opt-in ceiling D = Dv = 192, a cross layer's text
#: rows over more vision keys, an encoder's ragged last tile
BWD_CASES = [
    (4, 1024, 1024, 16, 2, 128, 128, True, 0, 0, 0),    # qwen2.5-3b
    (2, 1024, 1024, 32, 8, 120, 120, True, 256, 0, 0),  # h2o-danube, window
    (2, 1000, 1000, 16, 2, 128, 128, True, 0, 0, 0),    # a padded length
    (1, 300, 700, 8, 2, 64, 64, True, 0, 400, 0),       # a query offset
    (1, 6, 8, 2, 1, 128, 128, True, 0, 0, 3),           # rows 0-2: no key
    (2, 77, 77, 4, 4, 80, 80, False, 0, 0, 0),          # not causal
    (2, 256, 256, 4, 4, 24, 16, True, 0, 0, 0),         # MLA, smoke width
    (1, 512, 512, 4, 4, 192, 128, True, 0, 0, 0),       # MLA, full width
    (1, 6, 8, 2, 2, 192, 128, True, 0, 0, 3),           # MLA, rows 0-2 dead
    (1, 130, 130, 2, 2, 192, 192, True, 0, 0, 0),       # D = Dv = 192
    (2, 200, 320, 8, 2, 128, 128, False, 0, 0, 0),      # cross, GQA 4
    (2, 150, 150, 4, 4, 80, 80, False, 0, 0, 0),        # encoder, ragged
]
WIDE_BWD_CASES = BWD_CASES[6:]
#: lm_train_wide: the archs it trains (parity: their smoke configs in
#: float32, LM_TRAIN_PARITY_STEPS AdamW steps at LM_TRAIN_PARITY_LR,
#: batch × sequence), the full-width runs ((arch, depth or None for the
#: config's, batch, sequence); bf16, default_optimizer(), remat, one
#: warm-up and WIDE_TRAIN_STEPS measured steps; not grok-1: at one layer
#: its 6.53 B parameters, their gradients, bf16 AdamW states and the
#: update's new parameters and states come to 91 GB, past the card's 80 GB,
#: so its training is held by its parity run only) and the kernels
#: entries at their shapes (B, Sq,
#: Skv, H, Hkv, D, Dv, causal, window, q_offset, kv_offset), each read
#: from its arch's run
WIDE_ARCHS = ("deepseek-v2-236b", "grok-1-314b", "llama-3.2-vision-11b",
              "hubert-xlarge")
WIDE_PARITY_BATCH, WIDE_PARITY_SEQ = 2, 64
WIDE_TRAIN = (("deepseek-v2-236b", 2, 2, 1024),
              ("llama-3.2-vision-11b", 5, 2, 1024),
              ("hubert-xlarge", None, 4, 1500))
WIDE_TRAIN_STEPS = 2
_MLA = (2, 1024, 1024, 128, 128, 192, 128, True, 0, 0, 0)
WIDE_FLASH = [
    ("flash_attention_train_mla", "deepseek-v2-236b", _MLA),
    ("flash_attention_bwd_mla", "deepseek-v2-236b", _MLA),
    ("flash_attention_bwd_cross", "llama-3.2-vision-11b",
     (2, 1024, 1600, 32, 8, 128, 128, False, 0, 0, 0)),
    ("flash_attention_bwd_encoder", "hubert-xlarge",
     (4, 1500, 1500, 16, 16, 80, 80, False, 0, 0, 0)),
]


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30))) \
        if a.size else 0.0


def check_close(what: str, got, want, atol: float, rtol: float) -> float:
    got = got.detach().cpu().numpy() if hasattr(got, "detach") else got
    want = want.detach().cpu().numpy() if hasattr(want, "detach") else want
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape} != {want.shape}")
    if not np.allclose(got, want, atol=atol, rtol=rtol, equal_nan=False):
        d = np.abs(got.astype(np.float64) - want)
        raise AssertionError(f"{what}: max |diff| {d.max():.3e} exceeds "
                             f"atol {atol} + rtol {rtol}")
    return float(np.max(np.abs(got.astype(np.float64) - want))) \
        if got.size else 0.0


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_graph_ms(torch, fn, replays: int = 50, calls: int = 20) -> float:
    """Device time of one ``fn()`` call: capture ``calls`` back-to-back
    calls in one CUDA graph, replay it, and take the median of per-replay
    CUDA-event times over ``calls``. Back to back, a short call's time
    holds no host latency of the graph launch."""
    for _ in range(3):                   # warm up outside the capture
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(calls):
                fn()
    torch.cuda.current_stream().wait_stream(stream)
    for _ in range(10):
        graph.replay()
    torch.cuda.synchronize()
    events = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events) / calls


def time_eager_ms(torch, fn, calls: int = 20, reps: int = 10) -> float:
    """Device time of one ``fn()`` call for a function that synchronizes
    with the host and so cannot be captured in a graph: CUDA events
    around ``calls`` eager calls, the median of ``reps`` runs per call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / calls)
    return statistics.median(runs)


def cold_copies(nbytes: float) -> int:
    """Copies of a call's inputs and outputs (``nbytes`` a call) that
    together hold ``COLD_BYTES``."""
    return max(2, int(np.ceil(COLD_BYTES / nbytes)))


def time_cold_ms(torch, fns: list, replays: int = 20) -> float:
    """Device time of one call whose inputs and output are not in L2:
    each of ``fns`` reads its own copy of the inputs and writes its own
    output (``cold_copies`` of them), one CUDA graph calls each once in
    turn, and the median per-replay time is divided by ``len(fns)``. The
    bytes bound (device memory at 3.35 TB/s) applies to this time, not to
    ``time_graph_ms``'s, whose 20 calls replay the same buffers from L2."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            outs = [fn() for fn in fns]   # alive together: one output each
    torch.cuda.current_stream().wait_stream(stream)
    del outs
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    events = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events) / len(fns)


def device_breakdown_us(torch, calls: dict, reps: int = 20) -> dict:
    """Device microseconds per call of every CUDA kernel that each of
    ``calls`` launches, from ``torch.profiler``; empty where the profiler
    recorded no device time."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for label, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = {}
        for evt in prof.key_averages():
            t = getattr(evt, "self_device_time_total", 0.0)
            if t > 0 and not evt.key.startswith("cuda"):
                name = kernel_name(evt.key)
                rows[name] = rows.get(name, 0.0) + t / reps
        out[label] = rows
    return out


def kernel_name(key: str) -> str:
    """A profiler key without its signature:
    "void (anonymous namespace)::node_gemm_kernel<true>(...)" ->
    "node_gemm_kernel"."""
    name = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].split("::")[-1]


def bound_ms(flops, nbytes: float, peak: float = PEAK_F32_FLOPS):
    """The least time for the work, in ms, and what bounds it: ``flops``
    operations at ``peak`` (or a list of ``(flops, peak)`` parts done on
    different units, one after the other) against ``nbytes`` at
    ``PEAK_BYTES``."""
    parts = flops if isinstance(flops, list) else [(flops, peak)]
    t_ops = sum(n / pk for n, pk in parts)
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def packed_graph(torch, dev, p, q, f=16, seed=0, masked_tail=0.2):
    """A packed flat-axis graph: x [P,F], globally-offset edges [Q,2],
    masks with a padded tail (the JAX package's test sweep shape)."""
    rng = np.random.default_rng(seed)
    n_real = max(1, int(p * (1 - masked_tail)))
    x = rng.standard_normal((p, f)).astype(np.float32)
    edges = (rng.integers(0, n_real, (q, 2)).astype(np.int32) if q
             else np.zeros((0, 2), np.int32))
    emask = np.zeros((q,), np.float32)
    if q:
        emask[:max(1, q * 3 // 4)] = 1.0
    nmask = np.zeros((p,), np.float32)
    nmask[:n_real] = 1.0
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return t(x), t(edges), t(emask), t(nmask)


def weights(torch, dev, f, h, seed=0):
    rng = np.random.default_rng(seed + 100)
    return [torch.as_tensor(rng.standard_normal(s).astype(np.float32) * .1,
                            device=dev) for s in ((f, h), (f, h), (h,))]


def random_dag_doc(rng: np.random.Generator, n: int, idx: int) -> dict:
    """A seeded ``repro.opgraph.v1`` document: a DAG of ``n`` operator
    nodes, each fed by one to three earlier nodes."""
    from repro_torch.core.ir import OP_VOCAB
    batch = int(rng.choice([1, 8, 32]))
    nodes, edges = [], []
    for i in range(n):
        op = str(rng.choice(OP_VOCAB))
        width = int(rng.choice([64, 128, 256, 512, 1024]))
        shape = [batch, width] if op in ("dense", "softmax", "norm") else \
            [batch, int(rng.integers(4, 64)), int(rng.integers(4, 64)), width]
        numel = float(np.prod(shape))
        macs = numel * width if op in ("dense", "conv") else 0.0
        nodes.append({"id": i, "op": op, "out_shape": shape,
                      "dtype": "float32", "attrs": {},
                      "flops": 2 * macs or numel, "macs": macs,
                      "bytes_accessed": 8 * numel,
                      "param_bytes": 4.0 * width * width if macs else 0.0})
        if i:
            for s in sorted(set(rng.integers(0, i, size=min(i, 3)).tolist())):
                edges.append([s, i])
    return {"schema": "repro.opgraph.v1", "nodes": nodes, "edges": edges,
            "meta": {"batch": batch, "family": "synthetic", "index": idx}}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(torch) -> str:
    name_limit = smi()
    from repro_torch.kernels.build import nvcc_path
    nvcc = subprocess.run([nvcc_path(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    emit({"phase": "device", "nvidia_smi": name_limit,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc.strip().splitlines()[-1],
          "count": torch.cuda.device_count()})
    return name_limit


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    seconds = build.build_all()
    total = time.perf_counter() - t0
    ptxas = {}
    for name in seconds:
        ptxas[name] = [ln.strip() for ln in build.build_log(name).splitlines()
                       if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": round(total, 3),
          "per_source_s": {k: round(v, 3) for k, v in seconds.items()},
          "ptxas": ptxas})


def sweep_fused(torch, dev) -> float:
    """fused_mp_layer against its plain version over edge cases on both
    node-phase routes: the tensor-core kernel's tile edges (P not a
    multiple of 128, H below and above one tile, F a multiple of 8 or only
    of 4, depth over several turns of its ring), the FMA kernel's odd
    widths and unaligned view, and inf, -inf and NaN in x, in agg (through
    an edge) and in the weights. Each case's route must be the one
    ``fused_mp_plan`` names."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_spmm import (fused_mp_layer_cuda,
                                                  fused_mp_plan)
    worst = 0.0
    cases = []
    for p, q in [(128, 128), (128, 129), (100, 50), (257, 300), (64, 0)]:
        for mode in ("sum", "mean"):
            for combine in ("split", "pre"):
                cases.append(dict(p=p, q=q, mode=mode, combine=combine,
                                  scale="vector", act="relu", nm=True,
                                  weighted=False))
    for scale in ("vector", "scalar", "tensor0d", None):
        for act in ("relu", "none"):
            cases.append(dict(p=96, q=140, mode="sum", combine="pre",
                              scale=scale, act=act, nm=True, weighted=False))
    cases.append(dict(p=80, q=200, mode="sum", combine="split", scale=None,
                      act="none", nm=False, weighted=True))
    cases.append(dict(p=80, q=200, mode="mean", combine="pre", scale="vector",
                      act="relu", nm=False, weighted=True))
    # widths that are not multiples of 4 take the scalar-load kernel, and so
    # does an input view that starts one float into its storage
    cases.append(dict(p=300, q=500, mode="mean", combine="split", scale=None,
                      act="relu", nm=True, weighted=True, f=70, h=130))
    cases.append(dict(p=150, q=90, mode="mean", combine="pre", scale="vector",
                      act="relu", nm=True, weighted=False, f=13, h=7))
    cases.append(dict(p=128, q=129, mode="mean", combine="split", scale=None,
                      act="relu", nm=True, weighted=False, unaligned=True))
    # the tensor-core kernel's edges: its 128 x 128 tile, depth stages of
    # 32 (F = 8k, F = 4 mod 8, a depth that turns its ring of three)
    for p, q, f, h, combine in [(200, 300, 40, 24, "split"),
                                (300, 500, 12, 100, "pre"),
                                (129, 200, 20, 128, "split"),
                                (257, 400, 64, 200, "pre"),
                                (384, 700, 36, 260, "split"),
                                (130, 260, 256, 132, "pre"),
                                (100, 150, 4, 4, "split")]:
        cases.append(dict(p=p, q=q, mode="mean", combine=combine,
                          scale="vector", act="relu", nm=True, weighted=True,
                          f=f, h=h))
    # inf, -inf and NaN in x (rows that send no edge), in agg (through the
    # edges of the rows that carry them) and in the weights, on both routes
    for where in ("x", "agg", "w"):
        for combine in ("split", "pre"):
            for unaligned in (False, True):
                cases.append(dict(p=200, q=300, mode="mean", combine=combine,
                                  scale="vector", act="relu", nm=True,
                                  weighted=False, f=24, h=160,
                                  unaligned=unaligned, bad=where))
    routes = dict.fromkeys(fused_mp_layer_cuda.route_launches, 0)
    for i, c in enumerate(cases):
        f, h = c.get("f", 16), c.get("h", 24)
        x, edges, emask, nmask = packed_graph(torch, dev, c["p"], c["q"], f=f,
                                              seed=i)
        wn, ws, b = weights(torch, dev, f, h, seed=i)
        bad = {5: float("inf"), 150: float("nan"), 170: float("-inf")}
        if c.get("bad") == "x":
            keep = ~torch.isin(edges[:, 0], torch.tensor(list(bad),
                                                         device=dev))
            edges, emask = edges[keep].contiguous(), emask[keep].contiguous()
        elif c.get("bad") == "agg":
            edges[:3, 0] = torch.tensor(list(bad), device=dev)
            emask[:3] = 1.0
        for r, v in bad.items() if c.get("bad") else ():
            if c["bad"] == "w":
                w = ws if c["combine"] == "split" and r == 5 else wn
                w[r % f, (r * 7) % h] = v
            else:
                x[r, 7] = v
        if c.get("unaligned"):
            shifted = torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape)
            x = shifted.copy_(x)
        if c["weighted"]:
            emask = emask * torch.rand(c["q"], device=dev,
                                       generator=torch.Generator(dev)
                                       .manual_seed(i))
        ss = {"vector": torch.rand(c["p"], device=dev,
                                   generator=torch.Generator(dev)
                                   .manual_seed(i)),
              "scalar": 1.37,
              "tensor0d": torch.tensor(0.63, device=dev),
              None: None}[c["scale"]]
        kw = dict(w_neigh=wn, w_self=ws, bias=b, mode=c["mode"],
                  combine=c["combine"], self_scale=ss, act=c["act"])
        nm = nmask if c["nm"] else None
        before = dict(fused_mp_layer_cuda.route_launches)
        got = fused_mp_layer_cuda(x, edges, emask, nm, **kw)
        want = ref.fused_mp_layer_ref(x, edges, emask, nm, **kw)
        torch.cuda.synchronize()
        route = fused_mp_plan(f, h, not c.get("unaligned"))
        if fused_mp_layer_cuda.route_launches[route] != before[route] + 1:
            raise AssertionError(f"fused_mp_layer case {c}: did not run the "
                                 f"{route} route")
        routes[route] += 1
        if c.get("bad"):
            if torch.isfinite(want).all():
                raise AssertionError(f"fused_mp_layer case {c}: no "
                                     f"non-finite value reached the output")
            err = check_close_nan(f"fused_mp_layer case {c}", got, want,
                                  KERNEL_ATOL, KERNEL_RTOL)
        else:
            err = check_close(f"fused_mp_layer case {c}", got, want,
                              KERNEL_ATOL, KERNEL_RTOL)
        worst = max(worst, err)
    if min(routes.values()) == 0:
        raise AssertionError(f"fused_mp_layer sweep: routes {routes}")
    return worst


def readout_runs(rng, p, sizes, f, frac=False):
    """A packed bin's readout inputs: graph k's ``sizes[k]`` real rows in a
    run from row 0, in graph order, then padded rows (id 0, mask 0, h 1e6
    that must not leak); ``frac`` gives real rows mask values in
    (0.05, 1]."""
    n_real = int(sum(sizes))
    h = rng.standard_normal((p, f)).astype(np.float32)
    h[n_real:] = 1e6
    ids = np.zeros(p, np.int32)
    ids[:n_real] = np.repeat(np.arange(len(sizes)), sizes)
    nm = np.zeros(p, np.float32)
    nm[:n_real] = rng.uniform(0.05, 1.0, n_real) if frac else 1.0
    return h, ids, nm


def readout_cases(rng) -> dict:
    """name -> (h, ids, nm, G) for ``sweep_readout``: the packed layout
    (runs, a padded tail, trailing empty graphs), ids in no order, an
    all-masked bin, a NaN in a real row (fault C1), a column whose every
    real value is NaN, ±inf on both routes, fractional masks, graphs of
    800 and 1,500 rows, a masked row inside the real ones, and 40,000 rows
    (more than the kernel stages in shared memory) on both routes."""
    out = {}
    for p, f, g in ((300, 16, 12), (130, 130, 8)):
        n_real = p * 3 // 4
        sizes = np.bincount(np.sort(rng.integers(0, g - 3, n_real)),
                            minlength=g - 3)
        out[f"runs p={p} f={f}"] = (*readout_runs(rng, p, sizes, f), g)
    out["random p=257 f=40"] = (
        rng.standard_normal((257, 40)).astype(np.float32),
        rng.integers(0, 9, 257).astype(np.int32),
        (rng.random(257) < 0.8).astype(np.float32), 9)
    out["all masked"] = (rng.standard_normal((64, 8)).astype(np.float32),
                         np.zeros(64, np.int32), np.zeros(64, np.float32), 4)
    h, ids, nm = readout_runs(rng, 160, [12, 40, 5, 70], 16)
    h[20, 3] = np.nan
    out["NaN in a real row"] = (h, ids, nm, 6)
    h = h.copy()
    h[:127, 5] = np.nan
    out["column of NaN"] = (h, ids, nm, 6)
    h, ids, nm = readout_runs(rng, 160, [12, 40, 5, 70], 16)
    h[3, 1], h[30, 2], h[31, 2], h[100, 7] = (np.inf, -np.inf, np.inf,
                                              -np.inf)
    out["inf runs"] = (h, ids, nm, 6)
    hr = rng.standard_normal((100, 10)).astype(np.float32)
    hr[7, 0], hr[50, 4], hr[51, 9] = np.nan, np.inf, -np.inf
    out["inf random"] = (hr, rng.integers(0, 4, 100).astype(np.int32),
                         np.ones(100, np.float32), 4)
    out["fractional"] = (*readout_runs(rng, 300, [5, 40, 17, 0, 190], 20,
                                       frac=True), 6)
    out["long 800 and 1500"] = (*readout_runs(rng, 4096, [800, 7, 1500, 30],
                                              512), 8)
    h, ids, nm = readout_runs(rng, 80, [3, 50, 8], 9)
    nm[20] = 0.0
    out["masked inside the runs"] = (h, ids, nm, 4)
    sizes = rng.integers(1000, 4000, 10)
    out["P=40000 runs"] = (*readout_runs(rng, 40000, sizes, 8), 12)
    out["P=40000 random"] = (
        rng.standard_normal((40000, 8)).astype(np.float32),
        rng.integers(0, 12, 40000).astype(np.int32),
        (rng.random(40000) < 0.8).astype(np.float32), 12)
    return out


def sweep_readout(torch, dev) -> dict:
    """segment_readout and its gradient against their plain versions over
    ``readout_cases``, both kinds: every call runs twice, the same bits
    required, NaN and inf where the plain version puts them, and the route
    the kernel counted must be the one ``readout_plan`` names."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_spmm import (
        readout_plan, readout_route_counts, segment_readout_backward_cuda,
        segment_readout_cuda)
    worst = {"segment_readout": 0.0, "segment_readout_backward": 0.0}
    cases = {}
    rng = np.random.default_rng(7)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    for name, (h, ids, nm, g) in readout_cases(rng).items():
        th, ti, tm = t(h), t(ids), t(nm)
        route = readout_plan(ids, nm)
        for kind in ("mean", "mean_max"):
            what = f"segment_readout {kind} {name}"
            before = readout_route_counts(dev)
            z, again = (segment_readout_cuda(th, ti, tm, g, kind=kind)
                        for _ in range(2))
            want = ref.segment_readout_ref(th, ti, tm, g, kind=kind)
            gz = t(rng.standard_normal(tuple(want.shape)).astype(np.float32))
            dh, dh2 = (segment_readout_backward_cuda(th, ti, tm, want, gz,
                                                     kind=kind)
                       for _ in range(2))
            dwant = ref.segment_readout_backward_ref(th, ti, tm, want, gz,
                                                     kind=kind)
            after = readout_route_counts(dev)
            if not (same_bits(torch, z, again) and same_bits(torch, dh, dh2)):
                raise AssertionError(f"{what}: two runs differ in their bits")
            counted = {way: {r: after[way][r] - before[way][r]
                             for r in after[way]} for way in after}
            expect = {r: 2 * (r == route) for r in counted["forward"]}
            if counted != {"forward": expect, "backward": expect}:
                raise AssertionError(f"{what}: routes {counted}, but "
                                     f"readout_plan says {route}")
            err = check_close_nan(what, z, want, KERNEL_ATOL, KERNEL_RTOL)
            berr = check_close_nan(f"{what} backward", dh, dwant,
                                   KERNEL_ATOL, KERNEL_RTOL)
            worst["segment_readout"] = max(worst["segment_readout"], err)
            worst["segment_readout_backward"] = max(
                worst["segment_readout_backward"], berr)
            cases[f"{kind} {name}"] = {"route": route, "max_abs_err": err,
                                       "backward_max_abs_err": berr,
                                       "bitwise_repeat": True}
    return {"max_abs_err": worst, "cases": cases}


def check_close_card(what: str, got, want, atol: float, rtol: float) -> float:
    """:func:`check_close` computed on the card, in float64, for tensors of
    tens of millions of elements: |got - want| <= atol + rtol |want|
    everywhere; the largest |diff|."""
    got, want = got.detach().double(), want.detach().double()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    d = (got - want).abs()
    if not bool((d <= atol + rtol * want.abs()).all()):
        raise AssertionError(f"{what}: max |diff| {float(d.max()):.3e} "
                             f"exceeds atol {atol} + rtol {rtol}")
    return float(d.max()) if d.numel() else 0.0


def check_close_nan(what: str, got, want, atol: float, rtol: float) -> float:
    """:func:`check_close` where NaN is expected: the kernel's NaNs must sit
    exactly where the plain version's are, and the rest must agree."""
    got, want = got.detach().cpu().numpy(), want.detach().cpu().numpy()
    nan = np.isnan(want)
    if not np.array_equal(np.isnan(got), nan):
        raise AssertionError(f"{what}: NaN pattern differs from the plain "
                             f"version")
    inf = np.isinf(want)
    if not np.array_equal(got[inf], want[inf]):
        raise AssertionError(f"{what}: infinities differ from the plain "
                             f"version")
    fin = ~nan & ~inf
    return check_close(what, got[fin], want[fin], atol, rtol)


def twice_on_csr(torch, name: str, call, plain) -> tuple:
    """``call(c)`` twice with ``c`` true (the caller's shared CSR) and once
    with ``c`` None (the call builds its own): the three must be the same
    bits; then the result and the plain version's."""
    shared, again, own = call("shared"), call("shared"), call(None)
    want = plain()
    torch.cuda.synchronize()
    if not (same_bits(torch, shared, again) and same_bits(torch, shared, own)):
        raise AssertionError(f"{name}: two runs, or the shared and the own "
                             f"CSR, differ in their bits")
    return shared, want


def softmax_pile_cases() -> dict:
    """edge_softmax where a segment is split over a block: the padding
    pile of a packed bin (2,048 masked edges at (0, 0) and one live edge
    into 0), a 1,200-edge hub, a NaN score on the pile's live edge, and
    B = 3 rows each with its own pile."""
    rng = np.random.default_rng(4600)
    e, n = 8192, 4096
    s = (rng.standard_normal((1, e, 4)) * 3).astype(np.float32)
    dst = rng.integers(1, n, (1, e)).astype(np.int32)
    em = (rng.random((1, e)) < 0.9).astype(np.float32)
    dst[0, -2048:], em[0, -2048:] = 0, 0.0
    dst[0, 0], em[0, 0] = 0, 1.0
    hub = dst.copy()
    hub[0, 100:1300] = 7
    nan = s.copy()
    nan[0, 0, 2] = np.nan
    s3 = (rng.standard_normal((3, 700, 4)) * 3).astype(np.float32)
    d3 = rng.integers(0, 60, (3, 700)).astype(np.int32)
    m3 = (rng.random((3, 700)) < 0.85).astype(np.float32)
    d3[0, -300:], m3[0, -300:] = 0, 0.0
    d3[2, -500:], m3[2, -500:] = 0, 0.0
    return {"padding pile 2048": (s, dst, em, n),
            "in-degree 1200": (s, hub, em, n),
            "NaN score on the pile": (nan, dst, em, n),
            "B=3 piles": (s3, d3, m3, 60)}


def sweep_edge_softmax(torch, dev) -> float:
    """edge_softmax_cuda against its plain version: E in {129, 256, 0},
    H in {1, 4, 8}, B in {1, 2}, then an all-masked bin, a fully masked
    destination, a padded edge scoring 1e30, a NaN score and the split
    segments of ``softmax_pile_cases``; every case with a shared CSR twice
    and with its own, the same bits required."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_spmm import (dst_csr_cuda,
                                                  edge_softmax_cuda)
    worst = 0.0
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731

    def run(name, s, dst, em, nodes, nan=False):
        ts, td, tm = t(s), t(dst), t(em)
        csr = dst_csr_cuda(td, nodes)
        got, want = twice_on_csr(
            torch, f"edge_softmax {name}",
            lambda c: edge_softmax_cuda(ts, td, tm, nodes,
                                        csr=csr if c else None),
            lambda: ref.edge_softmax_ref(ts, td, tm, nodes))
        if nan:
            return got, check_close_nan(f"edge_softmax {name}", got, want,
                                        KERNEL_ATOL, KERNEL_RTOL)
        err = check_close(f"edge_softmax {name}", got, want, KERNEL_ATOL,
                          KERNEL_RTOL)
        if not bool((got[tm == 0] == 0).all()):
            raise AssertionError(f"edge_softmax {name}: a masked edge is not "
                                 f"exactly 0")
        return got, err

    n = 40
    for i, (b, e, h) in enumerate((b, e, h) for b in (1, 2)
                                  for e in (129, 256, 0) for h in (1, 4, 8)):
        rng = np.random.default_rng(i)
        s = rng.standard_normal((b, e, h)).astype(np.float32) * 3
        dst = rng.integers(0, n, (b, e)).astype(np.int32)
        em = (rng.random((b, e)) < 0.8).astype(np.float32)
        worst = max(worst, run(f"b={b} e={e} h={h}", s, dst, em, n)[1])
    rng = np.random.default_rng(99)
    s = rng.standard_normal((1, 192, 4)).astype(np.float32)
    dst = rng.integers(0, 24, (1, 192)).astype(np.int32)
    fixed = {
        "all masked": (s, dst, np.zeros((1, 192), np.float32), 24),
        "fully masked destination": (
            s[:, :8, :2].copy(), np.array([[0, 0, 0, 0, 1, 1, 1, 1]], np.int32),
            np.array([[1, 1, 1, 1, 0, 0, 0, 0]], np.float32), 2),
        "padded edge scoring 1e30": (
            np.array([[[-100.0], [-101.0], [1e30]]], np.float32),
            np.zeros((1, 3), np.int32),
            np.array([[1.0, 1.0, 0.0]], np.float32), 4),
    }
    for name, case in fixed.items():
        worst = max(worst, run(name, *case)[1])
    s, dst, em, nodes = fixed["fully masked destination"]
    s = s.copy()
    s[0, 1, 0] = np.nan
    got, err = run("NaN score", s, dst, em, nodes, nan=True)
    worst = max(worst, err)
    if np.isfinite(got[0, :4, 0].cpu().numpy()).any():
        raise AssertionError("edge_softmax: a NaN score left its "
                             "destination finite")
    for name, (s, dst, em, nodes) in softmax_pile_cases().items():
        nan = bool(np.isnan(s).any())
        got, err = run(name, s, dst, em, nodes, nan=nan)
        worst = max(worst, err)
        if nan and not bool(torch.isnan(got[0, t(dst)[0] == 0, 2]).all()):
            raise AssertionError("edge_softmax: a NaN score on the pile left "
                                 "a weight of its destination finite")
    return worst


def gat_pile_cases() -> dict:
    """fused_gat_aggregate where a segment is split into chunks, at the
    full bin's widths (P = 4096, D = 512, 4 heads): the full bin's padding
    pile (562 masked edges at (0, 0)), a 2,048-edge pile with a 1,200-edge
    hub, and NaN in the padded source row z[0]."""
    rng = np.random.default_rng(4700)
    p, d, h = FULL_P, 512, 4
    out = {}
    for name, q, pile, hub in (("padding pile 562", FULL_Q, 562, 0),
                               ("pile 2048 and in-degree 1200", 8192, 2048,
                                1200),
                               ("NaN in a padded source", FULL_Q, 562, 0)):
        z = rng.standard_normal((p, d)).astype(np.float32)
        edges = rng.integers(1, 3500, (q, 2)).astype(np.int32)
        em = np.ones(q, np.float32)
        edges[-pile:], em[-pile:] = 0, 0.0
        if hub:
            edges[100:100 + hub, 1] = 7
        if name.startswith("NaN"):
            z[0, 9] = np.nan
        out[name] = (z, edges, em, rng.random((q, h)).astype(np.float32),
                     (np.arange(p) < 3500).astype(np.float32))
    return out


def sweep_gat_aggregate(torch, dev) -> float:
    """fused_gat_aggregate_cuda against its plain version at (P, Q, H) in
    {(64, 96, 4), (130, 257, 2), (4096, 6656, 4), (64, 0, 4)}, an odd head
    width (the scalar route), an unaligned z, and ``gat_pile_cases``; every
    case with a shared CSR twice and with its own, the same bits
    required."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_spmm import (dst_csr_cuda,
                                                  fused_gat_aggregate_cuda)
    worst = 0.0
    cases = {}
    for p, q, h, d in ((64, 96, 4, 16), (130, 257, 2, 16),
                       (FULL_P, FULL_Q, 4, 512), (64, 0, 4, 16),
                       (90, 500, 3, 30)):
        rng = np.random.default_rng(p + q)
        cases[f"p={p} q={q} h={h} d={d}"] = (
            rng.standard_normal((p, d)).astype(np.float32),
            (rng.integers(0, p, (q, 2)).astype(np.int32) if q
             else np.zeros((0, 2), np.int32)),
            (rng.random(q) < 0.8).astype(np.float32),
            rng.random((q, h)).astype(np.float32),
            (rng.random(p) < 0.9).astype(np.float32))
    cases.update(gat_pile_cases())
    for name, arrays in cases.items():
        t = [torch.as_tensor(a, device=dev) for a in arrays]
        if name == "p=130 q=257 h=2 d=16":
            # a view one float into its storage: the scalar route
            t[0] = torch.empty(t[0].numel() + 1, device=dev)[1:].view(
                t[0].shape).copy_(t[0])
        p = t[0].shape[0]
        csr = dst_csr_cuda(t[1][:, 1][None], p)
        got, want = twice_on_csr(
            torch, f"fused_gat_aggregate {name}",
            lambda c: fused_gat_aggregate_cuda(*t, csr=csr if c else None),
            lambda: ref.fused_gat_aggregate_ref(*t))
        worst = max(worst, check_close_nan(f"fused_gat_aggregate {name}",
                                           got, want, KERNEL_ATOL,
                                           KERNEL_RTOL))
        if name.startswith("NaN") and not bool(torch.isnan(got[0, 9])):
            raise AssertionError("fused_gat_aggregate: NaN * 0 of the padded "
                                 "edges did not reach node 0")
    return worst


def edge_list(rng, b, n, e, weighted, pad=0.25):
    """``[B, E, 2]`` edges whose rows end in padding ((0, 0), mask 0), with
    a self-loop and a duplicate among the real edges of every row that has
    two; nodes no edge reaches are isolated destinations."""
    edges = np.zeros((b, e, 2), np.int32)
    em = np.zeros((b, e), np.float32)
    for i in range(b):
        real = e - int(e * pad)
        if real:
            edges[i, :real] = rng.integers(0, n, (real, 2))
            em[i, :real] = (rng.uniform(0.2, 2.0, real) if weighted else 1.0)
        if real >= 2:
            edges[i, 0, 1] = edges[i, 0, 0]          # a self-loop
            edges[i, 1] = edges[i, 0]                # and its duplicate
    return edges, em


def sweep_segment(torch, dev) -> tuple:
    """segment_aggregate_cuda, segment_scatter_cuda and segment_gather_cuda
    against their plain versions: B in {1, 3}, E in {0, 1, 129, 300}, N
    and F off the tile sizes, sum and mean, weighted masks, self-loops,
    duplicates, padded and isolated rows, then NaN in a masked row, then
    ``sweep_segment_routes``; the worst errors and the routes' cases."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_spmm import (segment_aggregate_cuda,
                                                  segment_gather_cuda,
                                                  segment_scatter_cuda)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    worst = {"segment_aggregate": 0.0, "segment_scatter": 0.0,
             "segment_gather": 0.0}
    cases = [(b, n, e, f, w) for b in (1, 3) for n, e in
             ((1, 1), (37, 0), (37, 129), (130, 129), (130, 300))
             for f in (1, 7, 16, 130) for w in (False, True)]
    for i, (b, n, e, f, weighted) in enumerate(cases):
        rng = np.random.default_rng(1000 + i)
        edges, em = edge_list(rng, b, n, e, weighted)
        h = rng.standard_normal((b, n, f)).astype(np.float32)
        msgs = rng.standard_normal((b, e, f)).astype(np.float32)
        te, tm, th, tg = t(edges), t(em), t(h), t(msgs)
        if f == 16 and weighted:
            # a view one float into its storage: the scalar-load kernels
            th = torch.empty(th.numel() + 1, device=dev)[1:].view(
                th.shape).copy_(th)
        for mode in ("sum", "mean"):
            got, gdeg = segment_aggregate_cuda(te, tm, th, mode,
                                               return_degree=True)
            want, wdeg = ref.segment_aggregate_ref(te, tm, th, mode,
                                                   return_degree=True)
            torch.cuda.synchronize()
            worst["segment_aggregate"] = max(
                worst["segment_aggregate"],
                check_close(f"segment_aggregate {mode} case {i}", got, want,
                            KERNEL_ATOL, KERNEL_RTOL),
                check_close(f"segment degree case {i}", gdeg, wdeg,
                            KERNEL_ATOL, KERNEL_RTOL))
        got = segment_scatter_cuda(te[..., 1], tm, tg, n)
        want = ref.segment_scatter_ref(te[..., 1], tm, tg, n)
        got_g = segment_gather_cuda(th, te[..., 0], tm)
        want_g = ref.segment_gather_ref(th, te[..., 0], tm)
        torch.cuda.synchronize()
        worst["segment_scatter"] = max(worst["segment_scatter"], check_close(
            f"segment_scatter case {i}", got, want, KERNEL_ATOL, KERNEL_RTOL))
        worst["segment_gather"] = max(worst["segment_gather"], check_close(
            f"segment_gather case {i}", got_g, want_g, KERNEL_ATOL,
            KERNEL_RTOL))
    # NaN in a masked row: edge 2 is masked and its source row (and
    # message) is NaN; NaN·0 reaches its destination in both versions
    rng = np.random.default_rng(77)
    edges, em = edge_list(rng, 2, 40, 64, True)
    edges[1, edges[1, :, 0] == 39, 0] = 0            # no real edge leaves 39
    edges[1, 2] = (39, 5)
    em[1, 2] = 0.0
    h = rng.standard_normal((2, 40, 9)).astype(np.float32)
    h[1, 39] = np.nan
    msgs = rng.standard_normal((2, 64, 9)).astype(np.float32)
    msgs[1, 2] = np.nan
    te, tm = t(edges), t(em)
    for mode in ("sum", "mean"):
        got = segment_aggregate_cuda(te, tm, t(h), mode)
        want = ref.segment_aggregate_ref(te, tm, t(h), mode)
        torch.cuda.synchronize()
        check_close_nan(f"segment_aggregate {mode} NaN in a masked row", got,
                        want, KERNEL_ATOL, KERNEL_RTOL)
        if not bool(torch.isnan(got[1, 5]).all()):
            raise AssertionError("segment_aggregate: NaN·0 of a masked edge "
                                 "did not reach its destination")
    got = segment_scatter_cuda(te[..., 1], tm, t(msgs), 40)
    want = ref.segment_scatter_ref(te[..., 1], tm, t(msgs), 40)
    torch.cuda.synchronize()
    check_close_nan("segment_scatter NaN in a masked row", got, want,
                    KERNEL_ATOL, KERNEL_RTOL)
    routes = sweep_segment_routes(torch, dev)
    for name in ("segment_aggregate", "segment_scatter"):
        worst[name] = max(worst[name], routes["max_abs_err"][name])
    return worst, routes["cases"]


def same_bits(torch, a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def sweep_segment_routes(torch, dev) -> dict:
    """The segmented sums' routes (``segment_plan``) where they are
    stressed, each call against its plain version and run twice, which
    must give the same bits: the padded edges of a packed step piled on
    node 0 (2,048 of weight 0), a destination of in-degree 1,200, both at
    F = 512 and F = 4 and through the aggregate (sum and mean with the
    degree) and the scatter, with NaN in one piled message at F = 4; and
    the shapes the packed readout's backward once gave it, [P, 1 + F]
    and [P, 1] rows of weight 1 into its graph slots (its padded nodes all
    sit in graph 0)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_spmm import (segment_aggregate_cuda,
                                                  segment_plan,
                                                  segment_scatter_cuda)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    rng = np.random.default_rng(5000)
    worst = {"segment_aggregate": 0.0, "segment_scatter": 0.0}
    cases = {}

    def hold(name, kernel, call, plain, f, e):
        first, again = call(), call()
        want = plain()
        torch.cuda.synchronize()
        first = first if isinstance(first, tuple) else (first,)
        again = again if isinstance(again, tuple) else (again,)
        want = want if isinstance(want, tuple) else (want,)
        err = 0.0
        for x, y, w in zip(first, again, want):
            if not same_bits(torch, x, y):
                raise AssertionError(f"{name}: two runs differ in their "
                                     f"bits")
            err = max(err, check_close_nan(name, x, w, KERNEL_ATOL,
                                           KERNEL_RTOL))
        worst[kernel] = max(worst[kernel], err)
        cases[name] = {"route": segment_plan(f, e, True).route,
                       "max_abs_err": err, "bitwise_repeat": True}

    n, e = 4096, 8192
    for label, hub in (("padding pile", None), ("in-degree 1200", 1200)):
        edges, em = edge_list(rng, 1, n, e, True)     # 2,048 padded edges
        if hub:
            edges[0, 100:100 + hub, 1] = 7
        te, tm = t(edges), t(em)
        for f in (512, 4):
            h = t(rng.standard_normal((1, n, f)).astype(np.float32))
            msgs = rng.standard_normal((1, e, f)).astype(np.float32)
            if f == 4 and hub is None:
                msgs[0, -1, 0] = np.nan                # a piled message
            msgs = t(msgs)
            for mode in ("sum", "mean"):
                hold(f"segment_aggregate {mode} {label} F={f}",
                     "segment_aggregate",
                     lambda m=mode: segment_aggregate_cuda(
                         te, tm, h, m, return_degree=True),
                     lambda m=mode: ref.segment_aggregate_ref(
                         te, tm, h, m, return_degree=True), f, e)
            hold(f"segment_scatter {label} F={f}", "segment_scatter",
                 lambda: segment_scatter_cuda(te[..., 1], tm, msgs, n),
                 lambda: ref.segment_scatter_ref(te[..., 1], tm, msgs, n),
                 f, e)
    pk = train_steps("packed")
    gid = t(pk["graph_ids"][None].astype(np.int32))
    p, g = pk["graph_ids"].shape[0], pk["static"].shape[0]
    ones = torch.ones((1, p), device=dev)
    for f in (1 + TRAIN_HIDDEN, 1):
        rows = t(rng.integers(0, 2, (1, p, f)).astype(np.float32))
        hold(f"segment_scatter readout backward F={f}", "segment_scatter",
             lambda: segment_scatter_cuda(gid, ones, rows, g),
             lambda: ref.segment_scatter_ref(gid, ones, rows, g), f, p)
    return {"max_abs_err": worst, "cases": cases}


def sweep_dense(torch, dev) -> float:
    """dense_aggregate_cuda against its plain version: B in {1, 3}, N and F
    off the tile sizes, sum and mean, 0/1 and weighted adjacency,
    transposed with a row scale (the backward's form), degree out, and NaN
    in a row of h."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.sage_spmm import dense_aggregate_cuda
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    worst = 0.0
    cases = [(b, n, f) for b in (1, 3) for n, f in
             ((1, 1), (5, 7), (32, 32), (130, 70), (256, 512), (257, 130))]
    for i, (b, n, f) in enumerate(cases):
        rng = np.random.default_rng(2000 + i)
        adj = (rng.random((b, n, n)) < 0.05).astype(np.float32)
        if i % 2:
            adj *= rng.uniform(0.1, 1.0, adj.shape).astype(np.float32)
        h = rng.standard_normal((b, n, f)).astype(np.float32)
        scale = rng.uniform(0.2, 1.0, (b, n)).astype(np.float32)
        for mode in ("sum", "mean"):
            for trans, sc in ((False, None), (True, scale), (True, None)):
                kw = dict(scale=None if sc is None else t(sc),
                          transpose=trans, return_degree=True)
                got, gdeg = dense_aggregate_cuda(t(adj), t(h), mode, **kw)
                want, wdeg = ref.dense_aggregate_ref(t(adj), t(h), mode, **kw)
                torch.cuda.synchronize()
                worst = max(worst, check_close(
                    f"dense_aggregate {mode} trans={trans} case {(b, n, f)}",
                    got, want, KERNEL_ATOL, KERNEL_RTOL),
                    check_close(f"dense degree case {(b, n, f)}", gdeg, wdeg,
                                KERNEL_ATOL, KERNEL_RTOL))
    rng = np.random.default_rng(2100)
    adj = (rng.random((2, 64, 64)) < 0.1).astype(np.float32)
    h = rng.standard_normal((2, 64, 16)).astype(np.float32)
    h[1, 7, 3] = np.nan
    h[0, 60, 11] = np.inf
    for mode in ("sum", "mean"):
        got = dense_aggregate_cuda(t(adj), t(h), mode)
        want = ref.dense_aggregate_ref(t(adj), t(h), mode)
        torch.cuda.synchronize()
        check_close_nan(f"dense_aggregate {mode} NaN and inf in h", got,
                        want, KERNEL_ATOL, KERNEL_RTOL)
    return worst


def backward_cases(rng) -> list:
    """(name, differentiable entry of ops, numpy inputs, index of the input
    that takes the gradient) for each autograd.Function, on the edge
    cases."""
    from repro_torch.kernels import ops
    out = []
    for b, n, e, f in ((1, 37, 0, 8), (3, 130, 300, 7), (2, 64, 129, 64)):
        edges, em = edge_list(rng, b, n, e, True)
        h = rng.standard_normal((b, n, f)).astype(np.float32)
        msgs = rng.standard_normal((b, e, f)).astype(np.float32)
        for mode in ("sum", "mean"):
            out.append((f"segment_aggregate {mode} {(b, n, e, f)}",
                        lambda x, y, z, m=mode: ops.segment_aggregate(
                            x, y, z, m), [edges, em, h], 2))
        out.append((f"segment_scatter {(b, n, e, f)}",
                    lambda x, y, z, n=n: ops.segment_scatter(x, y, z, n),
                    [edges[..., 1].copy(), em, msgs], 2))
        out.append((f"segment_gather {(b, n, e, f)}", ops.segment_gather,
                    [h, edges[..., 0].copy()], 0))
        heads = 4
        s = rng.standard_normal((b, e, heads)).astype(np.float32) * 3
        out.append((f"edge_softmax {(b, n, e)}",
                    lambda x, y, z, n=n: ops.edge_softmax(x, y, z, n),
                    [s, edges[..., 1].copy(), (em > 0).astype(np.float32)],
                    0))
    for b, n, f in ((1, 5, 3), (3, 130, 70), (2, 256, 64)):
        adj = (rng.random((b, n, n)) < 0.05).astype(np.float32)
        h = rng.standard_normal((b, n, f)).astype(np.float32)
        for mode in ("sum", "mean"):
            out.append((f"dense_aggregate {mode} {(b, n, f)}",
                        lambda x, y, m=mode: ops.dense_aggregate(x, y, m),
                        [adj, h], 1))
    for p, f, g in ((64, 5, 6), (300, 16, 12)):
        # small integers tie within a graph; the last graph stays empty
        h = rng.integers(-2, 3, (p, f)).astype(np.float32)
        ids = np.sort(rng.integers(0, g - 1, p)).astype(np.int32)
        nm = (rng.random(p) < 0.85).astype(np.float32)
        for kind in ("mean", "mean_max"):
            out.append((f"segment_readout {kind} {(p, f, g)}",
                        lambda x, y, z, g=g, k=kind: ops.segment_readout(
                            x, y, z, g, kind=k), [h, ids, nm], 0))
    return out


def sweep_backward(torch, dev) -> dict:
    """Each autograd.Function's backward on the card (its kernels) against
    the same backward on the CPU (the plain versions), same inputs and
    the same upstream gradient; the worst error per kernel."""
    worst = {}
    rng = np.random.default_rng(3000)
    for name, fn, arrays, k in backward_cases(rng):
        grads, outs = [], []
        for d in (dev, torch.device("cpu")):
            ts = [torch.as_tensor(a, device=d) for a in arrays]
            ts[k].requires_grad_(True)
            y = fn(*ts)
            gout = torch.as_tensor(np.random.default_rng(len(name))
                                   .standard_normal(tuple(y.shape))
                                   .astype(np.float32), device=d)
            y.backward(gout)
            outs.append(y.detach())
            grads.append(ts[k].grad)
        torch.cuda.synchronize()
        kern = name.split()[0]
        worst[kern] = max(worst.get(kern, 0.0),
                          check_close(f"{name} forward", outs[0], outs[1],
                                      KERNEL_ATOL, KERNEL_RTOL),
                          check_close(f"{name} backward", grads[0], grads[1],
                                      KERNEL_ATOL, KERNEL_RTOL))
    return worst


def full_bin(torch, dev, cfg):
    """The first (fullest) packed bin of a seeded synthetic bulk, staged
    as the engine stages it, and full-width random weights for ``cfg``
    (numpy pytree)."""
    from repro_torch.core.batching import (collate_packed, pack_graphs,
                                           packed_shape)
    from repro_torch.core.gnn import pmgns_init
    from repro_torch.dataset.builder import synthetic_samples
    samples = synthetic_samples(120, seed=3, n_min=16, n_max=200)
    bins = pack_graphs(samples, FULL_P, None, None)
    chunk = [samples[j] for j in bins[0]]
    shape = packed_shape(chunk, FULL_P, 2 * FULL_P, FULL_P // 16)
    if shape != (FULL_P, FULL_Q, FULL_G):
        raise AssertionError(f"full bin has shape {shape}")
    batch = collate_packed(chunk, FULL_P, 2 * FULL_P, FULL_P // 16)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    return batch, pmgns_init(0, cfg), len(chunk)


def readout_library_ms(torch, h, gid, p_real: int, g: int) -> float:
    """The two-call yardstick of the readout: ``torch.segment_reduce`` of
    the real rows (a prefix, in runs of their graph ids) in ``"mean"``,
    then in ``"max"``, timed as one function; never called by the port."""
    lengths = torch.bincount(gid[:p_real].long(), minlength=g)
    rows = h[:p_real]
    return time_graph_ms(torch, lambda: (
        torch.segment_reduce(rows, "mean", lengths=lengths, unsafe=True),
        torch.segment_reduce(rows, "max", lengths=lengths, unsafe=True)))


def sage_kernel_entries(torch, dev, cfg) -> tuple:
    """fused_mp_layer and segment_readout at the GraphSAGE full bin, and
    fused_mp_layer's ``pre`` combine there, GCN-style (sum, edge weights,
    a [P] self scale)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_spmm import (fused_mp_layer_cuda,
                                                  segment_readout_cuda)
    sweep_mp = sweep_fused(torch, dev)
    ro_sweep = sweep_readout(torch, dev)
    sweep_ro = ro_sweep["max_abs_err"]["segment_readout"]
    batch, tree, n_graphs = full_bin(torch, dev, cfg)
    w = {f"{k}{i}": torch.as_tensor(tree["gnn"][f"b{i}"][blk][leaf],
                                    device=dev)
         for i in (0, 1)
         for k, blk, leaf in (("ws", "self", "w"), ("wn", "neigh", "w"),
                              ("b", "self", "b"))}
    x, edges, em, nm = (batch["x"], batch["edges"], batch["edge_mask"],
                        batch["mask"])
    gid = batch["graph_ids"]
    P, F0 = x.shape
    H = w["wn0"].shape[1]
    Q = edges.shape[0]
    q_real = int((em != 0).sum())
    p_real = int((nm > 0).sum())

    def layer(fn, h, i):
        return fn(h, edges, em, nm, w_neigh=w[f"wn{i}"], w_self=w[f"ws{i}"],
                  bias=w[f"b{i}"], mode="mean", combine="split", act="relu")

    # GCN's layer (core/gnn.py _fused_mp_stack): normalised edge weights,
    # the d^-1 d^-1 self scale, sum, pre
    deg = torch.zeros((P,), device=dev).index_add_(
        0, edges[:, 1].long(), em) + nm
    dinv = torch.rsqrt(deg.clamp_min(1.0))
    gcn_w = (em * dinv[edges[:, 1].long()] * dinv[edges[:, 0].long()]
             ).contiguous()
    gcn_ss = (dinv * dinv * nm).contiguous()

    def pre_layer(fn, h):
        return fn(h, edges, gcn_w, nm, w_neigh=w["wn1"], bias=w["b1"],
                  mode="sum", combine="pre", self_scale=gcn_ss, act="relu")

    routes0 = dict(fused_mp_layer_cuda.route_launches)
    h0_k = layer(fused_mp_layer_cuda, x, 0)
    h0_r = layer(ref.fused_mp_layer_ref, x, 0)
    h1_k = layer(fused_mp_layer_cuda, h0_r, 1)
    h1_r = layer(ref.fused_mp_layer_ref, h0_r, 1)
    g1_k = pre_layer(fused_mp_layer_cuda, h0_r)
    g1_r = pre_layer(ref.fused_mp_layer_ref, h0_r)
    routes = {k: v - routes0[k]
              for k, v in fused_mp_layer_cuda.route_launches.items()}
    if routes.get("tf32x3") != 3:
        raise AssertionError(f"fused_mp_layer at the full bin ran the routes "
                             f"{routes}, not the tensor-core one")
    z_k = segment_readout_cuda(h1_r, gid, nm, FULL_G, kind=cfg.readout)
    z_again = segment_readout_cuda(h1_r, gid, nm, FULL_G, kind=cfg.readout)
    z_r = ref.segment_readout_ref(h1_r, gid, nm, FULL_G, kind=cfg.readout)
    torch.cuda.synchronize()
    if not same_bits(torch, z_k, z_again):
        raise AssertionError("segment_readout at the full bin: two runs "
                             "differ in their bits")
    err_full = {
        "split F=32": check_close("fused_mp_layer full width F=32", h0_k,
                                  h0_r, KERNEL_ATOL, KERNEL_RTOL),
        "split F=512": check_close("fused_mp_layer full width F=512", h1_k,
                                   h1_r, KERNEL_ATOL, KERNEL_RTOL),
        "pre F=512": check_close("fused_mp_layer full width pre F=512 (GCN)",
                                 g1_k, g1_r, KERNEL_ATOL, KERNEL_RTOL)}
    err_mp = max(err_full.values())
    err_ro = check_close("segment_readout full width", z_k, z_r,
                         KERNEL_ATOL, KERNEL_RTOL)

    def product_ms(h, i):
        """torch.mm on layer i's node-phase product alone, [x | agg/d] @
        [Ws; Wn] ([P, 2F] x [2F, H]) in float32 with TF32 off: the
        yardstick, never called by the port"""
        src, dst = edges[:, 0].long(), edges[:, 1].long()
        agg = torch.zeros_like(h).index_add_(0, dst, h[src] * em[:, None])
        d = torch.zeros((P,), device=dev).index_add_(0, dst, em)
        a = torch.cat([h, agg / d.clamp_min(1.0)[:, None]], 1)
        bm = torch.cat([w[f"ws{i}"], w[f"wn{i}"]], 0)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return time_graph_ms(torch, lambda: torch.mm(a, bm))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32

    t_mp = {}
    for label, i, h in (("f32", 0, x), ("f512", 1, h0_r)):
        t_mp[label] = {
            "ms": time_graph_ms(torch, lambda: layer(fused_mp_layer_cuda, h, i)),
            "plain_ms": time_graph_ms(
                torch, lambda: layer(ref.fused_mp_layer_ref, h, i)),
            "product_torch_mm_ms": product_ms(h, i),
        }
    t_mp["pre f512"] = {
        "ms": time_graph_ms(torch, lambda: pre_layer(fused_mp_layer_cuda,
                                                     h0_r)),
        "plain_ms": time_graph_ms(torch, lambda: pre_layer(
            ref.fused_mp_layer_ref, h0_r))}
    t_ro = time_graph_ms(torch, lambda: segment_readout_cuda(
        h1_r, gid, nm, FULL_G, kind=cfg.readout))
    ro_in = [(h1_r, gid, nm)] + [
        (h1_r.clone(), gid.clone(), nm.clone()) for _ in range(cold_copies(
            4.0 * (P * H + 2 * P + FULL_G * 2 * H)) - 1)]
    t_ro_cold = time_cold_ms(torch, [
        lambda x=x: segment_readout_cuda(*x, FULL_G, kind=cfg.readout)
        for x in ro_in])
    del ro_in
    breakdown = device_breakdown_us(torch, {
        "fused_mp_layer F=32": lambda: layer(fused_mp_layer_cuda, x, 0),
        "fused_mp_layer F=512": lambda: layer(fused_mp_layer_cuda, h0_r, 1),
        "fused_mp_layer pre F=512": lambda: pre_layer(fused_mp_layer_cuda,
                                                      h0_r),
        "segment_readout": lambda: segment_readout_cuda(
            h1_r, gid, nm, FULL_G, kind=cfg.readout)})
    t_ro_plain = time_graph_ms(torch, lambda: ref.segment_readout_ref(
        h1_r, gid, nm, FULL_G, kind=cfg.readout))
    t_ro_library = readout_library_ms(torch, h1_r, gid, p_real, FULL_G)
    phases_us = {}
    for label in ("F=32", "F=512", "pre F=512"):
        rows = breakdown[f"fused_mp_layer {label}"]
        node = sum(v for k, v in rows.items()
                   if k in ("split_transpose_kernel", "tf32x3_node_kernel",
                            "node_gemm_kernel"))
        edge = rows.get("scatter_kernel", 0.0)
        phases_us[label] = {"node_phase_us": node, "edge_phase_us": edge,
                            "zero_fills_us": sum(rows.values()) - node - edge}

    # least time for one bin's three layers: each input read once, the
    # output written once; the real edges' scatter on the FMA pipes, and the
    # product as three TF32 products on the tensor cores (the split) or, for
    # the record, as one float32 product on the FMA pipes
    def layer_bound(f, products, peak):
        ops = [(2.0 * q_real * f + q_real, PEAK_F32_FLOPS),
               (products * 2.0 * P * (2 * f) * H, peak)]
        nbytes = 4.0 * (P * f + 2 * Q + Q + P + 2 * f * H + H + P * H)
        return ops, nbytes
    bounds = []
    for products, peak in ((3, PEAK_TF32_FLOPS), (1, PEAK_F32_FLOPS)):
        (op0, by0) = layer_bound(F0, products, peak)
        (op1, by1) = layer_bound(H, products, peak)
        bounds.append((bound_ms(op0 + op1 + op1, by0 + 2 * by1),
                       {"f32": bound_ms(op0, by0)[0],
                        "f512": bound_ms(op1, by1)[0]}))
    ((mp_bound, mp_by), bound_layer), ((fma_bound, _), fma_layer) = bounds
    # the readout reads the real rows of h only, and the ids and mask of
    # every row; ro_bound_all counts all P rows of h, the earlier figure
    ro_flops = 3.0 * p_real * H + 2.0 * FULL_G * H
    ro_bound, ro_by = bound_ms(ro_flops, 4.0 * (p_real * H + 2 * P
                                                + FULL_G * 2 * H))
    ro_bound_all, _ = bound_ms(ro_flops, 4.0 * (P * H + 2 * P
                                                + FULL_G * 2 * H))
    blocks = cfg.n_gnn_blocks

    def per_bin(key):
        return t_mp["f32"][key] + (blocks - 1) * t_mp["f512"][key]
    entries = [
        {"name": "fused_mp_layer", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_mp.cu",
         "replaces": "src/repro/kernels/segment_spmm.py:370",
         "launches": None, "max_abs_err": max(err_mp, sweep_mp),
         "ms": per_bin("ms"), "plain_ms": per_bin("plain_ms"),
         "bound_ms": mp_bound, "bound_by": mp_by, "launches_per_unit": blocks,
         "bound_fma_ms": fma_bound,
         "library_ms": per_bin("product_torch_mm_ms"),
         "unit": f"one full bin: {blocks} GraphSAGE layers at P={P} Q={Q} "
                 f"F={F0}->{H}, then {H}->{H}",
         "per_layer": t_mp, "device_us_by_phase": phases_us,
         "full_bin_route": routes, "full_bin_max_abs_err": err_full,
         "bound_per_layer_ms": bound_layer,
         "bound_fma_per_layer_ms": fma_layer,
         "bound_note": "bound_ms: the product as three TF32 products at "
                       "495 TFLOP/s (the split), the edge scatter at the "
                       "FMA peak, or the bytes at 3.35 TB/s, whichever is "
                       "larger; bound_fma_ms: the product once at the "
                       "67 TFLOP/s FMA peak",
         "library_note": "the node phase's product alone: torch.mm on "
                         "[P, 2F] x [2F, H] float32 with allow_tf32=False, "
                         "summed over the bin's layers; no single PyTorch "
                         "call computes the gather, scatter-mean, combine "
                         "product and epilogue, and the port never calls "
                         "torch.mm here",
         "build": build_facts("fused_mp", ("HGMMA",))},
        {"name": "segment_readout", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/segment_readout.cu",
         "replaces": "src/repro/kernels/segment_spmm.py:241",
         "launches": None, "max_abs_err": max(err_ro, sweep_ro),
         "ms": t_ro, "cold_ms": t_ro_cold, "plain_ms": t_ro_plain,
         "bound_ms": ro_bound,
         "bound_by": ro_by, "bound_all_rows_ms": ro_bound_all,
         "library_ms": t_ro_library,
         "unit": f"one full bin: P={P} ({p_real} real) F={H} G={FULL_G} "
                 f"{cfg.readout}",
         "bound_note": "bound_ms: the real rows of h, the ids and mask of "
                       "all P rows and the output at 3.35 TB/s; "
                       "bound_all_rows_ms: all P rows of h, the bound "
                       "this entry carried before the real rows were "
                       "counted",
         "library_note": "two calls, not one: no single PyTorch call "
                         "computes the masked segment mean and max with "
                         "empty graphs at 0; library_ms is "
                         "torch.segment_reduce(h[:p_real], 'mean', "
                         "lengths=...) plus the same with 'max' on the "
                         "runs layout, timed as one function",
         "bitwise_repeat": True, "routes_sweep": ro_sweep["cases"],
         "timing_note": COLD_NOTE,
         "build": segment_build_facts("segment_readout")},
    ]
    info = {"graphs_in_full_bin": n_graphs, "real_nodes": p_real,
            "real_edges": q_real,
            "sweep_max_abs_err": {"fused_mp_layer": sweep_mp,
                                  **ro_sweep["max_abs_err"]}}
    return entries, breakdown, info


#: PR 19's reading of a full bin's GAT kernels, 3 x (edge_softmax +
#: fused_gat_aggregate) at 6.83 + 24.7 us, before they shared a CSR
GAT_BIN_PR19_MS = 0.0946


def gat_kernel_entries(torch, dev, cfg) -> tuple:
    """edge_softmax, fused_gat_aggregate and the CSR build they share at
    the GAT full bin: the first layer's projection, scores and attention,
    as ``_fused_mp_stack`` computes them. Each kernel is timed on the
    bin's shared CSR (its ``ms``) and building its own; the bin's GAT
    kernels, one build and three layers of both, as one graph."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_spmm import (dst_csr_cuda,
                                                  edge_softmax_cuda,
                                                  fused_gat_aggregate_cuda,
                                                  gat_plan)
    sweep_sm = sweep_edge_softmax(torch, dev)
    sweep_ga = sweep_gat_aggregate(torch, dev)
    batch, tree, _ = full_bin(torch, dev, cfg)
    lp = {k: torch.as_tensor(v, device=dev) for k, v in
          (("w", tree["gnn"]["b0"]["proj"]["w"]),
           ("src", tree["gnn"]["b0"]["att_src"]),
           ("dst", tree["gnn"]["b0"]["att_dst"]))}
    x, edges, em, nm = (batch["x"], batch["edges"], batch["edge_mask"],
                        batch["mask"])
    P, Q = x.shape[0], edges.shape[0]
    heads = lp["src"].shape[0]
    src, dst = edges[:, 0].long(), edges[:, 1].long()
    z = x @ lp["w"]
    D = z.shape[1]
    zh = z.reshape(P, heads, -1)
    es = torch.einsum("phd,hd->ph", zh, lp["src"])
    ed = torch.einsum("phd,hd->ph", zh, lp["dst"])
    s = torch.nn.functional.leaky_relu(ed[dst] + es[src], 0.2)[None]
    d32, em1 = edges[:, 1].contiguous()[None], em[None]
    q_real = int((em != 0).sum())
    pile = int((dst == 0).sum())

    csr = dst_csr_cuda(d32, P)
    csr_want = ref.dst_csr_ref(d32, P)
    att_k, att_r = twice_on_csr(
        torch, "edge_softmax full bin",
        lambda c: edge_softmax_cuda(s, d32, em1, P, csr=csr if c else None),
        lambda: ref.edge_softmax_ref(s, d32, em1, P))
    att = att_r[0].contiguous()
    out_k, out_r = twice_on_csr(
        torch, "fused_gat_aggregate full bin",
        lambda c: fused_gat_aggregate_cuda(z, edges, em, att, nm,
                                           csr=csr if c else None),
        lambda: ref.fused_gat_aggregate_ref(z, edges, em, att, nm))
    if not all(torch.equal(a, b) for a, b in zip(csr, csr_want)):
        raise AssertionError("dst_csr at the full bin differs from its "
                             "plain version")
    err_sm = check_close("edge_softmax full bin", att_k, att_r,
                         KERNEL_ATOL, KERNEL_RTOL)
    err_ga = check_close("fused_gat_aggregate full bin", out_k, out_r,
                         KERNEL_ATOL, KERNEL_RTOL)

    def layers(c):
        """the bin's three layers of both kernels on one CSR"""
        for _ in range(cfg.n_gnn_blocks):
            edge_softmax_cuda(s, d32, em1, P, csr=c)
            fused_gat_aggregate_cuda(z, edges, em, att, nm, csr=c)

    calls = {
        "edge_softmax": (
            lambda: edge_softmax_cuda(s, d32, em1, P, csr=csr),
            lambda: edge_softmax_cuda(s, d32, em1, P),
            lambda: ref.edge_softmax_ref(s, d32, em1, P)),
        "fused_gat_aggregate": (
            lambda: fused_gat_aggregate_cuda(z, edges, em, att, nm, csr=csr),
            lambda: fused_gat_aggregate_cuda(z, edges, em, att, nm),
            lambda: ref.fused_gat_aggregate_ref(z, edges, em, att, nm)),
        "dst_csr": (lambda: dst_csr_cuda(d32, P), None, None),
    }
    times = {k: {"ms": time_graph_ms(torch, shared),
                 "standalone_ms": (time_graph_ms(torch, own)
                                   if own is not None else None),
                 "plain_ms": (time_graph_ms(torch, plain)
                              if plain is not None else None)}
             for k, (shared, own, plain) in calls.items()}
    # the plain CSR's bincount reads its input's max on the host, so it
    # cannot be captured in a graph: CUDA events around 20 eager calls
    times["dst_csr"]["plain_ms"] = time_eager_ms(
        torch, lambda: ref.dst_csr_ref(d32, P))
    bin_ms = time_graph_ms(torch, lambda: layers(dst_csr_cuda(d32, P)),
                           calls=5)
    breakdown = device_breakdown_us(torch, {
        **{k: shared for k, (shared, _, _) in calls.items()},
        **{f"{k} standalone": own for k, (_, own, _) in calls.items()
           if own is not None}})
    # each input read once, each output written once; the operations this
    # run's real edges need: max, subtract, exp, scale, add and divide per
    # (edge, head); a product, two scalings and an add per (edge, feature)
    sm_bound, sm_by = bound_ms(6.0 * q_real * heads,
                               4.0 * (2 * Q * heads + 2 * Q))
    ga_bound, ga_by = bound_ms(4.0 * q_real * D,
                               4.0 * (2 * P * D + 3 * Q + Q * heads + P))
    # the build reads dst and writes rowptr and perm; its work is integer
    csr_bound, csr_by = bound_ms(0.0, 4.0 * (Q + (P + 1) + Q))
    blocks = cfg.n_gnn_blocks
    route = gat_plan(D, heads, z.data_ptr() % 16 == 0).route

    def per_bin(name, key):
        v = times[name][key]
        return None if v is None else v * blocks
    entries = [
        {"name": "edge_softmax", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/edge_softmax.cu",
         "replaces": "src/repro/kernels/segment_spmm.py:622",
         "launches": None, "max_abs_err": max(err_sm, sweep_sm),
         "ms": per_bin("edge_softmax", "ms"), "launches_per_unit": blocks,
         "standalone_ms": per_bin("edge_softmax", "standalone_ms"),
         "plain_ms": per_bin("edge_softmax", "plain_ms"),
         "bound_ms": sm_bound * blocks, "bound_by": sm_by,
         "library_ms": None, "build": segment_build_facts("edge_softmax"),
         "unit": f"one full bin: {blocks} GAT layers, each B=1 E={Q} "
                 f"H={heads} N={P} on the bin's shared CSR",
         "per_layer": times["edge_softmax"], "bound_per_layer_ms": sm_bound,
         "standalone_note": "standalone_ms: each call builds its own CSR "
                            "(a dst_csr launch, then the softmax)",
         "library_note": "no single PyTorch call computes a segment "
                         "softmax over a destination index"},
        {"name": "fused_gat_aggregate", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gat_aggregate.cu",
         "replaces": "src/repro/kernels/segment_spmm.py:503",
         "launches": None, "max_abs_err": max(err_ga, sweep_ga),
         "ms": per_bin("fused_gat_aggregate", "ms"),
         "launches_per_unit": blocks,
         "standalone_ms": per_bin("fused_gat_aggregate", "standalone_ms"),
         "plain_ms": per_bin("fused_gat_aggregate", "plain_ms"),
         "bound_ms": ga_bound * blocks, "bound_by": ga_by,
         "library_ms": None, "full_bin_route": route,
         "build": segment_build_facts("gat_aggregate"),
         "unit": f"one full bin: {blocks} GAT layers, each P={P} Q={Q} "
                 f"D={D} H={heads} on the bin's shared CSR",
         "per_layer": times["fused_gat_aggregate"],
         "bound_per_layer_ms": ga_bound,
         "standalone_note": "standalone_ms: each call builds its own CSR "
                            "(a dst_csr launch, then the aggregate)",
         "library_note": "no single PyTorch call computes the per-head "
                         "gather ⊙ attention → masked scatter"},
        {"name": "dst_csr", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/dst_csr.cuh",
         "replaces": "src/repro/kernels/segment_spmm.py:503",
         "replaces_note": "no TPU kernel of its own: the edge order that "
                          "_fused_gat_kernel's and _softmax_stats_kernel's "
                          "sequential grids walk (:455, :558), built once a "
                          "bin for both GAT kernels",
         "launches": None, "max_abs_err": 0.0,
         "ms": times["dst_csr"]["ms"], "launches_per_unit": 1,
         "plain_ms": times["dst_csr"]["plain_ms"],
         "bound_ms": csr_bound, "bound_by": csr_by, "library_ms": None,
         "unit": f"one full bin: B=1 E={Q} N={P}, once a bin",
         "library_note": "no single PyTorch call builds rowptr and a stable "
                         "destination order (a stable argsort gives the "
                         "order alone)"},
    ]
    info = {"gat_real_edges": q_real, "gat_node0_segment": pile,
            "gat_bin_kernels_ms": bin_ms,
            "gat_bin_kernels_ms_pr19": GAT_BIN_PR19_MS,
            "sweep_max_abs_err": {"edge_softmax": sweep_sm,
                                  "fused_gat_aggregate": sweep_ga}}
    return entries, breakdown, info


def train_steps(layout: str) -> dict:
    """The first step of the training segment with the largest node
    axis, as ``train_pmgns`` stacks the ``train_path`` data in epoch 0."""
    from repro_torch.core.batching import stack_epoch_segments
    from repro_torch.dataset.builder import synthetic_samples
    from repro_torch.train.gnn_trainer import _epoch_rng
    samples = synthetic_samples(TRAIN_SAMPLES, seed=1, n_min=16, n_max=200)
    segs = stack_epoch_segments(samples, TRAIN_BATCH, rng=_epoch_rng(0, 0),
                                layout=layout)
    seg = max(segs, key=lambda sg: sg["x"].shape[-2])
    return {k: v[0] for k, v in seg.items()}


COLD_NOTE = ("ms, plain_ms and library_ms are warm: time_graph_ms replays "
             "20 calls on the same buffers, which stay in the 50 MB L2. "
             "cold_ms and library_cold_ms are time_cold_ms's: each call "
             "reads its own copy of the inputs and writes its own output, "
             "more than 150 MB in all, so every call moves its bytes to and "
             "from device memory. bound_ms (3.35 TB/s) applies to the cold "
             "times only.")


def dense_strip_timings(torch, dev, b, n, f) -> dict:
    """B7 in sum form where every strip is dense (a random 10 % adjacency,
    as tests/test_torch_segment.py draws its dense cases, and all ones),
    held against its plain version and timed warm beside ``torch.bmm``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.sage_spmm import dense_aggregate_cuda
    rng = np.random.default_rng(4100)
    hd = torch.as_tensor(rng.standard_normal((b, n, f)).astype(np.float32),
                         device=dev)
    cases = {"random_10pct": (rng.random((b, n, n)) < 0.1).astype(np.float32),
             "all_ones": np.ones((b, n, n), np.float32)}
    out = {}
    for name, a in cases.items():
        adj = torch.as_tensor(a, device=dev)
        got = dense_aggregate_cuda(adj, hd, "sum")
        want = ref.dense_aggregate_ref(adj, hd, "sum")
        torch.cuda.synchronize()
        err = check_close(f"dense_aggregate sum, {name}", got, want,
                          KERNEL_ATOL, KERNEL_RTOL)
        out[name] = {
            "ms": time_graph_ms(torch, lambda: dense_aggregate_cuda(
                adj, hd, "sum")),
            "library_ms": time_graph_ms(torch, lambda: torch.bmm(adj, hd)),
            "max_abs_err": err, "shape": f"B={b} N={n} F={f}"}
    return out


def train_kernel_entries(torch, dev) -> tuple:
    """segment_aggregate, segment_scatter, segment_gather and
    dense_aggregate at the full-width training shapes of ``train_path``
    (hidden 512), held against their plain versions and timed beside
    their bound, plain version and library call; the gather, B7's three
    forms and their library calls timed cold as well (``time_cold_ms``),
    and B7 on dense strips (``dense_strip_timings``); the sweeps of all
    three sources and of every autograd.Function's backward."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.sage_spmm import dense_aggregate_cuda
    from repro_torch.kernels.segment_spmm import (dst_csr_cuda,
                                                  segment_aggregate_cuda,
                                                  segment_gather_cuda,
                                                  segment_plan,
                                                  segment_scatter_cuda)
    sweep, route_cases = sweep_segment(torch, dev)
    sweep["dense_aggregate"] = sweep_dense(torch, dev)
    back = sweep_backward(torch, dev)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    rng = np.random.default_rng(4000)
    hid = TRAIN_HIDDEN

    # packed step: B=1 over the flat axis (B5 forward; B6 and the gather
    # at GAT's projected width)
    pk = train_steps("packed")
    edges, em = t(pk["edges"][None]), t(pk["edge_mask"][None])
    p_nodes, q = pk["x"].shape[0], pk["edges"].shape[0]
    q_real = int(pk["edge_mask"].sum())
    h = t(rng.standard_normal((1, p_nodes, hid)).astype(np.float32))
    msgs = t(rng.standard_normal((1, q, hid)).astype(np.float32))
    # B6 at GAT's per-head width too: 3 of its 5 launches a layer step
    msgs4 = t(rng.standard_normal((1, q, 4)).astype(np.float32))
    dst, src = edges[..., 1], edges[..., 0]
    # dense step: the largest bucket
    dn = train_steps("dense")
    adj = t(dn["adj"])
    b, n = adj.shape[:2]
    nnz = int((dn["adj"] != 0).sum())
    hd = t(rng.standard_normal((b, n, hid)).astype(np.float32))
    deg = adj.sum(-1)
    inv = (1.0 / deg.clamp_min(1.0)).contiguous()

    pairs = {
        "segment_aggregate": (
            lambda: segment_aggregate_cuda(edges, em, h, "mean"),
            lambda: ref.segment_aggregate_ref(edges, em, h, "mean")),
        "segment_aggregate_sum": (
            lambda: segment_aggregate_cuda(edges, em, h, "sum"),
            lambda: ref.segment_aggregate_ref(edges, em, h, "sum")),
        "segment_scatter": (
            lambda: segment_scatter_cuda(dst, em, msgs, p_nodes),
            lambda: ref.segment_scatter_ref(dst, em, msgs, p_nodes)),
        "segment_scatter_f4": (
            lambda: segment_scatter_cuda(dst, em, msgs4, p_nodes),
            lambda: ref.segment_scatter_ref(dst, em, msgs4, p_nodes)),
        "segment_gather": (
            lambda: segment_gather_cuda(h, src),
            lambda: ref.segment_gather_ref(h, src)),
        "dense_aggregate": (
            lambda: dense_aggregate_cuda(adj, hd, "mean"),
            lambda: ref.dense_aggregate_ref(adj, hd, "mean")),
        "dense_aggregate_backward": (
            lambda: dense_aggregate_cuda(adj, hd, "sum", scale=inv,
                                         transpose=True),
            lambda: ref.dense_aggregate_ref(adj, hd, "sum", scale=inv,
                                            transpose=True)),
        "dense_aggregate_sum": (
            lambda: dense_aggregate_cuda(adj, hd, "sum"),
            lambda: ref.dense_aggregate_ref(adj, hd, "sum")),
    }
    err, times = {}, {}
    for name, (kern, plain) in pairs.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err[name] = check_close(f"{name} at training width", got, want,
                                KERNEL_ATOL, KERNEL_RTOL)
        times[name] = {"ms": time_graph_ms(torch, kern),
                       "plain_ms": time_graph_ms(torch, plain)}
    # one PyTorch call each that computes the same function
    flat_dst = (dst.long() + 0).reshape(-1)
    weighted = (msgs * em[..., None]).reshape(-1, hid).contiguous()
    weighted4 = (msgs4 * em[..., None]).reshape(-1, 4).contiguous()
    h2 = h[0]
    src_flat = src.reshape(-1).long()

    def index_add(x, w):
        return torch.zeros((p_nodes, w.shape[1]), device=dev).index_add_(
            0, x, w)
    library = {
        "segment_scatter": time_graph_ms(
            torch, lambda: index_add(flat_dst, weighted)),
        "segment_scatter_f4": time_graph_ms(
            torch, lambda: index_add(flat_dst, weighted4)),
        "segment_gather": time_graph_ms(
            torch, lambda: torch.index_select(h2, 0, src_flat)),
        "dense_aggregate_sum": time_graph_ms(torch,
                                             lambda: torch.bmm(adj, hd)),
    }
    us = device_breakdown_us(torch, {k: v[0] for k, v in pairs.items()})
    # the CSR build alone, as the scatter (dst) and the aggregate (dst and
    # src) build it
    csr_ms = {"dst": time_graph_ms(torch, lambda: dst_csr_cuda(dst, p_nodes)),
              "dst_src": time_graph_ms(torch, lambda: dst_csr_cuda(
                  dst, p_nodes, src))}

    # the gather, B7 and their library calls again from device memory: each
    # call on its own copy of the inputs and its own output
    hs = [h] + [h.clone() for _ in range(cold_copies(
        4.0 * (p_nodes * hid + q * hid)) - 1)]
    k = cold_copies(4.0 * (b * n * n + 2 * b * n * hid))
    dense_in = [(adj, hd, inv)] + [(adj.clone(), hd.clone(), inv.clone())
                                   for _ in range(k - 1)]
    cold = {
        "segment_gather": time_cold_ms(
            torch, [lambda x=x: segment_gather_cuda(x, src) for x in hs]),
        "index_select": time_cold_ms(
            torch, [lambda x=x: torch.index_select(x[0], 0, src_flat)
                    for x in hs]),
        "dense_aggregate": time_cold_ms(
            torch, [lambda a=a, x=x: dense_aggregate_cuda(a, x, "mean")
                    for a, x, _ in dense_in]),
        "dense_aggregate_sum": time_cold_ms(
            torch, [lambda a=a, x=x: dense_aggregate_cuda(a, x, "sum")
                    for a, x, _ in dense_in]),
        "dense_aggregate_backward": time_cold_ms(
            torch, [lambda a=a, x=x, s=s: dense_aggregate_cuda(
                a, x, "sum", scale=s, transpose=True)
                for a, x, s in dense_in]),
        "bmm": time_cold_ms(
            torch, [lambda a=a, x=x: torch.bmm(a, x) for a, x, _ in dense_in]),
    }
    del hs, dense_in

    def copies(nbytes, *ts):
        return [ts] + [tuple(x.clone() for x in ts)
                       for _ in range(cold_copies(nbytes) - 1)]
    sc = copies(4.0 * (q * hid + 3 * q + p_nodes * hid), edges, em, msgs)
    sc4 = copies(4.0 * (q * 4 + 3 * q + p_nodes * 4), edges, em, msgs4)
    ag = copies(4.0 * (2 * p_nodes * hid + 3 * q + p_nodes), edges, em, h)
    ia = copies(4.0 * (q * hid + q + p_nodes * hid), flat_dst, weighted)
    ia4 = copies(4.0 * (q * 4 + q + p_nodes * 4), flat_dst, weighted4)
    cold.update({
        "segment_scatter": time_cold_ms(torch, [
            lambda x=x: segment_scatter_cuda(x[0][..., 1], x[1], x[2],
                                             p_nodes) for x in sc]),
        "segment_scatter_f4": time_cold_ms(torch, [
            lambda x=x: segment_scatter_cuda(x[0][..., 1], x[1], x[2],
                                             p_nodes) for x in sc4]),
        "segment_aggregate": time_cold_ms(torch, [
            lambda x=x: segment_aggregate_cuda(*x, "mean") for x in ag]),
        "segment_aggregate_sum": time_cold_ms(torch, [
            lambda x=x: segment_aggregate_cuda(*x, "sum") for x in ag]),
        "index_add": time_cold_ms(torch, [lambda x=x: index_add(*x)
                                          for x in ia]),
        "index_add_f4": time_cold_ms(torch, [lambda x=x: index_add(*x)
                                             for x in ia4]),
    })
    del sc, sc4, ag, ia, ia4
    dense_strips = dense_strip_timings(torch, dev, b, n, hid)

    # bounds: each input read once, each output written once; the
    # operations this run's data needs (real edges; the adjacency's
    # nonzeros, which the dense product does not skip)
    bounds = {
        "segment_aggregate": bound_ms(
            2.0 * q_real * hid + p_nodes * hid,
            4.0 * (2 * p_nodes * hid + 3 * q + p_nodes)),
        "segment_aggregate_sum": bound_ms(
            2.0 * q_real * hid, 4.0 * (2 * p_nodes * hid + 3 * q)),
        "segment_scatter": bound_ms(
            2.0 * q_real * hid, 4.0 * (q * hid + 2 * q + p_nodes * hid)),
        "segment_scatter_f4": bound_ms(
            2.0 * q_real * 4, 4.0 * (q * 4 + 2 * q + p_nodes * 4)),
        "segment_gather": bound_ms(0.0, 4.0 * (p_nodes * hid + q
                                              + q * hid)),
        "dense_aggregate": bound_ms(
            2.0 * nnz * hid + b * n * hid + b * n * n,
            4.0 * (b * n * n + 2 * b * n * hid)),
    }
    src_root = "src/repro_torch/kernels/csrc/"
    shapes_p = f"B=1 N={p_nodes} E={q} ({q_real} real) F={hid}"
    seg_build = segment_build_facts()
    routes = {f: segment_plan(f, q, True).route for f in (hid, 4)}
    entries = [
        {"name": "segment_aggregate", "route": "cuda",
         "source": src_root + "segment_aggregate.cu",
         "replaces": "src/repro/kernels/segment_spmm.py:125",
         "launches": None,
         "max_abs_err": max(err["segment_aggregate"],
                            err["segment_aggregate_sum"],
                            sweep["segment_aggregate"],
                            back.get("segment_aggregate", 0.0)),
         **times["segment_aggregate"],
         "bound_ms": bounds["segment_aggregate"][0],
         "bound_by": bounds["segment_aggregate"][1], "library_ms": None,
         "unit": f"one packed training layer, mean: {shapes_p}",
         "route": routes[hid], "cold_ms": cold["segment_aggregate"],
         "sum": {**times["segment_aggregate_sum"],
                 "cold_ms": cold["segment_aggregate_sum"],
                 "bound_ms": bounds["segment_aggregate_sum"][0],
                 "bound_by": bounds["segment_aggregate_sum"][1]},
         "csr_build_ms": csr_ms["dst_src"],
         "device_us_by_kernel": {k: us[k] for k in (
             "segment_aggregate", "segment_aggregate_sum")},
         "build": seg_build,
         "library_note": "no single PyTorch call gathers, weights, "
                         "scatters and divides by the weighted degree",
         "timing_note": COLD_NOTE},
        {"name": "segment_scatter", "route": "cuda",
         "source": src_root + "segment_aggregate.cu",
         "replaces": "src/repro/kernels/segment_spmm.py:177",
         "launches": None,
         "max_abs_err": max(err["segment_scatter"], err["segment_scatter_f4"],
                            sweep["segment_scatter"],
                            back.get("segment_scatter", 0.0)),
         **times["segment_scatter"],
         "bound_ms": bounds["segment_scatter"][0],
         "bound_by": bounds["segment_scatter"][1],
         "library_ms": library["segment_scatter"],
         "unit": f"one packed GAT layer's scatter: {shapes_p}",
         "route": routes[hid], "cold_ms": cold["segment_scatter"],
         "library_cold_ms": cold["index_add"],
         "f4": {"unit": "the same edges at GAT's per-head width, F=4",
                "route": routes[4], **times["segment_scatter_f4"],
                "cold_ms": cold["segment_scatter_f4"],
                "bound_ms": bounds["segment_scatter_f4"][0],
                "bound_by": bounds["segment_scatter_f4"][1],
                "library_ms": library["segment_scatter_f4"],
                "library_cold_ms": cold["index_add_f4"]},
         "csr_build_ms": csr_ms["dst"],
         "device_us_by_kernel": {k: us[k] for k in (
             "segment_scatter", "segment_scatter_f4")},
         "routes_sweep": route_cases,
         "build": seg_build,
         "library_note": "index_add_ of the pre-weighted messages into a "
                         "fresh zero tensor, flattened",
         "timing_note": COLD_NOTE},
        {"name": "segment_gather", "route": "cuda",
         "source": src_root + "segment_aggregate.cu",
         "replaces": "src/repro/kernels/segment_spmm.py:53",
         "launches": None,
         "max_abs_err": max(err["segment_gather"], sweep["segment_gather"],
                            back.get("segment_gather", 0.0)),
         **times["segment_gather"],
         "bound_ms": bounds["segment_gather"][0],
         "bound_by": bounds["segment_gather"][1],
         "library_ms": library["segment_gather"],
         "cold_ms": cold["segment_gather"],
         "library_cold_ms": cold["index_select"],
         "unit": f"one packed GAT layer's z[src] gather: {shapes_p}",
         "library_note": "index_select of the flat rows",
         "timing_note": COLD_NOTE},
        {"name": "dense_aggregate", "route": "cuda",
         "source": src_root + "dense_aggregate.cu",
         "replaces": "src/repro/kernels/sage_spmm.py:42",
         "launches": None,
         "max_abs_err": max(err["dense_aggregate"],
                            err["dense_aggregate_backward"],
                            err["dense_aggregate_sum"],
                            sweep["dense_aggregate"],
                            back.get("dense_aggregate", 0.0),
                            *(c["max_abs_err"] for c in
                              dense_strips.values())),
         **times["dense_aggregate"],
         "bound_ms": bounds["dense_aggregate"][0],
         "bound_by": bounds["dense_aggregate"][1],
         "library_ms": library["dense_aggregate_sum"],
         "unit": f"one dense training layer, mean: B={b} N={n} F={hid} "
                 f"({nnz} nonzeros of {b * n * n})",
         "sum_ms": times["dense_aggregate_sum"]["ms"],
         "backward_ms": times["dense_aggregate_backward"]["ms"],
         "cold_ms": cold["dense_aggregate"],
         "sum_cold_ms": cold["dense_aggregate_sum"],
         "backward_cold_ms": cold["dense_aggregate_backward"],
         "library_cold_ms": cold["bmm"],
         "dense_strips": dense_strips,
         "dense_product_flops": 2.0 * b * n * n * hid,
         "library_note": "torch.bmm(adj, h): the sum form; compare with "
                         "sum_ms (warm) and sum_cold_ms (cold)",
         "timing_note": COLD_NOTE},
    ]
    info = {"train_shapes": {"packed": shapes_p,
                             "dense": f"B={b} N={n} F={hid}"},
            "device_us_per_call": us,
            "sweep_max_abs_err": sweep, "backward_max_abs_err": back}
    return entries, info


def readout_backward_composition(torch, h, gid, w, z, g,
                                 kind: str = "mean_max"):
    """The readout's gradient as the port composed it before it had a
    kernel of its own: a gather of the max, a scatter of the counts and
    ties, a gather of the per-graph gradient back, through the
    ``segment_gather`` / ``segment_scatter`` wrappers, then elementwise
    ops. Timed beside the kernel that replaced it; the port no longer
    calls it."""
    from repro_torch.kernels.segment_spmm import (segment_gather_cuda,
                                                  segment_scatter_cuda)
    f = h.shape[1]
    gid2 = gid[None]
    cols = [w[:, None]]
    if kind == "mean_max":
        mx = segment_gather_cuda(z[None, :, f:].contiguous(), gid2)[0]
        eq = ((h == mx) & (w[:, None] > 0)).to(h.dtype)
        cols.append(eq)
    ones = torch.ones((1, h.shape[0]), dtype=h.dtype, device=h.device)
    sums = segment_scatter_cuda(gid2, ones,
                                torch.cat(cols, dim=1).contiguous()[None],
                                g.shape[0])[0]
    per_graph = g[:, :f] / sums[:, :1].clamp_min(1.0)
    if kind == "mean_max":
        per_graph = torch.cat(
            [per_graph, g[:, f:] / sums[:, 1:].clamp_min(1.0)], dim=1)
    back = segment_gather_cuda(per_graph.contiguous()[None], gid2)[0]
    dh = w[:, None] * back[:, :f]
    if kind == "mean_max":
        dh = dh + eq * back[:, f:]
    return dh


def readout_backward_entry(torch, dev, sweep_err: float) -> dict:
    """segment_readout_backward at ``train_path``'s packed step (P=8192,
    G=32, hidden 512) and at P=1024 with G=32 graphs, each against its
    plain version and the composition it replaced, all three timed in this
    run; the composition's device µs by kernel at both shapes."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_spmm import (
        readout_plan, segment_readout_backward_cuda, segment_readout_cuda)
    rng = np.random.default_rng(4200)
    hid = TRAIN_HIDDEN
    pk = train_steps("packed")
    small = readout_runs(rng, 1024, rng.integers(16, 36, 32), hid)[1:]
    shapes = {"train step": (pk["graph_ids"].astype(np.int32), pk["mask"],
                             pk["static"].shape[0]),
              "P=1024": (*small, 32)}
    out, err = {}, 0.0
    for label, (ids, nm, g) in shapes.items():
        p = ids.shape[0]
        p_real = int((nm > 0).sum())
        h = torch.as_tensor(rng.standard_normal((p, hid)).astype(np.float32),
                            device=dev)
        gid, w = torch.as_tensor(ids, device=dev), torch.as_tensor(
            nm, device=dev)
        z = segment_readout_cuda(h, gid, w, g)
        gz = torch.as_tensor(rng.standard_normal(tuple(z.shape)).astype(
            np.float32), device=dev)
        calls = {
            "ms": lambda: segment_readout_backward_cuda(h, gid, w, z, gz),
            "plain_ms": lambda: ref.segment_readout_backward_ref(
                h, gid, w, z, gz),
            "composition_ms": lambda: readout_backward_composition(
                torch, h, gid, w, z, gz)}
        got = {k: fn() for k, fn in calls.items()}
        again = calls["ms"]()
        torch.cuda.synchronize()
        if not same_bits(torch, got["ms"], again):
            raise AssertionError(f"readout backward {label}: two runs "
                                 f"differ in their bits")
        for k in ("ms", "composition_ms"):
            err = max(err, check_close(
                f"readout backward {label} ({k[:-3] or 'kernel'})", got[k],
                got["plain_ms"], KERNEL_ATOL, KERNEL_RTOL))
        row = {k: time_graph_ms(torch, fn) for k, fn in calls.items()}
        copies = [(h, gid, w, z, gz)] + [
            tuple(x.clone() for x in (h, gid, w, z, gz))
            for _ in range(cold_copies(4.0 * (2 * p * hid + 2 * p
                                              + 4 * g * hid)) - 1)]
        row["cold_ms"] = time_cold_ms(torch, [
            lambda x=x: segment_readout_backward_cuda(*x) for x in copies])
        del copies
        nbytes = 4.0 * (p_real * hid + 2 * p + 3 * g * hid + p * hid)
        row["bound_ms"], row["bound_by"] = bound_ms(
            4.0 * p_real * hid + 2.0 * g * hid, nbytes)
        row["shape"] = f"P={p} ({p_real} real) F={hid} G={g} mean_max, " \
                       f"route {readout_plan(ids, nm)}"
        row["composition_device_us"] = device_breakdown_us(
            torch, {"c": calls["composition_ms"]})["c"]
        out[label] = row
    step = out["train step"]
    return {"name": "segment_readout_backward", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/segment_readout.cu",
            "replaces": "src/repro/kernels/segment_spmm.py:241",
            "launches": None, "max_abs_err": max(err, sweep_err),
            "ms": step["ms"], "cold_ms": step["cold_ms"],
            "plain_ms": step["plain_ms"],
            "bound_ms": step["bound_ms"], "bound_by": step["bound_by"],
            "library_ms": None, "composition_ms": step["composition_ms"],
            "timing_note": COLD_NOTE,
            "unit": f"one packed training step's readout gradient: "
                    f"{step['shape']}",
            "shapes": out, "bitwise_repeat": True,
            "replaces_note": "the gradient of B2; the JAX package "
                             "differentiates its plain composition, which "
                             "has no Pallas kernel of its own",
            "library_note": "no single PyTorch call computes the masked "
                            "mean and tied-max gradient; composition_ms is "
                            "the gather + scatter + gather composition it "
                            "replaced, on this tree's wrappers"}


def phase_kernels(torch, dev, sage_cfg, gat_cfg) -> list:
    t0 = time.perf_counter()
    sage, sage_us, sage_info = sage_kernel_entries(torch, dev, sage_cfg)
    gat, gat_us, gat_info = gat_kernel_entries(torch, dev, gat_cfg)
    train, train_info = train_kernel_entries(torch, dev)
    train.append(readout_backward_entry(
        torch, dev, sage_info["sweep_max_abs_err"]["segment_readout_backward"]))
    lm_entries, lm_info = lm_kernel_entries(torch, dev)
    back = train_info["backward_max_abs_err"]
    for e in sage + gat:
        # the backward passes of the readout and the edge softmax
        e["max_abs_err"] = max(e["max_abs_err"], back.get(e["name"], 0.0))
    entries = sage + gat + train + lm_entries
    emit({"phase": "kernels", "seconds": round(time.perf_counter() - t0, 3),
          **sage_info, **{k: v for k, v in gat_info.items()
                          if k != "sweep_max_abs_err"},
          "sweep_max_abs_err": {**sage_info["sweep_max_abs_err"],
                                **gat_info["sweep_max_abs_err"],
                                **train_info["sweep_max_abs_err"],
                                **lm_info["sweep_max_abs_err"]},
          "backward_max_abs_err": back,
          "train_shapes": train_info["train_shapes"],
          "tolerance": {"atol": KERNEL_ATOL, "rtol": KERNEL_RTOL,
                        "bfloat16": KERNEL_BF16_TOL},
          "device_us_per_call": {**sage_us, **gat_us,
                                 **train_info["device_us_per_call"],
                                 **lm_info["device_us_per_call"]},
          "kernels": entries})
    return entries


def path_kernels(variant: str) -> dict:
    """The wrappers a variant's forward launches, each with its launches
    per bin (per layer, or once): GAT builds one CSR a bin, which its
    layers' edge softmax and aggregate share."""
    from repro_torch.kernels import segment_spmm as k
    per_layer = {"graphsage": ["fused_mp_layer_cuda"],
                 "gat": ["edge_softmax_cuda", "fused_gat_aggregate_cuda"]}
    out = {name.removesuffix("_cuda"): (getattr(k, name), "layer")
           for name in per_layer[variant]}
    if variant == "gat":
        out["dst_csr"] = (k.dst_csr_cuda, "bin")
    out["segment_readout"] = (k.segment_readout_cuda, "bin")
    return out


#: the wrappers that count their calls on a shared CSR and on their own
CSR_SHARERS = ("edge_softmax", "fused_gat_aggregate")


def zero_counts(kernels: dict) -> None:
    """Every launch count of ``kernels`` (``path_kernels``) to 0, its
    routes' and CSR counts too."""
    for fn, _ in kernels.values():
        fn.launches = 0
        for key in ("route_launches", "csr_launches"):
            if hasattr(fn, key):
                setattr(fn, key, dict.fromkeys(getattr(fn, key), 0))


def readout_forward_counts() -> dict:
    """The readout's forward launches by route on the current device, from
    the kernel's own counters (``segment_spmm.readout_route_counts``)."""
    from repro_torch.kernels.segment_spmm import readout_route_counts
    return readout_route_counts()["forward"]


def readout_route_diff(before: dict) -> dict:
    """The readout's forward launches by route since ``before``."""
    now = readout_forward_counts()
    return {r: now[r] - before[r] for r in now}


def check_shared_csr(kernels: dict, launches: dict, phase: str) -> dict:
    """Each CSR sharer's calls on the path, by CSR: all must have used the
    bin's shared CSR."""
    out = {}
    for name in CSR_SHARERS:
        if name not in kernels:
            continue
        got = dict(kernels[name][0].csr_launches)
        if got != {"shared": launches[name], "own": 0}:
            raise AssertionError(f"{phase}: {name} ran {got}, not every "
                                 f"launch on the bin's shared CSR")
        out[name] = got
    return out


def path_inputs() -> tuple:
    """The main path's inputs: six seeded ``repro.opgraph.v1`` DAGs of
    20–800 nodes (their sizes, documents and graphs) and 400 synthetic
    graphs of 16–200 nodes."""
    from repro_torch.core import from_json
    from repro_torch.dataset.builder import synthetic_samples
    rng = np.random.default_rng(11)
    sizes = [20, 75, 160, 333, 512, 800]
    docs = [random_dag_doc(rng, n, i) for i, n in enumerate(sizes)]
    graphs = [from_json(d) for d in docs]
    samples = synthetic_samples(400, seed=1, n_min=16, n_max=200)
    return sizes, docs, graphs, samples


def pred_rows(preds) -> np.ndarray:
    """``[n, 3]`` of a list of ``Prediction``s."""
    return np.asarray([[p.latency_ms, p.energy_j, p.memory_mb]
                       for p in preds])


def phase_path(torch, cfg, name_limit: str, phase: str) -> tuple:
    """Drive one variant's main path on the card and hold it against the
    CPU; returns the launch counts and the card's ``DIPPM``."""
    from repro_torch.core import DIPPM, pmgns_init
    sizes, docs, graphs, samples = path_inputs()
    tree = pmgns_init(0, cfg)
    dippm = DIPPM.from_params(tree, cfg)          # on the card by default
    if dippm.device.type != "cuda":
        raise AssertionError(f"DIPPM ran on {dippm.device}")
    engine = dippm.engine()
    kernels = path_kernels(cfg.variant)

    zero_counts(kernels)
    routes0 = readout_forward_counts()
    fused = kernels.get("fused_mp_layer", (None,))[0]
    t0 = time.perf_counter()
    warmed = engine.warmup(rungs="all")
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    one = dippm.predict_json(docs[0])
    many, _ = dippm.predict_many(graphs, return_stats=True)
    bins_before = engine.stats.batches_run
    bulk_s, bulk_ys = [], []
    for _ in range(BULK_REPEATS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ys = engine.predict_samples(samples)
        torch.cuda.synchronize()
        bulk_s.append(time.perf_counter() - t1)
        bulk_ys.append(np.asarray(ys))
    t_bulk = statistics.median(bulk_s)
    launches = {name: fn.launches for name, (fn, _) in kernels.items()}
    readout_routes = readout_route_diff(routes0)
    # every bin of the bulk, run BULK_REPEATS times: GAT's kernels sum in
    # a fixed order, so its predictions must repeat bit for bit; B1's edge
    # phase still adds with float atomics, so GraphSAGE's are recorded
    bulk_bitwise = all(y.tobytes() == bulk_ys[0].tobytes() for y in bulk_ys)
    if cfg.variant == "gat" and not bulk_bitwise:
        raise AssertionError(f"{phase}: the bulk's predictions differ in "
                             f"their bits between repeats")
    routes = dict(fused.route_launches) if fused is not None else None
    gat_routes = (dict(kernels["fused_gat_aggregate"][0].route_launches)
                  if "fused_gat_aggregate" in kernels else None)
    csr_use = check_shared_csr(kernels, launches, phase)
    stats = engine.stats.snapshot()
    bulk_bins = (stats.batches_run - bins_before) // BULK_REPEATS

    runs = stats.batches_run + warmed
    want = {name: runs * (cfg.n_gnn_blocks if per == "layer" else 1)
            for name, (_, per) in kernels.items()}
    if launches != want or min(launches.values()) <= 0:
        raise AssertionError(f"{phase}: launch counts {launches} != bins x "
                             f"layers {want} ({stats.batches_run} bins + "
                             f"{warmed} warmup shapes)")
    if readout_routes != {"runs": launches["segment_readout"],
                          "general": 0}:
        raise AssertionError(f"{phase}: segment_readout ran the routes "
                             f"{readout_routes}, not the runs route of a "
                             f"packed bin ({launches['segment_readout']} "
                             f"launches)")
    if routes is not None and routes != {
            "tf32x3": launches["fused_mp_layer"], "fma": 0}:
        raise AssertionError(f"{phase}: fused_mp_layer ran the routes "
                             f"{routes}, not the tensor-core one throughout")
    card = np.concatenate([
        np.asarray([[p.latency_ms, p.energy_j, p.memory_mb]
                    for p in [one] + many]), ys])
    if card.shape != (1 + len(graphs) + len(samples), cfg.n_targets) or \
            not np.isfinite(card).all():
        raise AssertionError(f"{phase}: bad predictions: shape {card.shape}, "
                             f"finite {np.isfinite(card).all()}")

    cpu = DIPPM.from_params(tree, cfg, device="cpu")
    c_one = cpu.predict_json(docs[0])
    c_many = cpu.predict_many(graphs)
    c_ys = cpu.engine().predict_samples(samples)
    ref = np.concatenate([
        np.asarray([[p.latency_ms, p.energy_j, p.memory_mb]
                    for p in [c_one] + c_many]), c_ys])
    err = check_close(f"{phase}: card vs CPU predictions", card, ref,
                      E2E_ATOL, E2E_RTOL)
    migs_equal = [p.mig for p in [one] + many] == \
        [p.mig for p in [c_one] + c_many]
    out = {"phase": phase, "card": name_limit,
           "config": {"variant": cfg.variant, "hidden": cfg.hidden,
                      "gnn_blocks": cfg.n_gnn_blocks,
                      "fc_blocks": cfg.n_fc_blocks, "readout": cfg.readout,
                      "layout": cfg.layout, "precision": cfg.precision},
           "warmup_shapes": warmed, "warmup_s": t_warm,
           "json_docs": len(docs), "json_nodes": sizes,
           "bulk_graphs": len(samples), "bulk_bins": bulk_bins,
           "bulk_s": bulk_s, "bulk_predictions_per_s": len(samples) / t_bulk,
           "bulk_ms_per_bin": 1e3 * t_bulk / max(bulk_bins, 1),
           "launches": launches, "fused_mp_routes": routes,
           "gat_aggregate_routes": gat_routes, "csr_launches": csr_use,
           "readout_routes": readout_routes,
           "bulk_bitwise_repeat": bulk_bitwise,
           "engine_stats": {**{k: getattr(stats, k) for k in (
               "graphs_predicted", "batches_run", "cache_hits",
               "cache_misses", "cache_entries", "recompiles",
               "node_slots_total", "node_slots_real", "precision")},
               "padding_waste_frac": stats.padding_waste_frac},
           "vs_cpu": {"max_abs_err": err, "max_rel_err": rel_err(card, ref),
                      "atol": E2E_ATOL, "rtol": E2E_RTOL,
                      "mig_equal": migs_equal},
           "example": {"latency_ms": one.latency_ms, "energy_j": one.energy_j,
                       "memory_mb": one.memory_mb, "mig": one.mig}}
    if not migs_equal:
        raise AssertionError(f"{phase}: MIG advice differs between the card "
                             f"and the CPU")
    emit(out)
    return launches, dippm


def serving_docs() -> tuple:
    """The serving burst's documents: ``SERVE_SHARED`` that every thread
    draws from and, per thread, ``SERVE_PER_THREAD // 2`` of its own;
    returns ``(own, docs)``, ``docs`` the shared ones first."""
    rng = np.random.default_rng(23)
    shared = [random_dag_doc(rng, int(rng.integers(10, 300)), i)
              for i in range(SERVE_SHARED)]
    own = [[random_dag_doc(rng, int(rng.integers(10, 300)),
                           1000 * (t + 1) + j)
            for j in range(SERVE_PER_THREAD // 2)]
           for t in range(SERVE_THREADS)]
    return own, shared + [d for ds in own for d in ds]


def phase_serving(torch, dippm, name_limit: str) -> dict:
    """A burst of submit_json requests from many threads through a
    dedicated service on the card."""
    from repro_torch.core import from_json
    # the same fingerprint always gets the same key: its index in `docs`
    own, docs = serving_docs()
    direct = dippm.engine().predict_graphs([from_json(d) for d in docs])
    kernels = path_kernels(dippm.cfg.variant)
    results = [[] for _ in range(SERVE_THREADS)]
    errors = []
    with dippm.serve(max_wait_ms=2.0) as svc:
        svc.warmup()
        torch.cuda.synchronize()
        zero_counts(kernels)
        routes0 = readout_forward_counts()
        start = threading.Barrier(SERVE_THREADS)

        def client(t):
            r = np.random.default_rng(t)
            mine = list(range(SERVE_SHARED + t * len(own[0]),
                              SERVE_SHARED + (t + 1) * len(own[0])))
            keys = mine + [int(k) for k in r.integers(
                0, SERVE_SHARED, SERVE_PER_THREAD - len(mine))]
            r.shuffle(keys)
            try:
                start.wait(timeout=SERVE_TIMEOUT)
                futs = [(k, svc.submit_json(docs[k])) for k in keys]
                results[t] = [(k, f.result(timeout=SERVE_TIMEOUT))
                              for k, f in futs]
            except Exception as e:           # reported on the main thread
                errors.append(e)

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(SERVE_THREADS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=2 * SERVE_TIMEOUT)
        wall = time.perf_counter() - t0
        if errors or any(th.is_alive() for th in threads):
            raise AssertionError(f"serving: {len(errors)} client errors "
                                 f"{errors[:3]}, alive "
                                 f"{[th.is_alive() for th in threads]}")
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, (fn, _) in kernels.items()}
        csr_use = check_shared_csr(kernels, launches, "serving")
        readout_routes = readout_route_diff(routes0)
        st = svc.stats
    answers = [kp for rs in results for kp in rs]
    n_req = SERVE_THREADS * SERVE_PER_THREAD
    if len(answers) != n_req or st.submitted != n_req:
        raise AssertionError(f"serving: {len(answers)} answers, "
                             f"{st.submitted} submitted, want {n_req}")
    if st.submitted != st.completed + st.failed + st.deadline_expired + \
            st.shed_count or st.failed:
        raise AssertionError(f"serving: counters do not conserve or a "
                             f"request failed: {st}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"serving: the batcher launched no kernel "
                             f"{launches}")
    if readout_routes != {"runs": launches["segment_readout"], "general": 0}:
        raise AssertionError(f"serving: segment_readout ran the routes "
                             f"{readout_routes}")
    vec = lambda p: [p.latency_ms, p.energy_j, p.memory_mb]  # noqa: E731
    first = {}
    for k, p in answers:
        if k in first and vec(p) != first[k]:
            raise AssertionError(f"serving: document {k} got two different "
                                 f"answers; a cache hit must be bit-equal")
        first.setdefault(k, vec(p))
    got = np.asarray([vec(p) for _, p in answers])
    want = np.asarray([vec(direct[k]) for k, _ in answers])
    err = check_close("serving vs direct engine", got, want, E2E_ATOL,
                      E2E_RTOL)
    out = {"phase": "serving", "card": name_limit,
           "variant": dippm.cfg.variant, "threads": SERVE_THREADS,
           "requests": n_req, "distinct_documents": len(first),
           "wall_s": wall, "requests_per_s": n_req / wall,
           "latency_ms_p50": st.latency_ms_p50,
           "latency_ms_p99": st.latency_ms_p99, "hit_rate": st.hit_rate,
           "cache": {"hits": st.cache_hits, "coalesced": st.cache_coalesced,
                     "misses": st.cache_misses},
           "batches": st.batches, "bins": st.bins,
           "batch_occupancy": st.batch_occupancy,
           "counters": {k: getattr(st, k) for k in (
               "submitted", "completed", "failed", "deadline_expired",
               "shed_count", "rejected")},
           "launches": launches, "csr_launches": csr_use,
           "readout_routes": readout_routes,
           "vs_direct_engine": {"max_abs_err": err,
                                "atol": E2E_ATOL, "rtol": E2E_RTOL}}
    emit(out)
    return out


#: every wrapper, so a training run can show it launched none it should not
TRAIN_WRAPPERS = ("segment_aggregate", "segment_scatter", "segment_gather",
                  "dense_aggregate", "segment_readout",
                  "segment_readout_backward", "edge_softmax",
                  "fused_mp_layer", "fused_gat_aggregate", "dst_csr")


#: the wrappers that count their launches per route of the segmented sum
SEGMENT_SUMS = ("segment_aggregate", "segment_scatter")


def wrapper(name: str):
    from repro_torch.kernels import sage_spmm, segment_spmm
    mod = sage_spmm if name == "dense_aggregate" else segment_spmm
    return getattr(mod, f"{name}_cuda")


def train_launch_rule(cfg, steps: int) -> dict:
    """The launches each wrapper counts in ``steps`` training steps of
    ``cfg`` (L message-passing layers):

    * GraphSAGE: the aggregation (``dense_aggregate`` on the dense
      layout, ``segment_aggregate`` on the others) once per layer
      forward, and once per layer backward for every layer whose input
      requires grad — all but the first, whose input is the data:
      ``steps · (2L − 1)``.
    * GAT on an edge list: per layer forward three gathers (``ed[dst]``,
      ``es[src]``, ``z[src]``), one edge softmax and one scatter; per layer
      backward a scatter for each gather, a scatter and a gather for the
      softmax, and a gather for the scatter: ``5L`` gathers, ``5L``
      scatters and ``L`` softmaxes a step, each softmax on a CSR it builds
      itself (``L`` ``dst_csr`` launches; the forward's CSR is not shared
      across a training step).
    * The packed readout: once forward, and its gradient's own kernel
      (``segment_readout_backward``) once backward; no gather or scatter
      (the composition it replaced launched two gathers and a scatter).
    * The fused inference kernels: never.
    """
    n_layers = cfg.n_gnn_blocks
    layout = cfg.resolved_layout
    want = dict.fromkeys(TRAIN_WRAPPERS, 0)
    if cfg.variant == "graphsage":
        agg = "dense_aggregate" if layout == "dense" else "segment_aggregate"
        want[agg] = steps * (2 * n_layers - 1)
    elif cfg.variant == "gat" and layout != "dense":
        want["segment_gather"] = steps * 5 * n_layers
        want["segment_scatter"] = steps * 5 * n_layers
        want["edge_softmax"] = steps * n_layers
        want["dst_csr"] = steps * n_layers
    else:
        raise ValueError(f"no launch rule for {cfg.variant} on {layout}")
    if layout == "packed":
        want["segment_readout"] += steps
        want["segment_readout_backward"] += steps
    return want


# ---------------------------------------------------------------------------
# engine_layouts, bf16, fleet: the rest of the prediction engine and service
# ---------------------------------------------------------------------------

def all_wrappers() -> dict:
    """Every prediction and training wrapper, for ``zero_counts``."""
    return {name: (wrapper(name), None) for name in TRAIN_WRAPPERS}


def layout_launch_rule(cfg, chunks: int) -> dict:
    """The launches each wrapper counts in ``chunks`` bucketed chunks of
    ``cfg`` at inference (L message-passing layers):

    * GraphSAGE: ``dense_aggregate`` (dense) or ``segment_aggregate``
      (sparse) once a layer;
    * GAT on the sparse layout: per layer three gathers (``ed[dst]``,
      ``es[src]``, ``z[src]``), one edge softmax on a CSR it builds itself
      (one ``dst_csr``) and one scatter;
    * GAT on the dense layout: none (plain torch, as plain ``jnp`` in the
      JAX package);
    * never a fused kernel or the packed readout (the bucketed readout is
      plain torch).
    """
    n_layers, layout = cfg.n_gnn_blocks, cfg.resolved_layout
    want = dict.fromkeys(TRAIN_WRAPPERS, 0)
    if cfg.variant == "graphsage":
        agg = "dense_aggregate" if layout == "dense" else "segment_aggregate"
        want[agg] = chunks * n_layers
    elif cfg.variant == "gat" and layout == "sparse":
        want["segment_gather"] = chunks * 3 * n_layers
        want["segment_scatter"] = chunks * n_layers
        want["edge_softmax"] = chunks * n_layers
        want["dst_csr"] = chunks * n_layers
    elif not (cfg.variant == "gat" and layout == "dense"):
        raise ValueError(f"no launch rule for {cfg.variant} on {layout}")
    return want


def chunk_staged_bytes(engine, bucket: int = CHUNK_BUCKET) -> dict:
    """Host→device bytes of a full bucketed chunk at ``bucket`` (batch
    axis at the engine's cap), by array."""
    cfg = engine.cfg
    b = engine._batch_cap(bucket)
    out = {"batch": b, "x": 4 * b * bucket * cfg.node_feat_dim,
           "mask": 4 * b * bucket, "static": 4 * b * cfg.static_dim}
    if engine.sparse:
        e = engine._edge_floor(bucket)
        out.update(edges=8 * b * e, edge_mask=4 * b * e)
    else:
        out["adj"] = 4 * b * bucket * bucket
    out["total"] = sum(v for k, v in out.items() if k != "batch")
    return out


def chunk_kernel_rows(torch, dev, samples, hidden: int) -> dict:
    """B7 (``dense_aggregate``), B5's aggregate and B6 at F = hidden on
    the bucketed engines' full chunk: the first bucket-``CHUNK_BUCKET``
    chunk of ``samples`` at the engine's cap (64 graphs), its dense
    adjacency and its sparse edge list at the bucket's edge floor, with
    random activations; each held against its plain version and timed
    beside its bound and, where one exists, a library call."""
    from repro_torch.core.batching import (dense_adj, edge_bucket_for,
                                           edge_floor, group_by_bucket,
                                           max_batch_for_bucket, pack_edges)
    from repro_torch.kernels import ref
    from repro_torch.kernels.sage_spmm import dense_aggregate_cuda
    from repro_torch.kernels.segment_spmm import (segment_aggregate_cuda,
                                                  segment_scatter_cuda)
    n = CHUNK_BUCKET
    cap = max_batch_for_bucket(n, 64)
    members = group_by_bucket(samples)[n][:cap]
    chunk = [samples[j] for j in members]
    b = len(chunk)
    adj_np = np.zeros((b, n, n), np.float32)
    for i, s in enumerate(chunk):
        dense_adj(s.edges, n, out=adj_np[i])
    e = max(edge_bucket_for(max(s.n_edges for s in chunk)), edge_floor(n))
    edges_np, em_np = pack_edges(chunk, e)
    rng = np.random.default_rng(4200)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    adj, edges, em = t(adj_np), t(edges_np), t(em_np)
    h = t(rng.standard_normal((b, n, hidden)).astype(np.float32))
    msgs = t(rng.standard_normal((b, e, hidden)).astype(np.float32))
    dst = edges[..., 1]
    nnz, e_real = int(adj_np.sum()), int(em_np.sum())
    # B6's library call, as at the full bin: index_add_ of the
    # pre-weighted messages into a fresh zero tensor, flattened over the
    # chunk (each graph's destinations offset by its slot)
    flat_dst = (dst.long() + n * torch.arange(b, device=dev)[:, None]
                ).reshape(-1)
    weighted = (msgs * em[..., None]).reshape(-1, hidden).contiguous()

    def index_add(x, w):
        return torch.zeros((b * n, hidden), device=dev).index_add_(
            0, x, w).view(b, n, hidden)
    pairs = {
        "dense_aggregate": (
            lambda: dense_aggregate_cuda(adj, h, "mean"),
            lambda: ref.dense_aggregate_ref(adj, h, "mean"),
            lambda: torch.bmm(adj, h),
            bound_ms(2.0 * nnz * hidden + b * n * hidden + b * n * n,
                     4.0 * (b * n * n + 2 * b * n * hidden))),
        "segment_aggregate": (
            lambda: segment_aggregate_cuda(edges, em, h, "mean"),
            lambda: ref.segment_aggregate_ref(edges, em, h, "mean"), None,
            bound_ms(2.0 * e_real * hidden + b * n * hidden,
                     4.0 * (2 * b * n * hidden + 3 * b * e + b * n))),
        "segment_scatter": (
            lambda: segment_scatter_cuda(dst, em, msgs, n),
            lambda: ref.segment_scatter_ref(dst, em, msgs, n),
            lambda: index_add(flat_dst, weighted),
            bound_ms(2.0 * e_real * hidden,
                     4.0 * (b * e * hidden + 2 * b * e + b * n * hidden))),
    }
    rows = {}
    for name, (kern, plain, lib, (bnd, by)) in pairs.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = check_close(f"{name} at the inference chunk", got, want,
                          KERNEL_ATOL, KERNEL_RTOL)
        rows[name] = {"ms": time_graph_ms(torch, kern),
                      "plain_ms": time_graph_ms(torch, plain),
                      "library_ms": (time_graph_ms(torch, lib)
                                     if lib is not None else None),
                      "bound_ms": bnd, "bound_by": by, "max_abs_err": err}
    lib_err = check_close("index_add_ vs segment_scatter's plain version at "
                          "the inference chunk", index_add(flat_dst, weighted),
                          ref.segment_scatter_ref(dst, em, msgs, n),
                          KERNEL_ATOL, KERNEL_RTOL)

    def copies(nbytes, *ts):
        return [ts] + [tuple(x.clone() for x in ts)
                       for _ in range(cold_copies(nbytes) - 1)]
    sc = copies(4.0 * (b * e * hidden + 3 * b * e + b * n * hidden),
                edges, em, msgs)
    ia = copies(4.0 * (b * e * hidden + 2 * b * e + b * n * hidden),
                flat_dst, weighted)
    rows["segment_scatter"].update(
        cold_ms=time_cold_ms(torch, [
            lambda x=x: segment_scatter_cuda(x[0][..., 1], x[1], x[2], n)
            for x in sc]),
        library_cold_ms=time_cold_ms(torch, [lambda x=x: index_add(*x)
                                             for x in ia]),
        library_max_abs_err=lib_err,
        library_note="index_add_ of the pre-weighted messages into a "
                     "fresh zero tensor, flattened over the chunk")
    del sc, ia
    shape = f"B={b} N={n} F={hidden}"
    rows["dense_aggregate"]["unit"] = (
        f"one dense inference layer, mean: {shape} ({nnz} nonzeros of "
        f"{b * n * n})")
    rows["dense_aggregate"]["library_note"] = "torch.bmm(adj, h), sum form"
    rows["segment_aggregate"]["unit"] = (
        f"one sparse inference layer, mean: {shape} E={e} ({e_real} real)")
    rows["segment_scatter"]["unit"] = (
        f"one sparse GAT layer's scatter: {shape} E={e} ({e_real} real)")
    return rows


def phase_engine_layouts(torch, name_limit: str) -> dict:
    """GraphSAGE and GAT at the paper's width through the bucketed engine
    (``layout="dense"`` and ``"sparse"``) on the main path's inputs, from
    the packed path's seed-0 parameters: each held against the CPU's plain
    versions and against the card's packed engine, its launches against
    ``layout_launch_rule``."""
    import dataclasses
    from repro_torch.core import DIPPM, PMGNSConfig, pmgns_init
    sizes, docs, graphs, samples = path_inputs()
    kernels = all_wrappers()
    out = {"phase": "engine_layouts", "card": name_limit,
           "json_nodes": sizes, "bulk_graphs": len(samples), "runs": {}}
    for variant in LAYOUT_VARIANTS:
        packed_cfg = PMGNSConfig(variant=variant, layout="packed",
                                 precision="f32")
        tree = pmgns_init(0, packed_cfg)
        packed = DIPPM.from_params(tree, packed_cfg)
        packed_ref = np.concatenate([
            pred_rows(packed.predict_many(graphs)),
            packed.engine().predict_samples(samples)])
        for layout in ("dense", "sparse"):
            cfg = dataclasses.replace(packed_cfg, layout=layout)
            dippm = DIPPM.from_params(tree, cfg)      # on the card
            engine = dippm.engine()
            if dippm.device.type != "cuda" or engine.layout != layout:
                raise AssertionError(f"engine_layouts: {variant} {layout} "
                                     f"ran {engine.layout} on "
                                     f"{dippm.device}")
            zero_counts(kernels)
            t0 = time.perf_counter()
            warmed = engine.warmup()
            torch.cuda.synchronize()
            t_warm = time.perf_counter() - t0
            many = dippm.predict_many(graphs)
            chunks_before = engine.stats.batches_run
            bulk_s = []
            for _ in range(BULK_REPEATS):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                ys = engine.predict_samples(samples)
                torch.cuda.synchronize()
                bulk_s.append(time.perf_counter() - t1)
            launches = {k: fn.launches for k, (fn, _) in kernels.items()}
            stats = engine.stats.snapshot()
            want = layout_launch_rule(cfg, stats.batches_run + warmed)
            if launches != want:
                raise AssertionError(
                    f"engine_layouts: {variant} {layout} launched "
                    f"{launches}, want {want} ({stats.batches_run} chunks + "
                    f"{warmed} warmup shapes)")
            sparse_csr = None
            if variant == "gat" and layout == "sparse":
                sparse_csr = dict(wrapper("edge_softmax").csr_launches)
                if sparse_csr != {"shared": 0, "own": launches[
                        "edge_softmax"]}:
                    raise AssertionError(f"engine_layouts: the sparse GAT "
                                         f"softmax ran {sparse_csr}")
            busy_ms, top = device_busy_ms(
                torch, lambda: engine.predict_samples(samples))
            card = np.concatenate([pred_rows(many), ys])
            if card.shape != packed_ref.shape or not np.isfinite(card).all():
                raise AssertionError(f"engine_layouts: {variant} {layout}: "
                                     f"bad predictions {card.shape}")
            cpu = DIPPM.from_params(tree, cfg, device="cpu")
            ref = np.concatenate([pred_rows(cpu.predict_many(graphs)),
                                  cpu.engine().predict_samples(samples)])
            err_cpu = check_close(
                f"engine_layouts: {variant} {layout} card vs CPU", card, ref,
                E2E_ATOL, E2E_RTOL)
            err_packed = check_close(
                f"engine_layouts: {variant} {layout} vs the packed engine",
                card, packed_ref, E2E_ATOL, E2E_RTOL)
            t_bulk = statistics.median(bulk_s)
            bulk_chunks = (stats.batches_run - chunks_before) // BULK_REPEATS
            out["runs"][f"{variant}_{layout}"] = {
                "warmup_shapes": warmed, "warmup_s": t_warm,
                "bulk_s": bulk_s, "bulk_chunks": bulk_chunks,
                "bulk_predictions_per_s": len(samples) / t_bulk,
                "bulk_ms_per_chunk": 1e3 * t_bulk / max(bulk_chunks, 1),
                "device_busy_ms_per_chunk": busy_ms / max(bulk_chunks, 1),
                "top_device_ms_per_bulk": top,
                "launches": {k: v for k, v in launches.items() if v},
                "edge_softmax_csr": sparse_csr,
                "staged_bytes_full_chunk": chunk_staged_bytes(engine),
                "engine_stats": {**dataclasses.asdict(stats),
                                 "padding_waste_frac":
                                     stats.padding_waste_frac},
                "vs_cpu": {"max_abs_err": err_cpu,
                           "max_rel_err": rel_err(card, ref)},
                "vs_packed": {"max_abs_err": err_packed,
                              "max_rel_err": rel_err(card, packed_ref)},
                "atol": E2E_ATOL, "rtol": E2E_RTOL}
            del dippm, engine, cpu
            torch.cuda.empty_cache()
    out["kernels_at_chunk"] = chunk_kernel_rows(
        torch, torch.device("cuda"), samples, PMGNSConfig().hidden)
    emit(out)
    return out


#: float32 values whose bfloat16 rounding is easy to get wrong: ties to
#: even both ways, just past a tie, subnormals, ±inf and past the largest
BF16_SPECIAL = (1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8,
                1.0 + 2.0 ** -8 + 2.0 ** -20, -(1.0 + 2.0 ** -7 + 2.0 ** -9),
                1e-39, 1e-40, -3e-39, 1.1754942e-38, 2.0 ** -133,
                float("inf"), float("-inf"), 3.4e38, 0.1, -0.0)


def bf16_rounding_check(torch) -> dict:
    """The staging's rounding point on this host's CPU: ``stage_bf16``
    (one torch ``copy_``) against the integer round to nearest even of
    ``serve.artifact.f32_to_bf16_bits`` (``ml_dtypes``' bits), on the
    special values and 2^20 random bit patterns; a NaN must stay NaN."""
    from repro_torch.core.engine import stage_bf16
    from repro_torch.serve.artifact import f32_to_bf16_bits
    rng = np.random.default_rng(7)
    bulk = rng.integers(0, 2 ** 32, 1 << 20, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    v = np.concatenate([np.asarray(BF16_SPECIAL, np.float32), bulk])
    got = stage_bf16(v).view(torch.int16).numpy().view(np.uint16)
    want = f32_to_bf16_bits(v)
    nan = np.isnan(v)
    bad = int(np.count_nonzero(got[~nan] != want[~nan]))
    nan_kept = bool(np.isnan(stage_bf16(v[nan]).float().numpy()).all())
    if bad or not nan_kept:
        raise AssertionError(f"bf16: torch's rounding differs from round "
                             f"to nearest even in {bad} of {v.size} values "
                             f"(NaN kept: {nan_kept})")
    return {"values": int(v.size), "nan": int(nan.sum()), "differ": bad}


def upload_ms(torch, buf) -> float:
    """Median ms of one non-blocking upload of the pinned host ``buf``
    (CUDA events around the copy)."""
    dev = torch.device("cuda")
    times = []
    for _ in range(60):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        buf.to(dev, non_blocking=True)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[10:])


def mape(got, want) -> float:
    """Mean absolute percentage error of ``got`` against ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.mean(np.abs(got - want) / np.maximum(np.abs(want),
                                                         1e-6)))


def phase_bf16(torch, name_limit: str) -> dict:
    """bf16 staging at the paper's width: GraphSAGE and GAT predictors
    trained on the card as ``benchmarks/fused_mp.py`` trains its own
    (MAPE is relative to the float32 predictions, so they must sit at
    calibrated magnitudes), each served by a packed bf16 engine on the
    main path's inputs: MAPE against float32 on the card, the CPU's bf16
    run, launches against bins × layers, the staged bytes and upload
    times, and a bf16 artifact through ``DIPPM.load``."""
    import dataclasses
    import tempfile
    from repro_torch.core import DIPPM, PMGNSConfig, pmgns_init
    from repro_torch.core.batching import (packed_rung_ladder,
                                           resolve_packed_budgets)
    from repro_torch.core.engine import EngineConfig, stage_bf16
    from repro_torch.core.gnn import packed_staging_layout
    from repro_torch.serve.artifact import load_artifact, save_artifact
    from repro_torch.train.gnn_trainer import TrainConfig, train_pmgns
    sizes, docs, graphs, samples = path_inputs()
    out = {"phase": "bf16", "card": name_limit,
           "rounding": bf16_rounding_check(torch), "runs": {},
           "mape_bar": BF16_MAPE_BAR}
    budgets = resolve_packed_budgets(EngineConfig().node_budget)
    ladder = len(packed_rung_ladder(*budgets))
    for variant in LAYOUT_VARIANTS:
        cfg32 = PMGNSConfig(variant=variant, layout="packed",
                            precision="f32", dropout=0.0)
        cfg16 = dataclasses.replace(cfg32, precision="bf16")
        t0 = time.perf_counter()
        tree, hist = train_pmgns(cfg32, samples[:BF16_TRAIN_SAMPLES], (),
                                 TrainConfig(epochs=BF16_TRAIN_EPOCHS,
                                             batch_size=BF16_TRAIN_BATCH,
                                             lr=BF16_TRAIN_LR, seed=0))
        t_train = time.perf_counter() - t0
        d32 = DIPPM.from_params(tree, cfg32)
        d16 = DIPPM.from_params(tree, cfg16)
        e16 = d16.engine()
        kernels = path_kernels(variant)
        zero_counts(kernels)
        routes0 = readout_forward_counts()
        warmed = e16.warmup(rungs="all")
        delta = e16.stats.bf16_max_abs_delta
        y16 = np.concatenate([pred_rows(d16.predict_many(graphs)),
                              e16.predict_samples(samples)])
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, (fn, _) in kernels.items()}
        readout_routes = readout_route_diff(routes0)
        stats = e16.stats.snapshot()
        # every bin, every warmed rung and the delta probe's two passes
        runs = stats.batches_run + ladder + 2
        want = {k: runs * (cfg16.n_gnn_blocks if per == "layer" else 1)
                for k, (_, per) in kernels.items()}
        if launches != want:
            raise AssertionError(f"bf16: {variant} launched {launches}, "
                                 f"want {want}")
        if readout_routes != {"runs": launches["segment_readout"],
                              "general": 0}:
            raise AssertionError(f"bf16: readout routes {readout_routes}")
        if delta is None or not np.isfinite(delta):
            raise AssertionError(f"bf16: bf16_max_abs_delta {delta}")
        y32 = np.concatenate([pred_rows(d32.predict_many(graphs)),
                              d32.engine().predict_samples(samples)])
        drift = mape(y16, y32)
        # the bulk sweep's wall ms a bin, float32 and bf16 staging in turns
        turns = {"f32": [], "bf16": []}
        for kind in ("f32", "bf16", "bf16", "f32") * BULK_REPEATS:
            eng = e16 if kind == "bf16" else d32.engine()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            eng.predict_samples(samples)
            torch.cuda.synchronize()
            turns[kind].append(1e3 * (time.perf_counter() - t1))
        bulk_bins = len(e16.plan_bins(samples))
        busy16, _ = device_busy_ms(torch, lambda: e16.predict_samples(samples))
        if not np.isfinite(y16).all() or drift > BF16_MAPE_BAR:
            raise AssertionError(f"bf16: {variant} MAPE against float32 "
                                 f"{drift:.4%} exceeds {BF16_MAPE_BAR:.1%}")
        c16 = DIPPM.from_params(tree, cfg16, device="cpu")
        ref = np.concatenate([pred_rows(c16.predict_many(graphs)),
                              c16.engine().predict_samples(samples)])
        err_cpu = check_close(f"bf16: {variant} card vs CPU", y16, ref,
                              E2E_ATOL, E2E_RTOL)
        # the same drift on the seed-0 weights, for the record only
        tree0 = pmgns_init(0, cfg32)
        rand = mape(DIPPM.from_params(tree0, cfg16).engine()
                    .predict_samples(samples),
                    DIPPM.from_params(tree0, cfg32).engine()
                    .predict_samples(samples))
        # two artifacts of the bf16 model: float32 weights (the runtime
        # bf16 deployment, which must serve the engine's predictions) and
        # bfloat16 weights (precision="bf16", held against the CPU's load)
        art = {}
        with tempfile.TemporaryDirectory() as tmp:
            for stored in ("f32", "bf16"):
                path = str(Path(tmp) / f"{variant}_{stored}.npz")
                save_artifact(path, tree, cfg16, precision=stored)
                loaded = DIPPM.load(path)            # on the card
                if load_artifact(path)[1].precision != "bf16" or \
                        not loaded.engine()._stage_bf16:
                    raise AssertionError("bf16: the artifact's engine does "
                                         "not stage bfloat16")
                art[stored] = np.concatenate([
                    pred_rows(loaded.predict_many(graphs)),
                    loaded.engine().predict_samples(samples)])
                del loaded
            c_art = DIPPM.load(path, device="cpu")
            ref_art = np.concatenate([
                pred_rows(c_art.predict_many(graphs)),
                c_art.engine().predict_samples(samples)])
        err_same = check_close(f"bf16: {variant} float32-weight artifact vs "
                               f"the engine", art["f32"], y16, FLEET_ATOL,
                               FLEET_RTOL)
        err_art = check_close(f"bf16: {variant} bfloat16-weight artifact, "
                              f"card vs CPU", art["bf16"], ref_art,
                              E2E_ATOL, E2E_RTOL)
        out["runs"][variant] = {
            "train": {"samples": BF16_TRAIN_SAMPLES,
                      "epochs": BF16_TRAIN_EPOCHS,
                      "batch": BF16_TRAIN_BATCH, "lr": BF16_TRAIN_LR,
                      "seconds": t_train,
                      "final_train_loss": hist[-1]["train_loss"]},
            "bf16_max_abs_delta": delta, "warmup_shapes": warmed,
            "mape_vs_f32": drift, "mape_vs_f32_seed0_weights": rand,
            "bulk_ms_per_bin": {k: [t / bulk_bins for t in v]
                                for k, v in turns.items()},
            "bf16_device_busy_ms_per_bin": busy16 / bulk_bins,
            "vs_cpu_bf16": {"max_abs_err": err_cpu,
                            "max_rel_err": rel_err(y16, ref)},
            "launches": launches, "readout_routes": readout_routes,
            "bins": stats.batches_run,
            "artifact": {"f32_weights_vs_engine_max_abs_err": err_same,
                         "f32_weights_bitwise_equal":
                             art["f32"].tobytes() == y16.tobytes(),
                         "bf16_weights_vs_cpu_max_abs_err": err_art,
                         "bf16_weights_mape_vs_f32_model":
                             mape(art["bf16"], y32)}}
        del d32, d16, e16, c16, c_art
        torch.cuda.empty_cache()
    _, _, _, f_len, i_len = packed_staging_layout(PMGNSConfig(), FULL_P,
                                                  FULL_Q, FULL_G)
    f32 = torch.zeros((f_len,), pin_memory=True)
    b16 = stage_bf16(np.zeros(f_len, np.float32), pin=True)
    out["full_bin_staging"] = {
        "shape": f"P={FULL_P} Q={FULL_Q} G={FULL_G}",
        "float_bytes_f32": 4 * f_len, "float_bytes_bf16": 2 * f_len,
        "int_bytes": 4 * i_len,
        "upload_ms_f32": upload_ms(torch, f32),
        "upload_ms_bf16": upload_ms(torch, b16)}
    emit(out)
    return out


def fleet_drill(torch, tree, cfg, graphs, ref) -> dict:
    """Kill replica 0 mid-burst (a ``FailureInjector``), then revive it
    by a breaker probe after its cooldown; heartbeats for every
    replica."""
    import tempfile
    from repro_torch.core.engine import EngineConfig
    from repro_torch.runtime import FailureInjector, HeartbeatMonitor
    from repro_torch.serve import (BreakerConfig, PredictionService,
                                   ReplicaPool, ServeConfig)
    inj = {0: FailureInjector(fail_at_steps=[2])}
    rng = np.random.default_rng(5)
    with tempfile.TemporaryDirectory() as hb:
        pool = ReplicaPool(tree, cfg, EngineConfig(), n_replicas=2,
                           injectors=inj, heartbeat_dir=hb,
                           breaker=BreakerConfig(
                               cooldown_s=FLEET_COOLDOWN_S))
        svc = PredictionService(engine=pool, serve_cfg=ServeConfig(
            max_wait_ms=2.0, cache_size=None))
        try:
            futs = []
            for g in graphs:                  # open-loop Poisson arrivals
                futs.append(svc.submit(g))
                time.sleep(float(rng.exponential(FLEET_GAP_S)))
            svc.flush()
            got = pred_rows([f.result(timeout=SERVE_TIMEOUT) for f in futs])
            st = svc.stats
            states = pool.breaker_states
            # one failure trips replica 0's breaker (threshold 1); it may
            # already have revived if the burst outlasted its cooldown
            if (inj[0].failures != 1 or st.requeues < 1 or st.failed
                    or st.completed != len(graphs)
                    or st.submitted != st.completed + st.failed
                    + st.deadline_expired + st.shed_count):
                raise AssertionError(f"fleet: the kill drill lost work: "
                                     f"failures {inj[0].failures}, {st}")
            err = check_close("fleet: the kill drill vs one engine", got,
                              ref, FLEET_ATOL, FLEET_RTOL)
            time.sleep(1.5 * FLEET_COOLDOWN_S)
            svc.predict_many(graphs[:40], timeout=SERVE_TIMEOUT)
            if pool.breaker_states != ("closed", "closed") or \
                    pool.revivals != 1:
                raise AssertionError(f"fleet: no revival: "
                                     f"{pool.breaker_states}, "
                                     f"{pool.revivals}")
            beats = HeartbeatMonitor(hb).read_all()
            if {b["replica"] for b in beats} != {0, 1}:
                raise AssertionError(f"fleet: heartbeats {beats}")
            return {"requests": len(graphs), "failures": inj[0].failures,
                    "requeues": st.requeues, "bins": st.bins,
                    "replica_bins": st.replica_bins,
                    "breaker_after_kill": states,
                    "breaker_after_probe": pool.breaker_states,
                    "revivals": pool.revivals, "max_abs_err": err,
                    "heartbeats": sorted((b["replica"], b["step"],
                                          b["breaker"]) for b in beats)}
        finally:
            svc.close()
            pool.close()


def fleet_bulk(torch, engine, samples) -> dict:
    """Bins/s and bin latency (submission to result, p50/p99) of the
    bulk sweep's bins (``samples`` planned once, ``FLEET_BULK_REPEATS``
    times over), all in flight at once: through ``submit_bin`` on a
    pool, one after another through ``run_bin`` on an engine."""
    bins = engine.plan_bins(samples)
    chunks = [[samples[j] for j in b] for b in bins] * FLEET_BULK_REPEATS
    done = [0.0] * len(chunks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if hasattr(engine, "submit_bin"):
        futs = []
        for i, c in enumerate(chunks):
            f = engine.submit_bin(c)
            f.add_done_callback(
                lambda _f, i=i: done.__setitem__(i, time.perf_counter()))
            futs.append(f)
        for f in futs:
            f.result(timeout=SERVE_TIMEOUT)
    else:
        for i, c in enumerate(chunks):
            engine.run_bin(c)
            done[i] = time.perf_counter()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lat = 1e3 * (np.asarray(done) - t0)
    return {"bins": len(chunks), "wall_s": wall,
            "bins_per_s": len(chunks) / wall,
            "bin_latency_ms_p50": float(np.percentile(lat, 50)),
            "bin_latency_ms_p99": float(np.percentile(lat, 99)),
            "peak_inflight": getattr(engine, "peak_inflight", 1)}


def fleet_turns(torch, tree, cfg, graphs, samples) -> dict:
    """At ``FLEET_REPLICAS`` replicas on this card, in turns (each count
    once per turn, the order reversed every other turn), after warmup:
    the engine level (``fleet_bulk``: one engine, then pools of 1, 2 and 4
    replicas) and the request level (``FLEET_BURSTS`` atomic bursts of
    ``graphs`` through ``ServeConfig(replicas=n)``, cache off: bins/s and
    request p50/p99, featurization on the submitting thread included)."""
    from repro_torch.core.engine import PredictionEngine
    from repro_torch.serve import (PredictionService, ReplicaPool,
                                   ServeConfig)
    rows = {"engine": []}
    rows.update({f"pool_{n}": [] for n in FLEET_REPLICAS})
    rows.update({f"service_{n}": [] for n in FLEET_REPLICAS})
    for turn in range(FLEET_TURNS):
        order = FLEET_REPLICAS if turn % 2 == 0 else FLEET_REPLICAS[::-1]
        engine = PredictionEngine(tree, cfg)
        engine.warmup(rungs="all")
        rows["engine"].append(fleet_bulk(torch, engine, samples))
        del engine
        for n in order:
            with ReplicaPool(tree, cfg, n_replicas=n) as pool:
                pool.warmup(rungs="all")
                rows[f"pool_{n}"].append(fleet_bulk(torch, pool, samples))
            with PredictionService(tree, cfg, ServeConfig(
                    replicas=n, cache_size=None)) as svc:
                svc.warmup()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(FLEET_BURSTS):
                    svc.predict_many(graphs, timeout=SERVE_TIMEOUT)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                st = svc.stats
            rows[f"service_{n}"].append({
                "bins_per_s": st.bins / wall,
                "requests_per_s": st.completed / wall,
                "latency_ms_p50": st.latency_ms_p50,
                "latency_ms_p99": st.latency_ms_p99,
                "bins": st.bins, "wall_s": wall})
    return rows


def phase_fleet(torch, name_limit: str) -> dict:
    """``ServeConfig(replicas=N)`` on the one card at the paper's width:
    the placement (every replica on the card, each on a stream of its
    own), an atomic ``predict_many`` of the serving documents against one
    engine of the same plan (GAT bit for bit, GraphSAGE within
    ``FLEET_ATOL`` + ``FLEET_RTOL``), launches against bins × layers, the
    kill drill and revival, and bins/s and p50/p99 at 1, 2 and 4
    replicas in turns (``fleet_turns``)."""
    from repro_torch.core import PMGNSConfig, from_json, pmgns_init
    from repro_torch.core.engine import PredictionEngine
    from repro_torch.serve import PredictionService, ServeConfig
    _, docs = serving_docs()
    graphs = [from_json(d) for d in docs]
    samples = path_inputs()[3]
    out = {"phase": "fleet", "card": name_limit, "documents": len(docs),
           "bulk_graphs": len(samples), "runs": {}}
    for variant in LAYOUT_VARIANTS[::-1]:          # GAT first
        cfg = PMGNSConfig(variant=variant, layout="packed", precision="f32")
        tree = pmgns_init(0, cfg)
        with PredictionService(engine=PredictionEngine(tree, cfg)) as one:
            ref = pred_rows(one.predict_many(graphs, timeout=SERVE_TIMEOUT))
            one_bins = one.stats.bins
        kernels = path_kernels(variant)
        run = {"one_engine_bins": one_bins, "replicas": {}}
        for n in FLEET_REPLICAS[1:]:
            with PredictionService(tree, cfg, ServeConfig(replicas=n)) as svc:
                pool = svc.engine
                streams = [s.cuda_stream for s in pool.streams]
                default = torch.cuda.default_stream(pool.devices[0])
                if ({d.type for d in pool.devices} != {"cuda"}
                        or len(set(pool.devices)) != 1
                        or len(set(streams)) != n
                        or default.cuda_stream in streams):
                    raise AssertionError(f"fleet: placement {pool.devices}"
                                         f", streams {streams}")
                torch.cuda.synchronize()
                zero_counts(kernels)
                routes0 = readout_forward_counts()
                t0 = time.perf_counter()
                got = pred_rows(svc.predict_many(graphs,
                                                 timeout=SERVE_TIMEOUT))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = {k: fn.launches for k, (fn, _) in kernels.items()}
                readout_routes = readout_route_diff(routes0)
                st = svc.stats
                placement = {"devices": [str(d) for d in pool.devices],
                             "streams": [hex(s) for s in streams],
                             "note": pool.placement.note}
            if (st.bins != one_bins or sum(st.replica_bins) != st.bins
                    or min(st.replica_bins) <= 0):
                raise AssertionError(f"fleet: {n} replicas ran bins "
                                     f"{st.replica_bins} of {st.bins}, one "
                                     f"engine {one_bins}")
            want = {k: st.bins * (cfg.n_gnn_blocks if per == "layer" else 1)
                    for k, (_, per) in kernels.items()}
            if launches != want or readout_routes != {
                    "runs": launches["segment_readout"], "general": 0}:
                raise AssertionError(f"fleet: {n} replicas launched "
                                     f"{launches} ({readout_routes}), want "
                                     f"{want}")
            csr = check_shared_csr(kernels, launches, "fleet")
            if variant == "gat":
                if got.tobytes() != ref.tobytes():
                    raise AssertionError(
                        f"fleet: GAT on {n} replicas differs in its bits "
                        f"from one engine: max |diff| "
                        f"{np.max(np.abs(got - ref)):.3e}")
                err = 0.0
            else:
                err = check_close(f"fleet: GraphSAGE on {n} replicas vs "
                                  f"one engine", got, ref, FLEET_ATOL,
                                  FLEET_RTOL)
            run["replicas"][str(n)] = {
                "placement": placement, "bins": st.bins,
                "replica_bins": st.replica_bins, "wall_s": wall,
                "launches": launches, "csr_launches": csr,
                "bitwise_equal": got.tobytes() == ref.tobytes(),
                "max_abs_err": err, "atol": FLEET_ATOL, "rtol": FLEET_RTOL}
        run["kill_drill"] = fleet_drill(torch, tree, cfg, graphs, ref)
        run["turns"] = fleet_turns(torch, tree, cfg, graphs, samples)
        out["runs"][variant] = run
        torch.cuda.empty_cache()
    emit(out)
    return out


def device_ms_by_kernel(torch, fn) -> dict:
    """Device milliseconds of every kernel and copy that ``fn()`` runs,
    by kernel name, from ``torch.profiler``; {} where it recorded no
    device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0.0)
        if t > 0 and not e.key.startswith("cuda"):
            name = kernel_name(e.key)
            rows[name] = rows.get(name, 0.0) + t / 1e3
    return rows


def device_busy_ms(torch, fn) -> tuple:
    """Device milliseconds of every kernel and copy that ``fn()`` runs,
    from ``torch.profiler``, and the ten largest by kernel name; 0.0
    and {} where it recorded no device time."""
    rows = device_ms_by_kernel(torch, fn)
    top = dict(sorted(rows.items(), key=lambda kv: -kv[1])[:10])
    return sum(rows.values()), top


def train_run(torch, cfg, samples, epochs: int, phase: str,
              compare_cpu: bool, data_parallel: bool = False,
              device=None) -> dict:
    """``train_pmgns`` on the card (``device=None``: the current one) with
    the launch counts zeroed before and checked after; optionally the
    same run on the CPU's plain versions, held to the trainer's parity
    bar. ``data_parallel`` splits the steps over the default group."""
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.train.gnn_trainer import TrainConfig, train_pmgns
    tcfg = TrainConfig(epochs=epochs, batch_size=TRAIN_BATCH, lr=TRAIN_LR,
                       seed=0, data_parallel=data_parallel)
    for name in TRAIN_WRAPPERS:
        wrapper(name).launches = 0
    for name in SEGMENT_SUMS:
        wrapper(name).route_launches = dict.fromkeys(
            wrapper(name).route_launches, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, hist = train_pmgns(cfg, samples, (), tcfg, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: wrapper(n).launches for n in TRAIN_WRAPPERS}
    routes = {n: dict(wrapper(n).route_launches) for n in SEGMENT_SUMS}
    for name, per_route in routes.items():
        if sum(per_route.values()) != launches[name]:
            raise AssertionError(f"{phase}: {name}'s routes {per_route} do "
                                 f"not add up to its {launches[name]} "
                                 f"launches")
    steps = sum(r["steps"] for r in hist)
    want = train_launch_rule(cfg, steps)
    if launches != want:
        raise AssertionError(f"{phase}: launches {launches} != the rule's "
                             f"{want} over {steps} steps")
    losses = [r["train_loss"] for r in hist]
    leaves = [np.asarray(v) for v in tree_leaves(params)]
    if not (np.isfinite(losses).all()
            and all(np.isfinite(v).all() for v in leaves)):
        raise AssertionError(f"{phase}: non-finite losses {losses} or "
                             f"parameters")
    last = hist[-1]
    out = {"config": {"variant": cfg.variant, "layout": cfg.resolved_layout,
                      "hidden": cfg.hidden, "gnn_blocks": cfg.n_gnn_blocks,
                      "fc_blocks": cfg.n_fc_blocks, "readout": cfg.readout,
                      "dropout": cfg.dropout},
           "epochs": epochs, "steps": steps, "losses": losses,
           "wall_s": wall, "launches": launches, "route_launches": routes,
           "ms_per_step": 1e3 * last["seconds"] / last["steps"],
           "steps_per_s": last["steps"] / last["seconds"]}
    if compare_cpu:
        c_params, c_hist = train_pmgns(cfg, samples, (), tcfg, device="cpu")
        c_losses = [r["train_loss"] for r in c_hist]
        loss_err = rel_err(losses, c_losses)
        if loss_err > TRAIN_LOSS_RTOL:
            raise AssertionError(f"{phase}: losses {losses} vs the CPU's "
                                 f"{c_losses}: relative {loss_err:.3e}")
        grads, cpu_grads = step_grads_vs_cpu(torch, cfg, samples, phase)
        out["vs_cpu"] = {"cpu_losses": c_losses, "loss_rel_err": loss_err,
                         "loss_rtol": TRAIN_LOSS_RTOL,
                         "first_step_grads": grads,
                         **params_vs_cpu(leaves, tree_leaves(c_params),
                                         cpu_grads, phase)}
    return out, params


def params_vs_cpu(card: list, cpu: list, grads: list, phase: str) -> dict:
    """The trained parameters against the CPU's at the trainer's bar.
    Elements outside it are listed; each must be Adam noise: a first-step
    CPU gradient (``grads``, per leaf) below ``TRAIN_NOISE_FLOOR`` of its
    leaf's largest, and a distance within ``TRAIN_NOISE_ATOL``."""
    outside, total, worst, worst_leaf, bad, near_zero = [], 0, 0.0, None, 0, 0
    for i, (a, b, g) in enumerate(zip(card, cpu, grads)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if g.shape != b.shape:
            raise AssertionError(f"{phase}: gradient {g.shape} of leaf {i} "
                                 f"{b.shape}")
        d = np.abs(a - b)
        total += d.size
        if d.size and d.max() > worst:
            worst, worst_leaf = float(d.max()), i
        gmax = max(float(np.abs(g).max()), 1e-30)
        near_zero += int((np.abs(g) < TRAIN_NOISE_FLOOR * gmax).sum())
        for j in np.flatnonzero(d > TRAIN_PARAM_ATOL
                                + TRAIN_PARAM_RTOL * np.abs(b)):
            g_rel = float(abs(g.flat[j])) / gmax
            noise = g_rel < TRAIN_NOISE_FLOOR and d.flat[j] <= TRAIN_NOISE_ATOL
            bad += not noise
            outside.append({"leaf": i, "shape": list(b.shape),
                            "index": int(j), "abs_err": float(d.flat[j]),
                            "first_grad_rel_to_leaf_max": g_rel,
                            "noise": bool(noise)})
    out = {"param_max_abs_err": worst, "param_worst_leaf": worst_leaf,
           "params_outside_bar": len(outside), "params_total": total,
           "param_atol": TRAIN_PARAM_ATOL, "param_rtol": TRAIN_PARAM_RTOL,
           "noise_floor": TRAIN_NOISE_FLOOR, "noise_atol": TRAIN_NOISE_ATOL,
           "params_below_noise_floor": near_zero, "outside": outside[:40]}
    if bad:
        raise AssertionError(f"{phase}: {bad} parameters outside the bar "
                             f"are not Adam noise: {out}")
    return out


def first_step_grads(torch, cfg, samples, dev) -> dict:
    """The gradient tree of the trainer's first step (its initial tree
    and first batch) on ``dev``."""
    from repro_torch.core import gnn
    from repro_torch.core.batching import stack_epoch_segments
    from repro_torch.train import gnn_trainer as gt
    seg = stack_epoch_segments(samples, TRAIN_BATCH, rng=gt._epoch_rng(0, 0),
                               layout=cfg.resolved_layout)[0]
    mean, std = gt._target_stats(samples)
    model = gnn.params_from_numpy(gnn.pmgns_init(0, cfg), cfg, dev,
                                  requires_grad=True)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    wl, wn = gt._loss_terms(model.tree(), cfg,
                            {k: t(v[0]) for k, v in seg.items()}, None, 1.0,
                            t(mean), t(std))
    leaves = gt.tree_leaves(model.tree())
    grads = torch.autograd.grad(wl / wn, leaves)
    return gt.tree_unflatten(model.tree(), (g.detach() for g in grads))


def step_grads_vs_cpu(torch, cfg, samples, phase: str) -> tuple:
    """The first training step's gradients on the card against the CPU's,
    from the trainer's initial tree and its first batch; returns the
    comparison and the CPU's gradients (numpy, one per leaf)."""
    from repro_torch.core import gnn
    from repro_torch.optim.optimizers import tree_leaves
    grads = [[g.cpu().numpy() for g in tree_leaves(
        first_step_grads(torch, cfg, samples, d))]
        for d in (gnn.resolve_device(None), torch.device("cpu"))]
    worst = 0.0
    for a, b in zip(*grads):
        err = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        if err > TRAIN_GRAD_RTOL:
            raise AssertionError(f"{phase}: first-step gradient of a leaf "
                                 f"{b.shape} differs from the CPU's by "
                                 f"{err:.3e} of its largest element")
        worst = max(worst, err)
    return {"max_rel_to_leaf_max": worst, "rtol": TRAIN_GRAD_RTOL}, grads[1]


def reload_check(torch, params, cfg) -> dict:
    """The trained parameters through ``save_artifact`` and
    ``DIPPM.load`` on a packed config, one ``predict_samples`` bin against
    the trainer's own evaluation of the same bin."""
    import dataclasses
    import tempfile
    from repro_torch.core import DIPPM
    from repro_torch.core.batching import (collate_packed, next_pow2,
                                           pack_graphs,
                                           resolve_packed_budgets)
    from repro_torch.core.gnn import params_from_numpy
    from repro_torch.dataset.builder import synthetic_samples
    from repro_torch.serve.artifact import save_artifact
    from repro_torch.train.gnn_trainer import _eval_batch
    packed = dataclasses.replace(cfg, layout="packed")
    val = synthetic_samples(48, seed=5, n_min=16, n_max=200)
    budgets = resolve_packed_budgets(min(
        next_pow2(TRAIN_BATCH * 256),
        next_pow2(sum(s.n_nodes for s in val))))
    chunk = [val[j] for j in pack_graphs(val, *budgets)[0]]
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "trained.npz")
        save_artifact(path, params, packed)
        dippm = DIPPM.load(path)                    # on the card
        got = dippm.engine().predict_samples(chunk)
    dev = dippm.device
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in collate_packed(chunk, *budgets).items()}
    _, _, want = _eval_batch(params_from_numpy(params, packed, dev).tree(),
                             packed, batch)
    err = check_close("train_path: reloaded predictions vs the trainer's",
                      got, want[:len(chunk)], E2E_ATOL, E2E_RTOL)
    return {"graphs": len(chunk), "max_abs_err": err,
            "max_rel_err": rel_err(got, want[:len(chunk)])}


def phase_train(torch, name_limit: str) -> dict:
    """Train the PMGNS on the card through ``train_pmgns``: GraphSAGE at
    the paper's width on the dense layout (the default) and the packed
    one, each held against the CPU; a dropout epoch; packed GAT; sparse
    GraphSAGE at a smaller depth; the trained model reloaded and served."""
    import dataclasses
    from repro_torch.core.gnn import PMGNSConfig
    from repro_torch.dataset.builder import synthetic_samples
    t0 = time.perf_counter()
    samples = synthetic_samples(TRAIN_SAMPLES, seed=1, n_min=16, n_max=200)
    sage = PMGNSConfig(variant="graphsage", hidden=TRAIN_HIDDEN, dropout=0.0)
    runs = {}
    runs["dense"], _ = train_run(torch, sage, samples, 2, "train dense",
                                 compare_cpu=True)
    packed_cfg = dataclasses.replace(sage, layout="packed")
    runs["packed"], packed_params = train_run(
        torch, packed_cfg, samples, 2, "train packed", compare_cpu=True)
    runs["dense_dropout"], _ = train_run(
        torch, dataclasses.replace(sage, dropout=0.05), samples, 1,
        "train dense dropout", compare_cpu=False)
    runs["gat_packed"], _ = train_run(
        torch, dataclasses.replace(packed_cfg, variant="gat"), samples, 1,
        "train packed GAT", compare_cpu=False)
    runs["sparse"], _ = train_run(
        torch, dataclasses.replace(sage, layout="sparse", n_gnn_blocks=2),
        samples, 1, "train sparse", compare_cpu=False)
    from repro_torch.train.gnn_trainer import TrainConfig, train_pmgns
    one = TrainConfig(epochs=1, batch_size=TRAIN_BATCH, lr=TRAIN_LR)
    for key, cfg in (("dense", sage), ("packed", packed_cfg)):
        r = runs[key]
        steps = r["steps"] // 2
        busy, top = device_busy_ms(torch, lambda: train_pmgns(
            cfg, samples, (), one))
        r["device_busy_ms_per_step"] = busy / steps
        r["device_ms_per_step_by_kernel"] = {k: v / steps
                                             for k, v in top.items()}
        r["host_share"] = (1.0 - r["device_busy_ms_per_step"]
                           / r["ms_per_step"]) if busy else None
    out = {"phase": "train_path", "card": name_limit,
           "samples": TRAIN_SAMPLES, "batch_size": TRAIN_BATCH,
           "lr": TRAIN_LR, "runs": runs,
           "reload": reload_check(torch, packed_params, packed_cfg),
           "seconds": time.perf_counter() - t0}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# train_dp: data-parallel training over torch.distributed
# ---------------------------------------------------------------------------

def dp_configs() -> dict:
    """train_dp's two runs: train_path's dense GraphSAGE, and its sparse
    one at train_path's sparse depth."""
    import dataclasses
    from repro_torch.core.gnn import PMGNSConfig
    sage = PMGNSConfig(variant="graphsage", hidden=TRAIN_HIDDEN, dropout=0.0)
    return {"dense": sage,
            "sparse": dataclasses.replace(sage, layout="sparse",
                                          n_gnn_blocks=2)}


def dp_samples():
    from repro_torch.dataset.builder import synthetic_samples
    return synthetic_samples(TRAIN_SAMPLES, seed=1, n_min=16, n_max=200)


def init_group(backend: str, store: str, rank: int, world: int) -> None:
    """The default group, its rank and address given explicitly: a
    ``file://`` store, so no port is opened."""
    import datetime
    import torch.distributed as dist
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=DP_PG_TIMEOUT))


def dp_child(rank: int, world: int, backend: str, store: str,
             out_dir: str) -> None:
    """A rank of a spawned data-parallel world: cuda:0 for every rank under
    ``gloo`` (two processes sharing the one card), cuda:rank under NCCL.
    Trains each of ``dp_configs`` one epoch; writes its runs, or the
    traceback, to ``rank<r>.pkl``."""
    import pickle
    import traceback
    out = {}
    try:
        import torch
        import torch.distributed as dist
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch.core.gnn import resolve_device
        from repro_torch.train.gnn_trainer import TrainConfig, train_pmgns
        index = rank if backend == "nccl" else 0
        torch.cuda.set_device(index)
        dev = resolve_device(f"cuda:{index}")
        init_group(backend, store, rank, world)
        samples = dp_samples()
        for key, cfg in dp_configs().items():
            # a short warm-up run first, so that the timed one holds no
            # first-call set-up of this new process
            train_pmgns(cfg, samples[:2 * TRAIN_BATCH], (), TrainConfig(
                epochs=1, batch_size=TRAIN_BATCH, lr=TRAIN_LR,
                data_parallel=True), device=dev)
            run, params = train_run(torch, cfg, samples, 1,
                                    f"train_dp {backend} world {world} {key}",
                                    compare_cpu=False, data_parallel=True,
                                    device=dev)
            out[key] = (run, params)
        dist.destroy_process_group()
    except BaseException:   # recorded for the parent, which fails the phase
        out["error"] = traceback.format_exc()
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def dp_spawn(world: int, backend: str, tmp: str) -> list:
    """``world`` spawned ranks of :func:`dp_child`, joined by a deadline and
    killed past it; each rank's runs. Fails if any rank failed or hung."""
    import multiprocessing
    import pickle
    out_dir = Path(tmp) / f"{backend}{world}"
    out_dir.mkdir()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=dp_child,
                         args=(r, world, backend, str(out_dir / "store"),
                               str(out_dir)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DP_CHILD_TIMEOUT
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
    if hung:
        raise AssertionError(f"train_dp: {len(hung)} of {world} {backend} "
                             f"ranks still running after "
                             f"{DP_CHILD_TIMEOUT} s; killed")
    ranks = []
    for r, p in enumerate(procs):
        path = out_dir / f"rank{r}.pkl"
        if not path.exists():
            raise AssertionError(f"train_dp: {backend} rank {r} exited "
                                 f"{p.exitcode} with no result")
        with open(path, "rb") as f:
            ranks.append(pickle.load(f))
        if "error" in ranks[-1]:
            raise AssertionError(f"train_dp: {backend} rank {r} failed:\n"
                                 f"{ranks[-1]['error']}")
    return ranks


def leaves_of(params) -> list:
    from repro_torch.optim.optimizers import tree_leaves
    return [np.asarray(v) for v in tree_leaves(params)]


def same_params(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(leaves_of(a),
                                                    leaves_of(b)))


def allreduce_ms(torch, n: int, group, reps: int = 20) -> float:
    """CUDA-event ms of one float32 all-reduce of ``n`` values over
    ``group`` (after three warm-up calls)."""
    import torch.distributed as dist
    buf = torch.randn(n, device="cuda")
    for _ in range(3):
        dist.all_reduce(buf, group=group)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        dist.all_reduce(buf, group=group)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def dp_compression(torch, grads: dict) -> dict:
    """``compressed_grad_allreduce`` at world 1 over the card's group and
    over the CPU's, on the same gradients: the same bits required."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    from repro_torch.runtime.compression import (compressed_grad_allreduce,
                                                 init_error_state)
    results, ms = {}, None
    for kind in ("cuda", "cpu"):
        tree = tree_map(lambda g: g.to(kind), grads)
        mesh = make_mesh((1,), ("data",), kind)
        err = init_error_state(tree)
        out = compressed_grad_allreduce(tree, err, mesh, axis="data")
        results[kind] = [t.cpu() for t in tree_leaves(out[0])
                         + tree_leaves(out[1])]
        if kind == "cuda":
            ms = time_eager_ms(torch, lambda: compressed_grad_allreduce(
                tree, err, mesh, axis="data"))
    differ = sum(int(not torch.equal(a, b))
                 for a, b in zip(results["cuda"], results["cpu"]))
    if differ:
        raise AssertionError(f"train_dp: compressed_grad_allreduce on the "
                             f"card differs from the CPU's in {differ} of "
                             f"{len(results['cpu'])} tensors")
    return {"tensors": len(results["cpu"]), "bit_equal_to_cpu": True,
            "values": sum(t.numel() for t in tree_leaves(grads)),
            "ms": ms}


def dp_vs_world1(torch, ranks: list, world1: dict, grads: dict,
                 phase: str) -> dict:
    """A spawned world's runs against world 1's: every rank's parameters
    the same bits, losses within ``TRAIN_LOSS_RTOL``, parameters within
    the trainer's bar save for Adam noise (``params_vs_cpu``)."""
    from repro_torch.optim.optimizers import tree_leaves
    out = {}
    for key in dp_configs():
        run, params = ranks[0][key]
        for r, other in enumerate(ranks[1:], 1):
            if not same_params(other[key][1], params):
                raise AssertionError(f"{phase} {key}: rank {r}'s parameters "
                                     f"differ from rank 0's")
        want_run, want_params = world1[key]
        err = rel_err(run["losses"], want_run["losses"])
        if err > TRAIN_LOSS_RTOL:
            raise AssertionError(f"{phase} {key}: losses {run['losses']} vs "
                                 f"world 1's {want_run['losses']}: "
                                 f"relative {err:.3e}")
        g = [np.asarray(v.cpu()) for v in tree_leaves(grads[key])]
        out[key] = {"losses": run["losses"], "loss_rel_err": err,
                    "ms_per_step_by_rank": [r[key][0]["ms_per_step"]
                                            for r in ranks],
                    "steps": run["steps"], "launches": run["launches"],
                    **params_vs_cpu(leaves_of(params),
                                    leaves_of(want_params), g,
                                    f"{phase} {key}")}
    return out


def phase_train_dp(torch, name_limit: str) -> dict:
    """Data-parallel training (``TrainConfig(data_parallel=True)``) at
    train_path's settings, one epoch each of dense and sparse GraphSAGE:
    world 1 over NCCL in this process, bit-equal to the single-device run
    (in turns with it), launches on ``train_launch_rule``, the gradient
    all-reduce's device time; world 2 over ``gloo``, two processes on the
    one card, within the trainer's bar of world 1; NCCL over every card
    where there are two or more; the int8 all-reduce on the card against
    the CPU."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.train.gnn_trainer import TrainConfig, train_pmgns
    t0 = time.perf_counter()
    samples = dp_samples()
    cfgs = dp_configs()
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"phase": "train_dp", "card": name_limit,
           "samples": TRAIN_SAMPLES, "batch_size": TRAIN_BATCH,
           "lr": TRAIN_LR, "epochs": 1}
    with tempfile.TemporaryDirectory() as tmp:
        init_group("cpu:gloo,cuda:nccl", str(Path(tmp) / "store"), 0, 1)
        try:
            world1, grads, turns = {}, {}, {}
            for key, cfg in cfgs.items():
                runs = []
                for dp in (False, True, True, False):
                    run, params = train_run(
                        torch, cfg, samples, 1,
                        f"train_dp world 1 {key} dp={dp}",
                        compare_cpu=False, data_parallel=dp)
                    runs.append((dp, run, params))
                single = runs[0][2]
                for dp, run, params in runs[1:]:
                    if not same_params(params, single) or \
                            run["losses"] != runs[0][1]["losses"]:
                        raise AssertionError(
                            f"train_dp world 1 {key}: the "
                            f"{'data-parallel' if dp else 'repeated'} run's "
                            f"parameters or losses differ from the "
                            f"single-device run's")
                world1[key] = runs[1][1:]
                turns[key] = {
                    "order": ["single", "dp", "dp", "single"],
                    "ms_per_step": [r["ms_per_step"] for _, r, _ in runs],
                    "losses": runs[1][1]["losses"],
                    "steps": runs[1][1]["steps"],
                    "launches": runs[1][1]["launches"],
                    "bit_equal_to_single": True}
                grads[key] = first_step_grads(torch, cfg, samples, dev)
            group = make_mesh((1,), ("data",), "cuda").get_group("data")
            n_grad = sum(t.numel() for t in tree_leaves(grads["dense"]))
            steps = turns["dense"]["steps"]
            rows = device_ms_by_kernel(torch, lambda: train_pmgns(
                cfgs["dense"], samples, (), TrainConfig(
                    epochs=1, batch_size=TRAIN_BATCH, lr=TRAIN_LR,
                    data_parallel=True)))
            nccl = {k: v for k, v in rows.items() if "nccl" in k.lower()}
            out["world1_nccl"] = {
                "runs": turns,
                "gradient_values": n_grad,
                "gradient_bytes": 4 * n_grad,
                "allreduce_device_us_per_step": 1e3 * sum(nccl.values())
                / steps,
                "allreduce_kernels": nccl or "none recorded: NCCL "
                "launched no device work for an all-reduce over one rank",
                "device_busy_ms_per_step": sum(rows.values()) / steps,
                "allreduce_ms_per_call": allreduce_ms(torch, n_grad, group)}
            out["compression"] = dp_compression(torch, grads["dense"])
            world2 = dp_spawn(2, "gloo", tmp)
            out["world2_gloo_one_card"] = {
                "note": "two processes sharing one card, gradients staged "
                        "through the host by gloo: not a scaling number",
                **dp_vs_world1(torch, world2, world1, grads,
                               "train_dp world 2 gloo")}
            n_cards = torch.cuda.device_count()
            if n_cards >= 2:
                ranks = dp_spawn(n_cards, "nccl", tmp)
                out["multi_card"] = {
                    "world": n_cards,
                    **dp_vs_world1(torch, ranks, world1, grads,
                                   f"train_dp world {n_cards} nccl")}
            else:
                out["multi_card"] = "one card"
        finally:
            dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    return out


# ---------------------------------------------------------------------------
# zoo_path: the graph sources — tracer, zoo, labels, dataset
# ---------------------------------------------------------------------------

def plain_cfg(cfg: dict) -> dict:
    """A zoo config with numpy scalars as Python numbers, for JSON."""
    return json.loads(json.dumps(cfg, default=lambda v: v.item()))


def zoo_traces() -> tuple:
    """One ``family_variants`` draw (seed 0) of each zoo family at its
    Table-2 size, then the ``ZOO_GRID`` sweep of ViT, each traced on the
    meta device: (family, cfg, graph) triples and the host ms each
    trace took."""
    from repro_torch.zoo import (FAMILIES, family_variants, trace_family,
                                 variant_grid)
    rng = np.random.default_rng(0)
    plan = [(fam, family_variants(fam, rng)) for fam in FAMILIES]
    plan += [("vit", cfg) for cfg in variant_grid("vit", ZOO_GRID)]
    out, ms = [], []
    for fam, cfg in plan:
        t0 = time.perf_counter()
        g = trace_family(fam, cfg)
        ms.append(1e3 * (time.perf_counter() - t0))
        out.append((fam, cfg, g))
    return out, ms


def zoo_labels(traced: list) -> dict:
    """Every graph's labels from the cost model on both profiled devices:
    finite, positive, and the same from a second call."""
    import dataclasses
    from repro_torch.perfmodel import DEVICES, estimate
    out = {}
    for dev_name, dev in DEVICES.items():
        rows = []
        for fam, _, g in traced:
            a, b = estimate(g, dev), estimate(g, dev)
            y = a.as_targets()
            if not (np.isfinite(y).all() and (y > 0).all()):
                raise AssertionError(f"zoo_path: {fam} labels {y} on "
                                     f"{dev_name}")
            if dataclasses.asdict(a) != dataclasses.asdict(b):
                raise AssertionError(f"zoo_path: {fam} labels differ "
                                     f"between two calls")
            rows.append(y.tolist())
        out[dev_name] = rows
    return out


def zoo_dataset(torch) -> tuple:
    """``build_dataset`` as the reference's default build at a small
    count, its v1 save and load round trip (bit for bit), and the train
    split as padded samples."""
    import tempfile
    from repro_torch.dataset import builder
    t0 = time.perf_counter()
    ds = builder.build_dataset(ZOO_DATASET, seed=ZOO_SEED,
                               extra_families=ZOO_HELD_OUT)
    t_build = time.perf_counter() - t0
    if ds.n_skipped or not ds:
        raise AssertionError(f"zoo_path: build_dataset skipped "
                             f"{ds.skips_by_family()}")
    with tempfile.TemporaryDirectory() as tmp:
        builder.save_dataset(ds, tmp, shard_size=16)
        back = builder.load_dataset(tmp)
    same = len(back) == len(ds) and all(
        all(getattr(r, k).dtype == getattr(q, k).dtype
            and getattr(r, k).tobytes() == getattr(q, k).tobytes()
            for k in ("x", "edges", "static", "y"))
        and (r.family, r.n_nodes, r.meta) == (q.family, q.n_nodes, q.meta)
        for r, q in zip(back, ds))
    if not same:
        raise AssertionError("zoo_path: the saved dataset did not load "
                             "back bit for bit")
    splits = builder.split_dataset(ds, seed=ZOO_SEED)
    samples = builder.records_to_samples(splits["train"])
    info = {"records": len(ds), "build_s": t_build,
            "families": sorted({r.family for r in ds}),
            "splits": {k: len(v) for k, v in splits.items()},
            "nodes": [r.n_nodes for r in ds], "round_trip_bitwise": same,
            "train_samples": len(samples)}
    return info, samples


def zoo_train(torch, samples, phase: str = "zoo_path train",
              epochs: int = 1) -> tuple:
    """Packed GraphSAGE epochs at ``train_path``'s settings on a built
    dataset's train split: launches on ``train_launch_rule``
    (``train_run``) and the losses against the same epochs on the CPU.
    Returns the line's entry and the card's trained parameters."""
    from repro_torch.core.gnn import PMGNSConfig
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.train.gnn_trainer import TrainConfig, train_pmgns
    cfg = PMGNSConfig(variant="graphsage", hidden=TRAIN_HIDDEN, dropout=0.0,
                      layout="packed")
    out, params = train_run(torch, cfg, samples, epochs, phase,
                            compare_cpu=False)
    c_params, c_hist = train_pmgns(
        cfg, samples, (), TrainConfig(epochs=epochs, batch_size=TRAIN_BATCH,
                                      lr=TRAIN_LR, seed=0), device="cpu")
    c_losses = [r["train_loss"] for r in c_hist]
    loss_err = rel_err(out["losses"], c_losses)
    if loss_err > TRAIN_LOSS_RTOL:
        raise AssertionError(f"{phase}: losses {out['losses']} vs "
                             f"the CPU's {c_losses}: relative "
                             f"{loss_err:.3e}")
    d = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
            for a, b in zip(tree_leaves(params), tree_leaves(c_params)))
    out["vs_cpu"] = {"cpu_losses": c_losses, "loss_rel_err": loss_err,
                     "loss_rtol": TRAIN_LOSS_RTOL, "param_max_abs_err": d}
    return out, params


def zoo_predict(torch, cfg, draws: list, sweep: list, grid: list) -> tuple:
    """``predict_zoo`` on the ViT ``grid`` and ``predict_many`` on the
    family draws' graphs at full width on the card: launches zeroed
    before and held to bins × layers after (GAT's B3 and B4 all on the
    bin's shared CSR), predictions against the CPU's plain versions on
    the same graphs (``sweep`` holds the grid's traces); then those
    graphs straight through the engine, ``ZOO_REPEATS`` times, for wall
    ms per bin, the host's feature time and the device's busy ms a bin.
    Returns the line's entry and the card's ``DIPPM``."""
    from repro_torch.core import DIPPM, pmgns_init, sample_from_graph
    tree = pmgns_init(0, cfg)
    dippm = DIPPM.from_params(tree, cfg)          # on the card by default
    if dippm.device.type != "cuda":
        raise AssertionError(f"zoo_path: DIPPM ran on {dippm.device}")
    engine = dippm.engine()
    kernels = path_kernels(cfg.variant)
    phase = f"zoo_path {cfg.variant}"

    zero_counts(kernels)
    bins0 = engine.stats.batches_run
    t0 = time.perf_counter()
    zoo = dippm.predict_zoo("vit", grid)
    torch.cuda.synchronize()
    t_zoo = time.perf_counter() - t0
    many = dippm.predict_many(draws)
    torch.cuda.synchronize()
    bins = engine.stats.batches_run - bins0
    launches = {name: fn.launches for name, (fn, _) in kernels.items()}
    want = {name: bins * (cfg.n_gnn_blocks if per == "layer" else 1)
            for name, (_, per) in kernels.items()}
    if launches != want or min(launches.values()) <= 0:
        raise AssertionError(f"{phase}: launch counts {launches} != bins x "
                             f"layers {want} ({bins} bins)")
    csr_use = check_shared_csr(kernels, launches, phase)
    if [c for c, _ in zoo] != grid:
        raise AssertionError(f"{phase}: predict_zoo returned other configs")
    card = pred_rows([p for _, p in zoo] + many)
    if not np.isfinite(card).all():
        raise AssertionError(f"{phase}: non-finite predictions")

    cpu = DIPPM.from_params(tree, cfg, device="cpu")
    ref = pred_rows(cpu.predict_many(sweep + draws))
    err = check_close(f"{phase}: card vs CPU predictions", card, ref,
                      E2E_ATOL, E2E_RTOL)
    graphs = sweep + draws
    walls, feats = [], []
    for _ in range(ZOO_REPEATS):
        b0 = engine.stats.batches_run
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        engine.predict_graphs(graphs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        # the host's share of that: the graphs' features and padding
        t2 = time.perf_counter()
        samples = [sample_from_graph(g, buckets=engine.engine_cfg.buckets)
                   for g in graphs]
        feats.append(time.perf_counter() - t2)
    per_run = engine.stats.batches_run - b0
    t_run = statistics.median(walls)
    busy, top = device_busy_ms(torch, lambda: engine.predict_samples(samples))
    out = {"launches": launches, "bins": bins, "csr_launches": csr_use,
           "predict_zoo_s": t_zoo, "graphs": len(graphs),
           "nodes": sum(g.num_nodes for g in graphs),
           "vs_cpu": {"max_abs_err": err, "max_rel_err": rel_err(card, ref),
                      "atol": E2E_ATOL, "rtol": E2E_RTOL},
           "engine_s": walls, "engine_bins": per_run,
           "featurize_s": feats,
           "predictions_per_s": len(graphs) / t_run,
           "ms_per_bin": 1e3 * t_run / max(per_run, 1),
           "device_busy_ms_per_bin": busy / max(per_run, 1),
           "device_ms_by_kernel": top}
    return out, dippm


def zoo_net(torch):
    """A user model for ``submit_torch``: a convolution, a layer norm,
    GELU and a linear head, weights from a seed."""
    nn = torch.nn

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2d(3, 64, 3, stride=2, padding=1)
            self.norm = nn.LayerNorm(64)
            self.act = nn.GELU()
            self.fc = nn.Linear(64, 1000)

        def forward(self, x):
            y = self.conv(x).permute(0, 2, 3, 1)
            return self.fc(self.act(self.norm(y))).mean((1, 2))

    torch.manual_seed(0)
    return Net()


def zoo_submit(torch, dippm) -> dict:
    """``submit_torch`` through a started service against
    ``predict_torch`` on the same predictor: a zoo forward and a user
    module, the same bits required (GAT sums in a fixed order)."""
    from repro_torch.zoo import build_family
    specs, fwd, meta = build_family("resnet", {"batch": 8, "res": 224})
    net = zoo_net(torch)
    x_img = ((8, 224, 224, 3), torch.float32)
    x_net = ((8, 3, 224, 224), torch.float32)
    ptrs = [p.data_ptr() for p in net.parameters()]
    direct = [dippm.predict_torch(fwd, specs, x_img, meta=meta),
              dippm.predict_torch(net, None, x_net, batch=8)]
    with dippm.serve() as svc:
        futs = [svc.submit_torch(fwd, specs, x_img, meta=meta),
                svc.submit_torch(net, None, x_net, batch=8)]
        served = [f.result(timeout=SERVE_TIMEOUT) for f in futs]
        stats = svc.stats
    a, b = pred_rows(direct), pred_rows(served)
    if a.tobytes() != b.tobytes():
        raise AssertionError(f"zoo_path: submit_torch {b} != predict_torch "
                             f"{a}")
    if [p.data_ptr() for p in net.parameters()] != ptrs or any(
            p.device.type != "cpu" for p in net.parameters()):
        raise AssertionError("zoo_path: tracing moved the caller's module")
    return {"models": ["resnet b8 r224", "conv-norm-gelu-linear b8 r224"],
            "predictions": a.tolist(), "bitwise": True,
            "served": stats.completed, "invalid": stats.invalid}


def phase_zoo(torch, name_limit: str) -> dict:
    """The graph sources on the card: traces, labels, the dataset and a
    training epoch on it, ``predict_zoo`` at full width and
    ``submit_torch``."""
    import dataclasses
    from repro_torch.core.gnn import PMGNSConfig
    from repro_torch.zoo import variant_grid
    t0 = time.perf_counter()
    traced, trace_ms = zoo_traces()
    grid = variant_grid("vit", ZOO_GRID)
    n_draws = len(traced) - len(grid)
    traces = {fam: {"cfg": plain_cfg(cfg), "nodes": g.num_nodes,
                    "edges": g.num_edges, "raw_nodes": g.meta["n_raw_nodes"],
                    "host_ms": ms}
              for (fam, cfg, g), ms in zip(traced[:n_draws], trace_ms)}
    raw = {fam: t["raw_nodes"] for fam, t in traces.items()}
    if raw != ZOO_REF_RAW_NODES:
        raise AssertionError(f"zoo_path: raw node counts {raw} != the "
                             f"reference tracer's {ZOO_REF_RAW_NODES}")
    sweep = [{"cfg": plain_cfg(cfg), "nodes": g.num_nodes, "host_ms": ms}
             for (_, cfg, g), ms in zip(traced[n_draws:],
                                        trace_ms[n_draws:])]
    labels = zoo_labels(traced)
    dataset, samples = zoo_dataset(torch)
    train, _ = zoo_train(torch, samples)
    predict = {}
    sage = PMGNSConfig(variant="graphsage", layout="packed", precision="f32")
    draws = [g for _, _, g in traced[:n_draws]]
    sweep_graphs = [g for _, _, g in traced[n_draws:]]
    predict["graphsage"], _ = zoo_predict(torch, sage, draws, sweep_graphs,
                                          grid)
    predict["gat"], gat_dippm = zoo_predict(
        torch, dataclasses.replace(sage, variant="gat"), draws, sweep_graphs,
        grid)
    out = {"phase": "zoo_path", "card": name_limit,
           "traces": traces, "sweep": sweep,
           "trace_ms": {"median": statistics.median(trace_ms),
                        "max": max(trace_ms), "total": sum(trace_ms)},
           "nodes_per_graph": [g.num_nodes for _, _, g in traced],
           "labels": labels, "dataset": dataset, "train": train,
           "predict": predict, "submit_torch": zoo_submit(torch, gat_dippm),
           "seconds": time.perf_counter() - t0}
    emit(out)
    return out


def factory_shas(path: str) -> dict:
    """sha256 of every shard file of a factory build, by file name."""
    import hashlib
    shard_dir = Path(path) / "shards"
    return {f.name: hashlib.sha256(f.read_bytes()).hexdigest()
            for f in sorted(shard_dir.glob("*.npz"))}


def factory_predict(torch, cfg, params, samples: list) -> dict:
    """The trained parameters' predictions of ``samples`` on the card,
    launches zeroed before and held to bins × layers after, against the
    same parameters on the CPU's plain versions."""
    from repro_torch.core import DIPPM
    dippm = DIPPM.from_params(params, cfg)        # on the card by default
    if dippm.device.type != "cuda":
        raise AssertionError(f"factory: DIPPM ran on {dippm.device}")
    engine = dippm.engine()
    kernels = path_kernels(cfg.variant)
    zero_counts(kernels)
    bins0 = engine.stats.batches_run
    card = engine.predict_samples(samples)
    torch.cuda.synchronize()
    bins = engine.stats.batches_run - bins0
    launches = {name: fn.launches for name, (fn, _) in kernels.items()}
    want = {name: bins * (cfg.n_gnn_blocks if per == "layer" else 1)
            for name, (_, per) in kernels.items()}
    if launches != want or min(launches.values()) <= 0:
        raise AssertionError(f"factory predict: launch counts {launches} != "
                             f"bins x layers {want} ({bins} bins)")
    if not np.isfinite(card).all():
        raise AssertionError("factory predict: non-finite predictions")
    cpu = DIPPM.from_params(params, cfg, device="cpu")
    ref = cpu.engine().predict_samples(samples)
    err = check_close("factory predict: card vs CPU", card, ref, E2E_ATOL,
                      E2E_RTOL)
    return {"graphs": len(samples), "bins": bins, "launches": launches,
            "vs_cpu": {"max_abs_err": err, "max_rel_err": rel_err(card, ref),
                       "atol": E2E_ATOL, "rtol": E2E_RTOL}}


def timed(fn, *args, **kwargs) -> tuple:
    """``fn``'s result and the seconds it took."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - t0


def factory_trace_ms(factory, plan) -> dict:
    """Host ms of one trace + labels (``factory._trace_entry``) of every
    LM entry of the plan and of its first ``FACTORY_TIMED_ZOO`` zoo
    entries, in this process."""
    device = plan.config["device_name"]
    sigma = float(plan.config["noise_sigma"])
    out = {"lm": {}, "zoo": {}}
    zoo = 0
    for e in plan.entries:
        if e["kind"] == "zoo":
            if zoo == FACTORY_TIMED_ZOO:
                continue
            zoo += 1
        t0 = time.perf_counter()
        factory._trace_entry(e, device, sigma)
        out[e["kind"]][f"{e['index']}:{e['family']}"] = \
            1e3 * (time.perf_counter() - t0)
    for kind in ("lm", "zoo"):
        out[f"{kind}_median_ms"] = statistics.median(out[kind].values())
    return out


def graph_form_case(what: str, got, want) -> dict:
    """One kernel output against its graph form, at ``GRAPH_FORM_RTOL``
    of the graph form's largest magnitude."""
    scale = float(want.abs().max())
    err = check_close(what, got, want, GRAPH_FORM_RTOL * scale,
                      GRAPH_FORM_RTOL)
    return {"max_abs_err": err, "scale": scale,
            "max_rel_err": err / max(scale, 1e-30)}


def lm_graph_form_checks(torch, dev, entries: list) -> dict:
    """B8 and B9 on ``dev`` against the graph forms that a trace of
    ``lm.forward`` records (``graph_form.blockwise_attention``,
    ``graph_form._ssd_chunked``: the JAX package's jnp steps) run on ``dev``,
    float32, at each LM entry's attention and SSD shapes (its smoke
    config at its batch and seq), on seeded inputs; the kernels'
    launches counted. An MLA arch's attention is its full-sequence call:
    D = nope + rope over Dv = ``v_head_dim`` on every head, scale
    ``1 / sqrt(D)``. A cross-attention arch adds its cross layer's call:
    the seq's queries over ``vision_tokens`` keys, not causal."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    from repro_torch.models import graph_form
    gen = torch.Generator(device=dev)
    gen.manual_seed(ZOO_SEED)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    wrappers = {"flash_attention": flash_attention_cuda,
                "ssd_scan": ssd_scan_cuda}
    before = {k: w.launches for k, w in wrappers.items()}
    out = {k: {"cases": []} for k in wrappers}
    for e in entries:
        cfg = get_smoke_config(e["family"])
        b, s = int(e["cfg"]["batch"]), int(e["cfg"]["seq"])
        case = {"arch": e["family"], "batch": b, "seq": s}
        if cfg.block in ("attn", "hybrid"):
            if cfg.mla is not None:
                m = cfg.mla
                d, dv = m.qk_nope_dim + m.qk_rope_dim, m.v_head_dim
                hkv, scale = cfg.n_heads, 1.0 / math.sqrt(d)
            else:
                d = dv = cfg.resolved_head_dim
                hkv, scale = cfg.n_kv_heads, None
            q = rnd(b, s, cfg.n_heads, d)
            k, v = rnd(b, s, hkv, d), rnd(b, s, hkv, dv)
            got = ops.flash_attention(q, k, v, causal=cfg.causal,
                                      window=cfg.window, scale=scale)
            want = graph_form.blockwise_attention(q, k, v, causal=cfg.causal,
                                                  window=cfg.window,
                                                  scale=scale)
            out["flash_attention"]["cases"].append({
                **case, "q": list(q.shape), "k": list(k.shape),
                "v": list(v.shape), "window": cfg.window,
                **graph_form_case(
                    f"factory: B8 vs the graph form, {case}", got, want)})
        if cfg.cross_attn_every:
            hd = cfg.resolved_head_dim
            q = rnd(b, s, cfg.n_heads, hd)
            k, v = (rnd(b, cfg.vision_tokens, cfg.n_kv_heads, hd)
                    for _ in range(2))
            got = ops.flash_attention(q, k, v, causal=False)
            want = graph_form.blockwise_attention(q, k, v, causal=False)
            cross = {**case, "cross": True}
            out["flash_attention"]["cases"].append({
                **cross, "q": list(q.shape), "k": list(k.shape),
                "v": list(v.shape), "window": 0,
                **graph_form_case(
                    f"factory: B8 vs the graph form, {cross}", got, want)})
        if cfg.block in ("mamba2", "hybrid"):
            ssm = cfg.ssm
            nh, g = ssm.n_heads(cfg.d_model), ssm.n_groups
            x = rnd(b, s, nh, ssm.head_dim)
            dt = 0.05 + 0.1 * torch.rand((b, s, nh), generator=gen,
                                         device=dev)
            a = -torch.exp(0.1 * rnd(nh))
            bm, cm = rnd(b, s, g, ssm.d_state), rnd(b, s, g, ssm.d_state)
            y, last = ops.ssd_scan(x, dt, a, bm, cm, chunk=ssm.chunk)
            wy, wlast = graph_form._ssd_chunked(
                x, dt, a, bm.repeat_interleave(nh // g, 2),
                cm.repeat_interleave(nh // g, 2), ssm.chunk)
            out["ssd_scan"]["cases"].append({
                **case, "x": list(x.shape), "bc": list(bm.shape),
                "chunk": ssm.chunk,
                "y": graph_form_case(f"factory: B9 y vs the graph form, "
                                     f"{case}", y, wy),
                "last_state": graph_form_case(
                    f"factory: B9 state vs the graph form, {case}", last,
                    wlast)})
    torch.cuda.synchronize()
    for name, w in wrappers.items():
        n = w.launches - before[name]
        if not out[name]["cases"] or n != len(out[name]["cases"]):
            raise AssertionError(f"factory: {name} launched {n} times for "
                                 f"{len(out[name]['cases'])} graph-form "
                                 f"checks")
        out[name].update(launches=n, rtol=GRAPH_FORM_RTOL)
    return out


def moe_graph_form_checks(torch, dev, entries: list) -> dict:
    """The MoE block's graph form (``graph_form.moe_apply_local``: the JAX
    package's jnp steps, which a trace of ``lm.forward`` records) against
    its serving form (``layers.moe_apply_local``) on ``dev``, float32, at
    each MoE entry's B·S tokens of its smoke config, at its capacity
    factor and at 0.5 (replicas dropped), on seeded inputs and a seeded
    router of unit scale (no near-ties): the same expert ids and keep
    masks, the output and the aux loss within ``GRAPH_FORM_RTOL`` of
    their scale."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    gen = torch.Generator(device=dev)
    gen.manual_seed(ZOO_SEED)
    cases = []
    for e in entries:
        smoke = get_smoke_config(e["family"])
        if smoke.moe is None:
            continue
        for factor in (smoke.moe.capacity_factor, 0.5):
            mo = dataclasses.replace(smoke.moe, capacity_factor=factor)
            cases.append(moe_graph_form_case(
                torch, gen, dev, dataclasses.replace(smoke, moe=mo), e))
    if not cases:
        raise AssertionError("factory: no MoE entry in the plan")
    return {"cases": cases, "rtol": GRAPH_FORM_RTOL}


def moe_graph_form_case(torch, gen, dev, cfg, e) -> dict:
    """One case of :func:`moe_graph_form_checks`."""
    from repro_torch.models import graph_form
    from repro_torch.models import layers as L
    mo = cfg.moe
    b, s = int(e["cfg"]["batch"]), int(e["cfg"]["seq"])
    t = b * s
    p = L.moe_init(gen, cfg)
    p["router"] = torch.randn(p["router"].shape, generator=gen, device=dev)
    x = torch.randn((t, cfg.d_model), generator=gen, device=dev)
    with torch.no_grad():
        y, aux = L.moe_apply_local(p, cfg, x)
        gy, gaux = graph_form.moe_apply_local(p, mo, x)
        _, ids, _ = L._route(p["router"], x, mo)
        keep, _, cap = L.moe_slots(ids, mo, t)
        _, gids, _ = graph_form.moe_route(p["router"], x, mo.n_experts,
                                          mo.top_k)
        gkeep, _ = graph_form.moe_slots(gids, mo.n_experts, cap)
    case = {"arch": e["family"], "batch": b, "seq": s, "tokens": t,
            "capacity_factor": mo.capacity_factor, "cap": cap,
            "dropped": int((~keep).sum())}
    if not (torch.equal(ids.to(torch.int32), gids)
            and torch.equal(keep, gkeep)):
        raise AssertionError(f"factory: the MoE graph form routes "
                             f"otherwise than the serving form, {case}")
    return {**case, "y": graph_form_case(
        f"factory: MoE serving form vs the graph form, {case}", y, gy),
        "aux": graph_form_case(
            f"factory: MoE aux loss vs the graph form, {case}",
            aux.reshape(1), gaux.reshape(1))}


def factory_config(factory):
    """The factory phase's plan config, in ``factory``'s ``FactoryConfig``
    (the port's, or the JAX package's in a test)."""
    return factory.FactoryConfig(n_graphs=FACTORY_GRAPHS, seed=ZOO_SEED,
                                 shard_size=FACTORY_SHARD,
                                 extra_families=ZOO_HELD_OUT,
                                 lm_archs=FACTORY_LM_ARCHS)


def phase_factory(torch, name_limit: str) -> dict:
    """The dataset factory on the card machine's host, then its records on
    the card: a plan of zoo graphs and nine LM entries built by
    ``FACTORY_WORKERS`` spawned processes; a copy of the build that lost
    its last shard and the manifest (a build killed before its last
    shard) resumed in this process, every other shard reused and the
    sha256 equal to the first build's; the records streamed with
    ``verify=True`` and split by fingerprint; packed GraphSAGE trained on
    the train split against the CPU; the test split and the LM records predicted on the
    card against the CPU, launches on bins × layers; the LM entries'
    trace ms beside the zoo's; B8 and B9 against the graph forms at the
    LM entries' shapes; the MoE block's graph form against its serving
    form at the MoE entries' tokens."""
    import resource
    import tempfile
    from repro_torch.core import DIPPM
    from repro_torch.core.gnn import PMGNSConfig
    from repro_torch.dataset import builder, factory
    t0 = time.perf_counter()
    cfg = factory_config(factory)
    plan = factory.make_plan(cfg)
    if plan.plan_hash != FACTORY_PLAN_HASH:
        raise AssertionError(f"factory: plan hash {plan.plan_hash} != "
                             f"{FACTORY_PLAN_HASH}")
    with tempfile.TemporaryDirectory() as tmp:
        full, cut = str(Path(tmp) / "full"), str(Path(tmp) / "cut")
        res, build_s = timed(factory.build, full, cfg,
                             workers=FACTORY_WORKERS)
        if res.n_skipped or res.n_built != res.n_planned \
                or not res.manifest_path:
            raise AssertionError(f"factory: built {res.n_built} of "
                                 f"{res.n_planned}, skips "
                                 f"{res.skips_by_family}")
        shas = factory_shas(full)
        # a build killed before its last shard: that shard, its sidecar
        # and the manifest missing
        shutil.copytree(full, cut)
        last = sorted(shas)[-1]
        for name in (last, last.replace(".npz", ".json")):
            (Path(cut) / "shards" / name).unlink()
        (Path(cut) / "manifest.json").unlink()
        resumed, resume_s = timed(factory.build, cut)
        cut_shas = factory_shas(cut)
        if resumed.shards_reused != len(shas) - 1 \
                or resumed.shards_built != 1 or cut_shas != shas \
                or resumed.plan_hash != res.plan_hash:
            raise AssertionError(f"factory: the resumed build reused "
                                 f"{resumed.shards_reused} shards; its "
                                 f"shards {cut_shas} != {shas}")
        records = list(factory.iter_records(full, verify=True))
    lm_records = [r for r in records if r.meta.get("kind") == "lm"]
    if sorted(r.family for r in lm_records) != sorted(FACTORY_LM_ARCHS):
        raise AssertionError(f"factory: LM records "
                             f"{[r.family for r in lm_records]}")
    trace_ms = factory_trace_ms(factory, plan)
    lm_entries = [e for e in plan.entries if e["kind"] == "lm"]
    checks = lm_graph_form_checks(torch, "cuda", lm_entries)
    moe_checks = moe_graph_form_checks(torch, "cuda", lm_entries)
    splits = builder.split_dataset(records, seed=ZOO_SEED)
    if sum(len(v) for v in splits.values()) != len(records) \
            or not splits["train"] or not splits["test"]:
        raise AssertionError(f"factory: split "
                             f"{ {k: len(v) for k, v in splits.items()} }")
    train, params = zoo_train(torch, builder.records_to_samples(
        splits["train"]), "factory train", FACTORY_EPOCHS)
    pcfg = PMGNSConfig(variant="graphsage", hidden=TRAIN_HIDDEN,
                       dropout=0.0, layout="packed")
    buckets = DIPPM.from_params(params, pcfg, device="cpu").engine() \
        .engine_cfg.buckets
    predict = factory_predict(torch, pcfg, params, builder.records_to_samples(
        splits["test"], buckets=buckets))
    predict_lm = factory_predict(torch, pcfg, params,
                                 builder.records_to_samples(
                                     lm_records, buckets=buckets))
    out = {"phase": "factory", "card": name_limit,
           "plan": {"graphs": FACTORY_GRAPHS, "shard_size": FACTORY_SHARD,
                    "held_out": list(ZOO_HELD_OUT), "seed": ZOO_SEED,
                    "lm_archs": list(FACTORY_LM_ARCHS),
                    "workers": FACTORY_WORKERS},
           "plan_hash": res.plan_hash, "records": res.n_built,
           "shards": res.n_shards, "build_s": build_s,
           "records_per_s": res.n_built / build_s,
           # the sidecars' ru_maxrss: a spawned worker's starts at its
           # parent's at the fork (Linux keeps the high-water mark across
           # exec), so this is at least the host process's RSS then
           "sidecar_max_rss_kb": res.max_rss_kb,
           "host_peak_rss_kb": int(resource.getrusage(
               resource.RUSAGE_SELF).ru_maxrss),
           "resume": {"shards_removed": 1,
                      "shards_reused": resumed.shards_reused,
                      "shards_built": resumed.shards_built,
                      "seconds": resume_s, "same_sha256": True},
           "shard_sha256": shas,
           "reference_sha256_equal": shas == FACTORY_REF_SHA256,
           "lm_records": [{"arch": r.family, "batch": r.meta["batch"],
                           "seq": r.meta["seq"], "nodes": r.n_nodes,
                           "fingerprint": r.meta["fingerprint"]}
                          for r in lm_records],
           "trace_ms": trace_ms,
           "splits": {k: len(v) for k, v in splits.items()},
           "lm_splits": {k: sum(r.meta.get("kind") == "lm" for r in v)
                         for k, v in splits.items()},
           "train": train, "predict": predict, "predict_lm": predict_lm,
           "graph_form_checks": checks,
           "moe_graph_form_checks": moe_checks,
           "launches": {"train": train["launches"],
                        "predict": predict["launches"],
                        "predict_lm": predict_lm["launches"],
                        "graph_form_checks": {
                            k: v["launches"] for k, v in checks.items()}},
           "seconds": time.perf_counter() - t0}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# the LM stack: flash attention and the SSD scan, then lm_path
# ---------------------------------------------------------------------------

def lm_config(**overrides):
    """``LM_ARCH``'s config (its smoke config under ``LM_SMOKE_WIDTH``)
    with ``overrides``."""
    import dataclasses
    from repro_torch.configs import get_config, get_smoke_config
    cfg = (get_smoke_config if LM_SMOKE_WIDTH else get_config)(LM_ARCH)
    return dataclasses.replace(cfg, **overrides)


def tree_to(tree, dev):
    """A nested dict of tensors, copied to ``dev``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


#: flash sweep: (B, Sq, Skv, H, Hkv, D, causal, window, q_offset, kv_offset)
FLASH_SWEEP = [
    (1, 128, 128, 2, 2, 64, True, 0, 0, 0),
    (1, 96, 96, 2, 2, 64, False, 0, 0, 0),
    (1, 128, 128, 2, 2, 64, True, 32, 0, 0),
    (1, 1, 256, 2, 2, 64, False, 0, 255, 0),          # decode
    (2, 33, 70, 8, 2, 16, True, 16, 40, -3),          # GQA 4, ring offset
    (2, 5, 21, 4, 2, 120, True, 16, 3, -16),          # ring early: cols < 0
    (1, 6, 8, 2, 1, 128, True, 0, 0, 3),              # rows 0-2 fully masked
    (3, 1, 70, 4, 2, 80, True, 0, 45, 0),             # decode, GQA 2
    (2, 77, 77, 4, 4, 80, True, 0, 0, 0),             # ragged tiles
    # the tensor-core path: query tiles around the 64-row warpgroup and the
    # 128-row CTA, each padded head dim (16, 64, 80, 120 -> 128, 128)
    (1, 63, 63, 2, 2, 64, True, 0, 0, 0),
    (1, 64, 64, 2, 1, 80, True, 0, 0, 0),
    (1, 65, 65, 2, 2, 120, True, 0, 0, 0),
    (1, 200, 260, 4, 2, 128, True, 0, 60, 0),
    (1, 512, 576, 2, 2, 80, True, 0, 0, 0),
    (1, 40, 96, 4, 1, 16, True, 24, 70, -10),         # window, ring offset
    (1, 3, 24, 2, 2, 16, False, 0, 0, 0),             # Skv under one tile
    (2, 70, 90, 4, 2, 32, True, 0, 20, 0),            # D 32 and 24: padded
    (1, 130, 130, 2, 1, 24, True, 48, 0, 0),          # to 64 on the TMA path
    (4, 300, 300, 40, 8, 64, True, 0, 0, 150),        # items > SMs, empty ones
    # split-KV decode: GQA 4 and 8 over several splits, a window over the
    # ring's negative offset, Skv under one tile, a split with no kept key
    (1, 1, 576, 16, 4, 64, True, 0, 575, 0),
    (1, 1, 576, 16, 2, 128, True, 0, 575, 0),
    (1, 1, 300, 8, 2, 120, True, 40, 250, -30),
    (1, 1, 24, 4, 1, 64, True, 0, 23, 0),
    (2, 1, 20, 4, 1, 80, True, 0, 5, 10),
    # cross-attention and the encoder, none causal: text rows over vision
    # keys at D 128, GQA 4; frames at D 80 with a ragged last key tile
    # (150 = 2 × 64 + 22); a one-row step over 1,600 vision keys
    (2, 40, 100, 8, 2, 128, False, 0, 0, 0),
    (2, 150, 150, 4, 4, 80, False, 0, 0, 0),
    (2, 1, 1600, 8, 2, 128, False, 0, 530, 0),
]
#: SSD sweep: (Bt, S, H, P, N, G, chunk, kind); kind "s0x100" scales the
#: initial state by 100 (the bf16 kernel splits it into three bf16 terms),
#: "dt0" sets dt to 0 on rows 10-39 and 130 (steps that neither decay nor add)
SSD_SWEEP = [
    (2, 128, 2, 16, 8, 1, 32, ""), (2, 96, 1, 8, 4, 1, 32, ""),
    (2, 256, 2, 32, 16, 2, 64, ""),
    (1, 77, 4, 16, 16, 2, 32, ""),     # ragged chunk of 13 rows
    (1, 5, 4, 64, 64, 1, 128, ""),     # S < chunk
    (1, 300, 4, 64, 128, 1, 128, ""),  # N = 128: float32 halves its chunk
    # the tensor-core kernel's edges: S < 16; a last chunk of 72 rows (not
    # a multiple of 16); N = 128 at chunk 128; G = 2 with 4 heads; the
    # state at 100x (at N = 128 the float32 reference's own sums come near
    # the bar); steps with dt = 0; N and P that are not multiples of 8
    (2, 9, 4, 64, 64, 1, 128, ""),
    (1, 200, 4, 64, 64, 1, 128, ""),
    (2, 256, 4, 64, 128, 1, 128, ""),
    (2, 160, 4, 64, 64, 2, 128, ""),
    (1, 256, 4, 64, 64, 1, 128, "s0x100"),
    (1, 300, 4, 64, 128, 1, 128, "s0x100"),
    (2, 256, 4, 64, 64, 1, 128, "dt0"),
    (1, 40, 2, 12, 20, 1, 128, ""),
]


def sweep_flash(torch, dev) -> dict:
    """flash_attention_cuda against its plain version on FLASH_SWEEP, in
    float32 and bfloat16; the worst |diff| per dtype."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for i, (b, sq, skv, h, hkv, d, causal, window, qo, ko) in enumerate(
            FLASH_SWEEP):
        rng = np.random.default_rng(5000 + i)
        arrays = [rng.standard_normal(shape).astype(np.float32) for shape in
                  ((b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, d))]
        kw = dict(causal=causal, window=window, q_offset=qo, kv_offset=ko)
        for name in worst:
            q, k, v = (torch.as_tensor(a, device=dev).to(getattr(torch, name))
                       for a in arrays)
            got = flash_attention_cuda(q, k, v, **kw)
            want = ref.flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            tol = ((KERNEL_BF16_TOL,) * 2 if name == "bfloat16"
                   else (KERNEL_ATOL, KERNEL_RTOL))
            worst[name] = max(worst[name], check_close(
                f"flash_attention {name} case {FLASH_SWEEP[i]}", got.float(),
                want.float(), *tol))
    return worst


def ssd_inputs(torch, dev, bt, s, h, p, n, g, dtype, seed, kind=""):
    """x, dt, A, B, C (x, B, C in ``dtype``) and an initial state;
    ``kind`` as in SSD_SWEEP."""
    rng = np.random.default_rng(seed)
    t = lambda a, dt=torch.float32: torch.as_tensor(  # noqa: E731
        a.astype(np.float32), device=dev).to(dt)
    dt = rng.random((bt, s, h)) * 0.1 + 0.01
    if kind == "dt0":
        dt[:, 10:40] = 0.0
        dt[:, 130:131] = 0.0
    return (t(rng.standard_normal((bt, s, h, p)) * 0.5, dtype), t(dt),
            t(-(rng.random(h) * 0.5 + 0.1)),
            t(rng.standard_normal((bt, s, g, n)) * 0.3, dtype),
            t(rng.standard_normal((bt, s, g, n)) * 0.3, dtype),
            t(rng.standard_normal((bt, h, n, p))
              * (100.0 if kind == "s0x100" else 1.0)))


def sweep_ssd(torch, dev) -> dict:
    """ssd_scan_cuda against its plain version on SSD_SWEEP, x / B / C in
    float32 and bfloat16, from a zero and a given state: y and the last
    state (both float32); the worst |diff| per input dtype."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for i, (bt, s, h, p, n, g, chunk, kind) in enumerate(SSD_SWEEP):
        for name in worst:
            x, dt, a, b, c, s0 = ssd_inputs(torch, dev, bt, s, h, p, n, g,
                                            getattr(torch, name), 6000 + i,
                                            kind)
            for init in (None, s0):
                y, last = ssd_scan_cuda(x, dt, a, b, c, chunk=chunk, s0=init)
                y_r, last_r = ref.ssd_scan_ref(x, dt, a, b, c, chunk=chunk,
                                               s0=init)
                torch.cuda.synchronize()
                what = f"ssd_scan {name} case {SSD_SWEEP[i]} s0={init is not None}"
                worst[name] = max(worst[name],
                                  check_close(what + " y", y, y_r,
                                              KERNEL_ATOL, KERNEL_RTOL),
                                  check_close(what + " state", last, last_r,
                                              KERNEL_ATOL, KERNEL_RTOL))
    return worst


def check_ssd_grads(what: str, got, want, tol: float) -> tuple:
    """The backward kernel's gradients against the twin's, each within
    ``tol`` of its largest magnitude (and in the twin's dtype): (max
    |diff| by gradient, the same over its scale)."""
    errs, rels = {}, {}
    for gname, u, v in zip(SSD_GRADS, got, want):
        if (u is None) != (v is None):
            raise AssertionError(f"{what} {gname}: given by one side only")
        if u is None:
            continue
        if u.dtype != v.dtype:
            raise AssertionError(f"{what} {gname}: {u.dtype} != the twin's "
                                 f"{v.dtype}")
        scale = max(float(v.float().abs().max()), 1e-30)
        errs[gname] = check_close(f"{what} {gname}", u.float(), v.float(),
                                  tol * scale, tol)
        rels[gname] = errs[gname] / scale
    return errs, rels


def sweep_ssd_bwd(torch, dev) -> dict:
    """ssd_scan_bwd_cuda against its plain twin on SSD_SWEEP (its ragged
    chunks, S < 64, G = 2, N and P that are not multiples of 8, dt = 0
    inside S across a chunk edge, the state at 100x), x / B / C in
    float32 and bfloat16, from a zero state without a last-state gradient
    and from a given state with one: each gradient within its bar of its
    scale; the worst share of the scale by dtype and sweep kind."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda
    worst = {}
    for i, (bt, s, h, p, n, g, chunk, kind) in enumerate(SSD_SWEEP):
        for name, tol in (("float32", SSD_BWD_F32_TOL),
                          ("bfloat16", SSD_BWD_BF16_TOL)):
            x, dt, a, b, c, s0 = ssd_inputs(torch, dev, bt, s, h, p, n, g,
                                            getattr(torch, name), 8000 + i,
                                            kind)
            rng = np.random.default_rng(8100 + i)
            dy, dl = (torch.as_tensor(rng.standard_normal(shape)
                                      .astype(np.float32), device=dev)
                      for shape in ((bt, s, h, p), (bt, h, n, p)))
            for init, last in ((None, None), (s0, dl)):
                kw = dict(chunk=chunk, s0=init, d_last=last)
                got = ssd_scan_bwd_cuda(x, dt, a, b, c, dy, **kw)
                want = ref.ssd_scan_bwd_ref(x, dt, a, b, c, dy, **kw)
                torch.cuda.synchronize()
                _, rels = check_ssd_grads(
                    f"ssd_scan_bwd {name} case {SSD_SWEEP[i]} "
                    f"s0={init is not None}", got, want, tol)
                key = f"{name} {kind or 'plain'}"
                worst[key] = max(worst.get(key, 0.0), *rels.values())
    return worst


def ptxas_by_kernel(log: str) -> dict:
    """Registers, spills and static shared memory per kernel from a
    ``-Xptxas -v`` build log, keyed by the kernel's demangled name
    (``c++filt`` where it is installed)."""
    facts, order, cur = {}, [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
            order.append(cur)
            facts[cur] = {}
        elif cur and "spill stores" in line:
            nums = re.findall(r"(\d+) bytes (stack frame|spill stores|"
                              r"spill loads)", line)
            facts[cur].update({k.replace(" ", "_"): int(v) for v, k in nums})
        elif cur and "Used" in line and "registers" in line:
            m = re.search(r"Used (\d+) registers", line)
            facts[cur]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            facts[cur]["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    names = dict(zip(order, order))
    filt = shutil.which("c++filt")
    if filt and order:
        out = subprocess.run([filt], input="\n".join(order),
                             capture_output=True, text=True).stdout
        for mangled, plain in zip(order, out.splitlines()):
            names[mangled] = (plain.removeprefix("void ")
                              .replace("(anonymous namespace)::", "")
                              .split("(")[0])
    return {names[k]: v for k, v in facts.items()}


def cuobjdump_path():
    """``cuobjdump`` from PATH, beside ``nvcc``, or Triton's copy; None if
    none is installed."""
    from repro_torch.kernels.build import nvcc_path
    found = shutil.which("cuobjdump")
    if found:
        return found
    candidates = [Path(nvcc_path()).parent / "cuobjdump"]
    try:
        import importlib.util
        spec = importlib.util.find_spec("triton")
        if spec and spec.origin:
            candidates.append(Path(spec.origin).parent / "backends" /
                              "nvidia" / "bin" / "cuobjdump")
    except (ImportError, ValueError):
        pass
    return next((str(c) for c in candidates if c.exists()), None)


def built_sass(source: str) -> tuple:
    """What ptxas reports for each kernel of ``csrc/<source>.cu``, and the
    SASS of its built library; the run fails if there is no ptxas report
    or no ``cuobjdump``."""
    from repro_torch.kernels import build
    facts = {"ptxas": ptxas_by_kernel(build.build_log(source))}
    if not facts["ptxas"]:
        raise AssertionError(f"{source}: the build log holds no ptxas "
                             f"report (-Xptxas -v)")
    tool = cuobjdump_path()
    if tool is None:
        raise AssertionError(f"{source}: no cuobjdump found on PATH, beside "
                             f"nvcc or in Triton's package, so the SASS "
                             f"cannot be read")
    sass = subprocess.run(
        [tool, "-sass", str(build.build_dir() / f"lib{source}.so")],
        check=True, capture_output=True, text=True).stdout
    return facts, sass


def build_facts(source: str, opcodes: tuple) -> dict:
    """What ptxas reports for each kernel of ``csrc/<source>.cu``, and the
    count of each SASS opcode of ``opcodes`` in its built library; the run
    fails if there is no ptxas report, no ``cuobjdump`` or a count of 0
    (flash: ``HGMMA`` and ``UTMALDG``, or its bf16 prefill is not on wgmma
    and TMA, and ``HMMA``, or its bf16 route past D = 128 is not on the
    tensor cores; the SSD scan: ``HMMA``, or its bf16 path is not on the
    tensor cores; fused_mp: ``HGMMA``, or its node phase is not on
    wgmma)."""
    facts, sass = built_sass(source)
    counts = {op: len(re.findall(r"\b" + op + r"\b", sass))
              for op in opcodes}
    if not all(counts.values()):
        raise AssertionError(f"{source}: SASS counts {counts}: its "
                             f"tensor-core path is not on the instructions "
                             f"it was built for")
    facts["sass"] = counts
    return facts


def segment_build_facts(source: str = "segment_aggregate",
                        opcodes: tuple = ()) -> dict:
    """What ptxas reports for the kernels of a library that sums over a
    destination-sorted CSR (``csrc/segment_aggregate.cu``: the segmented
    sums and the CSR build; ``gat_aggregate.cu``; ``edge_softmax.cu``) or
    in a fixed order (``flash_attention_bwd.cu``) and the atomics in its
    SASS; the run fails if any of them adds a float (a ``RED`` or ``ATOM``
    on an F16, F32 or F64): the sums take no float atomic. ``opcodes``:
    SASS opcodes also counted under ``sass``, the run failing at a count
    of 0 (``flash_attention_bwd``: ``HMMA``, or its bf16 route is not on
    the tensor cores)."""
    facts, sass = built_sass(source)
    if opcodes:
        facts["sass"] = {op: len(re.findall(r"\b" + op + r"\b", sass))
                         for op in opcodes}
        if not all(facts["sass"].values()):
            raise AssertionError(f"{source}: SASS counts {facts['sass']}: "
                                 f"its tensor-core path is not on the "
                                 f"instructions it was built for")
    ops = re.findall(r"\b(?:RED|ATOMG|ATOMS|ATOM)\b[\w.]*", sass)
    floats = [op for op in ops if re.search(r"\.(?:BF16|F16|F32|F64)", op)]
    facts["sass_atomics"] = len(ops)
    facts["sass_float_atomics"] = len(floats)
    if floats:
        raise AssertionError(f"{source}: float atomics in the SASS: "
                             f"{sorted(set(floats))}")
    return facts


def ssd_occupancy(torch, dtype, n: int, p: int, chunk: int, s: int) -> dict:
    """The SSD kernel's chunk, its dynamic shared memory a block (from
    ``ssd_plan`` and from the library, which must agree) and the blocks an
    SM holds (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    import ctypes
    from repro_torch.kernels.segment_spmm import _entry
    from repro_torch.kernels.ssd_scan import _DTYPES, ssd_plan
    plan = ssd_plan(n, p, chunk, s, dtype)
    code = _DTYPES[dtype]
    smem = _entry("ssd_scan_smem")(code, n, p, plan.lc)
    if smem != plan.smem_bytes:
        raise AssertionError(f"ssd_scan: ssd_plan says {plan.smem_bytes} "
                             f"bytes of shared memory, the kernel {smem}")
    blocks = ctypes.c_int(0)
    rc = _entry("ssd_scan_occupancy")(code, n, p, plan.lc,
                                      ctypes.addressof(blocks))
    if rc != 0:
        raise AssertionError(f"ssd_scan occupancy: cudaError_t {rc}")
    return {"chunk": plan.lc, "smem_bytes_a_block": smem,
            "blocks_an_sm": blocks.value}


def ssd_record_shapes(torch, dev) -> list:
    """The bf16 scan at two shapes beside lm_path's, for the record (no
    pass mark on time): zamba2 at one sequence (80 blocks, fewer than the
    SMs) and mamba2-370m's N = 128 at lm_path's batch and chunk 128, each
    held to its plain version."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    out = []
    for i, (arch, b) in enumerate((("zamba2-2.7b", 1),
                                   ("mamba2-370m", LM_BATCH))):
        cfg = get_config(arch)
        sm = cfg.ssm
        nh, p, n, g = (sm.n_heads(cfg.d_model), sm.head_dim, sm.d_state,
                       sm.n_groups)
        x, dt, a, bm, cm, _ = ssd_inputs(torch, dev, b, LM_PROMPT, nh, p, n,
                                         g, torch.bfloat16, 7300 + i)
        fn = lambda: ssd_scan_cuda(x, dt, a, bm, cm,  # noqa: E731
                                   chunk=sm.chunk)
        (y, last), (y_r, last_r) = fn(), ref.ssd_scan_ref(
            x, dt, a, bm, cm, chunk=sm.chunk)
        torch.cuda.synchronize()
        err = max(check_close(f"ssd_scan {arch} B={b} y", y, y_r,
                              KERNEL_ATOL, KERNEL_RTOL),
                  check_close(f"ssd_scan {arch} B={b} state", last, last_r,
                              KERNEL_ATOL, KERNEL_RTOL))
        out.append({"shape": f"{arch}, x [{b}, {LM_PROMPT}, {nh}, {p}] bf16, "
                             f"B/C [{b}, {LM_PROMPT}, {g}, {n}], chunk "
                             f"{sm.chunk}",
                    "blocks": b * nh, "max_abs_err": err,
                    "ms": time_graph_ms(torch, fn),
                    **ssd_occupancy(torch, torch.bfloat16, n, p, sm.chunk,
                                    LM_PROMPT)})
    return out


def decode_shapes(cfg) -> list:
    """One-row decode steps the configs serve, (label, B, Skv, H, Hkv, D):
    lm_path's (more CTAs than SMs), lm_parity's batch of zamba2 and
    qwen2.5-3b alone (fewer), at lm_path's max_len and a longer cache."""
    from repro_torch.configs import get_config
    qw = get_config("qwen2.5-3b")
    t_max = LM_PROMPT + LM_NEW
    z = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
    w = (qw.n_heads, qw.n_kv_heads, qw.resolved_head_dim)
    return [(f"{cfg.name}, lm_path's batch", LM_BATCH, t_max, *z),
            (f"{cfg.name}, lm_parity's batch", LM_PARITY_BATCH, t_max, *z),
            (f"{qw.name}, one sequence", 1, t_max, *w),
            (f"{qw.name}, one sequence, 4096 keys", 1, 4096, *w)]


def decode_split_timings(torch, dev, cfg) -> list:
    """flash decode (bf16, the last row of a full cache, causal) at each of
    ``decode_shapes`` under the split plan's wave target, under twice it and
    under one split: each held to the plain version, then its splits and
    time."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = []
    for i, (label, b, skv, h, hkv, d) in enumerate(decode_shapes(cfg)):
        rng = np.random.default_rng(7200 + i)
        q, k, v = (torch.as_tensor(rng.standard_normal(shape).astype(
            np.float32), device=dev).to(torch.bfloat16)
            for shape in ((b, 1, h, d), (b, skv, hkv, d), (b, skv, hkv, d)))
        kw = dict(causal=True, q_offset=skv - 1)
        want = ref.flash_attention_ref(q, k, v, **kw)
        ctas = b * hkv * -(-(h // hkv) // fa._DECODE_ROWS)
        row = {"shape": label, "q": [b, 1, h, d], "kv": [b, skv, hkv, d],
               "ctas_a_split": ctas, "sms": sms}
        for name, w in (("plan", fa._DECODE_WAVES),
                        ("twice_the_waves", 2 * fa._DECODE_WAVES),
                        ("one_split", 0)):
            fn = lambda w=w: fa.flash_attention_cuda(  # noqa: E731
                q, k, v, decode_waves=w, **kw)
            check_close(f"flash decode {label}, {name}", fn().float(),
                        want.float(), KERNEL_BF16_TOL, KERNEL_BF16_TOL)
            row[name] = {"splits": fa.decode_split_plan(
                skv, ctas=ctas, sm_count=sms, tile=fa._DECODE_TILE[q.dtype],
                waves=w, **kw).n_splits, "ms": time_graph_ms(torch, fn)}
        out.append(row)
    return out


def host_us_per_call(torch, fn, calls: int = 200, reps: int = 7) -> float:
    """Host microseconds per ``fn()`` call: ``calls`` calls back to back
    from the host, without waiting for the card in between (the card keeps
    up or queues), the median over ``reps`` runs."""
    for _ in range(10):
        fn()
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append(1e6 * (time.perf_counter() - t) / calls)
    torch.cuda.synchronize()
    return statistics.median(runs)


def lm_kernel_entries(torch, dev) -> tuple:
    """flash_attention and ssd_scan at the shapes of lm_path's full serving
    run (prefill and decode for flash, prefill for the scan), in its
    bfloat16, held against their plain versions and timed beside their
    bound, plain version and library call; the sweeps."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    sweep = {"flash_attention": sweep_flash(torch, dev),
             "ssd_scan": sweep_ssd(torch, dev)}
    cfg = lm_config(param_dtype="bfloat16")
    bf16 = torch.bfloat16
    b, s, t_max = LM_BATCH, LM_PROMPT, LM_PROMPT + LM_NEW
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    rng = np.random.default_rng(7000)
    bt = lambda shape: torch.as_tensor(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32), device=dev).to(bf16)
    q, k, v = bt((b, s, h, hd)), bt((b, t_max, hkv, hd)), bt((b, t_max, hkv,
                                                             hd))
    qd = bt((b, 1, h, hd))
    pre = dict(causal=True)                    # prefill: rows 0..S-1
    dec = dict(causal=True, q_offset=t_max - 1)  # the last decode step
    sm = cfg.ssm
    nh, p, n, g = sm.n_heads(cfg.d_model), sm.head_dim, sm.d_state, sm.n_groups
    x, dt, a, bm, cm, _ = ssd_inputs(torch, dev, b, s, nh, p, n, g, bf16, 7100)

    pairs = {
        "flash_prefill": (lambda: flash_attention_cuda(q, k, v, **pre),
                          lambda: ref.flash_attention_ref(q, k, v, **pre)),
        "flash_decode": (lambda: flash_attention_cuda(qd, k, v, **dec),
                         lambda: ref.flash_attention_ref(qd, k, v, **dec)),
        "ssd_scan": (lambda: ssd_scan_cuda(x, dt, a, bm, cm, chunk=sm.chunk),
                     lambda: ref.ssd_scan_ref(x, dt, a, bm, cm,
                                              chunk=sm.chunk)),
    }
    err, times = {}, {}
    for name, (kern, plain) in pairs.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if name == "ssd_scan":
            err[name] = max(check_close(f"{name} y at full width", got[0],
                                        want[0], KERNEL_ATOL, KERNEL_RTOL),
                            check_close(f"{name} state at full width",
                                        got[1], want[1], KERNEL_ATOL,
                                        KERNEL_RTOL))
        else:
            err[name] = check_close(f"{name} at full width", got.float(),
                                    want.float(), KERNEL_BF16_TOL,
                                    KERNEL_BF16_TOL)
        times[name] = {"ms": time_graph_ms(torch, kern),
                       "plain_ms": time_graph_ms(torch, plain)}
    # the yardstick: one library call on the same inputs, the same mask
    qt, kt, vt, qdt = (z.transpose(1, 2).contiguous() for z in (q, k, v, qd))
    mask_pre = (torch.arange(t_max, device=dev)[None, :]
                <= torch.arange(s, device=dev)[:, None])
    library = {
        "flash_prefill": time_graph_ms(
            torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask_pre)),
        "flash_prefill_causal_512": time_graph_ms(
            torch, lambda: F.scaled_dot_product_attention(
                qt, kt[:, :, :s], vt[:, :, :s], is_causal=True)),
        "flash_decode": time_graph_ms(
            torch, lambda: F.scaled_dot_product_attention(qdt, kt, vt)),
    }
    plans = decode_split_timings(torch, dev, cfg)
    host_us = host_us_per_call(torch, pairs["flash_decode"][0])
    us = device_breakdown_us(torch, {kk: vv[0] for kk, vv in pairs.items()})
    # the scan's float32 kernel (the FMA pipes) on the same values
    x32, b32, c32 = (z.float() for z in (x, bm, cm))
    fma = lambda: ssd_scan_cuda(x32, dt, a, b32, c32,  # noqa: E731
                                chunk=sm.chunk)
    got, want = fma(), ref.ssd_scan_ref(x32, dt, a, b32, c32, chunk=sm.chunk)
    torch.cuda.synchronize()
    fma_err = max(check_close("ssd_scan float32 y at full width", got[0],
                              want[0], KERNEL_ATOL, KERNEL_RTOL),
                  check_close("ssd_scan float32 state at full width", got[1],
                              want[1], KERNEL_ATOL, KERNEL_RTOL))
    fma_entry = {"ms": time_graph_ms(torch, fma), "max_abs_err": fma_err,
                 **ssd_occupancy(torch, torch.float32, n, p, sm.chunk, s)}
    del x32, b32, c32, got, want
    ssd_occ = ssd_occupancy(torch, bf16, n, p, sm.chunk, s)
    if n == p == 64 and ssd_occ["blocks_an_sm"] < 2:
        raise AssertionError(f"ssd_scan: {ssd_occ['blocks_an_sm']} block an "
                             f"SM at N = P = 64; the design holds two")

    # bounds: each input read once, each output written once (2 bytes a
    # bfloat16, 4 a float32); the products this run's mask keeps (the
    # causal pairs; decode: every key), at the bfloat16 tensor-core peak;
    # at prefill only the K/V rows the mask keeps (S of the T_max keys:
    # the keys after the last query row are never read)
    kept_pre = b * h * s * (s + 1) // 2
    kept_dec = b * h * t_max
    lc = min(sm.chunk, s)
    n_chunks = -(-s // lc)
    tri = lc * (lc + 1) // 2
    ssd_flops = 2.0 * b * nh * n_chunks * (tri * n + tri * p + 2 * lc * n * p)
    kv_rows_pre = b * s * hkv * hd     # the keys the causal mask keeps
    bounds = {
        "flash_prefill": bound_ms(4.0 * hd * kept_pre,
                                  2.0 * (2 * q.numel() + 2 * kv_rows_pre),
                                  PEAK_BF16_FLOPS),
        "flash_decode": bound_ms(4.0 * hd * kept_dec,
                                 2.0 * (2 * qd.numel() + k.numel() + v.numel()),
                                 PEAK_BF16_FLOPS),
        "ssd_scan": bound_ms(ssd_flops,
                             2.0 * (x.numel() + bm.numel() + cm.numel())
                             + 4.0 * (dt.numel() + a.numel() + x.numel()
                                      + b * nh * n * p),
                             PEAK_BF16_FLOPS),
    }
    src_root = "src/repro_torch/kernels/csrc/"
    flash_unit = (f"prefill: q [{b}, {s}, {h}, {hd}] over k/v [{b}, {t_max}, "
                  f"{hkv}, {hd}] bf16, causal")
    entries = [
        {"name": "flash_attention", "route": "cuda",
         "source": src_root + "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:93",
         "launches": None,
         "max_abs_err": max(err["flash_prefill"], err["flash_decode"],
                            *sweep["flash_attention"].values()),
         **times["flash_prefill"],
         "bound_ms": bounds["flash_prefill"][0],
         "bound_by": bounds["flash_prefill"][1],
         "library_ms": library["flash_prefill"],
         "unit": flash_unit,
         "library_note": "scaled_dot_product_attention on the same "
                         "inputs ([B, H, S, D] copies) with the causal "
                         "mask as a boolean attn_mask",
         "same_function_ms": library["flash_prefill_causal_512"],
         "same_function_note": f"the same-function yardstick: "
                               f"scaled_dot_product_attention with "
                               f"is_causal over the first {s} keys, which "
                               f"computes the same output (keys {s}.."
                               f"{t_max - 1} lie after every query row)",
         "prefill_at_or_below_library": times["flash_prefill"]["ms"]
         <= library["flash_prefill"],
         # a served batch's prefill calls: one step of lm_launch_rule
         "prefill_launches": lm_launch_rule(cfg, 1)["flash_attention"],
         "decode": {"unit": f"q [{b}, 1, {h}, {hd}] over k/v [{b}, {t_max}, "
                            f"{hkv}, {hd}] bf16",
                    **times["flash_decode"],
                    "bound_ms": bounds["flash_decode"][0],
                    "bound_by": bounds["flash_decode"][1],
                    "library_ms": library["flash_decode"],
                    "ratio_to_library": times["flash_decode"]["ms"]
                    / library["flash_decode"],
                    "host_us_per_call": host_us,
                    "split_plan": plans},
         "build": build_facts("flash_attention",
                              ("HGMMA", "UTMALDG", "HMMA")),
         "max_abs_err_by_dtype": sweep["flash_attention"]},
        {"name": "ssd_scan", "route": "cuda",
         "source": src_root + "ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:81",
         "launches": None,
         "max_abs_err": max(err["ssd_scan"], *sweep["ssd_scan"].values()),
         **times["ssd_scan"],
         "bound_ms": bounds["ssd_scan"][0],
         "bound_by": bounds["ssd_scan"][1],
         "library_ms": None,
         "unit": f"x [{b}, {s}, {nh}, {p}] bf16, dt [{b}, {s}, {nh}] f32, "
                 f"B/C [{b}, {s}, {g}, {n}] bf16, chunk {sm.chunk} → y f32, "
                 f"state [{b}, {nh}, {n}, {p}] f32",
         "library_note": "none: no single call does a chunked SSD scan",
         "chunked_flops": ssd_flops,
         "max_abs_err_by_dtype": sweep["ssd_scan"],
         "occupancy": ssd_occ,
         "device_us_by_kernel": us["ssd_scan"],
         "float32": {"unit": "the same values with x, B, C in float32 (the "
                             "FMA kernel)", **fma_entry},
         "record": ssd_record_shapes(torch, dev),
         "build": build_facts("ssd_scan", ("HMMA",))},
    ]
    info = {"device_us_per_call": us, "sweep_max_abs_err": sweep}
    return entries, info


def lm_parity(torch, dev) -> dict:
    """zamba2 at full width, depth cut, float32: the card against the same
    weights on the CPU, prefill plus greedy decode step by step; every
    step's logits within E2E_ATOL + E2E_RTOL and the same tokens."""
    from repro_torch.models import lm
    cfg = lm_config(n_layers=LM_PARITY_LAYERS, param_dtype="float32")
    t0 = time.perf_counter()
    cpu = lm.init_params(cfg, seed=LM_SEED, device="cpu")
    card = tree_to(cpu, dev)
    rng = np.random.default_rng(LM_SEED + 1)
    prompts = rng.integers(0, cfg.vocab, (LM_PARITY_BATCH, LM_PARITY_PROMPT))
    max_len = LM_PARITY_PROMPT + LM_PARITY_STEPS
    runs = {}
    for where, params in (("card", card), ("cpu", cpu)):
        pd = params["embed"].device
        toks = torch.as_tensor(prompts, dtype=torch.int32, device=pd)
        cache = lm.init_cache(cfg, LM_PARITY_BATCH, max_len, device=pd)
        logits_all = []
        logits, cache = lm.decode_step(params, cfg, cache, {"tokens": toks},
                                       0, logits_mode="last")
        for i in range(LM_PARITY_STEPS):
            logits_all.append(logits[:, -1].cpu())
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            logits, cache = lm.decode_step(params, cfg, cache,
                                           {"tokens": tok[:, None]},
                                           LM_PARITY_PROMPT + i)
        logits_all.append(logits[:, -1].cpu())
        runs[where] = torch.stack(logits_all, 1)
    card_l, cpu_l = runs["card"], runs["cpu"]
    tok_card, tok_cpu = card_l.argmax(-1), cpu_l.argmax(-1)
    if not torch.equal(tok_card, tok_cpu):
        raise AssertionError(f"lm_path parity: greedy tokens differ "
                             f"{tok_card.tolist()} vs {tok_cpu.tolist()}")
    err = check_close("lm_path parity logits", card_l, cpu_l, E2E_ATOL,
                      E2E_RTOL)
    return {"config": {"arch": cfg.name, "n_layers": cfg.n_layers,
                       "d_model": cfg.d_model, "dtype": cfg.param_dtype},
            "prompts": [LM_PARITY_BATCH, LM_PARITY_PROMPT],
            "decode_steps": LM_PARITY_STEPS, "max_abs_err": err,
            "max_abs_logit": float(cpu_l.abs().max()),
            "atol": E2E_ATOL, "rtol": E2E_RTOL,
            "tokens_equal": True, "seconds": time.perf_counter() - t0}


def lm_launch_rule(cfg, new_tokens: int) -> dict:
    """The launches of one served batch: the flash kernel once per
    attention block per step (the prefill and every decode step: every
    layer of an ``attn`` stack, the shared block once a group of a hybrid
    one), the SSD scan once per Mamba2 layer at prefill only (a one-token
    step takes the plain decode update)."""
    if cfg.block == "attn":
        return {"flash_attention": cfg.n_layers * new_tokens, "ssd_scan": 0}
    n_attn = cfg.n_layers // cfg.hybrid_attn_every
    n_mamba = n_attn * cfg.hybrid_attn_every
    return {"flash_attention": n_attn * new_tokens, "ssd_scan": n_mamba}


def lm_serving_batch(torch, dev) -> tuple:
    """lm_path's serving batch: ``lm_config`` in bf16 with random weights
    from ``LM_SEED``, ``LM_BATCH`` × ``LM_PROMPT`` seeded prompt tokens on
    ``dev``, and the prefill and serve steps for ``max_len`` = LM_PROMPT +
    LM_NEW. Returns (cfg, params, prompts, prefill, serve)."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.lm import init_params
    cfg = lm_config(param_dtype="bfloat16")
    params = init_params(cfg, seed=LM_SEED)
    rng = np.random.default_rng(LM_SEED + 2)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (LM_BATCH,
                                                          LM_PROMPT)),
                              dtype=torch.int32, device=dev)
    max_len = LM_PROMPT + LM_NEW
    return (cfg, params, prompts, make_prefill_step(cfg, max_len),
            make_serve_step(cfg))


def phase_lm(torch, dev, name_limit: str) -> dict:
    """Serve zamba2 on the card through the LM stack's serve steps: the
    parity run against the CPU, then the full serving run at full width
    and depth in bfloat16 with its launch counts held to their rule."""
    from repro_torch import nn as tnn
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    t0 = time.perf_counter()
    parity = lm_parity(torch, dev)
    torch.cuda.empty_cache()

    cfg, params, prompts, prefill, serve = lm_serving_batch(torch, dev)
    max_len = LM_PROMPT + LM_NEW
    _, cache = prefill(params, {"tokens": prompts})          # warm up
    serve(params, cache, {"tokens": prompts[:, :1]}, LM_PROMPT)
    del cache
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wrappers = {"flash_attention": flash_attention_cuda,
                "ssd_scan": ssd_scan_cuda}
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": prompts})
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    idx, toks = LM_PROMPT, [tok]
    for _ in range(LM_NEW - 1):
        tok, cache, idx = serve(params, cache, {"tokens": tok[:, None]}, idx)
        toks.append(tok)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = {k: w.launches for k, w in wrappers.items()}
    want = lm_launch_rule(cfg, LM_NEW)
    if launches != want:
        raise AssertionError(f"lm_path: launches {launches} != the rule's "
                             f"{want}")
    peak = torch.cuda.max_memory_allocated()
    gen = torch.stack(toks, 1)
    finite = {"prefill_logits": bool(torch.isfinite(logits).all()),
              **{f"cache_{k}": bool(torch.isfinite(v.float()).all())
                 for k, v in cache.items()}}
    if not all(finite.values()) or logits.shape != (LM_BATCH, 1, cfg.vocab):
        raise AssertionError(f"lm_path: logits {tuple(logits.shape)}, "
                             f"finite {finite}")
    if not bool(((gen >= 0) & (gen < cfg.vocab)).all()):
        raise AssertionError("lm_path: a token outside the vocabulary")
    # where the time goes: one prefill and one decode step under the profiler
    pre_busy, pre_top = device_busy_ms(torch, lambda: prefill(
        params, {"tokens": prompts}))
    dec_busy, dec_top = device_busy_ms(torch, lambda: serve(
        params, cache, {"tokens": tok[:, None]}, LM_PROMPT + LM_NEW - 1))
    prefill_ms = 1e3 * (t2 - t1)
    decode_ms = 1e3 * (t3 - t2) / (LM_NEW - 1)
    out = {"phase": "lm_path", "card": name_limit, "parity": parity,
           "serve": {
               "config": {"arch": cfg.name, "n_layers": cfg.n_layers,
                          "d_model": cfg.d_model, "dtype": cfg.param_dtype},
               "prompts": [LM_BATCH, LM_PROMPT], "new_tokens": LM_NEW,
               "max_len": max_len, "launches": launches,
               "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
               "decode_tokens_per_s": LM_BATCH / (decode_ms / 1e3),
               "tokens_per_s": LM_BATCH * LM_NEW / (t3 - t1),
               "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / (t2 - t1),
               "max_memory_allocated": peak,
               "param_bytes": tnn.tree_bytes(params),
               "param_count": tnn.tree_size(params),
               "cache_bytes": tnn.tree_bytes(cache),
               "finite": finite,
               "first_tokens": gen[:2, :8].tolist(),
               "prefill_device_busy_ms": pre_busy,
               "prefill_device_ms_by_kernel": pre_top,
               "decode_step_device_busy_ms": dec_busy,
               "decode_step_device_ms_by_kernel": dec_top},
           "seconds": time.perf_counter() - t0}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# lm_moe_path: mixture-of-experts and MLA (deepseek-v2, grok-1)
# ---------------------------------------------------------------------------

def sweep_mla_flash(torch, dev) -> dict:
    """flash_attention_cuda against its plain version on MLA_FLASH_SWEEP
    (MLA's value head dims below the query's, grok-1's GQA calls), in
    float32 and bfloat16; the worst |diff| per dtype."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for i, case in enumerate(MLA_FLASH_SWEEP):
        b, sq, skv, h, hkv, d, dv, causal, qo, *scale = case
        rng = np.random.default_rng(8000 + i)
        arrays = [rng.standard_normal(shape).astype(np.float32) for shape in
                  ((b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, dv))]
        kw = dict(causal=causal, q_offset=qo,
                  scale=scale[0] if scale else 1 / np.sqrt(0.75 * d))
        for name in worst:
            q, k, v = (torch.as_tensor(a, device=dev).to(getattr(torch, name))
                       for a in arrays)
            got = flash_attention_cuda(q, k, v, **kw)
            want = ref.flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            tol = ((KERNEL_BF16_TOL,) * 2 if name == "bfloat16"
                   else (KERNEL_ATOL, KERNEL_RTOL))
            worst[name] = max(worst[name], check_close(
                f"flash_attention at MLA's dims, {name}, case {case}",
                got.float(), want.float(), *tol))
    return worst


def moe_route_recorder():
    """Wrap ``layers.moe_apply_local`` so that each call also records its
    route on the CPU: (expert ids, keep mask), as the block computes them
    (``_route``, ``moe_slots``). Returns (the records, a restore call)."""
    import torch
    from repro_torch.models import layers as L
    real = L.moe_apply_local
    seen = []

    def recording(p, cfg, x_flat):
        with torch.no_grad():   # the record takes no part in a gradient
            _, ids, _ = L._route(p["router"], x_flat, cfg.moe)
            keep, _, _ = L.moe_slots(ids, cfg.moe, x_flat.shape[0])
        seen.append((ids.cpu(), keep.cpu()))
        return real(p, cfg, x_flat)

    L.moe_apply_local = recording
    return seen, lambda: setattr(L, "moe_apply_local", real)


def moe_parity(torch, dev, arch: str) -> dict:
    """An MoE arch's smoke config in float32 on the card against the same
    weights on the CPU: ``forward`` logits and aux loss, the prefill and
    MOE_PARITY_STEPS greedy decode steps (every step's logits, the same
    tokens), and every MoE layer's expert ids and keep mask (the same)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    cfg = get_smoke_config(arch)
    cpu = lm.init_params(cfg, seed=LM_SEED, device="cpu")
    card = tree_to(cpu, dev)
    rng = np.random.default_rng(LM_SEED + 3)
    prompts = rng.integers(0, cfg.vocab, (MOE_PARITY_BATCH,
                                          MOE_PARITY_PROMPT))
    max_len = MOE_PARITY_PROMPT + MOE_PARITY_STEPS
    runs = {}
    for where, params in (("card", card), ("cpu", cpu)):
        pd = params["embed"].device
        toks = torch.as_tensor(prompts, dtype=torch.int32, device=pd)
        seen, restore = moe_route_recorder()
        try:
            fwd, aux = lm.forward(params, cfg, {"tokens": toks})
            logits, cache = lm.prefill(params, cfg, {"tokens": toks}, max_len)
            steps_l = [logits[:, -1].cpu()]
            for i in range(MOE_PARITY_STEPS):
                tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
                logits, cache = lm.decode_step(params, cfg, cache,
                                               {"tokens": tok[:, None]},
                                               MOE_PARITY_PROMPT + i)
                steps_l.append(logits[:, -1].cpu())
        finally:
            restore()
        runs[where] = dict(fwd=fwd.cpu(), aux=aux.cpu(),
                           steps=torch.stack(steps_l, 1), routes=seen)
    card_r, cpu_r = runs["card"], runs["cpu"]
    tok_card, tok_cpu = (r["steps"].argmax(-1) for r in (card_r, cpu_r))
    if not torch.equal(tok_card, tok_cpu):
        raise AssertionError(f"lm_moe_path parity {arch}: greedy tokens "
                             f"differ {tok_card.tolist()} vs "
                             f"{tok_cpu.tolist()}")
    routes_equal = len(card_r["routes"]) == len(cpu_r["routes"]) and all(
        torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        for a, b in zip(card_r["routes"], cpu_r["routes"]))
    if not routes_equal:
        raise AssertionError(f"lm_moe_path parity {arch}: the MoE expert "
                             f"ids or keep masks differ between the card "
                             f"and the CPU")
    tol = (MOE_PARITY_TOL, MOE_PARITY_TOL)
    errs = {
        "forward_logits": check_close(f"lm_moe_path {arch} forward logits",
                                      card_r["fwd"], cpu_r["fwd"], *tol),
        "aux_loss": check_close(f"lm_moe_path {arch} aux loss",
                                card_r["aux"], cpu_r["aux"], *tol),
        "step_logits": check_close(f"lm_moe_path {arch} decode logits",
                                   card_r["steps"], cpu_r["steps"], *tol)}
    dropped = sum(int((~k).sum()) for _, k in cpu_r["routes"])
    return {"arch": cfg.name, "n_layers": cfg.n_layers,
            "dtype": cfg.param_dtype,
            "prompts": [MOE_PARITY_BATCH, MOE_PARITY_PROMPT],
            "decode_steps": MOE_PARITY_STEPS, "max_abs_err": errs,
            "atol": MOE_PARITY_TOL, "rtol": MOE_PARITY_TOL,
            "tokens_equal": True, "routes_equal": True,
            "moe_calls": len(cpu_r["routes"]),
            "replicas_dropped": dropped}


def moe_full_run(torch, dev, arch: str, n_layers: int) -> dict:
    """One MoE arch at full width in bfloat16, its depth cut to
    ``n_layers``, weights drawn on the card: MOE_BATCH × MOE_PROMPT seeded
    prompt tokens through ``make_prefill_step`` and MOE_NEW - 1
    ``make_serve_step`` calls, the launch counts zeroed before and held
    to ``lm_launch_rule`` after (and read after the prefill, which takes
    the prefill's attention shape); finite logits and caches, tokens in
    the vocabulary; prefill ms, decode ms a step, peak memory and the
    device time of one prefill and one decode step by kernel."""
    import dataclasses
    from repro_torch import nn as tnn
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.lm import init_params
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers,
                              param_dtype="bfloat16")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=LM_SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(LM_SEED + 4)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (MOE_BATCH,
                                                          MOE_PROMPT)),
                              dtype=torch.int32, device=dev)
    max_len = MOE_PROMPT + MOE_NEW
    prefill, serve = make_prefill_step(cfg, max_len), make_serve_step(cfg)
    _, cache = prefill(params, {"tokens": prompts})           # warm up
    serve(params, cache, {"tokens": prompts[:, :1]}, MOE_PROMPT)
    del cache
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wrappers = {"flash_attention": flash_attention_cuda,
                "ssd_scan": ssd_scan_cuda}
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": prompts})
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    prefill_launches = flash_attention_cuda.launches
    idx, toks = MOE_PROMPT, [tok]
    for _ in range(MOE_NEW - 1):
        tok, cache, idx = serve(params, cache, {"tokens": tok[:, None]}, idx)
        toks.append(tok)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = {k: w.launches for k, w in wrappers.items()}
    want = lm_launch_rule(cfg, MOE_NEW)
    if launches != want or prefill_launches != cfg.n_layers:
        raise AssertionError(f"lm_moe_path {arch}: launches {launches} "
                             f"({prefill_launches} at prefill) != the "
                             f"rule's {want} ({cfg.n_layers})")
    peak = torch.cuda.max_memory_allocated()
    gen = torch.stack(toks, 1)
    finite = {"prefill_logits": bool(torch.isfinite(logits).all()),
              **{f"cache_{k}": bool(torch.isfinite(v.float()).all())
                 for k, v in cache.items()}}
    if not all(finite.values()) or logits.shape != (MOE_BATCH, 1,
                                                    cfg.vocab):
        raise AssertionError(f"lm_moe_path {arch}: logits "
                             f"{tuple(logits.shape)}, finite {finite}")
    if not bool(((gen >= 0) & (gen < cfg.vocab)).all()):
        raise AssertionError(f"lm_moe_path {arch}: a token outside the "
                             f"vocabulary")
    pre_busy, pre_top = device_busy_ms(torch, lambda: prefill(
        params, {"tokens": prompts}))
    dec_busy, dec_top = device_busy_ms(torch, lambda: serve(
        params, cache, {"tokens": tok[:, None]}, max_len - 1))
    prefill_ms = 1e3 * (t2 - t1)
    decode_ms = 1e3 * (t3 - t2) / (MOE_NEW - 1)
    out = {"config": {"arch": cfg.name, "n_layers": cfg.n_layers,
                      "d_model": cfg.d_model, "dtype": cfg.param_dtype,
                      "experts": [cfg.moe.n_experts, cfg.moe.top_k,
                                  cfg.moe.n_shared],
                      "mla": cfg.mla is not None},
           "prompts": [MOE_BATCH, MOE_PROMPT], "new_tokens": MOE_NEW,
           "max_len": max_len, "launches": launches,
           "prefill_launches": prefill_launches,
           "decode_launches": launches["flash_attention"] - prefill_launches,
           "init_s": init_s,
           "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
           "decode_tokens_per_s": MOE_BATCH / (decode_ms / 1e3),
           "prefill_tokens_per_s": MOE_BATCH * MOE_PROMPT / (t2 - t1),
           "max_memory_allocated": peak,
           "param_bytes": tnn.tree_bytes(params),
           "param_count": tnn.tree_size(params),
           "cache_bytes": tnn.tree_bytes(cache),
           "finite": finite, "first_tokens": gen[:2, :8].tolist(),
           "prefill_device_busy_ms": pre_busy,
           "prefill_device_ms_by_kernel": pre_top,
           "decode_step_device_busy_ms": dec_busy,
           "decode_step_device_ms_by_kernel": dec_top}
    del params, cache, logits
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def mla_kernel_entries(torch, dev, sweep: dict, launches: dict) -> list:
    """B8 at deepseek-v2's weight-absorbed shapes in lm_moe_path's full
    run (bf16, D 576 = rank 512 + rope 64 over Dv 512, one latent kv head
    under 128 query heads, MOE_PROMPT + MOE_NEW cached positions, scale
    1 / sqrt(192)): the prefill (causal from position 0, the mma.sync
    route) and the last decode step, each held to its plain version and
    timed beside its bound, the plain version and SDPA (``enable_gqa``)
    where SDPA takes the shape. ``launches``: the full run's, by entry."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    cfg = get_config("deepseek-v2-236b")
    m = cfg.mla
    b, s, t_max, h = MOE_BATCH, MOE_PROMPT, MOE_PROMPT + MOE_NEW, cfg.n_heads
    d, dv = m.kv_lora_rank + m.qk_rope_dim, m.kv_lora_rank
    scale = 1 / np.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    rng = np.random.default_rng(8100)
    bt = lambda shape: torch.as_tensor(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32),
        device=dev).to(torch.bfloat16)
    latent = bt((b, t_max, 1, d))            # the cache's [c ‖ r]
    k, v = latent, latent[..., :dv].contiguous()
    shapes = {"flash_attention_mla_prefill": (bt((b, s, h, d)), 0),
              "flash_attention_mla_decode": (bt((b, 1, h, d)), t_max - 1)}
    src = "src/repro_torch/kernels/csrc/flash_attention.cu"
    entries, kerns = [], {}
    for name, (q, qo) in shapes.items():
        kw = dict(causal=True, q_offset=qo, scale=scale)
        kern = kerns[name] = lambda q=q, kw=kw: flash_attention_cuda(  # noqa: E731,E501
            q, k, v, **kw)
        plain = lambda q=q, kw=kw: ref.flash_attention_ref(  # noqa: E731
            q, k, v, **kw)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = check_close(f"{name} at full width", got.float(), want.float(),
                          KERNEL_BF16_TOL, KERNEL_BF16_TOL)
        del got, want
        sq = q.shape[1]
        reps = dict(replays=5, calls=3) if sq > 1 else {}
        # the same function in one library call: the keys after the last
        # query row are never kept, so the prefill is is_causal over S
        qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
        if sq > 1:
            kt, vt = kt[:, :, :s], vt[:, :, :s]
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=sq > 1, scale=scale, enable_gqa=True)
        try:
            library, library_note = time_graph_ms(torch, sdpa, **reps), (
                "scaled_dot_product_attention, enable_gqa, on [B, H, S, D] "
                "views of the same inputs" + (", is_causal over the first "
                                              f"{s} keys" if sq > 1 else ""))
        except Exception as e:                  # noqa: BLE001
            library, library_note = None, f"none: SDPA refused ({e!r:.200})"
        # bounds: q read once, the latent cache once (v is its first Dv
        # columns), out written once; the kept pairs' products at the bf16
        # peak (the prefill's route runs on the tensor cores, the decode's
        # inputs are bf16)
        kept = b * h * (sum(min(t_max, qo + i + 1) for i in range(sq)))
        rows = min(t_max, qo + sq)               # cache rows the mask keeps
        flops = 2.0 * kept * (d + dv)
        nbytes = 2.0 * (q.numel() + b * rows * d + b * sq * h * dv)
        bound, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": "src/repro/kernels/flash_attention.py:93",
                 "launches": launches[name], "max_abs_err": max(
                     err, *sweep.values()),
                 "ms": time_graph_ms(torch, kern, **reps),
                 "plain_ms": time_graph_ms(torch, plain, **reps),
                 "bound_ms": bound, "bound_by": by, "library_ms": library,
                 "unit": f"q [{b}, {sq}, {h}, {d}] over k [{b}, {t_max}, 1, "
                         f"{d}], v [{b}, {t_max}, 1, {dv}] bf16, causal, "
                         f"q_offset {qo}",
                 "route_taken": "mma.sync (bf16, D > 128), 2 column "
                                "blocks of 256" if sq > 1
                 else "split-KV decode + merge",
                 "library_note": library_note, "kept_pairs": kept,
                 "flops": flops, "bytes": nbytes,
                 "max_abs_err_by_dtype": sweep}
        entries.append(entry)
    us = device_breakdown_us(torch, kerns, reps=3)
    for e in entries:
        e["device_us_by_kernel"] = us[e["name"]]
    return entries


def phase_lm_moe(torch, dev, name_limit: str) -> dict:
    """Serve the MoE and MLA archs on the card: the parity runs of both
    smoke configs against the CPU, B8 at MLA's head dims against its twin,
    then deepseek-v2 and grok-1 at full width in bfloat16, one after the
    other, with their launches held to ``lm_launch_rule``; B8's entries at
    deepseek-v2's MLA prefill and decode shapes."""
    t0 = time.perf_counter()
    parity = {arch: moe_parity(torch, dev, arch) for arch, _ in MOE_ARCHS}
    sweep = sweep_mla_flash(torch, dev)
    torch.cuda.empty_cache()
    serve = {arch: moe_full_run(torch, dev, arch, n)
             for arch, n in MOE_ARCHS}
    ds = serve["deepseek-v2-236b"]
    launches = {"flash_attention_mla_prefill": ds["prefill_launches"],
                "flash_attention_mla_decode": ds["decode_launches"]}
    entries = mla_kernel_entries(torch, dev, sweep, launches)
    torch.cuda.empty_cache()
    out = {"phase": "lm_moe_path", "card": name_limit, "parity": parity,
           "mla_flash_sweep_max_abs_err": sweep, "serve": serve,
           "mla_kernels": {e["name"]: {k: e[k] for k in (
               "launches", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")} for e in entries},
           "seconds": time.perf_counter() - t0}
    emit(out)
    out["entries"] = entries
    return out


# ---------------------------------------------------------------------------
# lm_vision_audio_path: cross-attention and the audio frontend
# ---------------------------------------------------------------------------

def vision_audio_inputs(torch, cfg, b: int, s: int, dev, seed: int) -> dict:
    """Seeded model inputs on ``dev``: int32 tokens and a float32 vision
    memory [b, vision_tokens, vision_dim], or float32 frames [b, s, d]."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if cfg.frontend == "audio_frames":
        return {"features": torch.randn((b, s, cfg.d_model), generator=gen,
                                        device=dev)}
    return {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                    device=dev, dtype=torch.int32),
            "vision_embeds": torch.randn(
                (b, cfg.vision_tokens, cfg.vision_dim), generator=gen,
                device=dev)}


def vision_audio_parity(torch, dev, arch: str) -> dict:
    """A smoke config in float32 on the card against the same weights and
    inputs on the CPU: llama-3.2-vision's ``forward``, prefill and
    MOE_PARITY_STEPS greedy decode steps (every step's logits, the same
    tokens); hubert's ``make_encode_step``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import make_encode_step
    from repro_torch.models import lm
    cfg = get_smoke_config(arch)
    cpu = lm.init_params(cfg, seed=LM_SEED, device="cpu")
    card = tree_to(cpu, dev)
    inputs = vision_audio_inputs(torch, cfg, MOE_PARITY_BATCH,
                                 MOE_PARITY_PROMPT, "cpu", LM_SEED + 5)
    max_len = MOE_PARITY_PROMPT + MOE_PARITY_STEPS
    runs = {}
    for where, params in (("card", card), ("cpu", cpu)):
        x = tree_to(inputs, dev if where == "card" else "cpu")
        if cfg.is_encoder_only:
            runs[where] = {"encode": make_encode_step(cfg)(params, x).cpu()}
            continue
        fwd, _ = lm.forward(params, cfg, x)
        logits, cache = lm.prefill(params, cfg, x, max_len)
        steps_l = [logits[:, -1].cpu()]
        for i in range(MOE_PARITY_STEPS):
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            logits, cache = lm.decode_step(params, cfg, cache,
                                           {"tokens": tok[:, None]},
                                           MOE_PARITY_PROMPT + i)
            steps_l.append(logits[:, -1].cpu())
        runs[where] = {"forward": fwd.cpu(), "steps": torch.stack(steps_l, 1)}
    tol = (MOE_PARITY_TOL, MOE_PARITY_TOL)
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "dtype": cfg.param_dtype, "atol": MOE_PARITY_TOL,
           "rtol": MOE_PARITY_TOL}
    if cfg.is_encoder_only:
        out.update(frames=[MOE_PARITY_BATCH, MOE_PARITY_PROMPT],
                   max_abs_err={"encode_logits": check_close(
                       f"lm_vision_audio_path {arch} encode logits",
                       runs["card"]["encode"], runs["cpu"]["encode"], *tol)})
        return out
    tok_card, tok_cpu = (r["steps"].argmax(-1) for r in runs.values())
    if not torch.equal(tok_card, tok_cpu):
        raise AssertionError(f"lm_vision_audio_path parity {arch}: greedy "
                             f"tokens differ {tok_card.tolist()} vs "
                             f"{tok_cpu.tolist()}")
    out.update(prompts=[MOE_PARITY_BATCH, MOE_PARITY_PROMPT],
               decode_steps=MOE_PARITY_STEPS, tokens_equal=True,
               max_abs_err={k: check_close(
                   f"lm_vision_audio_path {arch} {k} logits",
                   runs["card"][k], runs["cpu"][k], *tol)
                   for k in ("forward", "steps")})
    return out


def flash_shape_recorder():
    """Wrap ``ops.flash_attention`` so that each call also records its
    (Sq, Skv, causal); the wrapper's launch counts are untouched. Returns
    (the records, a restore call)."""
    from repro_torch.kernels import ops
    real = ops.flash_attention
    seen = []

    def recording(q, k, v, *, causal, **kw):
        seen.append((q.shape[1], k.shape[1], bool(causal)))
        return real(q, k, v, causal=causal, **kw)

    ops.flash_attention = recording
    return seen, lambda: setattr(ops, "flash_attention", real)


def vision_serve_run(torch, dev) -> dict:
    """llama-3.2-vision-11b at full width, VISION_LAYERS deep, bfloat16,
    weights drawn on the card: VISION_BATCH × VISION_PROMPT seeded tokens
    and their vision memory through ``make_prefill_step`` (which seeds the
    cross K / V) and VISION_NEW - 1 ``make_serve_step`` calls; launches
    zeroed before and held to ``lm_launch_rule`` after (every layer once a
    step, the cross layers among them), and counted by shape; finite
    logits and caches, tokens in the vocabulary; prefill ms, decode ms a
    step, peak memory and one prefill's and one step's device ms by
    kernel."""
    import dataclasses
    from repro_torch import nn as tnn
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.lm import init_params
    cfg = dataclasses.replace(get_config(VISION_ARCH), n_layers=VISION_LAYERS,
                              param_dtype="bfloat16")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=LM_SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    inputs = vision_audio_inputs(torch, cfg, VISION_BATCH, VISION_PROMPT, dev,
                                 LM_SEED + 6)
    max_len = VISION_PROMPT + VISION_NEW
    prefill, serve = make_prefill_step(cfg, max_len), make_serve_step(cfg)
    _, cache = prefill(params, inputs)                        # warm up
    serve(params, cache, {"tokens": inputs["tokens"][:, :1]}, VISION_PROMPT)
    del cache
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    flash_attention_cuda.launches = 0
    seen, restore = flash_shape_recorder()
    try:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits, cache = prefill(params, inputs)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        prefill_calls = list(seen)
        idx, toks = VISION_PROMPT, [tok]
        for _ in range(VISION_NEW - 1):
            tok, cache, idx = serve(params, cache, {"tokens": tok[:, None]},
                                    idx)
            toks.append(tok)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    finally:
        restore()
    launches = {"flash_attention": flash_attention_cuda.launches,
                "ssd_scan": 0}
    want = lm_launch_rule(cfg, VISION_NEW)
    if launches != want or len(seen) != launches["flash_attention"]:
        raise AssertionError(f"lm_vision_audio_path: launches {launches} "
                             f"({len(seen)} calls seen) != the rule's {want}")
    vt = cfg.vision_tokens
    by_shape = {
        "flash_attention_cross_prefill": sum(
            c == (VISION_PROMPT, vt, False) for c in prefill_calls),
        "flash_attention_cross_decode": sum(
            c == (1, vt, False) for c in seen[len(prefill_calls):]),
        "self": sum(c[2] for c in seen)}
    n_cross = cfg.n_layers // cfg.cross_attn_every
    if by_shape != {"flash_attention_cross_prefill": n_cross,
                    "flash_attention_cross_decode": n_cross * (VISION_NEW - 1),
                    "self": (cfg.n_layers - n_cross) * VISION_NEW}:
        raise AssertionError(f"lm_vision_audio_path: launches by shape "
                             f"{by_shape}")
    peak = torch.cuda.max_memory_allocated()
    gen = torch.stack(toks, 1)
    finite = {"prefill_logits": bool(torch.isfinite(logits).all()),
              **{f"cache_{k}": bool(torch.isfinite(v.float()).all())
                 for k, v in cache.items()}}
    if not all(finite.values()) or logits.shape != (VISION_BATCH, 1,
                                                    cfg.vocab):
        raise AssertionError(f"lm_vision_audio_path: logits "
                             f"{tuple(logits.shape)}, finite {finite}")
    if not bool(((gen >= 0) & (gen < cfg.vocab)).all()):
        raise AssertionError("lm_vision_audio_path: a token outside the "
                             "vocabulary")
    pre_busy, pre_top = device_busy_ms(torch, lambda: prefill(params, inputs))
    dec_busy, dec_top = device_busy_ms(torch, lambda: serve(
        params, cache, {"tokens": tok[:, None]}, max_len - 1))
    prefill_ms = 1e3 * (t2 - t1)
    decode_ms = 1e3 * (t3 - t2) / (VISION_NEW - 1)
    out = {"config": {"arch": cfg.name, "n_layers": cfg.n_layers,
                      "cross_layers": n_cross, "d_model": cfg.d_model,
                      "vision": [cfg.vision_tokens, cfg.vision_dim],
                      "dtype": cfg.param_dtype},
           "prompts": [VISION_BATCH, VISION_PROMPT], "new_tokens": VISION_NEW,
           "max_len": max_len, "launches": launches,
           "launches_by_shape": by_shape, "init_s": init_s,
           "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
           "decode_tokens_per_s": VISION_BATCH / (decode_ms / 1e3),
           "prefill_tokens_per_s": VISION_BATCH * VISION_PROMPT / (t2 - t1),
           "max_memory_allocated": peak,
           "param_bytes": tnn.tree_bytes(params),
           "param_count": tnn.tree_size(params),
           "cache_bytes": tnn.tree_bytes(cache),
           "finite": finite, "first_tokens": gen[:2, :8].tolist(),
           "prefill_device_busy_ms": pre_busy,
           "prefill_device_ms_by_kernel": pre_top,
           "decode_step_device_busy_ms": dec_busy,
           "decode_step_device_ms_by_kernel": dec_top}
    del params, cache, logits
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def audio_encode_run(torch, dev) -> dict:
    """hubert-xlarge at full width and depth, bfloat16, weights drawn on
    the card: ``make_encode_step`` over AUDIO_BATCH × AUDIO_FRAMES seeded
    frames, one launch a layer; finite logits [B, frames, vocab]; encode
    ms, peak memory, device busy ms and ms by kernel."""
    import dataclasses
    from repro_torch import nn as tnn
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.launch.steps import make_encode_step
    from repro_torch.models.lm import init_params
    cfg = dataclasses.replace(get_config(AUDIO_ARCH), param_dtype="bfloat16")
    params = init_params(cfg, seed=LM_SEED)
    inputs = vision_audio_inputs(torch, cfg, AUDIO_BATCH, AUDIO_FRAMES, dev,
                                 LM_SEED + 7)
    encode = make_encode_step(cfg)
    encode(params, inputs)                                    # warm up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    flash_attention_cuda.launches = 0
    t1 = time.perf_counter()
    logits = encode(params, inputs)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = flash_attention_cuda.launches
    if launches != cfg.n_layers:
        raise AssertionError(f"lm_vision_audio_path: hubert launched flash "
                             f"{launches} times for {cfg.n_layers} layers")
    if logits.shape != (AUDIO_BATCH, AUDIO_FRAMES, cfg.vocab) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"lm_vision_audio_path: hubert logits "
                             f"{tuple(logits.shape)} not finite")
    peak = torch.cuda.max_memory_allocated()
    busy, top = device_busy_ms(torch, lambda: encode(params, inputs))
    out = {"config": {"arch": cfg.name, "n_layers": cfg.n_layers,
                      "d_model": cfg.d_model, "heads": cfg.n_heads,
                      "head_dim": cfg.resolved_head_dim,
                      "dtype": cfg.param_dtype},
           "frames": [AUDIO_BATCH, AUDIO_FRAMES],
           "launches": {"flash_attention": launches, "ssd_scan": 0},
           "encode_ms": 1e3 * (t2 - t1),
           "frames_per_s": AUDIO_BATCH * AUDIO_FRAMES / (t2 - t1),
           "max_memory_allocated": peak,
           "param_bytes": tnn.tree_bytes(params),
           "param_count": tnn.tree_size(params),
           "logits": list(logits.shape), "finite": True,
           "device_busy_ms": busy, "device_ms_by_kernel": top}
    del params, logits
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def vision_audio_kernel_entries(torch, dev, launches: dict) -> tuple:
    """B8 at VISION_AUDIO_FLASH's shapes, none causal: each held to its
    plain version in bfloat16 at full size and in float32 at batch 1,
    and the bfloat16 call timed beside its bound (every pair kept: the
    products at the bf16 peak, or q, k, v and out once at the memory
    rate), the plain version and SDPA (``enable_gqa``) on the same
    inputs. ``launches``: the full runs', by entry. Returns (entries,
    the worst |diff| per dtype)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    src = "src/repro_torch/kernels/csrc/flash_attention.cu"
    entries, kerns = [], {}
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for i, (name, (b, sq, skv, h, hkv, d, qo)) in enumerate(
            VISION_AUDIO_FLASH.items()):
        gen = torch.Generator(device=dev)
        gen.manual_seed(8200 + i)
        qkv = [torch.randn(shape, generator=gen, device=dev) for shape in
               ((b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, d))]
        kw = dict(causal=False, q_offset=qo)
        err = {}
        for dname, cut in (("bfloat16", b), ("float32", 1)):
            q, k, v = (t[:cut].to(getattr(torch, dname)) for t in qkv)
            got = flash_attention_cuda(q, k, v, **kw)
            want = ref.flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            tol = ((KERNEL_BF16_TOL,) * 2 if dname == "bfloat16"
                   else (KERNEL_ATOL, KERNEL_RTOL))
            err[dname] = check_close(f"{name} {dname} at batch {cut}",
                                     got.float(), want.float(), *tol)
            worst[dname] = max(worst[dname], err[dname])
            del got, want
        q, k, v = (t.to(torch.bfloat16) for t in qkv)
        kern = kerns[name] = lambda q=q, k=k, v=v: flash_attention_cuda(  # noqa: E731,E501
            q, k, v, **kw)
        plain = lambda q=q, k=k, v=v: ref.flash_attention_ref(  # noqa: E731
            q, k, v, **kw)
        reps = dict(replays=5, calls=3) if sq > 1 else {}
        qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
        sdpa = lambda qt=qt, kt=kt, vt=vt: F.scaled_dot_product_attention(  # noqa: E731,E501
            qt, kt, vt, enable_gqa=True)
        try:
            library, library_note = time_graph_ms(torch, sdpa, **reps), (
                "scaled_dot_product_attention, enable_gqa, on [B, H, S, D] "
                "views of the same inputs")
        except Exception as e:                  # noqa: BLE001
            library, library_note = None, f"none: SDPA refused ({e!r:.200})"
        flops = 2.0 * b * h * sq * skv * (d + d)
        nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel())
        bound, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
        entries.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": "src/repro/kernels/flash_attention.py:93",
            "launches": launches[name], "max_abs_err": max(err.values()),
            "ms": time_graph_ms(torch, kern, **reps),
            "plain_ms": time_graph_ms(torch, plain, **reps),
            "bound_ms": bound, "bound_by": by,
            "library_ms": library,
            "unit": f"q [{b}, {sq}, {h}, {d}] over k / v [{b}, {skv}, "
                    f"{hkv}, {d}] bf16, not causal, q_offset {qo}",
            "route_taken": "TMA + wgmma (bf16, Sq > 1)" if sq > 1
            else "split-KV decode + merge",
            "library_note": library_note, "float32_batch": 1,
            "max_abs_err_by_dtype": err,
            "flops": flops, "bytes": nbytes})
    us = device_breakdown_us(torch, kerns, reps=3)
    for e in entries:
        e["device_us_by_kernel"] = us[e["name"]]
    return entries, worst


def phase_lm_vision_audio(torch, dev, name_limit: str) -> dict:
    """Serve llama-3.2-vision and encode with hubert on the card: the
    parity runs of both smoke configs against the CPU, then each arch at
    full width and depth in bfloat16 with its launches held to its rule,
    then B8's entries at their three new shapes (a cross prefill, its
    one-row decode, the encoder's self-attention) against the twin."""
    t0 = time.perf_counter()
    parity = {arch: vision_audio_parity(torch, dev, arch)
              for arch in (VISION_ARCH, AUDIO_ARCH)}
    serve = vision_serve_run(torch, dev)
    encode = audio_encode_run(torch, dev)
    launches = {**{k: serve["launches_by_shape"][k] for k in (
        "flash_attention_cross_prefill", "flash_attention_cross_decode")},
        "flash_attention_encoder": encode["launches"]["flash_attention"]}
    entries, worst = vision_audio_kernel_entries(torch, dev, launches)
    torch.cuda.empty_cache()
    out = {"phase": "lm_vision_audio_path", "card": name_limit,
           "parity": parity, "serve": serve, "encode": encode,
           "flash_max_abs_err": worst,
           "flash_kernels": {e["name"]: {k: e[k] for k in (
               "launches", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms", "max_abs_err_by_dtype")} for e in entries},
           "seconds": time.perf_counter() - t0}
    emit(out)
    out["entries"] = entries
    return out


# ---------------------------------------------------------------------------
# accuracy: the paper's protocol, gated on the JAX package's baseline
# ---------------------------------------------------------------------------

def accuracy_config(factory):
    """The accuracy gate's plan config, in ``factory``'s ``FactoryConfig``
    (the port's, or the JAX package's in a test): ``_factory_config`` of
    ``benchmarks/accuracy_mape.py`` at its CI size."""
    return factory.FactoryConfig(n_graphs=ACCURACY_GRAPHS, seed=ZOO_SEED,
                                 shard_size=ACCURACY_SHARD,
                                 extra_families=ZOO_HELD_OUT,
                                 lm_archs=ACCURACY_LM_ARCHS)


def gate_mape(measured: dict, bases: dict, tol: dict) -> dict:
    """Per head: measured ≤ max(base · rel, base + abs), the JAX gate's
    bound (``_gate_mape`` of ``benchmarks/accuracy_mape.py``)."""
    rel, add = float(tol["rel"]), float(tol["abs"])
    out = {}
    for head in ACCURACY_HEADS:
        base, got = float(bases[head]), float(measured[head])
        bound = max(base * rel, base + add)
        out[head] = {"measured": got, "base": base, "bound": bound,
                     "ok": got <= bound}
    return out


def median_heads(reports: list, split: str) -> dict:
    """Each head's median over ``reports`` (one ``run_accuracy`` report a
    seed) on ``split``."""
    return {head: statistics.median(float(r[split][head]) for r in reports)
            for head in ACCURACY_HEADS}


def accuracy_reference(protocol: dict) -> dict:
    """``ACCURACY_REFERENCE``: the JAX package's protocol over
    ``ACCURACY_SEEDS`` on the gate's plan, checked to be that run (its
    package, plan hash, seeds and default ``protocol``, and each median
    the median of its seeds' reports)."""
    ref = json.loads((ROOT / ACCURACY_REFERENCE).read_text())
    want = {"package": "jax", "plan_hash": ACCURACY_PLAN_HASH,
            "seeds": list(ACCURACY_SEEDS),
            "protocol": json.loads(json.dumps(protocol))}
    got = {k: ref.get(k) for k in want}
    if got != want:
        raise AssertionError(f"accuracy: {ACCURACY_REFERENCE} is not the "
                             f"JAX package's run of this protocol: {got}")
    for split, med in ref["median"].items():
        if med != median_heads(ref["reports"], split):
            raise AssertionError(f"accuracy: {ACCURACY_REFERENCE}'s {split} "
                                 f"medians are not its reports'")
    return ref


def phase_accuracy(torch, name_limit: str) -> dict:
    """The JAX package's accuracy gate run by the port: the gate's plan
    built by the port's factory (spawned workers), a second build reusing
    every shard, ``run_accuracy`` on the card at the default protocol for
    each seed of ``ACCURACY_SEEDS``, and each head's median over the seeds
    on the test and unseen splits within the JAX gate's bound around the
    JAX package's median (``accuracy_reference``)."""
    import dataclasses
    import os
    import tempfile
    from repro_torch.dataset import factory
    from repro_torch.train import AccuracyProtocol, run_accuracy
    t0 = time.perf_counter()
    cfg = accuracy_config(factory)
    ph = factory.plan_hash(cfg)
    if ph != ACCURACY_PLAN_HASH:
        raise AssertionError(f"accuracy: plan hash {ph} != "
                             f"{ACCURACY_PLAN_HASH}")
    workers = min(ACCURACY_MAX_WORKERS, os.cpu_count() or 1)
    baseline = json.loads((ROOT / ACCURACY_BASELINE).read_text())
    reference = accuracy_reference(AccuracyProtocol().to_json())
    kernels = all_wrappers()
    reports, train_s = [], []
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = str(Path(tmp) / "ds")
        res, build_s = timed(factory.build, out_dir, cfg, workers=workers)
        res2, rebuild_s = timed(factory.build, out_dir, cfg, workers=workers)
        if res2.shards_built != 0 or res2.shards_reused != res.n_shards:
            raise AssertionError(f"accuracy: the second build reused "
                                 f"{res2.shards_reused} of {res.n_shards} "
                                 f"shards and built {res2.shards_built}")
        coverage = res.n_built / max(res.n_planned, 1)
        if coverage < ACCURACY_MIN_COVERAGE:
            raise AssertionError(f"accuracy: coverage {coverage:.3f} < "
                                 f"{ACCURACY_MIN_COVERAGE}; skips "
                                 f"{res.skips_by_family}")
        zero_counts(kernels)
        for seed in ACCURACY_SEEDS:
            proto = dataclasses.replace(AccuracyProtocol(), seed=seed)
            report, secs = timed(run_accuracy, out_dir, proto)
            reports.append(report)
            train_s.append(secs)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, (fn, _) in kernels.items()}
        # the first seed again: the card's training is deterministic, so
        # the gate reads the same reports every run
        again = run_accuracy(out_dir, dataclasses.replace(
            AccuracyProtocol(), seed=ACCURACY_SEEDS[0]))
    first = reports[0]
    if not same_params(again.pop("params"), first["params"]) or \
            json.dumps(again, sort_keys=True) != json.dumps(
                {k: v for k, v in first.items() if k != "params"},
                sort_keys=True):
        raise AssertionError("accuracy: a second run of the protocol gave "
                             "another report")
    if launches["dense_aggregate"] <= 0:
        raise AssertionError(f"accuracy: the dense GraphSAGE trainer "
                             f"launched no B7 ({launches})")
    for report in reports:
        unseen = report["per_family"].get("unseen", {})
        if not unseen or any(h not in m for m in unseen.values()
                             for h in ("mape_latency", "mape_energy",
                                       "mape_memory")):
            raise AssertionError(f"accuracy: per-family holdout MAPE "
                                 f"missing: {unseen}")
        report.pop("params")
    tol = baseline["tolerance"]
    medians = {split: median_heads(reports, split)
               for split in ("test", "unseen")}
    gates = {split: gate_mape(med, reference["median"][split], tol)
             for split, med in medians.items()}
    baseline_gates = {split: gate_mape(med, baseline[split], tol)
                      for split, med in medians.items()}
    failed = [f"{split}.{head}" for split, checks in gates.items()
              for head, c in checks.items() if not c["ok"]]
    out = {"phase": "accuracy", "card": name_limit, "plan_hash": ph,
           "workers": workers,
           "dataset": {"n_planned": res.n_planned, "n_built": res.n_built,
                       "n_skipped": res.n_skipped, "n_shards": res.n_shards,
                       "coverage": coverage,
                       "skips_by_family": res.skips_by_family,
                       "shards_reused_on_resume": res2.shards_reused},
           "build_s": build_s, "rebuild_s": rebuild_s, "train_s": train_s,
           "seeds": [{"seed": seed, "splits": r["splits"],
                      "epochs_trained": r["epochs_trained"],
                      "best_epoch": r["best_epoch"],
                      "best_val_mape": r["best_val_mape"],
                      "converged": r["converged"],
                      "history_val_mape": r["history_val_mape"],
                      "val": r.get("val"), "test": r["test"],
                      "unseen": r["unseen"],
                      "unseen_per_family": r["per_family"]["unseen"]}
                     for seed, r in zip(ACCURACY_SEEDS, reports)],
           "gates": gates, "gates_failed": failed,
           "reference": {k: reference[k] for k in ("package", "jax",
                                                   "platform", "seeds")},
           "baseline_gates": baseline_gates,
           "baseline_misses": [
               f"{split}.{head}" for split, checks in baseline_gates.items()
               for head, c in checks.items() if not c["ok"]],
           "launches": launches, "second_run_same_bits": True,
           "seconds": time.perf_counter() - t0}
    emit(out)
    if failed:
        raise AssertionError(
            f"accuracy: median MAPE over seeds {list(ACCURACY_SEEDS)} above "
            f"the bound around the JAX package's: " + ", ".join(
                f"{split}.{head} {gates[split][head]['measured']:.4f} > "
                f"{gates[split][head]['bound']:.4f}"
                for split, head in (f.split(".") for f in failed)))
    return out


# ---------------------------------------------------------------------------
# lm_train: the flash backward, then LM training on the card
# ---------------------------------------------------------------------------

def lm_train_config(arch: str = LM_TRAIN_ARCH, **overrides):
    """``arch``'s config (its smoke config under ``LM_SMOKE_WIDTH``) with
    ``overrides``."""
    import dataclasses
    from repro_torch.configs import get_config, get_smoke_config
    cfg = (get_smoke_config if LM_SMOKE_WIDTH else get_config)(arch)
    return dataclasses.replace(cfg, **overrides)


def bwd_inputs(torch, dev, case, dtype, seed):
    """q, k, v and the output's gradient of a ``BWD_CASES`` case."""
    b, sq, skv, h, hkv, d, dv = case[:7]
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                            device=dev).to(dtype)
            for shape in ((b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, dv),
                          (b, sq, h, dv))]


def bwd_kw(case) -> dict:
    return dict(causal=case[7], window=case[8], q_offset=case[9],
                kv_offset=case[10])


def sweep_flash_bwd(torch, dev) -> dict:
    """The forward's lse and ``flash_attention_bwd_cuda`` against their
    plain versions on ``BWD_CASES`` in float32 and bf16, each gradient
    within the dtype's bar of its largest magnitude, every case run twice
    with the same bits; the worst error relative to scale per dtype."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    cases = []
    for i, case in enumerate(BWD_CASES):
        kw = bwd_kw(case)
        for name, tol in (("float32", BWD_F32_TOL),
                          ("bfloat16", BWD_BF16_TOL)):
            q, k, v, g = bwd_inputs(torch, dev, case, getattr(torch, name),
                                    6000 + i)
            out, lse = flash_attention_cuda(q, k, v, with_lse=True, **kw)
            _, lse_want = ref.flash_attention_ref(q, k, v, with_lse=True,
                                                  **kw)
            got = flash_attention_bwd_cuda(q, k, v, out, lse, g, **kw)
            again = flash_attention_bwd_cuda(q, k, v, out, lse, g, **kw)
            want = ref.flash_attention_bwd_ref(q, k, v, out, lse, g, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"flash_attention_bwd {name} case "
                                     f"{case}: two runs differ")
            live = lse_want > -1e29          # rows that keep a key
            lse_err = check_close(f"flash lse {name} case {case}",
                                  lse[live], lse_want[live], 1e-3, 1e-4)
            rels = {}
            for gname, a, w in zip(("dq", "dk", "dv"), got, want):
                scale = max(float(w.float().abs().max()), 1e-30)
                check_close(f"flash_attention_bwd {name} {gname} case {case}",
                            a.float(), w.float(), tol * scale, tol)
                rels[gname] = float((a.float() - w.float()).abs().max()) \
                    / scale
            if case[10] > 0 and case[7]:         # rows with no kept key
                dead = got[0][:, :case[10]]
                if not torch.equal(dead, torch.zeros_like(dead)):
                    raise AssertionError(f"flash_attention_bwd {name}: a row "
                                         f"with no kept key has dq != 0")
            worst[name] = max(worst[name], *rels.values())
            cases.append({"case": list(case), "dtype": name,
                          "rel_err": rels, "lse_max_abs_err": lse_err,
                          "same_bits": True})
    return {"worst_rel_err": worst, "cases": cases}


def flash_bwd_entry(torch, dev) -> dict:
    """flash_attention_bwd at the full training run's shape (qwen2.5-3b's
    heads, bf16, causal) against its plain version, timed beside its
    bound, the plain version and SDPA's forward + backward; the sweep."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    sweep = sweep_flash_bwd(torch, dev)
    cfg = lm_train_config()
    b, s = LM_TRAIN_BATCH, LM_TRAIN_SEQ
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    case = (b, s, s, h, hkv, d, d, True, 0, 0, 0)
    kw = bwd_kw(case)
    q, k, v, g = bwd_inputs(torch, dev, case, torch.bfloat16, 6100)
    out, lse = flash_attention_cuda(q, k, v, with_lse=True, **kw)
    kern = lambda: flash_attention_bwd_cuda(  # noqa: E731
        q, k, v, out, lse, g, **kw)
    plain = lambda: ref.flash_attention_bwd_ref(  # noqa: E731
        q, k, v, out, lse, g, **kw)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = max(check_close(f"flash_attention_bwd {n} at the training shape",
                          a.float(), w.float(),
                          BWD_BF16_TOL * float(w.float().abs().max()),
                          BWD_BF16_TOL)
              for n, a, w in zip(("dq", "dk", "dv"), got, want))
    del got, want
    ms = time_eager_ms(torch, kern, calls=5, reps=5)
    plain_ms = time_eager_ms(torch, plain, calls=2, reps=3)
    fwd_bwd_ms = time_eager_ms(torch, lambda: flash_attention_bwd_cuda(
        q, k, v, *flash_attention_cuda(q, k, v, with_lse=True, **kw), g,
        **kw), calls=5, reps=5)
    # the yardstick: SDPA forward + backward, is_causal, grouped heads
    library_ms, library_note = sdpa_train_ms(torch, q, k, v, g, True,
                                             calls=5)
    us = device_breakdown_us(torch, {"bwd": kern}, reps=5)["bwd"]
    # bound: the five products of the custom VJP's backward (s, dout·v,
    # dv, dq, dk), 2·D flops each per kept (causal) pair, at the bf16
    # tensor-core peak; bytes: q, k, v, out, dout read and dq, dk, dv
    # written once in bf16, lse read once in float32
    kept = b * h * s * (s + 1) // 2
    nbytes = 2.0 * (3 * q.numel() + 2 * out.numel() + 3 * k.numel()) \
        + 4.0 * lse.numel()
    bound = bound_ms(10.0 * d * kept, nbytes, PEAK_BF16_FLOPS)
    floor = bwd_floor_ms(10.0 * d * kept, d, d, nbytes)
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/models/layers.py:162",
            "replaces_note": "no Pallas kernel: the custom VJP's bwd of "
                             "_make_flash, jnp that XLA compiles",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "floor_ms": floor,
            "floor_note": FLOOR_NOTE, "library_ms": library_ms,
            "library_note": library_note, "fwd_bwd_ms": fwd_bwd_ms,
            "fwd_bwd_note": "this port's forward with lse + backward, the "
                            "like-for-like yardstick to library_ms",
            "unit": f"q, dout [{b}, {s}, {h}, {d}] over k/v [{b}, {s}, {hkv}, "
                    f"{d}] bf16, causal",
            "device_us_by_kernel": us,
            "sweep": sweep,
            "plan": flash_bwd_plan_facts(
                torch, [(case, "lm_train")]
                + [(c, n) for n, _, c in WIDE_FLASH if "bwd" in n]),
            "build": segment_build_facts("flash_attention_bwd", ("HMMA",))}


#: the bwd entries' floor_ms
FLOOR_NOTE = ("the design's own floor: its two kernels each recompute s and "
              "dout·v, 2 (4 D + 3 Dv) flops a kept pair against the "
              "bound's 2 (3 D + 2 Dv) (7 / 5 at D = Dv), at the bf16 peak, "
              "or the bound's bytes")


def bwd_floor_ms(flops: float, d: int, dv: int, nbytes: float) -> float:
    """The least time of ``flash_attention_bwd.cu``'s design for work whose
    bound is ``flops`` (the custom VJP's five products) and ``nbytes``:
    its seven products, ``(4 D + 3 Dv) / (3 D + 2 Dv)`` of the flops."""
    return bound_ms(flops * (4 * d + 3 * dv) / (3 * d + 2 * dv), nbytes,
                    PEAK_BF16_FLOPS)[0]


def flash_bwd_plan_facts(torch, cases) -> list:
    """For each ``(case, what)``: the bf16 backward's instance and tiles
    (``flash_bwd_plan``), its dynamic shared memory a dk / dv and a dq
    block (the plan's and the library's, which must agree), the blocks an
    SM of each (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and
    the head splits (``flash_bwd_splits``) on this card."""
    import ctypes
    from repro_torch.kernels.flash_attention import (_sm_count,
                                                     flash_bwd_plan,
                                                     flash_bwd_splits)
    from repro_torch.kernels.segment_spmm import _entry
    out = []
    for case, what in cases:
        b, _, skv, h, hkv, d, dv = case[:7]
        plan = flash_bwd_plan(d, dv, torch.bfloat16)
        row = {"what": what, "d": d, "dv": dv, "instance": [plan.d_max,
                                                           plan.dv_max],
               "bq": plan.bq, "bkq": plan.bkq,
               "n_split": flash_bwd_splits(b, skv, h, hkv, torch.bfloat16,
                                           _sm_count(0))}
        for which, kname in enumerate(("dkdv", "dq")):
            smem = _entry("flash_attention_bwd_smem")(1, d, dv, which)
            want = plan.dkdv_smem if which == 0 else plan.dq_smem
            if smem != want:
                raise AssertionError(f"flash_attention_bwd {kname} at D {d} "
                                     f"/ Dv {dv}: flash_bwd_plan says {want} "
                                     f"bytes, the library {smem}")
            blocks = ctypes.c_int(0)
            rc = _entry("flash_attention_bwd_occupancy")(
                1, d, dv, which, ctypes.addressof(blocks))
            if rc != 0:
                raise AssertionError(f"flash_attention_bwd occupancy: "
                                     f"cudaError_t {rc}")
            row[f"{kname}_smem"] = smem
            row[f"{kname}_blocks_an_sm"] = blocks.value
        out.append(row)
    return out


def lm_train_launch_rule(cfg, steps: int, remat: bool) -> dict:
    """The flash and SSD launches of ``steps`` training steps: each
    forward kernel once per layer that runs it (attention: every layer of
    an ``attn`` stack — dense, MLA (its full-sequence form), MoE, a
    cross-attention config's self and cross layers, an encoder's — the
    shared block once per group of a hybrid; the scan: every Mamba2
    layer), again in the backward under ``remat`` (each layer
    recomputed), and each backward kernel once per such layer."""
    n_attn = n_ssd = 0
    if cfg.block == "attn":
        n_attn = cfg.n_layers
    elif cfg.block == "mamba2":
        n_ssd = cfg.n_layers
    else:
        n_attn = cfg.n_layers // cfg.hybrid_attn_every
        n_ssd = n_attn * cfg.hybrid_attn_every
    k = 2 if remat else 1
    return {"flash_attention": steps * n_attn * k,
            "flash_attention_bwd": steps * n_attn,
            "ssd_scan": steps * n_ssd * k, "ssd_scan_bwd": steps * n_ssd}


def lm_train_wrappers() -> dict:
    """The wrappers ``lm_train_launch_rule`` counts, by name."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda, ssd_scan_cuda
    return {"flash_attention": flash_attention_cuda,
            "flash_attention_bwd": flash_attention_bwd_cuda,
            "ssd_scan": ssd_scan_cuda, "ssd_scan_bwd": ssd_scan_bwd_cuda}


def lm_train_batch(torch, cfg, b: int, s: int, dev, seed: int) -> dict:
    """A seeded training batch on ``dev``: int32 ``tokens`` and ``labels``
    [b, s], with a float32 ``vision_embeds`` [b, vision_tokens,
    vision_dim] for a cross-attention config; an audio-frame encoder's
    ``features`` [b, s, d_model] take the tokens' place (the reference's
    ``input_specs``)."""
    rng = np.random.default_rng(seed)
    keys = ("labels",) if cfg.frontend == "audio_frames" else ("tokens",
                                                                 "labels")
    out = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (b, s)),
                              dtype=torch.int32, device=dev) for k in keys}
    extra = {}
    if cfg.frontend == "audio_frames":
        extra["features"] = (b, s, cfg.d_model)
    if cfg.cross_attn_every:
        extra["vision_embeds"] = (b, cfg.vision_tokens, cfg.vision_dim)
    for k, shape in extra.items():
        out[k] = torch.as_tensor(rng.standard_normal(shape, np.float32),
                                 device=dev)
    return out


def lm_train_parity(torch, dev, cfg, batch: int, seq: int) -> dict:
    """``cfg`` in float32 (an arch at full width with its depth cut, or a
    smoke config): LM_TRAIN_PARITY_STEPS train steps on the card against
    the same steps on the CPU's plain versions; losses within
    LM_TRAIN_LOSS_RTOL, parameters on ROADMAP §C's bar (an element whose
    first-step CPU gradient is below TRAIN_NOISE_FLOOR of its leaf's
    largest may leave it by TRAIN_NOISE_ATOL), the card's launches on
    ``lm_train_launch_rule``; with MoE, every MoE call's expert ids and
    keep mask in the first step equal on both. The card's steps recompute
    each layer (``remat=True``, the launches the rule counts); the CPU's
    reference steps do not: remat changes no value (the same bits on the
    card machine's CPU for qwen2.5-3b and zamba2-2.7b, measured while
    cutting this phase's time; ``tests/test_torch_lm_train.py`` holds the
    gradients equal). The weights are drawn on the card and copied to the
    CPU; the quiet elements come from the CPU's first step's own
    gradient; the bar is read on the card."""
    import dataclasses
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import adamw, constant
    from repro_torch.optim.optimizers import tree_leaves
    t0 = time.perf_counter()
    arch = cfg.name
    opt = adamw(constant(LM_TRAIN_PARITY_LR), b1=0.9, b2=0.95,
                weight_decay=0.1, state_dtype=torch.float32,
                grad_clip_norm=1.0)
    quiet = []

    def update_noting_quiet(step, state, params, grads):
        """The CPU's update; its first gradient says which elements are
        float noise."""
        if not quiet:
            quiet.extend(g.abs() < TRAIN_NOISE_FLOOR * g.abs().max()
                         for g in tree_leaves(grads))
        return opt.update(step, state, params, grads)
    step_fns = {"card": make_train_step(cfg, opt),
                "cpu": make_train_step(cfg, dataclasses.replace(
                    opt, update=update_noting_quiet), remat=False)}
    card_init = lm.init_params(cfg, seed=LM_SEED, device=dev)
    cpu = tree_to(card_init, "cpu")
    batches = [lm_train_batch(torch, cfg, batch, seq, "cpu", LM_SEED + 10 + i)
               for i in range(LM_TRAIN_PARITY_STEPS)]
    runs, routes, secs = {}, {}, {"setup": time.perf_counter() - t0}
    wrappers = lm_train_wrappers()
    for where in ("card", "cpu"):
        t1 = time.perf_counter()
        step_fn = step_fns[where]
        params = card_init if where == "card" else cpu
        pd = dev if where == "card" else "cpu"
        state, step, losses = opt.init(params), 0, []
        before = {k: w.launches for k, w in wrappers.items()}
        for i, b in enumerate(batches):
            seen, restore = moe_route_recorder() if (
                cfg.moe is not None and i == 0) else ([], lambda: None)
            try:
                params, state, step, m = step_fn(
                    params, state, step, {k: v.to(pd) for k, v in b.items()})
            finally:
                restore()
            if i == 0:
                routes[where] = seen
            losses.append(float(m["loss"]))
        if where == "card":
            torch.cuda.synchronize()
            launches = {k: w.launches - before[k]
                        for k, w in wrappers.items()}
            want = lm_train_launch_rule(cfg, LM_TRAIN_PARITY_STEPS, True)
            if launches != want:
                raise AssertionError(f"lm_train parity {arch}: launches "
                                     f"{launches} != the rule's {want}")
        runs[where] = (losses, [t.detach() for t in tree_leaves(params)])
        secs[where] = time.perf_counter() - t1
    if cfg.moe is not None:
        # the card's step routes each MoE layer again as the backward
        # recomputes it, last layer first; the CPU's once
        a, w = routes["card"], routes["cpu"]
        if not w or len(a) != 2 * len(w) or not all(
                torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])
                for x, y in zip(a, w + w[::-1])):
            raise AssertionError(f"lm_train parity {arch}: the first step's "
                                 f"expert ids or keep masks differ between "
                                 f"the card and the CPU")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(runs["card"][0],
                                                         runs["cpu"][0]))
    if loss_rel > LM_TRAIN_LOSS_RTOL:
        raise AssertionError(f"lm_train parity {arch}: losses "
                             f"{runs['card'][0]} vs the CPU's "
                             f"{runs['cpu'][0]}")
    t1 = time.perf_counter()
    outside, worst_noise, worst = 0, 0.0, 0.0
    for a, w, q in zip(runs["card"][1], runs["cpu"][1], quiet):
        w, q = w.to(dev), q.to(dev)
        diff = (a - w).abs()
        excess = diff - (TRAIN_PARAM_ATOL + TRAIN_PARAM_RTOL * w.abs())
        worst = max(worst, float(diff.max()))
        out_el = excess > 0
        if bool((out_el & ~q).any()) or bool((excess > TRAIN_NOISE_ATOL)
                                             .any()):
            raise AssertionError(f"lm_train parity {arch}: parameters "
                                 f"outside the bar (max excess "
                                 f"{float(excess.max()):.3e})")
        outside += int(out_el.sum())
        if bool(out_el.any()):
            worst_noise = max(worst_noise, float(excess[out_el].max()))
    del a, w, q, diff, excess, out_el
    secs["compare"] = time.perf_counter() - t1
    return {"config": {"arch": cfg.name, "n_layers": cfg.n_layers,
                       "d_model": cfg.d_model, "dtype": cfg.param_dtype},
            "batch": [batch, seq],
            "steps": LM_TRAIN_PARITY_STEPS, "lr": LM_TRAIN_PARITY_LR,
            "losses": runs["card"][0], "cpu_losses": runs["cpu"][0],
            "loss_max_rel_err": loss_rel, "param_max_abs_err": worst,
            "params_outside_bar": outside,
            "outside_bar_max_excess": worst_noise,
            "launches": launches,
            **({"moe_calls_step1": len(routes["cpu"]),
                "routes_equal_step1": True,
                "replicas_dropped_step1": sum(int((~k).sum())
                                              for _, k in routes["cpu"])}
               if cfg.moe is not None else {}),
            "seconds_by_part": secs, "seconds": time.perf_counter() - t0}


def ssd_bwd_work(b: int, s: int, h: int, g: int, p: int, n: int,
                 esize: int, lc: int) -> tuple:
    """The backward kernel's operations and bytes for one call: per (b,
    chunk of ``lc`` rows, h) ``2 T (3N + 2P)`` flops over the ``T = Lc
    (Lc + 1) / 2`` pairs i ≥ j that the causal mask keeps (C Bᵀ, dy xᵀ
    and the three intra-chunk products; the forward's count in
    ``lm_kernel_entries``) and ``12 Lc N P`` (six state products), the
    same for every input; the bytes of x, B, C (``esize`` each), dt, A, s0, dy and
    d_last read once and of dx, dB, dC, ddt, dA and ds0 written once."""
    tri = lc * (lc + 1) // 2
    flops = b * (-(-s // lc)) * h * (2 * tri * (3 * n + 2 * p)
                                     + 12 * lc * n * p)
    nbytes = (esize * (2 * b * s * h * p + 4 * b * s * g * n)
              + 4 * (b * s * h * p + 2 * b * s * h + 3 * b * h * n * p
                     + 2 * h))
    return flops, nbytes


def ssd_bwd_entry(torch, dev) -> dict:
    """ssd_scan_bwd at each SSD arch's training shape (x [SSD_BWD_BATCH,
    SSD_BWD_SEQ, H, P], B/C [.., G, N], the model's chunk, from a given
    state and with a gradient on the last state) in float32 and bf16:
    each gradient against the plain twin on the card within its bar of
    its scale, twice with the same bits, the device time of one call (a
    CUDA graph of 20 calls, median of 50) beside its bound and the twin's
    time; the SASS free of float atomics. The bound is the larger of the
    bytes at ``PEAK_BYTES`` and the operations at the card's rate for the
    type, as the forward's and the flash backward's: bf16 at the bf16
    tensor-core peak, float32 as three TF32 products (the split that
    keeps float32's precision on the tensor cores, as ``fused_mp_layer``
    is bounded). The entry's own numbers are mamba2-370m's in bf16, the
    full training run's; ``sweep`` is :func:`sweep_ssd_bwd`'s."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_spmm import _entry
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda
    shapes = []
    for arch in SSD_BWD_ARCHS:
        cfg = lm_train_config(arch)
        sc = cfg.ssm
        h, p, n, g = (sc.n_heads(cfg.d_model), sc.head_dim, sc.d_state,
                      sc.n_groups)
        b, s = SSD_BWD_BATCH, SSD_BWD_SEQ
        for name, tol in (("float32", SSD_BWD_F32_TOL),
                          ("bfloat16", SSD_BWD_BF16_TOL)):
            seed = 7000 + len(shapes)
            x, dt, a, bm, cm, s0 = ssd_inputs(torch, dev, b, s, h, p, n, g,
                                              getattr(torch, name), seed)
            rng = np.random.default_rng(seed + 100)
            dy = torch.as_tensor(rng.standard_normal((b, s, h, p))
                                 .astype(np.float32), device=dev)
            dl = torch.as_tensor(rng.standard_normal((b, h, n, p))
                                 .astype(np.float32), device=dev)
            args = (x, dt, a, bm, cm, dy)
            kw = dict(chunk=sc.chunk, s0=s0, d_last=dl)
            kern = lambda: ssd_scan_bwd_cuda(*args, **kw)  # noqa: E731
            plain = lambda: ref.ssd_scan_bwd_ref(*args, **kw)  # noqa: E731
            got, again = kern(), kern()
            want = plain()
            torch.cuda.synchronize()
            if not all(torch.equal(u, v) for u, v in zip(got, again)):
                raise AssertionError(f"ssd_scan_bwd {arch} {name}: two runs "
                                     f"differ")
            errs, rels = check_ssd_grads(f"ssd_scan_bwd {arch} {name}",
                                         got, want, tol)
            del got, again, want
            ms = time_graph_ms(torch, kern)
            plain_ms = time_eager_ms(torch, plain, calls=1, reps=3)
            us = device_breakdown_us(torch, {"bwd": kern}, reps=5)["bwd"]
            flops, nbytes = ssd_bwd_work(b, s, h, g, p, n, x.element_size(),
                                         _entry("ssd_scan_bwd_chunk")())
            bound = bound_ms(flops, nbytes, PEAK_BF16_FLOPS) if (
                name == "bfloat16") else bound_ms(3.0 * flops, nbytes,
                                                  PEAK_TF32_FLOPS)
            shapes.append({"arch": arch, "dtype": name,
                           "unit": f"x [{b}, {s}, {h}, {p}], B/C [{b}, {s}, "
                                   f"{g}, {n}], chunk {sc.chunk}",
                           "rel_err": rels, "max_abs_err": max(errs.values()),
                           "bar": tol, "same_bits": True, "ms": ms,
                           "plain_ms": plain_ms, "bound_ms": bound[0],
                           "bound_by": bound[1], "gflop": flops / 1e9,
                           "mbytes": nbytes / 1e6,
                           "device_us_by_kernel": us})
            del x, dt, a, bm, cm, s0, dy, dl, args, kw
            torch.cuda.empty_cache()
    main = next(e for e in shapes if e["arch"] == LM_SSD_TRAIN_ARCH
                and e["dtype"] == "bfloat16")
    return {"name": "ssd_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
            "replaces": "src/repro/models/layers.py:739",
            "replaces_note": "no Pallas kernel: jax.grad of the plain-jnp "
                             "_ssd_chunked, which XLA compiles",
            "launches": None, "max_abs_err": main["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None,
            "library_note": "none: no single PyTorch call computes the "
                            "chunked SSD scan's gradient",
            "bound_note": "bound_ms: the larger of the bytes at 3.35 TB/s "
                          "and the kept (i >= j) intra-chunk and the state "
                          "products at the bf16 tensor-core peak",
            "unit": f"{main['arch']} bf16: {main['unit']}",
            "launches_per_unit": 1, "shapes": shapes,
            "sweep": sweep_ssd_bwd(torch, dev),
            "build": segment_build_facts("ssd_scan_bwd")}


def flash_train_shape_recorder():
    """Wrap ``ops.kernel`` so that each training call of the flash forward
    and backward also records its (Sq, Skv, D, Dv); the wrappers' launch
    counts are untouched. Returns (the records by kernel, a restore
    call)."""
    from repro_torch.kernels import ops
    real = ops.kernel
    seen = {"flash_attention": [], "flash_attention_bwd": []}

    def recording(name, t):
        fn = real(name, t)
        if name not in seen:
            return fn

        def call(q, k, v, *args, **kw):
            seen[name].append((q.shape[1], k.shape[1], q.shape[3],
                               v.shape[3]))
            return fn(q, k, v, *args, **kw)
        return call

    ops.kernel = recording
    return seen, lambda: setattr(ops, "kernel", real)


def by_shape(records: list) -> dict:
    """Launch records counted by shape, keyed "Sq/Skv/D/Dv"."""
    out = {}
    for r in records:
        key = "/".join(str(x) for x in r)
        out[key] = out.get(key, 0) + 1
    return out


def lm_train_full(torch, dev, cfg, batch: int, seq: int, seed: int,
                  bwd_kernels: tuple, steps: int = LM_TRAIN_STEPS) -> dict:
    """``cfg`` trained on the card from seeded random weights:
    ``default_optimizer()``, remat, one warm-up step and ``steps``
    measured ones (ms a step, tokens/s, peak memory, finite losses and
    parameters, launches on ``lm_train_launch_rule``, the flash launches
    also by shape), then one more step under the profiler (the device's
    busy share and ms by kernel; ``bwd_kernels``: the backward kernel's
    launches by name)."""
    import gc
    from repro_torch import nn as tnn
    from repro_torch.launch.steps import default_optimizer, make_train_step
    from repro_torch.models import lm
    from repro_torch.optim.optimizers import tree_leaves
    params = lm.init_params(cfg, seed=LM_SEED)
    opt = default_optimizer()
    state, step = opt.init(params), 0
    train_step = make_train_step(cfg, opt, remat=True)
    batches = [lm_train_batch(torch, cfg, batch, seq, dev, seed + i)
               for i in range(steps + 2)]
    params, state, step, m = train_step(params, state, step, batches[0])
    torch.cuda.synchronize()
    gc.collect()             # what a first call's lazy imports left in cycles
    after_warmup = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    wrappers = lm_train_wrappers()
    for w in wrappers.values():
        w.launches = 0
    losses, auxs, step_ms = [float(m["loss"])], [float(m["aux"])], []
    shapes, restore = flash_train_shape_recorder()
    try:
        for b in batches[1:steps + 1]:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            params, state, step, m = train_step(params, state, step, b)
            losses.append(float(m["loss"]))      # waits for the step
            step_ms.append(1e3 * (time.perf_counter() - t1))
            auxs.append(float(m["aux"]))
    finally:
        restore()
    launches = {k: w.launches for k, w in wrappers.items()}
    want = lm_train_launch_rule(cfg, steps, True)
    if launches != want:
        raise AssertionError(f"lm_train {cfg.name}: launches {launches} != "
                             f"the rule's {want}")
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses + auxs)):
        raise AssertionError(f"lm_train {cfg.name}: losses {losses}, aux "
                             f"{auxs}")
    if not all(bool(torch.isfinite(t.float()).all())
               for t in tree_leaves(params)):
        raise AssertionError(f"lm_train {cfg.name}: non-finite parameters")

    # where a step's device time goes: one more step under the profiler
    holder = {}

    def one_step():
        holder["out"] = train_step(params, state, step, batches[steps + 1])
    rows = device_ms_by_kernel(torch, one_step)
    holder.clear()
    busy = sum(rows.values())
    top = dict(sorted(rows.items(), key=lambda kv: -kv[1])[:12])
    bwd_ms = {k: rows.get(k, 0.0) for k in bwd_kernels}
    bwd_name = ("flash_attention_bwd" if cfg.block == "attn"
                else "ssd_scan_bwd")
    per_step = lm_train_launch_rule(cfg, 1, True)[bwd_name]
    med = statistics.median(step_ms)
    out = {"config": {"arch": cfg.name, "n_layers": cfg.n_layers,
                      "d_model": cfg.d_model, "dtype": cfg.param_dtype},
           "batch": [batch, seq],
           "optimizer": "default_optimizer() (AdamW, bf16 states)",
           "remat": True, "steps": steps,
           "losses": losses, "aux": auxs, "step_ms": step_ms,
           "ms_per_step": med,
           "tokens_per_s": batch * seq / (med / 1e3),
           "max_memory_allocated": peak,
           "allocated_after_warmup": after_warmup,
           "param_bytes": tnn.tree_bytes(params),
           "param_count": tnn.tree_size(params),
           "launches": launches,
           "flash_launches_by_shape": {k: by_shape(v)
                                       for k, v in shapes.items()},
           "step_device_busy_ms": busy,
           "device_busy_share": busy / med,
           "step_device_ms_by_kernel": top,
           "bwd_device_ms_by_kernel": bwd_ms,
           "bwd_us_per_launch": 1e3 * sum(bwd_ms.values()) / per_step}
    del params, state
    torch.cuda.empty_cache()
    return out


def cross_shapes(cfg, batch_seq: int) -> dict:
    """A cross-attention config's flash calls in one training forward, by
    "Sq/Skv/D/Dv": each group's self layers over the sequence, its cross
    layer over the vision memory."""
    groups = cfg.n_layers // cfg.cross_attn_every
    d = cfg.resolved_head_dim
    return {f"{batch_seq}/{batch_seq}/{d}/{d}":
            groups * (cfg.cross_attn_every - 1),
            f"{batch_seq}/{cfg.vision_tokens}/{d}/{d}": groups}


def sdpa_train_ms(torch, q, k, v, g, causal: bool, calls: int = 3):
    """``scaled_dot_product_attention`` forward + backward (``enable_gqa``)
    on [B, H, S, D] copies of q, k, v and the output's gradient ``g``, ms
    a call, and a note; (None, the refusal) where it refuses the shapes.
    Measured only, never on the path."""
    import torch.nn.functional as F
    qt, kt, vt = (z.transpose(1, 2).contiguous().requires_grad_()
                  for z in (q, k, v))
    gt = g.transpose(1, 2).contiguous()

    def library():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                           enable_gqa=True)
        return torch.autograd.grad(o, (qt, kt, vt), gt)
    note = ("scaled_dot_product_attention forward + backward, enable_gqa"
            + (", is_causal" if causal else "") + ", on [B, H, S, D] copies: "
            "measured only, never on the path")
    try:
        library()
        torch.cuda.synchronize()
    except RuntimeError as err:     # SDPA takes no such shapes: no yardstick
        return None, f"scaled_dot_product_attention refused: {err}"[:300]
    return time_eager_ms(torch, library, calls=calls, reps=5), note


def wide_flash_entries(torch, dev, launches: dict) -> list:
    """B8's forward with lse at MLA's full-sequence shape and 8' at the
    three shapes lm_train_wide's full runs give it (WIDE_FLASH), bf16,
    each against its plain version, timed beside its bound (the kept
    pairs' products at the bf16 peak, or the bytes read and written once)
    and its plain version, with SDPA's time where it takes the shapes;
    ``launches``: each shape's launches in the full runs, by entry. Their
    device time by kernel is the full runs' profiled steps'."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    import torch.nn.functional as F
    out = []
    for name, arch, case in WIDE_FLASH:
        kw = bwd_kw(case)
        b, sq, skv, h, hkv, d, dv = case[:7]
        q, k, v, g = bwd_inputs(torch, dev, case, torch.bfloat16,
                                6200 + len(out))
        kept = b * h * (sq * (sq + 1) // 2 if kw["causal"] else sq * skv)
        o, lse = flash_attention_cuda(q, k, v, with_lse=True, **kw)
        train = name.startswith("flash_attention_train")
        if train:
            kern = lambda: flash_attention_cuda(  # noqa: E731
                q, k, v, with_lse=True, **kw)
            plain = lambda: ref.flash_attention_ref(  # noqa: E731
                q, k, v, with_lse=True, **kw)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = check_close_card(f"{name} out", got[0], want[0],
                                   KERNEL_BF16_TOL, KERNEL_BF16_TOL)
            live = want[1] > -1e29
            check_close_card(f"{name} lse", got[1][live], want[1][live],
                             1e-3, 1e-4)
            flops = 2.0 * (d + dv) * kept
            nbytes = 2.0 * (q.numel() + k.numel() + v.numel() + o.numel()) \
                + 4.0 * lse.numel()
            qt, kt, vt = (z.transpose(1, 2).contiguous() for z in (q, k, v))
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=kw["causal"], enable_gqa=True)
            try:
                lib()
                torch.cuda.synchronize()
                library_ms = time_eager_ms(torch, lib, calls=5, reps=5)
                lib_note = ("scaled_dot_product_attention forward, "
                            "enable_gqa, is_causal, on [B, H, S, D] copies: "
                            "measured only")
            except RuntimeError as e:   # SDPA takes no such shapes
                library_ms, lib_note = None, f"SDPA refused: {e}"[:300]
            calls = 5
        else:
            kern = lambda: flash_attention_bwd_cuda(  # noqa: E731
                q, k, v, o, lse, g, **kw)
            plain = lambda: ref.flash_attention_bwd_ref(  # noqa: E731
                q, k, v, o, lse, g, **kw)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = max(check_close_card(
                f"{name} {n}", a, w, BWD_BF16_TOL * float(w.abs().max()),
                BWD_BF16_TOL) for n, a, w in zip(("dq", "dk", "dv"), got,
                                                 want))
            # 6 D + 4 Dv flops a kept pair: s and dq, dk over D, dout . v
            # and dv over Dv
            flops = (6.0 * d + 4.0 * dv) * kept
            nbytes = 2.0 * (2 * q.numel() + 2 * k.numel() + 2 * v.numel()
                            + 2 * o.numel()) + 4.0 * lse.numel()
            library_ms, lib_note = sdpa_train_ms(torch, q, k, v, g,
                                                 kw["causal"])
            calls = 3
        del got, want
        ms = time_eager_ms(torch, kern, calls=calls, reps=5)
        plain_ms = time_eager_ms(torch, plain, calls=1, reps=3)
        bound = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
        extra = {}
        if not train:
            extra = {"floor_ms": bwd_floor_ms(flops, d, dv, nbytes),
                     "floor_note": FLOOR_NOTE,
                     "fwd_bwd_ms": time_eager_ms(
                         torch, lambda: flash_attention_bwd_cuda(
                             q, k, v, *flash_attention_cuda(
                                 q, k, v, with_lse=True, **kw), g, **kw),
                         calls=calls, reps=5),
                     "fwd_bwd_note": "this port's forward with lse + "
                                     "backward, the like-for-like yardstick "
                                     "to library_ms"}
        out.append({
            "name": name, "route": "cuda",
            "source": ("src/repro_torch/kernels/csrc/flash_attention.cu"
                       if train else
                       "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"),
            "replaces": ("src/repro/kernels/flash_attention.py:93" if train
                         else "src/repro/models/layers.py:162"),
            **({} if train else {
                "replaces_note": "no Pallas kernel: the custom VJP's bwd "
                                 "of _make_flash, jnp that XLA compiles"}),
            "launches": launches.get(name, 0), "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], **extra, "library_ms": library_ms,
            "library_note": lib_note, "gflop": flops / 1e9,
            "mbytes": nbytes / 1e6,
            "unit": f"q [{b}, {sq}, {h}, {d}] over k [{b}, {skv}, {hkv}, "
                    f"{d}], v [.., {dv}] bf16, "
                    + ("causal" if kw["causal"] else "not causal")
                    + (", with lse" if train else "") + f": {arch}'s layer",
            "device_us_by_kernel_note": "in the full runs' profiled step "
                                        "(the phase line's train entries)"})
        del q, k, v, g, o, lse
        torch.cuda.empty_cache()
    return out


def live_cuda_tensors(torch, top: int = 6) -> list:
    """The largest CUDA tensors that the garbage collector can reach, as
    [shape, dtype, MB], one per storage: what an earlier phase still
    holds."""
    import gc
    seen = {}
    for obj in gc.get_objects():
        if (isinstance(obj, torch.Tensor) and obj.is_cuda
                and obj.layout == torch.strided):
            st = obj.untyped_storage()
            seen[st.data_ptr()] = [list(obj.shape), str(obj.dtype),
                                   st.nbytes() / 1e6]
    return sorted(seen.values(), key=lambda r: -r[2])[:top]


def phase_lm_train_wide(torch, dev, name_limit: str, sweep: dict) -> tuple:
    """Training the archs of MLA, MoE, cross-attention and the audio
    frontend: the flash backward's wide cases (``WIDE_BWD_CASES``, from
    ``lm_train``'s ``sweep``), the four smoke configs' parity runs against the
    CPU, the full-width runs of ``WIDE_TRAIN`` with their launches on
    ``lm_train_launch_rule`` (llama's also by shape), and the
    ``kernels`` entries at their shapes. Returns (phase line, entries)."""
    import dataclasses
    import gc
    from repro_torch.configs import get_config, get_smoke_config
    t0 = time.perf_counter()
    gc.collect()                  # deepseek-v2's step peaks near 76 GB
    torch.cuda.empty_cache()
    held = {"bytes": torch.cuda.memory_allocated(),
            "largest_tensors": live_cuda_tensors(torch)}
    parity = []
    for arch in WIDE_ARCHS:
        parity.append(lm_train_parity(torch, dev, get_smoke_config(arch),
                                      WIDE_PARITY_BATCH, WIDE_PARITY_SEQ))
        torch.cuda.empty_cache()
    runs = {}
    for arch, layers, batch, seq in WIDE_TRAIN:
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        runs[arch] = lm_train_full(
            torch, dev, cfg, batch, seq, LM_SEED + 40 + len(runs),
            FLASH_BWD_KERNELS,
            steps=WIDE_TRAIN_STEPS)
        if cfg.cross_attn_every:
            got = runs[arch]["flash_launches_by_shape"]
            rule = cross_shapes(cfg, seq)
            for kname, k in (("flash_attention", 2), ("flash_attention_bwd",
                                                       1)):
                want = {s: n * k * WIDE_TRAIN_STEPS for s, n in rule.items()}
                if got[kname] != want:
                    raise AssertionError(f"lm_train_wide {arch}: {kname} "
                                         f"launches by shape {got[kname]} "
                                         f"!= the rule's {want}")
        torch.cuda.empty_cache()
    shapes = {arch: r["flash_launches_by_shape"] for arch, r in runs.items()}

    def launched(arch, kname, case):
        key = "/".join(str(x) for x in (case[1], case[2], case[5], case[6]))
        return shapes[arch][kname].get(key, 0)
    launches = {}
    for name, arch, case in WIDE_FLASH:
        kname = ("flash_attention" if name.startswith("flash_attention_train")
                 else "flash_attention_bwd")
        launches[name] = launched(arch, kname, case)
    entries = wide_flash_entries(torch, dev, launches)
    wide = [c for c in sweep["cases"] if tuple(c["case"]) in WIDE_BWD_CASES]
    if len(wide) != 2 * len(WIDE_BWD_CASES):
        raise AssertionError("lm_train_wide: the sweep lacks wide cases")
    out = {"phase": "lm_train_wide", "card": name_limit,
           "allocated_at_start": held,
           "bwd_cases": wide, "parity": parity, "train": runs,
           "entries": {e["name"]: {k: e[k] for k in
                                   ("launches", "ms", "plain_ms", "bound_ms",
                                    "floor_ms", "bound_by", "library_ms",
                                    "fwd_bwd_ms") if k in e}
                       for e in entries},
           "seconds": time.perf_counter() - t0}
    emit(out)
    return out, entries


def phase_lm_train(torch, dev, name_limit: str) -> tuple:
    """The flash and SSD backwards against their plain versions, the
    parity runs (qwen2.5-3b, mamba2-370m, zamba2-2.7b), then qwen2.5-3b
    and mamba2-370m trained on the card at full size with their launches
    on ``lm_train_launch_rule``. Returns (phase line, the flash backward's
    kernels entry, the SSD backward's)."""
    t0 = time.perf_counter()
    entry = flash_bwd_entry(torch, dev)
    torch.cuda.empty_cache()
    ssd_entry = ssd_bwd_entry(torch, dev)
    torch.cuda.empty_cache()
    parity = lm_train_parity(
        torch, dev, lm_train_config(n_layers=LM_TRAIN_PARITY_LAYERS,
                                    param_dtype="float32"),
        LM_TRAIN_PARITY_BATCH, LM_TRAIN_PARITY_SEQ)
    torch.cuda.empty_cache()
    ssd_parity = []
    for arch, layers in LM_SSD_PARITY:
        ssd_parity.append(lm_train_parity(
            torch, dev, lm_train_config(arch, n_layers=layers,
                                        param_dtype="float32"),
            LM_SSD_PARITY_BATCH, LM_SSD_PARITY_SEQ))
        torch.cuda.empty_cache()
    train = lm_train_full(torch, dev, lm_train_config(), LM_TRAIN_BATCH,
                          LM_TRAIN_SEQ, LM_SEED + 20,
                          FLASH_BWD_KERNELS)
    ssd_train = lm_train_full(
        torch, dev, lm_train_config(LM_SSD_TRAIN_ARCH), LM_SSD_TRAIN_BATCH,
        LM_SSD_TRAIN_SEQ, LM_SEED + 30,
        ("ssd_bwd_chunk_kernel", "ssd_bwd_scan_kernel", "ssd_bwd_grad_kernel",
         "ssd_bwd_group_kernel", "ssd_bwd_da_kernel"))
    entry["launches"] = train["launches"]["flash_attention_bwd"]
    ssd_entry["launches"] = ssd_train["launches"]["ssd_scan_bwd"]
    out = {"phase": "lm_train", "card": name_limit,
           "kernel_sweep": entry["sweep"]["worst_rel_err"],
           "ssd_bwd_sweep": ssd_entry["sweep"],
           "ssd_bwd": {f"{e['arch']} {e['dtype']}":
                       {k: e[k] for k in ("rel_err", "same_bits", "ms",
                                          "plain_ms", "bound_ms")}
                       for e in ssd_entry["shapes"]},
           "parity": parity, "ssd_parity": ssd_parity,
           "train": train, "ssd_train": ssd_train,
           "seconds": time.perf_counter() - t0}
    emit(out)
    return out, entry, ssd_entry


def per_launch(e: dict) -> None:
    """``ms_per_launch`` and ``bound_per_launch_ms``: one wrapper call's
    time and bound on the entry's path, so that launches × (time − bound)
    reads straight from the line. A per-bin entry divides by its layers;
    flash weighs its prefill and decode calls by their launches."""
    if "prefill_launches" in e:
        pre, n = e["prefill_launches"], max(e["launches"], 1)
        dec = e["decode"]
        e["ms_per_launch"] = (pre * e["ms"] + (n - pre) * dec["ms"]) / n
        e["bound_per_launch_ms"] = (pre * e["bound_ms"]
                                    + (n - pre) * dec["bound_ms"]) / n
    else:
        k = e.get("launches_per_unit", 1)
        e["ms_per_launch"] = e["ms"] / k
        e["bound_per_launch_ms"] = e["bound_ms"] / k


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on an NVIDIA card", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.core.gnn import PMGNSConfig, resolve_device

    dev = resolve_device("cuda")         # also turns TF32 off
    sage_cfg = PMGNSConfig(variant="graphsage", layout="packed",
                           precision="f32")
    gat_cfg = PMGNSConfig(variant="gat", layout="packed", precision="f32")
    name_limit = phase_device(torch)
    phase_build()
    entries = phase_kernels(torch, dev, sage_cfg, gat_cfg)
    launches, _ = phase_path(torch, sage_cfg, name_limit, "main_path")
    gat_launches, gat_dippm = phase_path(torch, gat_cfg, name_limit,
                                         "gat_path")
    phase_serving(torch, gat_dippm, name_limit)
    layouts = phase_engine_layouts(torch, name_limit)
    phase_bf16(torch, name_limit)
    phase_fleet(torch, name_limit)
    train = phase_train(torch, name_limit)
    phase_train_dp(torch, name_limit)
    phase_zoo(torch, name_limit)
    fac = phase_factory(torch, name_limit)
    lm_run = phase_lm(torch, dev, name_limit)
    moe = phase_lm_moe(torch, dev, name_limit)
    vision_audio = phase_lm_vision_audio(torch, dev, name_limit)
    lm_train, bwd_entry, ssd_bwd = phase_lm_train(torch, dev, name_limit)
    _, wide_entries = phase_lm_train_wide(torch, dev, name_limit,
                                          bwd_entry["sweep"])
    phase_accuracy(torch, name_limit)
    entries.extend((bwd_entry, ssd_bwd, *moe["entries"],
                    *vision_audio["entries"], *wide_entries))
    path_launches = {
        "segment_aggregate": train["runs"]["packed"]["launches"],
        "dense_aggregate": train["runs"]["dense"]["launches"],
        "segment_scatter": train["runs"]["gat_packed"]["launches"],
        "segment_gather": train["runs"]["gat_packed"]["launches"],
        "segment_readout_backward": train["runs"]["packed"]["launches"],
        "flash_attention": lm_run["serve"]["launches"],
        "ssd_scan": lm_run["serve"]["launches"],
        "flash_attention_bwd": lm_train["train"]["launches"],
        "ssd_scan_bwd": lm_train["ssd_train"]["launches"],
        **{e["name"]: {e["name"]: e["launches"]}
           for e in (*moe["entries"], *vision_audio["entries"],
                     *wide_entries)},
    }
    for e in entries:
        # each kernel's count from the path that carries it: GraphSAGE
        # for the first two, GAT for the edge softmax and the aggregate,
        # the training run that carries each of the next five (the packed
        # GraphSAGE run for the readout's gradient), the full serving run
        # of lm_path for the LM stack's two, lm_train's full runs for the
        # flash and SSD backwards (and, beside them, the forwards' training
        # launches)
        name = e["name"]
        if name in path_launches:
            e["launches"] = path_launches[name][name]
        else:
            e["launches"] = launches.get(name, gat_launches.get(name))
        if name in SEGMENT_SUMS:
            run = "packed" if name == "segment_aggregate" else "gat_packed"
            e["route_launches"] = train["runs"][run]["route_launches"][name]
        if name in fac["graph_form_checks"]:
            # the factory's comparisons with the graph forms: not counted
            # in ``launches``
            e["graph_form_checks"] = fac["graph_form_checks"][name]
        if name == "flash_attention":
            e["train_launches"] = \
                lm_train["train"]["launches"]["flash_attention"]
        if name == "ssd_scan":
            e["train_launches"] = \
                lm_train["ssd_train"]["launches"]["ssd_scan"]
        if name in layouts["kernels_at_chunk"]:
            # the bucketed engines' full chunk, and their launches there
            e["inference_chunk"] = {
                **layouts["kernels_at_chunk"][name],
                "launches": {run: r["launches"].get(name, 0)
                             for run, r in layouts["runs"].items()}}
        per_launch(e)
    emit({"kernels": entries})
    print(smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
