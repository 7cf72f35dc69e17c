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
   several key splits and with no kept key; ragged chunks, sequences
   shorter than a chunk, an initial state, B/C per group, a d_state whose
   shared memory makes the float32 scan halve its chunk, and the edges of
   the scan's bf16 tensor-core kernel (S < 16, a last chunk that is not a
   multiple of 16, N = 128 at chunk 128, G = 2 with 4 heads, an initial
   state at 100x, steps with dt = 0, N and P not multiples of 8), every
   scan case at the float32 bar in both dtypes. The flash entry also
   carries each flash kernel's ptxas registers and spills, the counts of
   wgmma (HGMMA) and TMA (UTMALDG) instructions in the built library (the
   run fails if either is 0, or if no ptxas report or no ``cuobjdump`` is
   found), the host µs of one decode call, the decode at shapes with more
   and with fewer CTAs than SMs under its split plan, under twice the
   plan's CTAs and under one split, and the same-function yardstick (SDPA's
   is_causal over the kept keys). The scan's entry carries each SSD
   kernel's ptxas registers and spills and the count of ``HMMA`` in its
   library (the run fails at 0), its dynamic shared memory a block and
   blocks an SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; the run
   fails below two at N = P = 64), its device µs by kernel, the float32
   FMA kernel timed on the same values, and, for the record, zamba2 at one
   sequence and mamba2-370m's N = 128 at lm_path's batch. The
   fused_mp_layer entry sweeps both node-phase routes (the tensor-core
   kernel's tile edges, the FMA kernel's odd widths and unaligned view,
   inf and NaN in x, in agg and in the weights), holds the full bin's ``split`` (GraphSAGE) and ``pre``
   (GCN, a [P] self scale) layers, and carries the route taken there, the
   node and edge phases' device µs, its bound at the TF32 and at the FMA
   peak, the ``HGMMA`` count of its library (the run fails at 0) and one
   float32 ``torch.mm`` of the node phase's product as its yardstick. Then
   the kernel's time (a
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
   tensor-core route. The card's predictions are held against the same
   ``DIPPM`` on ``device="cpu"``, which runs the plain versions.
5. ``gat_path`` — the same for GAT at the paper's width: every layer
   launches ``edge_softmax`` and ``fused_gat_aggregate`` once per bin.
6. ``serving`` — ``dippm.serve()`` on the GAT model answers a burst of
   ``submit_json`` requests from 8 threads, unique and repeated documents
   mixed: every future resolves, the counters conserve, cache hits are
   bit-equal to the cold prediction and every answer matches the direct
   engine's; p50/p99 latency and the hit rate are printed.
7. ``train_path`` — ``train_pmgns`` on the card at the paper's Table 3
   settings over 400 synthetic graphs: GraphSAGE on the dense layout and
   on the packed one for 2 epochs each, each against the same run on the
   CPU's plain versions (per-epoch loss, the first step's gradients, the
   final parameters); one dense epoch with dropout 0.05; one packed GAT
   epoch; one sparse GraphSAGE epoch at depth 2. Every run's launch
   counts are zeroed before and must equal ``train_launch_rule`` after.
   It prints ms per step, steps/s and the host share of a step, and
   reloads the trained model through ``save_artifact`` / ``DIPPM.load``
   to hold one served bin against the trainer's own evaluation.
8. ``lm_path`` — the LM stack serving zamba2-2.7b. Parity: at full width
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

Then it prints ``{"kernels": [...]}``, the ``nvidia-smi`` name and power
limit, and, as the last line, ``{"ok": true, "device": {...}}``. Any failed
check raises, so the script exits non-zero and prints no result; it also
exits non-zero without a CUDA device. It imports nothing of JAX.
"""
from __future__ import annotations

import json
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
#: the cold timings (``time_cold_ms``) cycle through copies of a call's
#: inputs and outputs until they hold at least this many bytes, three times
#: the H100's 50 MB L2, so that every call reads and writes device memory
COLD_BYTES = 150e6
#: a bfloat16 kernel against its plain version on the same bfloat16 inputs:
#: both sum in float32, then the output rounds to 8 mantissa bits
KERNEL_BF16_TOL = 2e-2
#: lm_path: the model it serves (full width; LM_SMOKE_WIDTH swaps in the
#: smoke config, for rehearsing the script on the CPU), the full serving run
#: (prompts × prompt length, new tokens; max_len their sum) and the parity
#: run against the CPU (depth, prompts × prompt length, decode steps)
LM_ARCH, LM_SMOKE_WIDTH, LM_SEED = "zamba2-2.7b", False, 0
LM_BATCH, LM_PROMPT, LM_NEW = 8, 512, 64
LM_PARITY_LAYERS, LM_PARITY_BATCH, LM_PARITY_PROMPT, LM_PARITY_STEPS = (
    12, 2, 128, 16)


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


def sweep_readout(torch, dev) -> float:
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_spmm import segment_readout_cuda
    worst = 0.0
    rng = np.random.default_rng(7)
    cases = []
    for kind in ("mean", "mean_max"):
        # contiguous runs, padded tail with id 0, trailing empty graphs
        cases.append((kind, 300, 16, 12, "runs"))
        cases.append((kind, 130, 130, 8, "runs"))
        # ids in no order, some rows masked
        cases.append((kind, 257, 40, 9, "random"))
        # a bin with every row masked
        cases.append((kind, 64, 8, 4, "empty"))
    for kind, p, f, g, layout in cases:
        h = rng.standard_normal((p, f)).astype(np.float32)
        if layout == "runs":
            n_real = p * 3 // 4
            ids = np.zeros(p, np.int32)
            ids[:n_real] = np.sort(rng.integers(0, g - 3, n_real))
            nm = np.zeros(p, np.float32)
            nm[:n_real] = 1.0
            h[n_real:] = 1e6            # padding garbage must not leak
        elif layout == "random":
            ids = rng.integers(0, g, p).astype(np.int32)
            nm = (rng.random(p) < 0.8).astype(np.float32)
        else:
            ids = np.zeros(p, np.int32)
            nm = np.zeros(p, np.float32)
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        got = segment_readout_cuda(t(h), t(ids), t(nm), g, kind=kind)
        want = ref.segment_readout_ref(t(h), t(ids), t(nm), g, kind=kind)
        torch.cuda.synchronize()
        worst = max(worst, check_close(
            f"segment_readout {kind} p={p} f={f} g={g} {layout}", got, want,
            KERNEL_ATOL, KERNEL_RTOL))
    return worst


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


def sweep_edge_softmax(torch, dev) -> float:
    """edge_softmax_cuda against its plain version: E in {129, 256, 0},
    H in {1, 4, 8}, B in {1, 2}, then an all-masked bin, a fully masked
    destination, a padded edge scoring 1e30 and a NaN score."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_spmm import edge_softmax_cuda
    worst = 0.0
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    n = 40
    for i, (b, e, h) in enumerate((b, e, h) for b in (1, 2)
                                  for e in (129, 256, 0) for h in (1, 4, 8)):
        rng = np.random.default_rng(i)
        s = rng.standard_normal((b, e, h)).astype(np.float32) * 3
        dst = rng.integers(0, n, (b, e)).astype(np.int32)
        em = (rng.random((b, e)) < 0.8).astype(np.float32)
        got = edge_softmax_cuda(t(s), t(dst), t(em), n)
        want = ref.edge_softmax_ref(t(s), t(dst), t(em), n)
        torch.cuda.synchronize()
        worst = max(worst, check_close(f"edge_softmax b={b} e={e} h={h}",
                                       got, want, KERNEL_ATOL, KERNEL_RTOL))
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
    for name, (s, dst, em, nodes) in fixed.items():
        got = edge_softmax_cuda(t(s), t(dst), t(em), nodes)
        want = ref.edge_softmax_ref(t(s), t(dst), t(em), nodes)
        torch.cuda.synchronize()
        worst = max(worst, check_close(f"edge_softmax {name}", got, want,
                                       KERNEL_ATOL, KERNEL_RTOL))
        if not bool((got[t(em) == 0] == 0).all()):
            raise AssertionError(f"edge_softmax {name}: a masked edge is "
                                 f"not exactly 0")
    s, dst, em, nodes = fixed["fully masked destination"]
    s = s.copy()
    s[0, 1, 0] = np.nan
    got = edge_softmax_cuda(t(s), t(dst), t(em), nodes)
    want = ref.edge_softmax_ref(t(s), t(dst), t(em), nodes)
    torch.cuda.synchronize()
    worst = max(worst, check_close_nan("edge_softmax NaN score", got, want,
                                       KERNEL_ATOL, KERNEL_RTOL))
    if np.isfinite(got[0, :4, 0].cpu().numpy()).any():
        raise AssertionError("edge_softmax: a NaN score left its "
                             "destination finite")
    return worst


def sweep_gat_aggregate(torch, dev) -> float:
    """fused_gat_aggregate_cuda against its plain version at (P, Q, H) in
    {(64, 96, 4), (130, 257, 2), (4096, 6656, 4), (64, 0, 4)}."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_spmm import fused_gat_aggregate_cuda
    worst = 0.0
    for p, q, h in ((64, 96, 4), (130, 257, 2), (FULL_P, FULL_Q, 4),
                    (64, 0, 4)):
        rng = np.random.default_rng(p + q)
        d = 512 if p == FULL_P else 16
        arrays = (rng.standard_normal((p, d)).astype(np.float32),
                  (rng.integers(0, p, (q, 2)).astype(np.int32) if q
                   else np.zeros((0, 2), np.int32)),
                  (rng.random(q) < 0.8).astype(np.float32),
                  rng.random((q, h)).astype(np.float32),
                  (rng.random(p) < 0.9).astype(np.float32))
        t = [torch.as_tensor(a, device=dev) for a in arrays]
        got = fused_gat_aggregate_cuda(*t)
        want = ref.fused_gat_aggregate_ref(*t)
        torch.cuda.synchronize()
        worst = max(worst, check_close(f"fused_gat_aggregate p={p} q={q} "
                                       f"h={h}", got, want, KERNEL_ATOL,
                                       KERNEL_RTOL))
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


def sweep_segment(torch, dev) -> dict:
    """segment_aggregate_cuda, segment_scatter_cuda and segment_gather_cuda
    against their plain versions: B in {1, 3}, E in {0, 1, 129, 300}, N
    and F off the tile sizes, sum and mean, weighted masks, self-loops,
    duplicates, padded and isolated rows, then NaN in a masked row."""
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
    return worst


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


def sage_kernel_entries(torch, dev, cfg) -> tuple:
    """fused_mp_layer and segment_readout at the GraphSAGE full bin, and
    fused_mp_layer's ``pre`` combine there, GCN-style (sum, edge weights,
    a [P] self scale)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_spmm import (fused_mp_layer_cuda,
                                                  segment_readout_cuda)
    sweep_mp = sweep_fused(torch, dev)
    sweep_ro = sweep_readout(torch, dev)
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
    z_r = ref.segment_readout_ref(h1_r, gid, nm, FULL_G, kind=cfg.readout)
    torch.cuda.synchronize()
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
    breakdown = device_breakdown_us(torch, {
        "fused_mp_layer F=32": lambda: layer(fused_mp_layer_cuda, x, 0),
        "fused_mp_layer F=512": lambda: layer(fused_mp_layer_cuda, h0_r, 1),
        "fused_mp_layer pre F=512": lambda: pre_layer(fused_mp_layer_cuda,
                                                      h0_r),
        "segment_readout": lambda: segment_readout_cuda(
            h1_r, gid, nm, FULL_G, kind=cfg.readout)})
    t_ro_plain = time_graph_ms(torch, lambda: ref.segment_readout_ref(
        h1_r, gid, nm, FULL_G, kind=cfg.readout))
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
    ro_flops = 3.0 * p_real * H + 2.0 * FULL_G * H
    ro_bytes = 4.0 * (P * H + 2 * P + FULL_G * 2 * H)
    ro_bound, ro_by = bound_ms(ro_flops, ro_bytes)
    blocks = cfg.n_gnn_blocks

    def per_bin(key):
        return t_mp["f32"][key] + (blocks - 1) * t_mp["f512"][key]
    entries = [
        {"name": "fused_mp_layer", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_mp.cu",
         "replaces": "src/repro/kernels/segment_spmm.py:370",
         "launches": None, "max_abs_err": max(err_mp, sweep_mp),
         "ms": per_bin("ms"), "plain_ms": per_bin("plain_ms"),
         "bound_ms": mp_bound, "bound_by": mp_by,
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
         "ms": t_ro, "plain_ms": t_ro_plain, "bound_ms": ro_bound,
         "bound_by": ro_by, "library_ms": None,
         "unit": f"one full bin: P={P} F={H} G={FULL_G} {cfg.readout}",
         "library_note": "no single PyTorch call computes the masked "
                         "segment mean and max with empty graphs at 0"},
    ]
    info = {"graphs_in_full_bin": n_graphs, "real_nodes": p_real,
            "real_edges": q_real,
            "sweep_max_abs_err": {"fused_mp_layer": sweep_mp,
                                  "segment_readout": sweep_ro}}
    return entries, breakdown, info


def gat_kernel_entries(torch, dev, cfg) -> tuple:
    """edge_softmax and fused_gat_aggregate at the GAT full bin: the first
    layer's projection, scores and attention, as ``_fused_mp_stack``
    computes them."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_spmm import (edge_softmax_cuda,
                                                  fused_gat_aggregate_cuda)
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

    att_k = edge_softmax_cuda(s, d32, em1, P)
    att_r = ref.edge_softmax_ref(s, d32, em1, P)
    out_k = fused_gat_aggregate_cuda(z, edges, em, att_r[0], nm)
    out_r = ref.fused_gat_aggregate_ref(z, edges, em, att_r[0], nm)
    torch.cuda.synchronize()
    err_sm = check_close("edge_softmax full bin", att_k, att_r,
                         KERNEL_ATOL, KERNEL_RTOL)
    err_ga = check_close("fused_gat_aggregate full bin", out_k, out_r,
                         KERNEL_ATOL, KERNEL_RTOL)
    att = att_r[0].contiguous()
    calls = {
        "edge_softmax": (lambda: edge_softmax_cuda(s, d32, em1, P),
                         lambda: ref.edge_softmax_ref(s, d32, em1, P)),
        "fused_gat_aggregate": (
            lambda: fused_gat_aggregate_cuda(z, edges, em, att, nm),
            lambda: ref.fused_gat_aggregate_ref(z, edges, em, att, nm)),
    }
    times = {k: {"ms": time_graph_ms(torch, kern),
                 "plain_ms": time_graph_ms(torch, plain)}
             for k, (kern, plain) in calls.items()}
    breakdown = device_breakdown_us(torch, {k: kern for k, (kern, _)
                                            in calls.items()})
    # each input read once, each output written once; the operations this
    # run's real edges need: max, subtract, exp, scale, add and divide per
    # (edge, head); a product, two scalings and an add per (edge, feature)
    sm_bound, sm_by = bound_ms(6.0 * q_real * heads,
                               4.0 * (2 * Q * heads + 2 * Q))
    ga_bound, ga_by = bound_ms(4.0 * q_real * D,
                               4.0 * (2 * P * D + 3 * Q + Q * heads + P))
    blocks = cfg.n_gnn_blocks
    entries = [
        {"name": "edge_softmax", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/edge_softmax.cu",
         "replaces": "src/repro/kernels/segment_spmm.py:622",
         "launches": None, "max_abs_err": max(err_sm, sweep_sm),
         "ms": times["edge_softmax"]["ms"] * blocks,
         "plain_ms": times["edge_softmax"]["plain_ms"] * blocks,
         "bound_ms": sm_bound * blocks, "bound_by": sm_by,
         "library_ms": None,
         "unit": f"one full bin: {blocks} GAT layers, each B=1 E={Q} "
                 f"H={heads} N={P}",
         "per_layer": times["edge_softmax"], "bound_per_layer_ms": sm_bound,
         "library_note": "no single PyTorch call computes a segment "
                         "softmax over a destination index"},
        {"name": "fused_gat_aggregate", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gat_aggregate.cu",
         "replaces": "src/repro/kernels/segment_spmm.py:503",
         "launches": None, "max_abs_err": max(err_ga, sweep_ga),
         "ms": times["fused_gat_aggregate"]["ms"] * blocks,
         "plain_ms": times["fused_gat_aggregate"]["plain_ms"] * blocks,
         "bound_ms": ga_bound * blocks, "bound_by": ga_by,
         "library_ms": None,
         "unit": f"one full bin: {blocks} GAT layers, each P={P} Q={Q} "
                 f"D={D} H={heads}",
         "per_layer": times["fused_gat_aggregate"],
         "bound_per_layer_ms": ga_bound,
         "library_note": "no single PyTorch call computes the per-head "
                         "gather ⊙ attention → masked scatter"},
    ]
    info = {"gat_real_edges": q_real,
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
    from repro_torch.kernels.segment_spmm import (segment_aggregate_cuda,
                                                  segment_gather_cuda,
                                                  segment_scatter_cuda)
    sweep = sweep_segment(torch, dev)
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
        "segment_scatter": (
            lambda: segment_scatter_cuda(dst, em, msgs, p_nodes),
            lambda: ref.segment_scatter_ref(dst, em, msgs, p_nodes)),
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
    h2 = h[0]
    src_flat = src.reshape(-1).long()
    library = {
        "segment_scatter": time_graph_ms(torch, lambda: torch.zeros(
            (p_nodes, hid), device=dev).index_add_(0, flat_dst, weighted)),
        "segment_gather": time_graph_ms(
            torch, lambda: torch.index_select(h2, 0, src_flat)),
        "dense_aggregate_sum": time_graph_ms(torch,
                                             lambda: torch.bmm(adj, hd)),
    }
    us = device_breakdown_us(torch, {k: v[0] for k, v in pairs.items()})

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
    dense_strips = dense_strip_timings(torch, dev, b, n, hid)

    # bounds: each input read once, each output written once; the
    # operations this run's data needs (real edges; the adjacency's
    # nonzeros, which the dense product does not skip)
    bounds = {
        "segment_aggregate": bound_ms(
            2.0 * q_real * hid + p_nodes * hid,
            4.0 * (2 * p_nodes * hid + 3 * q + p_nodes)),
        "segment_scatter": bound_ms(
            2.0 * q_real * hid, 4.0 * (q * hid + 2 * q + p_nodes * hid)),
        "segment_gather": bound_ms(0.0, 4.0 * (p_nodes * hid + q
                                              + q * hid)),
        "dense_aggregate": bound_ms(
            2.0 * nnz * hid + b * n * hid + b * n * n,
            4.0 * (b * n * n + 2 * b * n * hid)),
    }
    src_root = "src/repro_torch/kernels/csrc/"
    shapes_p = f"B=1 N={p_nodes} E={q} ({q_real} real) F={hid}"
    entries = [
        {"name": "segment_aggregate", "route": "cuda",
         "source": src_root + "segment_aggregate.cu",
         "replaces": "src/repro/kernels/segment_spmm.py:125",
         "launches": None,
         "max_abs_err": max(err["segment_aggregate"],
                            sweep["segment_aggregate"],
                            back.get("segment_aggregate", 0.0)),
         **times["segment_aggregate"],
         "bound_ms": bounds["segment_aggregate"][0],
         "bound_by": bounds["segment_aggregate"][1], "library_ms": None,
         "unit": f"one packed training layer, mean: {shapes_p}",
         "library_note": "no single PyTorch call gathers, weights, "
                         "scatters and divides by the weighted degree"},
        {"name": "segment_scatter", "route": "cuda",
         "source": src_root + "segment_aggregate.cu",
         "replaces": "src/repro/kernels/segment_spmm.py:177",
         "launches": None,
         "max_abs_err": max(err["segment_scatter"], sweep["segment_scatter"],
                            back.get("segment_scatter", 0.0)),
         **times["segment_scatter"],
         "bound_ms": bounds["segment_scatter"][0],
         "bound_by": bounds["segment_scatter"][1],
         "library_ms": library["segment_scatter"],
         "unit": f"one packed GAT layer's scatter: {shapes_p}",
         "library_note": "index_add_ of the pre-weighted messages into a "
                         "fresh zero tensor, flattened"},
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


def phase_kernels(torch, dev, sage_cfg, gat_cfg) -> list:
    t0 = time.perf_counter()
    sage, sage_us, sage_info = sage_kernel_entries(torch, dev, sage_cfg)
    gat, gat_us, gat_info = gat_kernel_entries(torch, dev, gat_cfg)
    train, train_info = train_kernel_entries(torch, dev)
    lm_entries, lm_info = lm_kernel_entries(torch, dev)
    back = train_info["backward_max_abs_err"]
    for e in sage + gat:
        # the backward passes of the readout and the edge softmax
        e["max_abs_err"] = max(e["max_abs_err"], back.get(e["name"], 0.0))
    entries = sage + gat + train + lm_entries
    emit({"phase": "kernels", "seconds": round(time.perf_counter() - t0, 3),
          **sage_info, "gat_real_edges": gat_info["gat_real_edges"],
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
    per bin (per layer, or once)."""
    from repro_torch.kernels import segment_spmm as k
    per_layer = {"graphsage": ["fused_mp_layer_cuda"],
                 "gat": ["edge_softmax_cuda", "fused_gat_aggregate_cuda"]}
    out = {name.removesuffix("_cuda"): (getattr(k, name), "layer")
           for name in per_layer[variant]}
    out["segment_readout"] = (k.segment_readout_cuda, "bin")
    return out


def phase_path(torch, cfg, name_limit: str, phase: str) -> tuple:
    """Drive one variant's main path on the card and hold it against the
    CPU; returns the launch counts and the card's ``DIPPM``."""
    from repro_torch.core import DIPPM, from_json, pmgns_init
    from repro_torch.dataset.builder import synthetic_samples
    rng = np.random.default_rng(11)
    sizes = [20, 75, 160, 333, 512, 800]
    docs = [random_dag_doc(rng, n, i) for i, n in enumerate(sizes)]
    graphs = [from_json(d) for d in docs]
    samples = synthetic_samples(400, seed=1, n_min=16, n_max=200)
    tree = pmgns_init(0, cfg)
    dippm = DIPPM.from_params(tree, cfg)          # on the card by default
    if dippm.device.type != "cuda":
        raise AssertionError(f"DIPPM ran on {dippm.device}")
    engine = dippm.engine()
    kernels = path_kernels(cfg.variant)

    for fn, _ in kernels.values():
        fn.launches = 0
    fused = kernels.get("fused_mp_layer", (None,))[0]
    if fused is not None:
        fused.route_launches = dict.fromkeys(fused.route_launches, 0)
    t0 = time.perf_counter()
    warmed = engine.warmup(rungs="all")
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    one = dippm.predict_json(docs[0])
    many, _ = dippm.predict_many(graphs, return_stats=True)
    bins_before = engine.stats.batches_run
    bulk_s = []
    for _ in range(BULK_REPEATS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ys = engine.predict_samples(samples)
        torch.cuda.synchronize()
        bulk_s.append(time.perf_counter() - t1)
    t_bulk = statistics.median(bulk_s)
    launches = {name: fn.launches for name, (fn, _) in kernels.items()}
    routes = dict(fused.route_launches) if fused is not None else None
    stats = engine.stats.snapshot()
    bulk_bins = (stats.batches_run - bins_before) // BULK_REPEATS

    runs = stats.batches_run + warmed
    want = {name: runs * (cfg.n_gnn_blocks if per == "layer" else 1)
            for name, (_, per) in kernels.items()}
    if launches != want or min(launches.values()) <= 0:
        raise AssertionError(f"{phase}: launch counts {launches} != bins x "
                             f"layers {want} ({stats.batches_run} bins + "
                             f"{warmed} warmup shapes)")
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


def phase_serving(torch, dippm, name_limit: str) -> dict:
    """A burst of submit_json requests from many threads through a
    dedicated service on the card."""
    from repro_torch.core import from_json
    rng = np.random.default_rng(23)
    shared = [random_dag_doc(rng, int(rng.integers(10, 300)), i)
              for i in range(SERVE_SHARED)]
    own = [[random_dag_doc(rng, int(rng.integers(10, 300)),
                           1000 * (t + 1) + j)
            for j in range(SERVE_PER_THREAD // 2)]
           for t in range(SERVE_THREADS)]
    # the same fingerprint always gets the same key: its index in `docs`
    docs = shared + [d for ds in own for d in ds]
    direct = dippm.engine().predict_graphs([from_json(d) for d in docs])
    kernels = path_kernels(dippm.cfg.variant)
    results = [[] for _ in range(SERVE_THREADS)]
    errors = []
    with dippm.serve(max_wait_ms=2.0) as svc:
        svc.warmup()
        torch.cuda.synchronize()
        for fn, _ in kernels.values():
            fn.launches = 0
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
           "launches": launches,
           "vs_direct_engine": {"max_abs_err": err,
                                "atol": E2E_ATOL, "rtol": E2E_RTOL}}
    emit(out)
    return out


#: every wrapper, so a training run can show it launched none it should not
TRAIN_WRAPPERS = ("segment_aggregate", "segment_scatter", "segment_gather",
                  "dense_aggregate", "segment_readout", "edge_softmax",
                  "fused_mp_layer", "fused_gat_aggregate")


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
      scatters and ``L`` softmaxes a step.
    * The packed readout: once forward; backward one gather of the max
      (mean⊕max), one scatter of the counts and ties, one gather of the
      per-graph gradient.
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
    else:
        raise ValueError(f"no launch rule for {cfg.variant} on {layout}")
    if layout == "packed":
        want["segment_readout"] += steps
        want["segment_gather"] += steps * (
            2 if cfg.readout == "mean_max" else 1)
        want["segment_scatter"] += steps
    return want


def device_busy_ms(torch, fn) -> tuple:
    """Device milliseconds of every kernel and copy that ``fn()`` runs,
    from ``torch.profiler``, and the ten largest by kernel name; 0.0
    and {} where it recorded no device time."""
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
    top = dict(sorted(rows.items(), key=lambda kv: -kv[1])[:10])
    return sum(rows.values()), top


def train_run(torch, cfg, samples, epochs: int, phase: str,
              compare_cpu: bool) -> dict:
    """``train_pmgns`` on the card (``device=None``) with the launch
    counts zeroed before and checked after; optionally the same run on
    the CPU's plain versions, held to the trainer's parity bar."""
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.train.gnn_trainer import TrainConfig, train_pmgns
    tcfg = TrainConfig(epochs=epochs, batch_size=TRAIN_BATCH, lr=TRAIN_LR,
                       seed=0)
    for name in TRAIN_WRAPPERS:
        wrapper(name).launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, hist = train_pmgns(cfg, samples, (), tcfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: wrapper(n).launches for n in TRAIN_WRAPPERS}
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
           "wall_s": wall, "launches": launches,
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


def step_grads_vs_cpu(torch, cfg, samples, phase: str) -> tuple:
    """The first training step's gradients on the card against the CPU's,
    from the trainer's initial tree and its first batch; returns the
    comparison and the CPU's gradients (numpy, one per leaf)."""
    from repro_torch.core.batching import stack_epoch_segments
    from repro_torch.core import gnn
    from repro_torch.train import gnn_trainer as gt
    seg = stack_epoch_segments(samples, TRAIN_BATCH, rng=gt._epoch_rng(0, 0),
                               layout=cfg.resolved_layout)[0]
    batch = {k: v[0] for k, v in seg.items()}
    mean, std = gt._target_stats(samples)
    grads = []
    for d in (gnn.resolve_device(None), torch.device("cpu")):
        model = gnn.params_from_numpy(gnn.pmgns_init(0, cfg), cfg, d,
                                      requires_grad=True)
        t = lambda a: torch.as_tensor(a, device=d)  # noqa: E731
        wl, wn = gt._loss_terms(model.tree(), cfg,
                                {k: t(v) for k, v in batch.items()}, None,
                                1.0, t(mean), t(std))
        grads.append([g.cpu().numpy() for g in torch.autograd.grad(
            wl / wn, gt.tree_leaves(model.tree()))])
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


def build_facts(source: str, opcodes: tuple) -> dict:
    """What ptxas reports for each kernel of ``csrc/<source>.cu``, and the
    count of each SASS opcode of ``opcodes`` in its built library; the run
    fails if there is no ptxas report, no ``cuobjdump`` or a count of 0
    (flash: ``HGMMA`` and ``UTMALDG``, or its bf16 prefill is not on wgmma
    and TMA; the SSD scan: ``HMMA``, or its bf16 path is not on the tensor
    cores; fused_mp: ``HGMMA``, or its node phase is not on wgmma)."""
    from repro_torch.kernels import build
    facts = {"ptxas": ptxas_by_kernel(build.build_log(source))}
    if not facts["ptxas"]:
        raise AssertionError(f"{source}: the build log holds no ptxas "
                             f"report (-Xptxas -v)")
    tool = cuobjdump_path()
    if tool is None:
        raise AssertionError(f"{source}: no cuobjdump found on PATH, beside "
                             f"nvcc or in Triton's package, so the SASS "
                             f"cannot be counted")
    sass = subprocess.run(
        [tool, "-sass", str(build.build_dir() / f"lib{source}.so")],
        check=True, capture_output=True, text=True).stdout
    counts = {op: len(re.findall(r"\b" + op + r"\b", sass))
              for op in opcodes}
    if not all(counts.values()):
        raise AssertionError(f"{source}: SASS counts {counts}: its "
                             f"tensor-core path is not on the instructions "
                             f"it was built for")
    facts["sass"] = counts
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
         "build": build_facts("flash_attention", ("HGMMA", "UTMALDG")),
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
    attention block per step (the prefill and every decode step), the SSD
    scan once per Mamba2 layer at prefill only (a one-token step takes
    the plain decode update)."""
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
    train = phase_train(torch, name_limit)
    lm_run = phase_lm(torch, dev, name_limit)
    path_launches = {
        "segment_aggregate": train["runs"]["packed"]["launches"],
        "dense_aggregate": train["runs"]["dense"]["launches"],
        "segment_scatter": train["runs"]["gat_packed"]["launches"],
        "segment_gather": train["runs"]["gat_packed"]["launches"],
        "flash_attention": lm_run["serve"]["launches"],
        "ssd_scan": lm_run["serve"]["launches"],
    }
    for e in entries:
        # each kernel's count from the path that carries it: GraphSAGE
        # for the first two, GAT for the edge softmax and the aggregate,
        # the training run that carries each of the next four, the full
        # serving run of lm_path for the LM stack's two
        name = e["name"]
        if name in path_launches:
            e["launches"] = path_launches[name][name]
        else:
            e["launches"] = launches.get(name, gat_launches.get(name))
    emit({"kernels": entries})
    print(smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
