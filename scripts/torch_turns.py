#!/usr/bin/env python3
"""Times of two checkouts of the PyTorch port on one NVIDIA card, measured
in turns (A, B, B, A, ...).

    python3 scripts/torch_turns.py BODY PARENT_DIR THIS_DIR [--pairs N]
        [--variants graphsage,gat]

Each turn is a fresh process that imports ``repro_torch`` from the given
checkout's ``src`` (and ``chip_smoke.py``'s helpers from this script's
checkout, so both turns run the same inputs), builds its kernels and runs
one BODY:

* ``bulk`` — ``DIPPM.from_params`` at the paper's width (random weights,
  seed 0) per variant, the packed rung ladder warmed, and
  ``engine().predict_samples`` over 400 seeded synthetic graphs seven
  times: ms per full bin of every sweep and their median. A variant the
  checkout does not run is reported as its error.
* ``lm`` — ``chip_smoke.lm_serving_batch``: zamba2-2.7b at full width and
  depth in bf16, 8 prompts × 512 seeded tokens through the prefill and 63
  serve steps. After one warm-up batch, three batches: each one's prefill
  ms (host clock around work that ends in ``torch.cuda.synchronize()``)
  and decode ms per step, and their medians; then one more batch whose
  decode steps are timed one by one, each ending in
  ``torch.cuda.synchronize()``: the median and quartiles of its steps.
* ``lm_host`` — ``lm``'s batch warmed, then 16 decode steps under
  ``torch.profiler`` (host and card): wall ms per step, and per step the
  host's self ms and call count of every operator and CUDA runtime call,
  the ten largest by self time listed, and the card's busy ms.
* ``train`` — ``train_pmgns`` per variant on the packed layout at
  ``chip_smoke.py``'s train_path settings (hidden 512, batch 32, 400
  seeded synthetic graphs): one warm-up epoch, one timed epoch (wall ms
  per step from the trainer's own clock) and one epoch under
  ``torch.profiler``: the card's busy ms per step and every kernel's
  device ms per step above 0.005.
* ``flash_host`` — the host µs of one ``flash_attention_cuda`` decode call
  at lm_path's last decode step (``chip_smoke.host_us_per_call``), and the
  card's time of the same call (``chip_smoke.time_graph_ms``).
* ``factory`` — the ``factory`` phase of the turn's own checkout's
  ``chip_smoke.py`` (its plan, its checks): the phase's seconds, the
  build's, the records, whether the shards are the JAX package's bytes,
  the LM entries' trace ms, and each graph-form check's error (B8, B9,
  and the MoE block where the checkout has it).

* ``flash_bwd`` — the flash backward (``flash_attention_bwd_cuda``) at
  the four bf16 shapes of ``chip_smoke.py``'s ``kernels`` entries
  (qwen2.5-3b's training shape, and ``WIDE_FLASH``'s MLA, cross and
  encoder shapes), seeded inputs: its ms (CUDA events around eager
  calls), its device µs by kernel under ``torch.profiler``, this port's
  forward with lse + backward, and ``scaled_dot_product_attention``
  forward + backward on the same inputs (the same library call in both
  turns: a check on the card's drift between turns).
* ``lm_train`` — ``chip_smoke.lm_train_full`` for qwen2.5-3b and
  mamba2-370m at ``lm_train``'s full size and for ``WIDE_TRAIN``'s
  deepseek-v2, llama-3.2-vision and hubert-xlarge (bf16,
  ``default_optimizer()``, remat): ms a step, tokens/s, peak memory,
  the card's busy ms and the flash backward's device ms in the profiled
  step.

It prints one JSON line per turn. ``--pairs N`` runs N rounds of parent,
this, this, parent. Two versions are compared only within one run of this
script, on one card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def body_bulk(torch, variants: str) -> dict:
    from repro_torch.core import DIPPM, PMGNSConfig, pmgns_init
    from repro_torch.dataset.builder import synthetic_samples
    out = {}
    samples = synthetic_samples(400, seed=1, n_min=16, n_max=200)
    for variant in variants.split(","):
        try:
            cfg = PMGNSConfig(variant=variant, layout="packed")
            eng = DIPPM.from_params(pmgns_init(0, cfg), cfg).engine()
        except (NotImplementedError, ValueError) as e:
            out[variant] = {"error": str(e)}
            continue
        eng.warmup(rungs="all")
        bins = len(eng.plan_bins(samples))
        ms = []
        for _ in range(7):
            torch.cuda.synchronize()
            t = time.perf_counter()
            eng.predict_samples(samples)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t) / bins)
        out[variant] = {"bins": bins, "ms_per_bin": ms,
                        "median": statistics.median(ms)}
    return out


def body_lm(torch, _variants: str) -> dict:
    import chip_smoke as cs
    _, params, prompts, prefill, serve = cs.lm_serving_batch(torch, "cuda")

    def batch(steps=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, {"tokens": prompts})
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        idx = cs.LM_PROMPT
        for _ in range(cs.LM_NEW - 1):
            ts = time.perf_counter()
            tok, cache, idx = serve(params, cache, {"tokens": tok[:, None]},
                                    idx)
            if steps is not None:
                torch.cuda.synchronize()
                steps.append(1e3 * (time.perf_counter() - ts))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return 1e3 * (t1 - t0), 1e3 * (t2 - t1) / (cs.LM_NEW - 1)

    batch()
    runs = [batch() for _ in range(3)]
    steps = []
    batch(steps)
    pre, dec = [r[0] for r in runs], [r[1] for r in runs]
    q1, q2, q3 = statistics.quantiles(steps, n=4)
    return {"prefill_ms": pre, "decode_ms_per_step": dec,
            "prefill_median": statistics.median(pre),
            "decode_median": statistics.median(dec),
            "synced_step_ms": {"q1": q1, "median": q2, "q3": q3}}


def body_lm_host(torch, _variants: str) -> dict:
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    _, params, prompts, prefill, serve = cs.lm_serving_batch(torch, "cuda")
    steps = 16
    logits, cache = prefill(params, {"tokens": prompts})
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    idx = cs.LM_PROMPT
    for _ in range(8):                                    # warm up
        tok, cache, idx = serve(params, cache, {"tokens": tok[:, None]}, idx)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            tok, cache, idx = serve(params, cache, {"tokens": tok[:, None]},
                                    idx)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t) / steps
    host, calls, card = {}, 0, 0.0
    for evt in prof.key_averages():
        card += getattr(evt, "self_device_time_total", 0.0)
        if evt.self_cpu_time_total > 0:
            host[evt.key] = (evt.self_cpu_time_total / 1e3 / steps,
                             evt.count / steps)
            calls += evt.count
    top = sorted(host.items(), key=lambda kv: -kv[1][0])[:10]
    return {"wall_ms_per_step_profiled": wall,
            "host_self_ms_per_step": sum(v[0] for v in host.values()),
            "host_calls_per_step": calls / steps,
            "card_busy_ms_per_step": card / 1e3 / steps,
            "top_host_self_ms_per_step": {k: {"ms": v[0], "calls": v[1]}
                                          for k, v in top}}


def body_flash_host(torch, _variants: str) -> dict:
    import numpy as np

    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    cfg = cs.lm_config(param_dtype="bfloat16")
    b, t_max = cs.LM_BATCH, cs.LM_PROMPT + cs.LM_NEW
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    rng = np.random.default_rng(7000)
    q, k, v = (torch.as_tensor(rng.standard_normal(s).astype(np.float32),
                               device="cuda").to(torch.bfloat16)
               for s in ((b, 1, h, d), (b, t_max, hkv, d), (b, t_max, hkv, d)))

    def call():
        return flash_attention_cuda(q, k, v, causal=True,
                                    q_offset=t_max - 1)

    return {"unit": f"q [{b}, 1, {h}, {d}] over k/v [{b}, {t_max}, {hkv}, "
                    f"{d}] bf16",
            "host_us_per_call": cs.host_us_per_call(torch, call),
            "device_ms": cs.time_graph_ms(torch, call)}


def body_train(torch, variants: str) -> dict:
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.core.gnn import PMGNSConfig
    from repro_torch.dataset.builder import synthetic_samples
    from repro_torch.train.gnn_trainer import TrainConfig, train_pmgns
    samples = synthetic_samples(cs.TRAIN_SAMPLES, seed=1, n_min=16,
                                n_max=200)
    one = TrainConfig(epochs=1, batch_size=cs.TRAIN_BATCH, lr=cs.TRAIN_LR)
    out = {}
    for variant in variants.split(","):
        cfg = PMGNSConfig(variant=variant, hidden=cs.TRAIN_HIDDEN,
                          layout="packed", dropout=0.0)
        train_pmgns(cfg, samples, (), one)               # warm-up
        _, hist = train_pmgns(cfg, samples, (), one)
        steps = hist[-1]["steps"]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            train_pmgns(cfg, samples, (), one)
            torch.cuda.synchronize()
        rows = {}
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", 0.0)
            if t > 0 and not e.key.startswith("cuda"):
                name = cs.kernel_name(e.key)
                rows[name] = rows.get(name, 0.0) + t / 1e3 / steps
        out[variant] = {
            "steps": steps,
            "ms_per_step": 1e3 * hist[-1]["seconds"] / steps,
            "card_busy_ms_per_step": sum(rows.values()),
            "kernel_ms_per_step": {k: v for k, v in sorted(
                rows.items(), key=lambda kv: -kv[1]) if v > 0.005}}
    return out


def body_factory(torch, _variants: str) -> dict:
    import contextlib
    import importlib.util
    import io

    import repro_torch
    from repro_torch.core.gnn import resolve_device
    tree = Path(repro_torch.__file__).resolve().parents[2]
    spec = importlib.util.spec_from_file_location("chip_smoke_turn",
                                                  tree / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    resolve_device("cuda")                 # TF32 off, as chip_smoke runs
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out = cs.phase_factory(torch, cs.smi())
    checks = out["graph_form_checks"]
    return {
        "seconds": time.perf_counter() - t, "build_s": out["build_s"],
        "records": out["records"], "plan_hash": out["plan_hash"],
        "reference_sha256_equal": out["reference_sha256_equal"],
        "lm_trace_ms": out["trace_ms"]["lm"],
        "zoo_trace_median_ms": out["trace_ms"]["zoo_median_ms"],
        "flash": {"launches": checks["flash_attention"]["launches"],
                  "cases": [(c["arch"], c.get("q"), c.get("v", c.get("kv")),
                             c["max_rel_err"])
                            for c in checks["flash_attention"]["cases"]]},
        "ssd": [(c["arch"], c["y"]["max_rel_err"],
                 c["last_state"]["max_rel_err"])
                for c in checks["ssd_scan"]["cases"]],
        "moe": [(c["arch"], c["capacity_factor"], c["dropped"],
                 c["y"]["max_rel_err"], c["aux"]["max_rel_err"])
                for c in out.get("moe_graph_form_checks",
                                 {}).get("cases", [])]}


def body_flash_bwd(torch, _variants: str) -> dict:
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    cfg = cs.lm_train_config()
    b, s = cs.LM_TRAIN_BATCH, cs.LM_TRAIN_SEQ
    rows = [("flash_attention_bwd", (b, s, s, cfg.n_heads, cfg.n_kv_heads,
                                     cfg.resolved_head_dim,
                                     cfg.resolved_head_dim, True, 0, 0, 0))]
    rows += [(n, c) for n, _, c in cs.WIDE_FLASH if "bwd" in n]
    out = {}
    for i, (name, case) in enumerate(rows):
        kw = cs.bwd_kw(case)
        q, k, v, g = cs.bwd_inputs(torch, "cuda", case, torch.bfloat16,
                                   6300 + i)
        o, lse = flash_attention_cuda(q, k, v, with_lse=True, **kw)

        def kern():
            return flash_attention_bwd_cuda(q, k, v, o, lse, g, **kw)

        def fwd_bwd():
            return flash_attention_bwd_cuda(
                q, k, v, *flash_attention_cuda(q, k, v, with_lse=True, **kw),
                g, **kw)
        out[name] = {
            "ms": cs.time_eager_ms(torch, kern, calls=5, reps=5),
            "fwd_bwd_ms": cs.time_eager_ms(torch, fwd_bwd, calls=5, reps=5),
            "sdpa_fwd_bwd_ms": cs.sdpa_train_ms(torch, q, k, v, g,
                                                kw["causal"], calls=5)[0],
            "device_us_by_kernel": cs.device_breakdown_us(
                torch, {"b": kern}, reps=5)["b"]}
        del q, k, v, g, o, lse
        torch.cuda.empty_cache()
    return out


def body_lm_train(torch, _variants: str) -> dict:
    import dataclasses

    import chip_smoke as cs
    from repro_torch.configs import get_config
    runs = [(cs.lm_train_config(), cs.LM_TRAIN_BATCH, cs.LM_TRAIN_SEQ,
             cs.LM_TRAIN_STEPS),
            (cs.lm_train_config(cs.LM_SSD_TRAIN_ARCH), cs.LM_SSD_TRAIN_BATCH,
             cs.LM_SSD_TRAIN_SEQ, cs.LM_TRAIN_STEPS)]
    for arch, layers, batch, seq in cs.WIDE_TRAIN:
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        runs.append((cfg, batch, seq, cs.WIDE_TRAIN_STEPS))
    out = {}
    for i, (cfg, batch, seq, steps) in enumerate(runs):
        r = cs.lm_train_full(torch, "cuda", cfg, batch, seq,
                             cs.LM_SEED + 60 + i, cs.FLASH_BWD_KERNELS,
                             steps=steps)
        out[cfg.name] = {
            "layers": cfg.n_layers, "batch": [batch, seq],
            "ms_per_step": r["ms_per_step"], "step_ms": r["step_ms"],
            "tokens_per_s": r["tokens_per_s"],
            "max_memory_allocated": r["max_memory_allocated"],
            "losses": r["losses"],
            "step_device_busy_ms": r["step_device_busy_ms"],
            "flash_bwd_device_ms": sum(r["bwd_device_ms_by_kernel"].values())
            if cfg.block != "mamba2" else 0.0,
            "bwd_device_ms_by_kernel": r["bwd_device_ms_by_kernel"]}
        torch.cuda.empty_cache()
    return out


BODIES = {"bulk": body_bulk, "lm": body_lm, "lm_host": body_lm_host,
          "flash_host": body_flash_host, "train": body_train,
          "factory": body_factory, "flash_bwd": body_flash_bwd,
          "lm_train": body_lm_train}


def turn(body: str, tree: str, variants: str) -> dict:
    """One turn in this process: ``repro_torch`` from ``tree``."""
    sys.path.insert(0, str(Path(tree) / "src"))
    sys.path.append(str(ROOT))
    import torch
    from repro_torch.kernels import build
    build.build_all()
    return {"device": torch.cuda.get_device_name(0),
            **BODIES[body](torch, variants)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("body", choices=sorted(BODIES))
    ap.add_argument("parent")
    ap.add_argument("this")
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--variants", default="graphsage,gat")
    ap.add_argument("--turn", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:            # a child: one turn of `body` on `this`
        print(json.dumps(turn(args.body, args.this, args.variants)))
        return 0
    turns = [("parent", args.parent), ("this", args.this),
             ("this", args.this), ("parent", args.parent)] * args.pairs
    for name, tree in turns:
        r = subprocess.run([sys.executable, __file__, args.body, "-",
                            os.path.abspath(tree), "--variants",
                            args.variants, "--turn"],
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            print(r.stderr[-4000:], file=sys.stderr)
            return r.returncode
        print(json.dumps({"turn": name, **json.loads(r.stdout)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
