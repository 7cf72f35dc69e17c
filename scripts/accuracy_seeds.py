#!/usr/bin/env python3
"""The accuracy protocol over several seeds, in one package.

    PYTHONPATH=src python scripts/accuracy_seeds.py --data build/acc_ds \
        --build [--package port|jax] [--device cuda|cpu] [--seeds 0,1,2,3,4]

``--build`` first builds the plan of ``chip_smoke.py``'s ``accuracy``
phase (the JAX package's CI gate: 320 zoo graphs, convnext held out,
qwen2.5-3b and mamba2-370m traced) into ``--data`` with the port's
factory, whose shards are the JAX package's bytes. Then it trains the
default ``AccuracyProtocol`` (GraphSAGE-512, 30 epochs in chunks of 15,
lr 2.754e-5 × 100) once a seed and prints one JSON line a seed (splits,
epochs, best epoch, the test and unseen heads) and a last line with each
head's median over the seeds beside
``benchmarks/baselines/accuracy_mape.json``'s bound. ``--out`` also
writes the seeds' reports and medians to a JSON file;
``chip_smoke.py``'s ``accuracy`` phase holds the port's medians on the
card to the JAX package's, read from ``ACCURACY_REFERENCE``:

    JAX_PLATFORMS=cpu PYTHONPATH=src python scripts/accuracy_seeds.py \
        --data build/acc_ds --build --package jax \
        --out scripts/accuracy_jax_seeds.json

* ``port`` — ``repro_torch.train.run_accuracy`` on ``--device`` (default
  ``cuda``);
* ``jax`` — ``repro.train.accuracy.run_accuracy`` as the JAX gate runs it
  (on the CPU here: set ``JAX_PLATFORMS=cpu``).

A run takes about 20 s on an H100 and three to six minutes on an 8-core
x86-64 CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data", required=True)
    ap.add_argument("--build", action="store_true")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--package", choices=("port", "jax"), default="port")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", default="0,1,2,3,4")
    ap.add_argument("--out", help="write the reports and medians here")
    args = ap.parse_args()
    cs = chip_smoke()
    if args.build:
        from repro_torch.dataset import factory
        res = factory.build(args.data, cs.accuracy_config(factory),
                            workers=args.workers)
        print(json.dumps({"built": res.n_built, "shards": res.n_shards,
                          "plan_hash": res.plan_hash}), flush=True)
    if args.package == "jax":
        import jax
        from repro.train.accuracy import AccuracyProtocol, run_accuracy
        kw = {}
        versions = {"jax": jax.__version__,
                    "platform": jax.devices()[0].platform}
    else:
        import torch
        from repro_torch.train import AccuracyProtocol, run_accuracy
        kw = {"device": args.device}
        versions = {"torch": torch.__version__, "platform": args.device}
    versions["numpy"] = np.__version__
    seeds = [int(s) for s in args.seeds.split(",")]
    reports, rows = [], []
    for seed in seeds:
        t0 = time.perf_counter()
        r = run_accuracy(args.data, dataclasses.replace(AccuracyProtocol(),
                                                        seed=seed), **kw)
        r.pop("params")
        reports.append(r)
        rows.append({"seed": seed, "seconds": time.perf_counter() - t0,
                     **{k: r[k] for k in ("splits", "epochs_trained",
                                          "best_epoch", "converged",
                                          "test", "unseen")}})
        print(json.dumps({"package": args.package, **rows[-1]}),
              flush=True)
    with open(os.path.join(ROOT, cs.ACCURACY_BASELINE)) as f:
        base = json.load(f)
    median = {split: cs.median_heads(reports, split)
              for split in ("test", "unseen")}
    print(json.dumps({"package": args.package, "seeds": seeds,
                      "median": {split: cs.gate_mape(
                          median[split], base[split], base["tolerance"])
                          for split in median}}), flush=True)
    if args.out:
        with open(os.path.join(args.data, "manifest.json")) as f:
            manifest = json.load(f)
        with open(args.out, "w") as f:
            json.dump({"package": args.package, **versions,
                       "plan_hash": manifest["plan_hash"],
                       "n_built": manifest["n_built"],
                       "protocol": AccuracyProtocol().to_json(),
                       "seeds": seeds, "reports": rows, "median": median},
                      f, indent=1, sort_keys=True)
            f.write("\n")


if __name__ == "__main__":
    main()
