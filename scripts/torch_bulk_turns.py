#!/usr/bin/env python3
"""Bulk-sweep time per full packed bin of two checkouts of the PyTorch
port on one NVIDIA card, measured in turns (A, B, B, A).

    python3 scripts/torch_bulk_turns.py PARENT_DIR THIS_DIR [--variants graphsage,gat]

Each turn is a fresh process that imports ``repro_torch`` from the given
checkout's ``src``, builds its kernels, runs ``DIPPM.from_params`` at the
paper's width (random weights, seed 0), warms the packed rung ladder and
times ``engine().predict_samples`` over 400 seeded synthetic graphs
seven times. It prints one JSON line per turn: the ms per bin of every
sweep and their median, per variant. A variant the checkout does not run
is reported as its error. Two versions are compared only within one run
of this script, on one card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_TURN = r'''
import json, statistics, sys, time
sys.path.insert(0, sys.argv[1] + "/src")
import torch
from repro_torch.core import DIPPM, PMGNSConfig, pmgns_init
from repro_torch.dataset.builder import synthetic_samples
out = {"device": torch.cuda.get_device_name(0)}
samples = synthetic_samples(400, seed=1, n_min=16, n_max=200)
for variant in sys.argv[2].split(","):
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
print(json.dumps(out))
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("this")
    ap.add_argument("--variants", default="graphsage,gat")
    args = ap.parse_args()
    turns = [("parent", args.parent), ("this", args.this),
             ("this", args.this), ("parent", args.parent)]
    for name, tree in turns:
        r = subprocess.run([sys.executable, "-c", _TURN,
                            os.path.abspath(tree), args.variants],
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            print(r.stderr[-4000:], file=sys.stderr)
            return r.returncode
        print(json.dumps({"turn": name, **json.loads(r.stdout)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
