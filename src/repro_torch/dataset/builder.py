"""Synthetic labeled samples — the port's copy of
``repro.dataset.builder.synthetic_samples`` (numpy, the same draws for
the same seed). The traced-zoo dataset builder is later work
(ROADMAP A13)."""
from __future__ import annotations

from typing import List

import numpy as np

from ..core.batching import GraphSample, pad_sample


def synthetic_samples(n: int, seed: int = 0, n_min: int = 4,
                      n_max: int = 30,
                      y_scale: float = 100.0) -> List[GraphSample]:
    """Random labeled ``GraphSample``s (chain + random extra edges)."""
    rng = np.random.default_rng(seed)
    out: List[GraphSample] = []
    for i in range(n):
        nn = int(rng.integers(n_min, n_max))
        x = rng.standard_normal((nn, 32)).astype(np.float32)
        edges = ([(j, j + 1) for j in range(nn - 1)]
                 + [(int(rng.integers(nn)), int(rng.integers(nn)))
                    for _ in range(nn // 2)])
        out.append(pad_sample(
            x, np.asarray(edges, np.int32),
            rng.standard_normal(5).astype(np.float32),
            y=(rng.random(3) * y_scale + 1).astype(np.float32),
            meta={"i": i}))
    return out
