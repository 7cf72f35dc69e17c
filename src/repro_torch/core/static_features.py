"""Static Feature Generator (paper §3.3, eq. 1).

    F_s = F_mac ⊕ F_batch ⊕ F_Tconv ⊕ F_Tdense ⊕ F_Trelu

The paper computes F_mac with TVM's relay analysis, which only counts
Conv2D / Conv2D-transpose / dense / batch-matmul — our tracer attributes
MACs to exactly the ``dense`` and ``conv`` node kinds, i.e. the same
operator set, so the semantics match.

A 3-feature extension (total params, total activation bytes, total flops)
is available behind ``extended=True`` — used by the beyond-paper ablation
in benchmarks; the default is the faithful 5-vector.
"""
from __future__ import annotations

import numpy as np

from .ir import OpGraph

STATIC_FEATURE_DIM = 5
STATIC_FEATURE_DIM_EXT = 8


def static_features(g: OpGraph, extended: bool = False) -> np.ndarray:
    batch = float(g.meta.get("batch", g.meta.get("batch_size", 1)))
    f = [
        np.log1p(g.total_macs()),        # F_mac
        np.log1p(batch),                 # F_batch
        float(g.op_count("conv")),       # F_Tconv
        float(g.op_count("dense")),      # F_Tdense
        float(g.op_count("relu")),       # F_Trelu
    ]
    if extended:
        total_act = sum(nd.out_bytes for nd in g.nodes)
        f += [
            np.log1p(float(g.meta.get("param_bytes", g.total_param_bytes()))),
            np.log1p(float(total_act)),
            np.log1p(g.total_flops()),
        ]
    return np.asarray(f, dtype=np.float32)
