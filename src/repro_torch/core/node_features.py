"""Node Feature Generator (paper §3.2, Algorithm 1).

Each operator node gets a fixed-length **32-dim** feature vector:

    F_node = F_oh ⊕ F_attr ⊕ F_shape          (Algorithm 1, lines 6-8)

* ``F_oh``    — 16-dim one-hot over :data:`repro_torch.core.ir.OP_VOCAB`.
* ``F_attr``  — 8-dim operator attributes (kernel/stride/groups/window/
                contraction size/moved elements/dtype width).
* ``F_shape`` — 8-dim output-shape descriptor (rank, leading log-dims,
                log-numel, log-param-bytes).

All magnitude-like entries are ``log1p``-scaled: node features must live on
comparable scales for the GNN, and operator sizes span 9 orders of
magnitude across the dataset.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .ir import OP_INDEX, OP_VOCAB, OpGraph, OpNode, dtype_bytes

N_OP = len(OP_VOCAB)            # 16
N_ATTR = 8
N_SHAPE = 8
NODE_FEATURE_DIM = N_OP + N_ATTR + N_SHAPE   # 32 — matches the paper


def node_feature(nd: OpNode) -> np.ndarray:
    """One node's 32-dim feature row.

    Delegates to :func:`node_feature_matrix` on a single-node graph so
    there is exactly one implementation of the feature layout.
    """
    return node_feature_matrix(OpGraph(nodes=[nd], edges=[]))[0]


def node_feature_matrix(g: OpGraph) -> np.ndarray:
    """X with shape [N_op, N_features] (paper notation).

    Vectorized equivalent of stacking :func:`node_feature` rows: raw
    scalars are gathered in one pass and every magnitude column gets one
    array-wide ``log1p``. Per-node scalar ``log1p`` calls dominated sweep
    preprocessing (~7 µs/node), which the batched prediction engine turns
    into the serial bottleneck of a zoo sweep.
    """
    n = g.num_nodes
    if n == 0:
        return np.zeros((0, NODE_FEATURE_DIM), dtype=np.float32)
    f = np.zeros((n, NODE_FEATURE_DIM), dtype=np.float64)
    ops = np.fromiter((OP_INDEX[nd.op] for nd in g.nodes),
                      dtype=np.int64, count=n)
    f[np.arange(n), ops] = 1.0

    # staged columns (F_attr ⊕ F_shape): kernel_h, kernel_w, stride,
    # groups*, window, contract_k*, moved_elems*, dtype_bytes, rank,
    # dim0*..dim3*, numel*, param_bytes*, flops*   (* = log1p below)
    rows = []
    for nd in g.nodes:
        a = nd.attrs
        kernel = a.get("kernel", (0, 0))
        stride = a.get("stride", (1,))
        window = a.get("window", (0,))
        k0 = float(kernel[0]) if len(kernel) > 0 else 0.0
        shape = nd.out_shape
        rows.append((
            k0,
            float(kernel[1]) if len(kernel) > 1 else k0,
            float(stride[0]) if len(stride) > 0 else 1.0,
            a.get("groups", 1),
            float(window[0]) if len(window) > 0 else 0.0,
            a.get("contract_k", 0),
            a.get("moved_elems", 0),
            dtype_bytes(nd.dtype),
            len(shape),
            shape[0] if len(shape) > 0 else 0,
            shape[1] if len(shape) > 1 else 0,
            shape[2] if len(shape) > 2 else 0,
            shape[3] if len(shape) > 3 else 0,
            nd.out_elems,
            nd.param_bytes,
            nd.flops,
        ))
    raw = np.asarray(rows, dtype=np.float64)       # [n, N_ATTR + N_SHAPE]
    log_cols = [3, 5, 6, 9, 10, 11, 12, 13, 14, 15]
    raw[:, log_cols] = np.log1p(np.maximum(raw[:, log_cols], 0.0))
    f[:, N_OP:] = raw
    return f.astype(np.float32)


def adjacency_matrix(g: OpGraph) -> np.ndarray:
    """A[dst, src] — row i holds the in-neighbourhood of node i."""
    return g.adjacency()


def graph_tensors(g: OpGraph) -> Tuple[np.ndarray, np.ndarray]:
    """The (A, X) pair of Algorithm 1."""
    return adjacency_matrix(g), node_feature_matrix(g)
