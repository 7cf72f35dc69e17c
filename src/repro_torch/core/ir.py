"""Generalized operator-graph IR — the framework-neutral model representation.

This is the analogue of the paper's Relay IR stage (DIPPM §3.1): every
frontend (serialized JSON graphs here) lowers to :class:`OpGraph`, and
every downstream component (Node Feature Generator, Static Feature
Generator, batching) consumes only :class:`OpGraph`.

The PyTorch port keeps its own copy of ``repro.core.ir``, line for line
in what it computes: :meth:`OpGraph.fingerprint` must hash a graph to
the same bytes in both packages, since serving caches key on it.

Design notes
------------
* Nodes are *operators* with attributes and an output shape — exactly the
  information Algorithm 1 of the paper extracts from Relay.
* Non-operator nodes (constants, pure layout ops) are contracted away by
  :func:`filter_and_preprocess`, preserving dataflow connectivity, mirroring
  the paper's post-order "filter and preprocess" step.
* The op vocabulary is deliberately small and hardware-meaningful: the
  one-hot segment of the 32-dim node feature (§3.2) indexes into
  :data:`OP_VOCAB`.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Operator vocabulary
# ---------------------------------------------------------------------------

#: Canonical operator kinds. Order matters: it defines the one-hot encoding.
OP_VOCAB: Tuple[str, ...] = (
    "dense",        # matmul / dot_general / batched matmul
    "conv",         # any convolution
    "add",
    "mul",
    "div",
    "relu",         # max(x, 0) family
    "gelu",         # gelu / silu / swish / other smooth activations
    "tanh",
    "exp",
    "softmax",      # detected softmax pattern or explicit op
    "reduce",       # sum/max/mean reductions (incl. norm statistics)
    "norm",         # fused layer/rms/batch norm (frontends may emit directly)
    "pool",         # avg/max pooling (reduce_window)
    "gather",       # embedding lookup / take / dynamic-slice
    "scatter",      # scatter / dynamic-update-slice / one-hot dispatch
    "elementwise",  # any other pointwise op (rsqrt, logistic, select, ...)
)

OP_INDEX: Dict[str, int] = {name: i for i, name in enumerate(OP_VOCAB)}

_DTYPE_BYTES = {
    "float64": 8, "float32": 4, "float16": 2, "bfloat16": 2,
    "int64": 8, "int32": 4, "int16": 2, "int8": 1, "uint8": 1, "bool": 1,
    "float8_e4m3fn": 1, "float8_e5m2": 1,
}


def dtype_bytes(dtype: str) -> int:
    return _DTYPE_BYTES.get(str(dtype), 4)


class GraphValidationError(ValueError):
    """A submitted graph document is structurally invalid.

    Raised by the frontends (``repro_torch.core.frontends.from_json``) with
    node-level context — missing fields, dangling edge references,
    negative shape dims, cycles — instead of leaking raw ``KeyError``
    / ``IndexError`` from arbitrary user payloads. ``node_id`` carries
    the offending node when one is identifiable. The serving layer
    maps this to an immediate future rejection (the request never
    touches the queue)."""

    def __init__(self, message: str, node_id: Optional[int] = None):
        super().__init__(message)
        self.node_id = node_id


#: Weisfeiler–Lehman refinement rounds behind :meth:`OpGraph.fingerprint`.
#: Each round folds one more hop of wiring into every node label; 4 rounds
#: separate any two operator DAGs whose 4-hop neighborhoods differ, at
#: O(rounds · (n + e)) hashing cost.
_WL_ROUNDS = 4


# ---------------------------------------------------------------------------
# Node / Graph dataclasses
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OpNode:
    """One operator node of the generalized graph (paper Algorithm 1)."""

    node_id: int
    op: str                               # one of OP_VOCAB (post-filter)
    out_shape: Tuple[int, ...]
    dtype: str = "float32"
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: FLOPs attributed to this node (filled by the tracer / frontend).
    flops: float = 0.0
    #: MACs for dense/conv nodes — feeds F_mac (paper eq. 1).
    macs: float = 0.0
    #: bytes read + written, roofline memory side.
    bytes_accessed: float = 0.0
    #: parameter bytes held by this node (weights), for the memory model.
    param_bytes: float = 0.0

    @property
    def out_elems(self) -> int:
        n = 1
        for d in self.out_shape:
            n *= int(d)
        return n

    @property
    def out_bytes(self) -> int:
        return self.out_elems * dtype_bytes(self.dtype)

    def to_json(self) -> Dict[str, Any]:
        return {
            "id": self.node_id, "op": self.op,
            "out_shape": list(self.out_shape), "dtype": self.dtype,
            "attrs": self.attrs, "flops": self.flops, "macs": self.macs,
            "bytes_accessed": self.bytes_accessed,
            "param_bytes": self.param_bytes,
        }

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "OpNode":
        return OpNode(
            node_id=int(d["id"]), op=str(d["op"]),
            out_shape=tuple(int(x) for x in d["out_shape"]),
            dtype=str(d.get("dtype", "float32")),
            attrs=dict(d.get("attrs", {})),
            flops=float(d.get("flops", 0.0)), macs=float(d.get("macs", 0.0)),
            bytes_accessed=float(d.get("bytes_accessed", 0.0)),
            param_bytes=float(d.get("param_bytes", 0.0)),
        )


@dataclasses.dataclass
class OpGraph:
    """Directed operator dataflow graph with metadata.

    ``edges`` are (src_id, dst_id) pairs over ``nodes`` ids; ids are dense
    [0, n) after :func:`filter_and_preprocess`.
    """

    nodes: List[OpNode]
    edges: List[Tuple[int, int]]
    #: global metadata: batch size, family name, input shapes...
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # -- structural helpers -------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return len(self.nodes)

    @property
    def num_edges(self) -> int:
        return len(self.edges)

    def adjacency(self) -> np.ndarray:
        """Dense adjacency matrix A[dst, src] = 1 (message flows src→dst)."""
        n = self.num_nodes
        a = np.zeros((n, n), dtype=np.float32)
        for s, d in self.edges:
            a[d, s] = 1.0
        return a

    def in_degrees(self) -> np.ndarray:
        deg = np.zeros((self.num_nodes,), dtype=np.int32)
        for _, d in self.edges:
            deg[d] += 1
        return deg

    def topo_order(self) -> List[int]:
        """Kahn topological order (graphs from tracing are DAGs)."""
        n = self.num_nodes
        indeg = [0] * n
        succ: List[List[int]] = [[] for _ in range(n)]
        for s, d in self.edges:
            indeg[d] += 1
            succ[s].append(d)
        stack = [i for i in range(n) if indeg[i] == 0]
        order: List[int] = []
        while stack:
            u = stack.pop()
            order.append(u)
            for v in succ[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    stack.append(v)
        if len(order) != n:  # cycle — shouldn't happen for traced graphs
            raise ValueError("OpGraph has a cycle; not a DAG")
        return order

    # -- aggregate statistics (consumed by SFG + cost model) ----------------
    def total_flops(self) -> float:
        return float(sum(nd.flops for nd in self.nodes))

    def total_macs(self) -> float:
        return float(sum(nd.macs for nd in self.nodes))

    def total_param_bytes(self) -> float:
        return float(sum(nd.param_bytes for nd in self.nodes))

    def op_count(self, op: str) -> int:
        return sum(1 for nd in self.nodes if nd.op == op)

    def fingerprint(self) -> str:
        """Canonical content hash — invariant under node reordering.

        Two :class:`OpGraph`\\ s describing the same model must hash
        equal even when their node lists are permuted or their (dense)
        ids relabeled — frontends that re-parse a serialized graph can
        emit nodes in a different order, and the serving layer's
        content-addressed prediction cache (``serve/cache.py``) keys
        on this hash, so an order-sensitive fingerprint would silently
        miss on every re-parsed duplicate.

        The hash is built from permutation-invariant views only:

        1. a per-node content label ``(op, out_shape, dtype)``, refined
           for a few Weisfeiler–Lehman rounds over the sorted multisets
           of predecessor/successor labels (so a node's label encodes
           its local wiring, not its position);
        2. the sorted multiset of final node labels;
        3. the sorted multiset of edge ``(src_label, dst_label)`` pairs;
        4. node/edge counts and the JSON-canonicalized ``meta``.

        WL-indistinguishable non-isomorphic graphs could in principle
        collide, but operator DAGs with shaped, typed nodes don't hit
        those pathologies in practice; for cache keys the failure mode
        is astronomically unlikely (and bounded by sha256 anyway).

        The hash is memoized on the instance: graphs are treated as
        immutable once built (every transform in this repo constructs a
        new ``OpGraph``), and both the serving cache and the cost
        model's noise seeding hit this per request — recomputing the WL
        refinement each time would cost more than a cache hit saves.
        """
        memo = self.__dict__.get("_fingerprint")
        if memo is not None:
            return memo
        n = len(self.nodes)
        pos = {nd.node_id: i for i, nd in enumerate(self.nodes)}

        def _h(data: bytes) -> bytes:
            return hashlib.blake2b(data, digest_size=16).digest()

        labels = [_h(f"{nd.op}|{tuple(nd.out_shape)}|{nd.dtype}".encode())
                  for nd in self.nodes]
        preds: List[List[int]] = [[] for _ in range(n)]
        succs: List[List[int]] = [[] for _ in range(n)]
        edge_pos = []
        for s, d in self.edges:
            si, di = pos[s], pos[d]
            preds[di].append(si)
            succs[si].append(di)
            edge_pos.append((si, di))
        for _ in range(_WL_ROUNDS):
            labels = [
                _h(labels[i]
                   + b"<" + b"".join(sorted(labels[p] for p in preds[i]))
                   + b">" + b"".join(sorted(labels[q] for q in succs[i])))
                for i in range(n)
            ]
        h = hashlib.sha256()
        h.update(f"{n}|{len(self.edges)}".encode())
        for lab in sorted(labels):
            h.update(lab)
        for pair in sorted(labels[si] + labels[di] for si, di in edge_pos):
            h.update(pair)
        h.update(json.dumps(self.meta, sort_keys=True, default=str).encode())
        fp = h.hexdigest()
        self.__dict__["_fingerprint"] = fp
        return fp

    # -- serialization (the portable multi-frontend schema) -----------------
    def to_json(self) -> Dict[str, Any]:
        return {
            "schema": "repro.opgraph.v1",
            "nodes": [nd.to_json() for nd in self.nodes],
            "edges": [list(e) for e in self.edges],
            "meta": self.meta,
        }

    def dumps(self) -> str:
        return json.dumps(self.to_json())

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "OpGraph":
        if d.get("schema") != "repro.opgraph.v1":
            raise ValueError(f"unknown OpGraph schema: {d.get('schema')!r}")
        return OpGraph(
            nodes=[OpNode.from_json(x) for x in d["nodes"]],
            edges=[(int(a), int(b)) for a, b in d["edges"]],
            meta=dict(d.get("meta", {})),
        )

    @staticmethod
    def loads(s: str) -> "OpGraph":
        return OpGraph.from_json(json.loads(s))


# ---------------------------------------------------------------------------
# Filter / preprocess  (paper Algorithm 1, lines 2-11)
# ---------------------------------------------------------------------------

def filter_and_preprocess(
    raw_nodes: Sequence[OpNode],
    raw_edges: Iterable[Tuple[int, int]],
    meta: Optional[Dict[str, Any]] = None,
) -> OpGraph:
    """Contract non-operator (layout) nodes, keep operator nodes.

    Mirrors the paper's ``filter_and_preprocess(IR)``: pure layout ops
    (reshape/transpose/...) carry no compute signal; they are removed and
    their predecessors are wired directly to their successors so dataflow
    connectivity is preserved. Node ids are re-densified.
    """
    raw_nodes = list(raw_nodes)
    id2node = {nd.node_id: nd for nd in raw_nodes}
    keep = {nd.node_id for nd in raw_nodes if nd.op in OP_INDEX}

    # predecessor lists over the raw graph
    preds: Dict[int, List[int]] = {nd.node_id: [] for nd in raw_nodes}
    for s, d in raw_edges:
        if s in id2node and d in id2node:
            preds[d].append(s)

    # resolve each raw node to its set of kept ancestors (transitively
    # skipping layout nodes); memoized DFS, post-order
    resolved: Dict[int, Tuple[int, ...]] = {}

    def resolve(nid: int) -> Tuple[int, ...]:
        if nid in resolved:
            return resolved[nid]
        resolved[nid] = ()  # cycle guard
        if nid in keep:
            resolved[nid] = (nid,)
            return resolved[nid]
        out: List[int] = []
        for p in preds[nid]:
            out.extend(resolve(p))
        resolved[nid] = tuple(dict.fromkeys(out))
        return resolved[nid]

    new_ids = {old: i for i, old in enumerate(sorted(keep))}
    edges: List[Tuple[int, int]] = []
    seen = set()
    for nid in keep:
        for p in preds[nid]:
            for src in resolve(p):
                e = (new_ids[src], new_ids[nid])
                if e not in seen and e[0] != e[1]:
                    seen.add(e)
                    edges.append(e)

    nodes = []
    for old in sorted(keep):
        nd = id2node[old]
        nodes.append(dataclasses.replace(nd, node_id=new_ids[old]))
    return OpGraph(nodes=nodes, edges=sorted(edges), meta=dict(meta or {}))
