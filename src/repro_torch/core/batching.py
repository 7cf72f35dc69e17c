"""Graph batching in the three layouts of ``repro.core.batching``.

The port's copy of ``repro.core.batching``, numpy as there, so that the
same samples and the same ``rng`` give exactly equal arrays:

* **dense** (:func:`collate`): every graph pads to a node bucket ``N``
  and the batch carries ``adj [B, N, N]``; aggregation is a batched
  product (``repro_torch.kernels.ops.dense_aggregate``).
* **sparse** (``collate(..., sparse=True)``): the batch carries a padded
  edge list ``edges [B, E, 2]`` + ``edge_mask [B, E]`` with ``E``
  rounded up to an edge bucket; aggregation is gather → segment-scatter
  (``repro_torch.kernels.ops.segment_aggregate``).
* **packed** (:func:`pack_graphs` + :func:`collate_packed`, the
  prediction path): a set of graphs is flattened into **one node axis** —
``x [P, F]`` with a ``graph_ids [P]`` segment vector, globally-offset
``edges [Q, 2]``, and per-graph ``static [G, ·]`` / ``y [G, ·]`` — the
PyG block-diagonal form. A greedy token-budget bin-packer
(:func:`pack_graphs`) mixes graphs of *different* sizes into one bin,
and bin shapes collapse to a handful of ``(P, Q, G)`` budget rungs
(:func:`packed_shape`). Graph-level pooling is a segment-mean/max
readout over ``graph_ids``
(``repro_torch.kernels.ops.segment_readout``).

Storage is sparse until collate: a :class:`GraphSample` carries an
``[E, 2]`` edge list, and per-bin arrays are materialized only when a
bin is assembled (:func:`collate_packed`, the prediction engine's
staging). Padding exists only at the tail of each budgeted bin, so
waste is ``1 - Σ real / P`` per bin.

Training stacks an epoch into ``[S, B, ...]`` segments of any layout
(:func:`stack_epoch_segments`) under one batch schedule.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .ir import OpGraph
from .node_features import node_feature_matrix
from .static_features import static_features

DEFAULT_BUCKETS: Tuple[int, ...] = (32, 64, 128, 256, 512, 1024)


def dense_adj(edges: np.ndarray, size: int,
              out: Optional[np.ndarray] = None) -> np.ndarray:
    """Densify an ``[E, 2]`` (src, dst) edge list into ``A[dst, src]``.

    Writes into ``out`` (a zeroed ``[size, size]`` view) when given — the
    batch assemblers pass slices of a preallocated batch array so the
    dense adjacency never exists per sample.
    """
    a = out if out is not None else np.zeros((size, size), dtype=np.float32)
    if len(edges):
        a[edges[:, 1], edges[:, 0]] = 1.0
    return a


@dataclasses.dataclass
class GraphSample:
    """One dataset point: (A, X, F_s, Y) — paper §4.1.

    The adjacency is stored as a sparse ``[E, 2]`` (src, dst) edge list.

    **Edge-list contract:** rows are unique (:func:`pad_sample`, the
    single construction path, deduplicates), so the segment kernels
    scatter each edge exactly once. Construct through
    :func:`pad_sample` rather than directly to keep this invariant.
    """

    x: np.ndarray           # [N, 32] node features, padded to the bucket
    edges: np.ndarray       # [E, 2]  int32 (src, dst), indices < n_nodes
    mask: np.ndarray        # [N]     1 for real nodes
    static: np.ndarray      # [5] or [8]
    y: Optional[np.ndarray]  # [3] (latency_ms, energy_j, memory_mb) or None
    meta: Dict = dataclasses.field(default_factory=dict)

    @property
    def n_nodes(self) -> int:
        return int(self.mask.sum())

    @property
    def n_edges(self) -> int:
        return int(self.edges.shape[0])


def bucket_for(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket that fits ``n`` nodes (largest bucket if none do)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def next_pow2(n: int) -> int:
    """Smallest power of two ≥ ``n`` (≥ 1) — the batch-dimension buckets."""
    return 1 << max(0, (int(n) - 1).bit_length())


#: Floor for edge buckets: tiny graphs all land on one compiled shape.
MIN_EDGE_BUCKET = 16


#: Feature-cell proxy for the sparse memory envelope: the widest
#: activation a batch row carries through the model (hidden width 512).
SPARSE_ENVELOPE_FEAT = 512


def edge_bucket_for(n_edges: int) -> int:
    """Edge-count bucket: next power of two, floored at MIN_EDGE_BUCKET.

    Sparse batches pad their edge axis to this, so batch shapes — and
    therefore compiled functions — bucket by (node bucket, edge bucket)
    instead of exact ragged edge counts.
    """
    return max(MIN_EDGE_BUCKET, next_pow2(max(int(n_edges), 1)))


def edge_floor(node_bucket: int) -> int:
    """Per-node-bucket edge-bucket floor at typical DAG density (~2/node).

    The single source of truth shared by the prediction engine's chunk
    builder and the trainer's segment builder (both previously re-derived
    it): chunks/segments at or below this density all land on one
    compiled shape per node bucket, and only rare denser batches escape
    to a larger edge bucket.
    """
    return edge_bucket_for(2 * node_bucket)


def max_batch_for_bucket(size: int, batch_size: int,
                         ref_size: int = 256,
                         edges: Optional[int] = None) -> int:
    """Per-bucket batch cap under a constant memory envelope.

    **Dense** (``edges=None``): the padded ``[B, N, N]`` adjacency
    dominates batch memory, so the cap scales ``batch_size`` down for
    buckets larger than ``ref_size`` such that ``B · N²`` stays within
    ``batch_size · ref_size²`` cells.

    **Sparse** (``edges`` = the bucket's padded edge count): there is no
    N² term — a batch row costs O(N·F + E) cells (widest activation
    ``N · SPARSE_ENVELOPE_FEAT`` plus ~4 cells per edge for endpoints,
    mask, and per-edge messages) — so the cap is re-derived from that
    footprint against the same reference envelope at
    ``(ref_size, 2·ref_size)``. Big buckets keep far larger batches than
    the quadratic dense rule allows: at N=512 the dense cap is
    ``batch_size/4``; the sparse cap stays ≈ ``batch_size/2``.
    """
    if edges is None:
        base_cells = batch_size * ref_size * ref_size
        return max(1, min(batch_size, base_cells // (size * size)))
    ref_fp = ref_size * SPARSE_ENVELOPE_FEAT + 4 * (2 * ref_size)
    fp = size * SPARSE_ENVELOPE_FEAT + 4 * max(int(edges), 1)
    return max(1, min(batch_size, (batch_size * ref_fp) // fp))


def group_by_bucket(
    samples: Sequence[GraphSample],
) -> Dict[int, List[int]]:
    """Group sample *indices* by padded bucket size, preserving input order.

    Shared by training batching (:func:`batches_by_bucket`), the stacked
    scan schedule (:func:`stack_epoch_segments`), and the inference engine
    (``repro_torch.core.engine``), which needs the indices to restore input
    order after per-bucket batched execution.
    """
    by_bucket: Dict[int, List[int]] = {}
    for i, s in enumerate(samples):
        by_bucket.setdefault(s.x.shape[0], []).append(i)
    return by_bucket


def pad_sample(
    x: np.ndarray,
    edges: np.ndarray,
    static: np.ndarray,
    y: Optional[np.ndarray] = None,
    meta: Optional[Dict] = None,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    truncate_weight: Optional[np.ndarray] = None,
) -> GraphSample:
    """The single padding/truncation path behind every ``GraphSample``.

    Pads ``x``/``mask`` to the smallest bucket that fits and keeps the
    edge list sparse. Graphs larger than the top bucket are truncated to
    the heaviest nodes by ``truncate_weight`` (default: the last node
    feature, ``log1p(flops)``) with edges remapped — rare, and the static
    features still see the whole graph. Shared by
    :func:`sample_from_graph` (OpGraph path) and
    ``repro_torch.dataset.builder.synthetic_samples``.
    """
    x = np.asarray(x, dtype=np.float32)
    edges = np.asarray(edges, dtype=np.int32).reshape(-1, 2)
    if len(edges):
        # canonicalize: unique rows, sorted — the JAX package's dense
        # layout collapses duplicates by assignment, so dedup here keeps
        # the segment path (which scatters per edge) numerically identical
        edges = np.unique(edges, axis=0)
    n = x.shape[0]
    cap = buckets[-1]
    if n > cap:
        w = np.asarray(truncate_weight if truncate_weight is not None
                       else x[:, -1], dtype=np.float64)
        keep = np.sort(np.argsort(-w, kind="stable")[:cap])
        remap = -np.ones((n,), dtype=np.int64)
        remap[keep] = np.arange(cap)
        x = x[keep]
        if len(edges):
            e = edges[(remap[edges[:, 0]] >= 0) & (remap[edges[:, 1]] >= 0)]
            edges = (np.stack([remap[e[:, 0]], remap[e[:, 1]]], -1)
                     .astype(np.int32) if len(e)
                     else np.zeros((0, 2), dtype=np.int32))
        n = cap
    size = bucket_for(n, buckets)
    xp = np.zeros((size, x.shape[1]), dtype=np.float32)
    xp[:n] = x
    mask = np.zeros((size,), dtype=np.float32)
    mask[:n] = 1.0
    return GraphSample(
        x=xp, edges=edges, mask=mask,
        static=np.asarray(static, dtype=np.float32),
        y=None if y is None else np.asarray(y, dtype=np.float32),
        meta=dict(meta or {}),
    )


def sample_from_graph(
    g: OpGraph,
    y: Optional[np.ndarray] = None,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    extended_static: bool = False,
) -> GraphSample:
    """Pad one OpGraph into a fixed-size GraphSample (sparse edges)."""
    return pad_sample(
        node_feature_matrix(g),
        np.asarray(g.edges, dtype=np.int32).reshape(-1, 2),
        static_features(g, extended=extended_static),
        y=y, meta=dict(g.meta), buckets=buckets,
        truncate_weight=np.asarray([nd.flops for nd in g.nodes]),
    )


def pack_edges(samples: Sequence[GraphSample],
               e_pad: Optional[int] = None,
               edges_out: Optional[np.ndarray] = None,
               mask_out: Optional[np.ndarray] = None,
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad per-sample edge lists into ``edges [B, E, 2]`` + ``edge_mask``.

    ``E`` defaults to the edge bucket of the largest member
    (:func:`edge_bucket_for`). Padding rows are ``(0, 0)`` with mask 0 —
    in-range endpoints so gathers stay legal; the mask makes their
    contribution exactly zero in every sparse kernel. The batch
    assemblers can pass preallocated ``edges_out``/``mask_out`` views.

    Edge lists are copied as stored: :class:`GraphSample`'s contract
    guarantees unique rows (``pad_sample`` deduplicates at construction,
    matching ``dense_adj``'s collapse-by-assignment semantics), so
    packing is a straight memcpy on the batch-assembly hot path.
    """
    if e_pad is None:
        e_pad = edge_bucket_for(max((s.n_edges for s in samples), default=0))
    b = len(samples)
    edges = (edges_out if edges_out is not None
             else np.zeros((b, e_pad, 2), dtype=np.int32))
    emask = (mask_out if mask_out is not None
             else np.zeros((b, e_pad), dtype=np.float32))
    for i, s in enumerate(samples):
        e = s.n_edges
        if e > e_pad:
            raise ValueError(
                f"sample has {e} edges, edge bucket is {e_pad}")
        if e:
            edges[i, :e] = s.edges
            emask[i, :e] = 1.0
    return edges, emask


def collate(samples: Sequence[GraphSample],
            sparse: bool = False,
            edge_bucket: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Stack same-bucket samples into one batch dict (numpy arrays).

    Dense (default): the ``[B, N, N]`` adjacency is built from each
    sample's edge list, so dense adjacency memory is O(batch), never
    O(dataset). Sparse: the batch carries ``edges [B, E, 2]`` +
    ``edge_mask [B, E]`` (E = the chunk's edge bucket) instead — no
    dense adjacency is ever materialized.
    """
    sizes = {s.x.shape[0] for s in samples}
    if len(sizes) != 1:
        raise ValueError(f"collate needs a single bucket size, got {sizes}")
    size = sizes.pop()
    batch = {
        "x": np.stack([s.x for s in samples]),
        "mask": np.stack([s.mask for s in samples]),
        "static": np.stack([s.static for s in samples]),
    }
    if sparse:
        batch["edges"], batch["edge_mask"] = pack_edges(samples, edge_bucket)
    else:
        adj = np.zeros((len(samples), size, size), dtype=np.float32)
        for i, s in enumerate(samples):
            dense_adj(s.edges, size, out=adj[i])
        batch["adj"] = adj
    if all(s.y is not None for s in samples):
        batch["y"] = np.stack([s.y for s in samples])
    return batch


# ---------------------------------------------------------------------------
# packed block-diagonal layout: one flat node axis, token-budget bin-packing
# ---------------------------------------------------------------------------

#: Default node budget ``P`` for packed bins: matches the sparse memory
#: envelope at the reference point (batch 16 × the 256-node reference
#: bucket) and holds ~dozens of typical DIPPM DAGs per compiled call.
DEFAULT_NODE_BUDGET = 4096


def resolve_packed_budgets(
    node_budget: Optional[int] = None,
    edge_budget: Optional[int] = None,
    graph_budget: Optional[int] = None,
) -> Tuple[int, int, int]:
    """Fill packed-layout budget defaults → ``(P, Q, G)``.

    ``Q`` defaults to ``2·P`` (the same ~2-edges-per-node density floor
    as :func:`edge_floor`) and ``G`` to ``P // 16`` — graphs smaller than
    16 nodes hit the graph budget before the node budget, which keeps
    the per-graph ``static``/``y`` arrays bounded.
    """
    p = int(node_budget or DEFAULT_NODE_BUDGET)
    q = int(edge_budget) if edge_budget else 2 * p
    g = int(graph_budget) if graph_budget else max(1, p // 16)
    return p, q, g


def packed_rung(p: int, edge_budget: int,
                graph_budget: int) -> Tuple[int, int]:
    """``(Q, G)`` rung for a bin padded to node rung ``p``.

    The typical-density companion shapes :func:`packed_shape` assigns
    (``1.625·P`` edges, ``P/16`` graphs, both clamped to their budgets)
    — shared with the engine's warmup so the precompiled shape is
    exactly the one full bins hit. A zero budget disables the rung
    (returns 0 on that axis).
    """
    q = min(edge_budget, p + p // 2 + p // 8) if edge_budget else 0
    g = min(graph_budget, max(1, p // 16)) if graph_budget else 0
    return q, g


def packed_rung_ladder(
    node_budget: Optional[int] = None,
    edge_budget: Optional[int] = None,
    graph_budget: Optional[int] = None,
) -> List[Tuple[int, int, int]]:
    """The typical-density ``(P, Q, G)`` rung ladder of
    :func:`packed_shape`.

    ``P`` starts at the ``budget // 16`` floor and doubles up to the
    budget (≤ 5 rungs at the defaults), each with its typical-density
    :func:`packed_rung` companions — the shapes bins of ordinary DAG
    density and ordinary graph count land on. Serving warmup
    (``repro.serve.PredictionService.warmup`` /
    ``PredictionEngine.warmup(rungs="all")``) precompiles exactly this
    set, so steady traffic at any request *size* runs compile-free.
    Bins that escalate an axis past its rung — denser-than-typical edge
    content, or more graphs than ``P // 16`` (many very small graphs in
    one bin), or an oversize lone graph — use the budget/pow2 escape
    shapes instead and still pay a one-time compile on first sight;
    those shapes are workload-dependent, so warmup does not guess them.
    """
    p_cap, q_cap, g_cap = resolve_packed_budgets(node_budget, edge_budget,
                                                 graph_budget)
    ps = [max(1, p_cap // 16)]
    t = next_pow2(ps[0])
    if t == ps[0]:
        t *= 2
    while t < p_cap:
        ps.append(t)
        t *= 2
    if ps[-1] != p_cap:
        ps.append(p_cap)
    return [(p, *packed_rung(p, q_cap, g_cap)) for p in ps]


def packed_shape(samples: Sequence[GraphSample],
                 node_budget: Optional[int] = None,
                 edge_budget: Optional[int] = None,
                 graph_budget: Optional[int] = None,
                 ) -> Tuple[int, int, int]:
    """Padded ``(P, Q, G)`` shape for one packed bin.

    ``P`` walks a short geometric ladder of powers of two between
    ``budget/16`` and the budget (≤ 5 rungs): full bins hit the budget
    shape, part-full bins (the tail of a sweep, a small serving
    request) hit the nearest rung instead of padding all the way up.
    ``Q`` and ``G`` are tied to the chosen rung (``1.625·P`` edges,
    ``P/16`` graphs), so the compiled-shape set stays a handful, not a
    cross-product. The edge rung undercuts the sparse path's 2-per-node
    :func:`edge_floor` deliberately: a bin mixes ~dozens of graphs, so
    its aggregate density concentrates at the zoo *mean* (~1.5
    edges/node for DIPPM DAGs) rather than the per-graph worst case a
    padded row must cover; denser bins still escalate safely. An oversize bin (a lone graph larger
    than a budget — :func:`pack_graphs` never mixes one with others)
    escalates just the axes it overflows to the next power of two, the
    packed analogue of the sparse path's escape to a larger edge
    bucket.
    """
    tn = sum(s.n_nodes for s in samples)
    te = sum(s.n_edges for s in samples)
    ng = len(samples)
    cap_p, cap_q, cap_g = (int(node_budget or 0), int(edge_budget or 0),
                           int(graph_budget or 0))
    if cap_p and tn <= cap_p:
        p = min(cap_p, max(next_pow2(max(tn, 1)), max(1, cap_p // 16)))
    else:
        p = next_pow2(max(tn, 1))
    # Q and G step: rung → full budget → power-of-two escalation. The
    # middle step matters for non-pow2 budgets (a trainer batch of 12):
    # content over the rung but within budget must use the budget
    # exactly, never a pow2 that overshoots it.
    q_rung, g_rung = packed_rung(p, cap_q, cap_g)
    if cap_q and te <= q_rung:
        q = q_rung
    elif cap_q and te <= cap_q:
        q = cap_q
    else:
        q = max(q_rung, edge_bucket_for(te))
    if cap_g and ng <= g_rung:
        g = g_rung
    elif cap_g and ng <= cap_g:
        g = cap_g
    else:
        g = max(g_rung, next_pow2(max(ng, 1)))
    return p, q, g


def pack_graphs(samples: Sequence[GraphSample],
                node_budget: Optional[int] = None,
                edge_budget: Optional[int] = None,
                graph_budget: Optional[int] = None,
                sort: bool = True) -> List[List[int]]:
    """Greedy token-budget bin-packing → bins of sample *indices*.

    First-fit-decreasing over real (unpadded) node counts: samples are
    considered largest-first (``sort=False`` keeps input order — useful
    for order-sensitivity tests) and each goes into the first open bin
    whose node/edge/graph budgets still fit, else opens a new bin. Mixing
    sizes freely is the point: the packed layout has no bucket
    quantization, so a bin's waste is only its tail padding.

    A sample that alone exceeds a budget gets a bin of its own (the
    collate escalates that bin's shape). Returns bins of ascending
    indices; every input index appears in exactly one bin, so callers
    can scatter per-graph results back to input order.
    """
    p, q, g = resolve_packed_budgets(node_budget, edge_budget, graph_budget)
    order = (sorted(range(len(samples)), key=lambda i: -samples[i].n_nodes)
             if sort else range(len(samples)))
    bins: List[List[int]] = []
    used: List[Tuple[int, int]] = []            # (nodes, edges) per bin
    for i in order:
        n, e = samples[i].n_nodes, samples[i].n_edges
        for b, (un, ue) in enumerate(used):
            if un + n <= p and ue + e <= q and len(bins[b]) < g:
                bins[b].append(i)
                used[b] = (un + n, ue + e)
                break
        else:
            bins.append([i])
            used.append((n, e))
    return [sorted(b) for b in bins]


def collate_packed(samples: Sequence[GraphSample],
                   node_budget: Optional[int] = None,
                   edge_budget: Optional[int] = None,
                   graph_budget: Optional[int] = None,
                   *, out: Optional[Dict[str, np.ndarray]] = None,
                   ) -> Dict[str, np.ndarray]:
    """Flatten one bin of graphs into the packed batch dict.

    Layout (``P``/``Q``/``G`` from :func:`packed_shape`; with no budgets
    given the shapes are tight powers of two):

    * ``x [P, F]`` — real node rows of every graph, concatenated
    * ``mask [P]`` — 1.0 real node / 0.0 tail padding
    * ``graph_ids [P]`` int32 — segment id of each node's graph
      (padding rows carry id 0 and are killed by ``mask``)
    * ``edges [Q, 2]`` int32 — (src, dst) with **globally offset** node
      indices; padding rows are ``(0, 0)``
    * ``edge_mask [Q]`` — 1.0 real edge / 0.0 padding
    * ``static [G, D]`` — per-graph static features (zero rows padding)
    * ``wt [G]`` — 1.0 real graph / 0.0 padded graph slot
    * ``y [G, T]`` — only when every sample is labeled (padding 1.0)

    The block-diagonal structure is implicit: edges never cross graph
    boundaries, so message passing over the flat axis is exactly
    per-graph message passing, and the segment readout over
    ``graph_ids`` replaces per-graph masked pooling.

    ``out`` lets a caller supply preallocated (zeroed) destination
    arrays — e.g. the engine's staging-buffer views — instead of fresh
    allocations; only the keys present in ``out`` are filled, and the
    budgets are ignored (the caller already sized the arrays). This
    keeps ONE fill loop as the packed-layout source of truth for
    training, eval, and the serving hot path alike.
    """
    if not samples:
        raise ValueError("collate_packed needs at least one sample")
    labeled = all(s.y is not None for s in samples)
    if out is None:
        p, q, g = packed_shape(samples, node_budget, edge_budget,
                               graph_budget)
        feat = samples[0].x.shape[1]
        sdim = samples[0].static.shape[0]
        out = {
            "x": np.zeros((p, feat), np.float32),
            "mask": np.zeros((p,), np.float32),
            "graph_ids": np.zeros((p,), np.int32),
            "edges": np.zeros((q, 2), np.int32),
            "edge_mask": np.zeros((q,), np.float32),
            "static": np.zeros((g, sdim), np.float32),
            "wt": np.zeros((g,), np.float32),
        }
        if labeled:
            out["y"] = np.ones((g, samples[0].y.shape[0]), np.float32)
    off = eoff = 0
    for gi, s in enumerate(samples):
        n, e = s.n_nodes, s.n_edges
        out["x"][off:off + n] = s.x[:n]
        out["mask"][off:off + n] = 1.0
        out["graph_ids"][off:off + n] = gi
        if e:
            out["edges"][eoff:eoff + e] = s.edges + off
            out["edge_mask"][eoff:eoff + e] = 1.0
        out["static"][gi] = s.static
        if "wt" in out:
            out["wt"][gi] = 1.0
        if labeled and "y" in out:
            out["y"][gi] = s.y
        off += n
        eoff += e
    return out


def batches_by_bucket(
    samples: Sequence[GraphSample],
    batch_size: int,
    rng: Optional[np.random.Generator] = None,
    drop_remainder: bool = False,
    sparse: bool = False,
) -> List[Dict[str, np.ndarray]]:
    """Group samples into per-bucket shuffled batches.

    Per-bucket batch size is scaled down for big buckets so the batch
    stays within a constant memory envelope — the padded ``[B, N, N]``
    adjacency cells when dense, the O(N·F + E) footprint when
    ``sparse=True`` (see :func:`max_batch_for_bucket`).
    """
    out: List[Dict[str, np.ndarray]] = []
    for size, members in sorted(group_by_bucket(samples).items()):
        e_bucket = (max(edge_bucket_for(
            max((samples[j].n_edges for j in members), default=0)),
            edge_floor(size))
            if sparse else None)
        bs = max_batch_for_bucket(size, batch_size, edges=e_bucket)
        idx = np.arange(len(members))
        if rng is not None:
            rng.shuffle(idx)
        for i in range(0, len(members), bs):
            chunk = [samples[members[j]] for j in idx[i:i + bs]]
            if drop_remainder and len(chunk) < bs:
                continue
            out.append(collate(chunk, sparse=sparse, edge_bucket=e_bucket))
    if rng is not None:
        rng.shuffle(out)  # type: ignore[arg-type]
    return out


def stack_epoch_segments(
    samples: Sequence[GraphSample],
    batch_size: int,
    rng: Optional[np.random.Generator] = None,
    batch_multiple: int = 1,
    max_steps: int = 32,
    sparse: bool = False,
    layout: Optional[str] = None,
) -> List[Dict[str, np.ndarray]]:
    """Stack an epoch into ``[S, B, ...]`` segments, the trainer's unit
    of host → device transfer.

    Every sample in a bucket lands in a step of the *same* shape:
    the per-bucket batch size ``B`` is fixed (memory-envelope cap, rounded
    up to ``batch_multiple`` so a data-parallel mesh divides it), chunks
    short of ``B`` are completed with zero-weight rows, and at most
    ``max_steps`` steps stack into one segment — so host/device transient
    memory is O(max_steps · B · N²) per segment (dense) or
    O(max_steps · B · (N·F + E)) (sparse), never O(dataset · N²).

    ``layout`` selects the step format (``"dense"`` | ``"sparse"`` |
    ``"packed"``; default follows the legacy ``sparse`` flag). Dense and
    sparse segments carry ``x [S,B,N,F]``, ``mask [S,B,N]``,
    ``static [S,B,D]``, ``y [S,B,T]``, ``wt [S,B]`` (1.0 for real rows,
    0.0 for batch padding), plus either ``adj [S,B,N,N]`` or
    ``edges [S,B,E,2]`` + ``edge_mask [S,B,E]`` (E = the bucket's edge
    bucket, floored at :func:`edge_floor` so segment shapes stay stable
    across epochs). **Packed** segments keep the *identical* batch
    schedule — same grouping, caps (the sparse envelope), and shuffle
    order, so per-step losses and updates match the padded-sparse
    reference to float tolerance — but each step's rows are flattened
    into the packed layout: ``x [S,P,F]``, ``mask [S,P]``,
    ``graph_ids [S,P]``, ``edges [S,Q,2]`` (globally offset),
    ``edge_mask [S,Q]``, ``static [S,G,D]``, ``y [S,G,T]``,
    ``wt [S,G]`` with G = B and (P, Q) the segment's tight
    power-of-two budgets over real node/edge totals — typically ~half
    the padded row volume. (Note dropout draws per-activation: packed
    steps have different activation shapes, so train-mode RNG streams
    diverge from the padded layouts; disable dropout when comparing.)

    The trainer's weighted loss makes padded rows/graph-slots exact
    no-ops, so every layout matches the eager reference numerically.

    With ``rng``, samples shuffle within buckets and the segment list
    shuffles across buckets (the scan analogue of ``batches_by_bucket``'s
    global batch shuffle — step *order within* a segment is the fusion
    trade-off, so ``max_steps`` also sets the shuffle granularity).
    """
    if batch_multiple < 1:
        raise ValueError(f"batch_multiple must be ≥ 1, got {batch_multiple}")
    if layout is None:
        layout = "sparse" if sparse else "dense"
    if layout not in ("dense", "sparse", "packed"):
        raise ValueError(f"layout must be dense|sparse|packed, got {layout!r}")
    sparse = layout == "sparse"
    packed = layout == "packed"
    segments: List[Dict[str, np.ndarray]] = []
    for size, members in sorted(group_by_bucket(samples).items()):
        e_bucket = (max(edge_bucket_for(
            max((samples[j].n_edges for j in members), default=0)),
            edge_floor(size))
            if (sparse or packed) else None)
        bs = max_batch_for_bucket(size, batch_size, edges=e_bucket)
        bs = -(-bs // batch_multiple) * batch_multiple
        idx = np.arange(len(members))
        if rng is not None:
            rng.shuffle(idx)
        ordered = [samples[members[j]] for j in idx]
        if any(s.y is None for s in ordered):
            raise ValueError("stack_epoch_segments needs labeled samples")
        feat = ordered[0].x.shape[1]
        sdim = ordered[0].static.shape[0]
        tdim = ordered[0].y.shape[0]
        per_seg = bs * max_steps
        for start in range(0, len(ordered), per_seg):
            seg = ordered[start:start + per_seg]
            n_steps = -(-len(seg) // bs)
            steps = [seg[k * bs:(k + 1) * bs] for k in range(n_steps)]
            if packed:
                segments.append(_pack_segment(steps, bs, feat, sdim, tdim))
                continue
            arrs = {
                "x": np.zeros((n_steps, bs, size, feat), np.float32),
                "mask": np.zeros((n_steps, bs, size), np.float32),
                "static": np.zeros((n_steps, bs, sdim), np.float32),
                "y": np.ones((n_steps, bs, tdim), np.float32),
                "wt": np.zeros((n_steps, bs), np.float32),
            }
            if sparse:
                arrs["edges"] = np.zeros((n_steps, bs, e_bucket, 2),
                                         np.int32)
                arrs["edge_mask"] = np.zeros((n_steps, bs, e_bucket),
                                             np.float32)
            else:
                arrs["adj"] = np.zeros((n_steps, bs, size, size),
                                       np.float32)
            for k, s in enumerate(seg):
                si, bi = divmod(k, bs)
                arrs["x"][si, bi] = s.x
                if sparse:
                    pack_edges([s], e_bucket,
                               edges_out=arrs["edges"][si, bi:bi + 1],
                               mask_out=arrs["edge_mask"][si, bi:bi + 1])
                else:
                    dense_adj(s.edges, size, out=arrs["adj"][si, bi])
                arrs["mask"][si, bi] = s.mask
                arrs["static"][si, bi] = s.static
                arrs["y"][si, bi] = s.y
                arrs["wt"][si, bi] = 1.0
            segments.append(arrs)
    if rng is not None:
        rng.shuffle(segments)  # type: ignore[arg-type]
    return segments


def _pack_segment(steps: List[List[GraphSample]], bs: int, feat: int,
                  sdim: int, tdim: int) -> Dict[str, np.ndarray]:
    """Flatten one segment's steps into packed ``[S, P, ...]`` arrays.

    Every step shares the segment's (P, Q, G=bs) budgets — tight
    powers of two over the largest step's real node/edge totals — so one
    shape serves the whole segment.
    """
    p = next_pow2(max(sum(s.n_nodes for s in st) for st in steps))
    q = edge_bucket_for(max(sum(s.n_edges for s in st) for st in steps))
    n_steps = len(steps)
    arrs = {
        "x": np.zeros((n_steps, p, feat), np.float32),
        "mask": np.zeros((n_steps, p), np.float32),
        "graph_ids": np.zeros((n_steps, p), np.int32),
        "edges": np.zeros((n_steps, q, 2), np.int32),
        "edge_mask": np.zeros((n_steps, q), np.float32),
        "static": np.zeros((n_steps, bs, sdim), np.float32),
        "y": np.ones((n_steps, bs, tdim), np.float32),
        "wt": np.zeros((n_steps, bs), np.float32),
    }
    for si, st in enumerate(steps):
        b = collate_packed(st, node_budget=p, edge_budget=q, graph_budget=bs)
        for k in arrs:
            # collate_packed may choose a smaller ladder rung than the
            # segment budget; the tail stays at its init value (zeros,
            # or ones for y — both are wt-masked no-ops)
            arrs[k][si, :b[k].shape[0]] = b[k]
    return arrs
