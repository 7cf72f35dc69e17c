"""Batched multi-graph prediction engine — the port of
``repro.core.engine``.

:class:`PredictionEngine` follows the model's batch layout
(``cfg.resolved_layout``):

* **packed** — bin-packs mixed-size graphs onto one flat node axis
  (:func:`~repro_torch.core.batching.pack_graphs`), stages each bin into
  two flat host buffers (``x ⊕ mask ⊕ edge_mask ⊕ static`` and int32
  ``edges ⊕ graph_ids``) that ride to the device in two copies, and pads
  onto the ``(P, Q, G)`` budget-rung ladder
  (:func:`~repro_torch.core.batching.packed_shape`). Under
  ``precision="bf16"`` the float buffer is staged in bfloat16 (half its
  host→device bytes) and upcast on the device; parameters stay float32.
* **dense / sparse** (bucketed) — pads each graph to a node bucket,
  groups samples by bucket (:func:`~repro_torch.core.batching.group_by_bucket`),
  chunks each bucket under a memory-envelope cap and pads the chunk's
  batch axis to a power of two. Dense chunks carry an ``[B, N, N]``
  adjacency built on the host; sparse chunks a padded edge list.

Results scatter back to input order either way. PyTorch runs eagerly,
so there is no compiled function per shape; the set of shapes seen
(``(node_bucket, edge_bucket, batch_bucket)`` or ``("packed", P, Q,
G)``, the JAX engine's keys) takes the place of its jit cache in
:class:`EngineStats`, so both engines report the same numbers for the
same traffic.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .batching import (DEFAULT_BUCKETS, DEFAULT_NODE_BUDGET, GraphSample,
                       collate_packed, dense_adj, edge_bucket_for,
                       edge_floor, group_by_bucket, max_batch_for_bucket,
                       next_pow2, pack_edges, pack_graphs, packed_rung,
                       packed_rung_ladder, packed_shape,
                       resolve_packed_budgets, sample_from_graph)
from .gnn import (PMGNS, PMGNSConfig, check_supported, make_infer_fn,
                  make_staged_packed_infer_fn, packed_staging_layout,
                  params_from_numpy, params_to_numpy, resolve_device)
from .ir import OpGraph
from .static_features import STATIC_FEATURE_DIM, STATIC_FEATURE_DIM_EXT


#: Optional finer node buckets for throughput-critical sweeps (the JAX
#: package's): padded adjacency work is quadratic in the bucket, so more
#: buckets cut padded work; different padded shapes change the order of
#: reductions, so predictions can drift ~1e-4 from the default buckets.
#: Use via ``DIPPM.engine(buckets=INFERENCE_BUCKETS)``.
INFERENCE_BUCKETS: Tuple[int, ...] = (
    32, 64, 96, 128, 160, 192, 224, 256, 320, 384, 448, 512, 640, 768,
    896, 1024)


class PredictionInvalidError(RuntimeError):
    """The engine produced non-finite (NaN/Inf) outputs for a bin.

    :meth:`PredictionEngine.run_bin` validates outputs and raises this
    instead of returning corrupt numbers; ``bad_rows`` lists the in-bin
    indices whose output rows were non-finite (advisory: a NaN can bleed
    across rows of a packed bin through the gather/scatter).
    """

    def __init__(self, message: str, bad_rows: Tuple[int, ...] = ()):
        super().__init__(message)
        self.bad_rows = tuple(bad_rows)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Knobs for the prediction engine — the fields and defaults of
    ``repro.core.engine.EngineConfig``.

    ``buckets`` are the node buckets a graph pads to (and the node cap it
    is truncated to); ``max_batch`` bounds graphs per bucketed chunk at
    the reference bucket (256), and larger buckets get proportionally
    smaller caps so the padded ``[B, N, N]`` adjacency stays inside one
    memory envelope. Every packed bin pads onto the ``(node_budget,
    edge_budget, graph_budget)`` rung ladder; ``None`` edge/graph
    budgets resolve via
    :func:`~repro_torch.core.batching.resolve_packed_budgets`
    (``2·node_budget`` edges, ``node_budget // 16`` graphs).
    """

    buckets: Tuple[int, ...] = DEFAULT_BUCKETS
    max_batch: int = 64
    extended_static: bool = False
    node_budget: int = DEFAULT_NODE_BUDGET
    edge_budget: Optional[int] = None
    graph_budget: Optional[int] = None
    #: Validate bin outputs for NaN/Inf and raise
    #: :class:`PredictionInvalidError` instead of returning them.
    validate_outputs: bool = True


@dataclasses.dataclass
class EngineStats:
    """Counters exposed as :attr:`PredictionEngine.stats`.

    ``cache_entries`` is the number of distinct shapes run and
    ``recompiles`` the number of first sightings of a shape (the JAX
    engine's compile events). ``node_slots_total`` / ``node_slots_real``
    count padded vs real node rows shipped to the device;
    :attr:`padding_waste_frac` is the derived waste ratio.
    """

    graphs_predicted: int = 0
    batches_run: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    cache_entries: int = 0
    recompiles: int = 0
    node_slots_total: int = 0
    node_slots_real: int = 0
    #: Active inference precision policy (``cfg.resolved_precision``).
    precision: str = "f32"
    #: Max |bf16 − f32| prediction delta measured on a synthetic packed
    #: bin at warmup (``None`` until a bf16 packed engine warms up).
    bf16_max_abs_delta: Optional[float] = None

    @property
    def padding_waste_frac(self) -> float:
        """Fraction of device node rows that were padding (0.0 if no
        batch has run yet)."""
        if self.node_slots_total <= 0:
            return 0.0
        return 1.0 - self.node_slots_real / self.node_slots_total

    def snapshot(self) -> "EngineStats":
        """A detached copy (for ``predict_many(..., return_stats=True)``)."""
        return dataclasses.replace(self)




def _placed(dev: torch.device) -> torch.device:
    """The device a tensor sent to ``dev`` lands on (``cuda`` → the
    current card)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def stage_bf16(fbuf: np.ndarray, pin: bool = False) -> torch.Tensor:
    """A float32 host buffer rounded to a ``torch.bfloat16`` host tensor
    (pinned when ``pin``): one CPU ``copy_``, round to nearest, ties to
    even — the bits ``ml_dtypes.bfloat16`` gives every finite value and
    ±inf (a NaN stays a NaN)."""
    out = torch.empty(fbuf.shape, dtype=torch.bfloat16, pin_memory=pin)
    return out.copy_(torch.from_numpy(fbuf))


class PredictionEngine:
    """Order-preserving batched inference over many ``OpGraph``s.

    ``params`` is a numpy pytree (as ``load_artifact`` returns it) or a
    :class:`~repro_torch.core.gnn.PMGNS`; the engine holds it on
    ``device`` (default ``"cuda"``, which raises if CUDA is missing).
    :meth:`run_bin` is **thread-safe**: a lock guards the stats counters
    and the shape bookkeeping only, while staging and the device work run
    unlocked, so concurrent callers overlap. The device work — the
    pinned uploads, the kernels and the readback — runs on the calling
    thread's current CUDA stream; a serving fleet
    (:class:`~repro_torch.serve.fleet.ReplicaPool`) gives each replica a
    stream of its own.
    """

    def __init__(self, params: Union[PMGNS, dict], cfg: PMGNSConfig,
                 engine_cfg: EngineConfig = EngineConfig(), *,
                 device: Union[None, str, torch.device] = None):
        check_supported(cfg)
        feat_dim = (STATIC_FEATURE_DIM_EXT if engine_cfg.extended_static
                    else STATIC_FEATURE_DIM)
        if cfg.static_dim != feat_dim:
            raise ValueError(
                f"extended_static={engine_cfg.extended_static} produces "
                f"{feat_dim}-dim static features but the model was built "
                f"with PMGNSConfig(static_dim={cfg.static_dim})")
        self.device = resolve_device(device)
        if isinstance(params, PMGNS):
            if params.cfg != cfg:
                raise ValueError("PMGNS was built for another PMGNSConfig")
            if _placed(next(params.parameters()).device) != \
                    _placed(self.device):
                # a copy: Module.to would move the caller's parameters
                params = params_from_numpy(params_to_numpy(params), cfg,
                                           self.device)
        else:
            params = params_from_numpy(params, cfg, self.device)
        self.params = params
        self.cfg = cfg
        self.engine_cfg = engine_cfg
        self._precision = cfg.resolved_precision
        self.stats = EngineStats(precision=self._precision)
        #: the model's batch layout: sparse chunks carry padded edge lists
        #: (the shape key gains the edge bucket), packed bins one flat
        #: node axis under the ``(P, Q, G)`` budgets
        self.layout = cfg.resolved_layout
        self.sparse = self.layout == "sparse"
        self.packed = self.layout == "packed"
        #: bf16 is staging compression on the packed path: the float
        #: buffer ships in bfloat16 and the device upcasts it. Parameters
        #: stay float32. ``int8-weights`` is artifact-level, so float32
        #: here; non-packed layouts have no staged cast point and always
        #: stage float32, as in the JAX package.
        self._stage_bf16 = self._precision == "bf16" and self.packed
        self._budgets = resolve_packed_budgets(
            engine_cfg.node_budget, engine_cfg.edge_budget,
            engine_cfg.graph_budget)
        self._infer = make_infer_fn(cfg)
        self._shapes_seen: set = set()
        #: Guards stats counters + shape bookkeeping ONLY (not the device
        #: work): concurrent submitters share one engine and still run
        #: their bins concurrently.
        self._lock = threading.RLock()
        self._pin = self.device.type == "cuda"

    # -- shape bookkeeping ---------------------------------------------------
    def _track_shape(self, key: Tuple) -> None:
        """Count ``key`` as a hit or a first sighting (lock held)."""
        if key in self._shapes_seen:
            self.stats.cache_hits += 1
        else:
            self.stats.cache_misses += 1
            self.stats.recompiles += 1
            self._shapes_seen.add(key)
            self.stats.cache_entries = len(self._shapes_seen)

    def _infer_fn(self, node_bucket: int, batch_bucket: int,
                  edge_bucket: Optional[int] = None):
        with self._lock:
            self._track_shape((node_bucket, edge_bucket, batch_bucket))
        return self._infer

    def _packed_fn(self, p: int, q: int, g: int):
        with self._lock:
            self._track_shape(("packed", p, q, g))
        return make_staged_packed_infer_fn(self.cfg, p, q, g)

    def _host(self, shape, dtype=torch.float32) -> torch.Tensor:
        """A zeroed host tensor, pinned when the engine runs on the card."""
        return torch.zeros(shape, dtype=dtype, pin_memory=self._pin)

    def _upload(self, t: torch.Tensor) -> torch.Tensor:
        """Host tensor → the engine's device on the current stream."""
        return t.to(self.device, non_blocking=True)

    def warmup(self, node_buckets: Optional[Sequence[int]] = None,
               batch_buckets: Optional[Sequence[int]] = None,
               rungs=None) -> int:
        """Run every shape of a grid once before traffic (cold start).

        Bucketed engines default to every node bucket × the full
        per-bucket batch cap. Packed engines take ``rungs`` instead:
        ``None`` warms the top rung that full bins hit, ``"all"`` the
        whole typical-density ladder
        (:func:`~repro_torch.core.batching.packed_rung_ladder`), a
        sequence of ``P`` values those rungs; a bf16 packed engine then
        measures :attr:`EngineStats.bf16_max_abs_delta`. Asking either
        kind for the other's grid raises ``ValueError``. Returns the
        number of shapes seen for the first time.
        """
        sdim, feat = self.cfg.static_dim, self.cfg.node_feat_dim
        dev = self.device
        # before/run/after under the lock: a concurrent run_bin seeing a
        # new shape mid-warmup must not leak into the returned count
        if self.packed:
            if node_buckets or batch_buckets:
                raise ValueError(
                    "packed-layout engines have no node/batch buckets to "
                    "warm — shapes follow the (node_budget, edge_budget, "
                    "graph_budget) rung ladder; use warmup(rungs=...)")
            nb, eb, gb = self._budgets
            if rungs is None:
                shapes = [(nb, *packed_rung(nb, eb, gb))]
            elif rungs == "all":
                shapes = packed_rung_ladder(nb, eb, gb)
            else:
                shapes = [(int(p), *packed_rung(int(p), eb, gb))
                          for p in rungs]
            fdtype = torch.bfloat16 if self._stage_bf16 else torch.float32
            with self._lock:
                before = self.stats.cache_misses
                for p, q, g in shapes:
                    fn = self._packed_fn(p, q, g)
                    _, _, _, f_len, i_len = packed_staging_layout(
                        self.cfg, p, q, g)
                    fn(self.params,
                       torch.zeros((f_len,), dtype=fdtype, device=dev),
                       torch.zeros((i_len,), dtype=torch.int32,
                                   device=dev)).cpu()
                if self._precision == "bf16":
                    self.stats.bf16_max_abs_delta = \
                        self._measure_bf16_delta()
                return self.stats.cache_misses - before
        if rungs is not None:
            raise ValueError(
                "rungs= selects packed budget rungs; bucketed engines "
                "warm via warmup(node_buckets=..., batch_buckets=...)")
        node_buckets = tuple(node_buckets or self.engine_cfg.buckets)
        with self._lock:
            before = self.stats.cache_misses
            for n in node_buckets:
                for b in batch_buckets or (self._batch_cap(n),):
                    b = next_pow2(int(b))   # chunks pad to powers of two
                    batch = {
                        "x": torch.zeros((b, n, feat), device=dev),
                        "mask": torch.zeros((b, n), device=dev),
                        "static": torch.zeros((b, sdim), device=dev),
                    }
                    if self.sparse:
                        e = self._edge_floor(n)
                        fn = self._infer_fn(n, b, e)
                        batch["edges"] = torch.zeros(
                            (b, e, 2), dtype=torch.int32, device=dev)
                        batch["edge_mask"] = torch.zeros((b, e), device=dev)
                    else:
                        fn = self._infer_fn(n, b)
                        batch["adj"] = torch.zeros((b, n, n), device=dev)
                    fn(self.params, batch).cpu()
            return self.stats.cache_misses - before

    def _measure_bf16_delta(self) -> float:
        """Max |bf16 − f32| prediction delta on one synthetic packed bin.

        The JAX engine's probe, on the same inputs (numpy
        ``default_rng(0)``, ``P = min(node_budget, 256)``, 7/8 of the rows
        and half the edges real, ascending graph ids): the engine's bf16
        staged path against a float32 twin of the same shape, over the
        real graph rows.
        """
        nb, eb, gb = self._budgets
        p = min(nb, 256)
        q, g = packed_rung(p, eb, gb)
        feat, sdim = self.cfg.node_feat_dim, self.cfg.static_dim
        o1, o2, o3, f_len, i_len = packed_staging_layout(self.cfg, p, q, g)
        rng = np.random.default_rng(0)
        n_real, q_real, g_real = p * 7 // 8, q // 2, max(g // 2, 1)
        fbuf = np.zeros(f_len, np.float32)
        ibuf = np.zeros(i_len, np.int32)
        x = fbuf[:o1].reshape(p, feat)
        x[:n_real] = rng.standard_normal((n_real, feat)).astype(np.float32)
        fbuf[o1:o1 + n_real] = 1.0                      # node mask
        fbuf[o2:o2 + q_real] = 1.0                      # edge mask
        fbuf[o3:] = rng.standard_normal(g * sdim).astype(np.float32)
        ibuf[:2 * q_real] = rng.integers(0, n_real, 2 * q_real)
        ibuf[2 * q:] = np.minimum(np.arange(p) * g_real // max(n_real, 1),
                                  g_real - 1)           # ascending ids
        ib = self._upload(torch.from_numpy(ibuf))
        y16 = self._packed_fn(p, q, g)(
            self.params, self._upload(stage_bf16(fbuf)), ib).cpu().numpy()
        cfg32 = dataclasses.replace(self.cfg, precision="f32")
        y32 = make_staged_packed_infer_fn(cfg32, p, q, g)(
            self.params, self._upload(torch.from_numpy(fbuf)),
            ib).cpu().numpy()
        return float(np.max(np.abs(y16[:g_real] - y32[:g_real])))

    @staticmethod
    def _edge_floor(node_bucket: int) -> int:
        """Per-node-bucket edge-bucket floor
        (:func:`~repro_torch.core.batching.edge_floor`): sparse chunks at
        or below that density share one shape, the one :meth:`warmup`
        runs."""
        return edge_floor(node_bucket)

    def _batch_cap(self, node_bucket: int) -> int:
        """Chunk-size cap for a bucket: the memory-envelope cap rounded
        *down* to a power of two, so padded chunks never exceed the
        envelope and full chunks hit one shape. Sparse chunks have no N²
        term; their cap comes from the O(N·F + E) footprint at the
        bucket's edge floor."""
        edges = self._edge_floor(node_bucket) if self.sparse else None
        cap = max_batch_for_bucket(node_bucket, self.engine_cfg.max_batch,
                                   edges=edges)
        return 1 << (cap.bit_length() - 1)

    # -- bucketed run --------------------------------------------------------
    def _run_chunk(self, node_bucket: int,
                   chunk: Sequence[GraphSample]) -> np.ndarray:
        """Run one same-bucket chunk; returns ``[len(chunk), n_targets]``.

        The batch axis pads to a power of two. Dense chunks get their
        ``[B, N, N]`` adjacency built on the host; sparse chunks an edge
        list padded to the larger of the chunk's edge bucket and the node
        bucket's floor. Every array is filled in (pinned) host memory and
        uploaded without blocking.
        """
        b = len(chunk)
        bb = next_pow2(b)
        feat = chunk[0].x.shape[1]
        sdim = chunk[0].static.shape[0]
        host = {"x": self._host((bb, node_bucket, feat)),
                "mask": self._host((bb, node_bucket)),
                "static": self._host((bb, sdim))}
        x, mask, static = (host[k].numpy() for k in ("x", "mask", "static"))
        for i, s in enumerate(chunk):
            x[i], mask[i], static[i] = s.x, s.mask, s.static
        if self.sparse:
            eb = max(edge_bucket_for(max(s.n_edges for s in chunk)),
                     self._edge_floor(node_bucket))
            host["edges"] = self._host((bb, eb, 2), torch.int32)
            host["edge_mask"] = self._host((bb, eb))
            pack_edges(chunk, eb, edges_out=host["edges"].numpy()[:b],
                       mask_out=host["edge_mask"].numpy()[:b])
            fn = self._infer_fn(node_bucket, bb, eb)
        else:
            host["adj"] = self._host((bb, node_bucket, node_bucket))
            adj = host["adj"].numpy()
            for i, s in enumerate(chunk):
                dense_adj(s.edges, node_bucket, out=adj[i])
            fn = self._infer_fn(node_bucket, bb)
        batch = {k: self._upload(v) for k, v in host.items()}
        out = fn(self.params, batch).cpu().numpy()
        with self._lock:
            self.stats.batches_run += 1
            self.stats.node_slots_total += bb * node_bucket
            self.stats.node_slots_real += sum(s.n_nodes for s in chunk)
        return out[:b]

    # -- packed run ----------------------------------------------------------
    def _stage_packed(self, chunk: Sequence[GraphSample], p: int, q: int,
                      g: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Flatten a bin into the two staging buffers of
        :func:`~repro_torch.core.gnn.packed_staging_layout`, as host
        tensors (pinned when the engine runs on the card), filled by
        :func:`~repro_torch.core.batching.collate_packed` through numpy
        views. Under bf16 the float buffer is filled in float32 and then
        rounded into a bfloat16 one (:func:`stage_bf16`)."""
        feat = self.cfg.node_feat_dim
        sdim = self.cfg.static_dim
        o1, o2, o3, f_len, i_len = packed_staging_layout(self.cfg, p, q, g)
        ibuf = self._host((i_len,), torch.int32)
        if self._stage_bf16:
            fnp = np.zeros(f_len, np.float32)
        else:
            fbuf = self._host((f_len,))
            fnp = fbuf.numpy()
        inp = ibuf.numpy()
        collate_packed(chunk, out={
            "x": fnp[:o1].reshape(p, feat),
            "mask": fnp[o1:o2],
            "edge_mask": fnp[o2:o3],
            "static": fnp[o3:].reshape(g, sdim),
            "edges": inp[:2 * q].reshape(q, 2),
            "graph_ids": inp[2 * q:],
        })
        if self._stage_bf16:
            fbuf = stage_bf16(fnp, pin=self._pin)
        return fbuf, ibuf

    def _run_packed(self, chunk: Sequence[GraphSample]) -> np.ndarray:
        """Run one packed bin; returns ``[len(chunk), n_targets]``."""
        nb, eb, gb = self._budgets
        p, q, g = packed_shape(chunk, nb, eb, gb)
        fbuf, ibuf = self._stage_packed(chunk, p, q, g)
        fn = self._packed_fn(p, q, g)
        out = fn(self.params, self._upload(fbuf),
                 self._upload(ibuf)).cpu().numpy()
        with self._lock:
            self.stats.batches_run += 1
            self.stats.node_slots_total += p
            self.stats.node_slots_real += sum(s.n_nodes for s in chunk)
        return out[:len(chunk)]

    def plan_bins(self, samples: Sequence[GraphSample]) -> List[List[int]]:
        """Split samples into the device bins :meth:`run_bin` accepts.

        Packed engines bin-pack mixed-size graphs under the budget rungs
        (:func:`~repro_torch.core.batching.pack_graphs`); bucketed
        engines group by node bucket and chunk under the memory-envelope
        cap. Returns lists of sample *indices*; every index appears
        exactly once, so callers can scatter per-bin results back to
        input order.
        """
        if self.packed:
            nb, eb, gb = self._budgets
            return pack_graphs(samples, nb, eb, gb)
        bins: List[List[int]] = []
        for size, members in sorted(group_by_bucket(samples).items()):
            cap = self._batch_cap(size)
            bins.extend(members[i:i + cap]
                        for i in range(0, len(members), cap))
        return bins

    def run_bin(self, chunk: Sequence[GraphSample]) -> np.ndarray:
        """Run one pre-planned bin on the device — **thread-safe**.

        Non-packed bins must be same-bucket (``plan_bins`` guarantees
        it; a mixed one raises ``ValueError``). Returns
        ``[len(chunk), n_targets]`` physical-unit predictions in chunk
        order; raises :class:`PredictionInvalidError` on non-finite
        outputs when ``validate_outputs`` is on.
        """
        chunk = list(chunk)
        if not chunk:
            return np.zeros((0, self.cfg.n_targets), dtype=np.float32)
        if self.packed:
            out = self._run_packed(chunk)
        else:
            sizes = {s.x.shape[0] for s in chunk}
            if len(sizes) != 1:
                raise ValueError(
                    f"run_bin needs a single-bucket chunk, got padded "
                    f"sizes {sorted(sizes)} — plan with plan_bins()")
            out = self._run_chunk(sizes.pop(), chunk)
        if self.engine_cfg.validate_outputs:
            finite = np.isfinite(out).all(axis=-1)
            if not finite.all():
                bad = tuple(int(i) for i in np.flatnonzero(~finite))
                raise PredictionInvalidError(
                    f"non-finite predictions for {len(bad)}/{len(chunk)} "
                    f"graphs in bin (rows {bad[:8]}"
                    f"{'...' if len(bad) > 8 else ''}) — degenerate "
                    f"input features or numeric overflow", bad_rows=bad)
        with self._lock:
            self.stats.graphs_predicted += len(chunk)
        return out

    def predict_samples(self, samples: Sequence[GraphSample]) -> np.ndarray:
        """Predict targets for padded samples, in input order:
        ``[len(samples), n_targets]`` (latency ms, energy J, memory MB)."""
        samples = list(samples)
        out = np.zeros((len(samples), self.cfg.n_targets), dtype=np.float32)
        for idx in self.plan_bins(samples):
            out[idx] = self.run_bin([samples[j] for j in idx])
        return out

    def predict_graphs(self, graphs: Sequence[OpGraph]) -> List["Prediction"]:
        """Pad, bin, and predict many graphs; one ``Prediction`` each, in
        input order."""
        from .predictor import make_prediction
        samples = [
            sample_from_graph(g, buckets=self.engine_cfg.buckets,
                              extended_static=self.engine_cfg.extended_static)
            for g in graphs
        ]
        ys = self.predict_samples(samples)
        return [make_prediction(y, meta=dict(g.meta))
                for g, y in zip(graphs, ys)]
