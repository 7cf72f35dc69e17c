"""Batched multi-graph prediction engine, packed layout.

The port of the packed hot path of ``repro.core.engine``; the JAX
engine's dense and sparse chunking is not ported (ROADMAP A11c), and a
dense or sparse ``PMGNSConfig`` raises ``NotImplementedError`` here.
Trained parameters do not depend on the layout, so a model trained on
any layout serves through this engine under ``layout="packed"``.
:class:`PredictionEngine` bin-packs mixed-size graphs onto one flat node
axis (:func:`~repro_torch.core.batching.pack_graphs`), stages each bin
into two flat host buffers (float32 ``x ⊕ mask ⊕ edge_mask ⊕ static``
and int32 ``edges ⊕ graph_ids``) that ride to the device in two copies,
runs the packed PMGNS on them, and scatters the results back to input
order. Bins pad onto the ``(P, Q, G)`` budget-rung ladder
(:func:`~repro_torch.core.batching.packed_shape`), so any traffic mix
runs a handful of shapes.

PyTorch runs eagerly, so there is no compiled function per shape; the
set of ``(P, Q, G)`` shapes seen takes the place of the JAX package's
jit cache in :class:`EngineStats` (``cache_entries``, ``recompiles``,
``cache_hits``, ``cache_misses``), so the two engines report the same
numbers for the same traffic.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .batching import (DEFAULT_BUCKETS, DEFAULT_NODE_BUDGET, GraphSample,
                       collate_packed, pack_graphs, packed_rung,
                       packed_rung_ladder, packed_shape,
                       resolve_packed_budgets, sample_from_graph)
from .gnn import (PMGNS, PMGNSConfig, check_supported,
                  make_staged_packed_infer_fn, packed_staging_layout,
                  params_from_numpy, resolve_device)
from .ir import OpGraph
from .static_features import STATIC_FEATURE_DIM, STATIC_FEATURE_DIM_EXT


_NOT_PORTED_CHUNKING = (
    "the engine runs the packed layout only; its dense and sparse chunking "
    "is not ported yet (ROADMAP.md A11c) — predict with "
    "dataclasses.replace(cfg, layout='packed'), which takes the same "
    "parameters")


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
    """Knobs for the packed prediction engine.

    ``buckets`` only sets the node cap a graph is truncated to
    (:func:`~repro_torch.core.batching.pad_sample`). Every packed bin pads
    onto the ``(node_budget, edge_budget, graph_budget)`` rung ladder;
    ``None`` edge/graph budgets resolve via
    :func:`~repro_torch.core.batching.resolve_packed_budgets`
    (``2·node_budget`` edges, ``node_budget // 16`` graphs).
    """

    buckets: Tuple[int, ...] = DEFAULT_BUCKETS
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

    ``cache_entries`` is the number of distinct ``(P, Q, G)`` shapes run
    and ``recompiles`` the number of first sightings of a shape (the JAX
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


class PredictionEngine:
    """Order-preserving packed inference over many ``OpGraph``s.

    ``params`` is a numpy pytree (as ``load_artifact`` returns it) or a
    :class:`~repro_torch.core.gnn.PMGNS`; the engine holds it on
    ``device`` (default ``"cuda"``, which raises if CUDA is missing).
    :meth:`run_bin` is **thread-safe**: a lock guards the stats counters
    and the shape bookkeeping only, while staging and the device work run
    unlocked, so concurrent callers overlap.
    """

    def __init__(self, params: Union[PMGNS, dict], cfg: PMGNSConfig,
                 engine_cfg: EngineConfig = EngineConfig(), *,
                 device: Union[None, str, torch.device] = None):
        check_supported(cfg)
        if cfg.resolved_layout != "packed":
            raise NotImplementedError(_NOT_PORTED_CHUNKING)
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
            params = params.to(self.device)
        else:
            params = params_from_numpy(params, cfg, self.device)
        self.params = params
        self.cfg = cfg
        self.engine_cfg = engine_cfg
        self.stats = EngineStats(precision=cfg.resolved_precision)
        self._budgets = resolve_packed_budgets(
            engine_cfg.node_budget, engine_cfg.edge_budget,
            engine_cfg.graph_budget)
        self._shapes_seen: set = set()
        #: Guards stats counters + shape bookkeeping ONLY (not the device
        #: work): concurrent submitters share one engine and still run
        #: their bins concurrently.
        self._lock = threading.RLock()
        self._pin = self.device.type == "cuda"

    # -- shape bookkeeping ---------------------------------------------------
    def _packed_fn(self, p: int, q: int, g: int):
        with self._lock:
            key = (p, q, g)
            if key in self._shapes_seen:
                self.stats.cache_hits += 1
            else:
                self.stats.cache_misses += 1
                self.stats.recompiles += 1
                self._shapes_seen.add(key)
                self.stats.cache_entries = len(self._shapes_seen)
        return make_staged_packed_infer_fn(self.cfg, p, q, g)

    def warmup(self, rungs=None) -> int:
        """Run the packed path once per shape of a rung set (cold start).

        ``rungs=None`` warms the top rung that full bins hit, ``"all"``
        the whole typical-density ladder
        (:func:`~repro_torch.core.batching.packed_rung_ladder`), and a
        sequence of ``P`` values those rungs. Returns the number of
        shapes seen for the first time.
        """
        nb, eb, gb = self._budgets
        if rungs is None:
            shapes = [(nb, *packed_rung(nb, eb, gb))]
        elif rungs == "all":
            shapes = packed_rung_ladder(nb, eb, gb)
        else:
            shapes = [(int(p), *packed_rung(int(p), eb, gb)) for p in rungs]
        # before/run/after under the lock: a concurrent run_bin seeing a
        # new shape mid-warmup must not leak into the returned count
        with self._lock:
            before = self.stats.cache_misses
            for p, q, g in shapes:
                fn = self._packed_fn(p, q, g)
                _, _, _, f_len, i_len = packed_staging_layout(
                    self.cfg, p, q, g)
                fbuf = torch.zeros((f_len,), dtype=torch.float32,
                                   device=self.device)
                ibuf = torch.zeros((i_len,), dtype=torch.int32,
                                   device=self.device)
                fn(self.params, fbuf, ibuf).cpu()
            return self.stats.cache_misses - before

    # -- packed run ----------------------------------------------------------
    def _stage_packed(self, chunk: Sequence[GraphSample], p: int, q: int,
                      g: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Flatten a bin into the two staging buffers of
        :func:`~repro_torch.core.gnn.packed_staging_layout` (host tensors,
        pinned when the engine runs on the card), filled by
        :func:`~repro_torch.core.batching.collate_packed` through numpy
        views, then copied to the device without blocking."""
        feat = self.cfg.node_feat_dim
        sdim = self.cfg.static_dim
        o1, o2, o3, f_len, i_len = packed_staging_layout(self.cfg, p, q, g)
        fbuf = torch.zeros((f_len,), dtype=torch.float32,
                           pin_memory=self._pin)
        ibuf = torch.zeros((i_len,), dtype=torch.int32, pin_memory=self._pin)
        fnp, inp = fbuf.numpy(), ibuf.numpy()
        collate_packed(chunk, out={
            "x": fnp[:o1].reshape(p, feat),
            "mask": fnp[o1:o2],
            "edge_mask": fnp[o2:o3],
            "static": fnp[o3:].reshape(g, sdim),
            "edges": inp[:2 * q].reshape(q, 2),
            "graph_ids": inp[2 * q:],
        })
        return (fbuf.to(self.device, non_blocking=True),
                ibuf.to(self.device, non_blocking=True))

    def _run_packed(self, chunk: Sequence[GraphSample]) -> np.ndarray:
        """Run one packed bin; returns ``[len(chunk), n_targets]``."""
        nb, eb, gb = self._budgets
        p, q, g = packed_shape(chunk, nb, eb, gb)
        fbuf, ibuf = self._stage_packed(chunk, p, q, g)
        fn = self._packed_fn(p, q, g)
        out = fn(self.params, fbuf, ibuf).cpu().numpy()
        with self._lock:
            self.stats.batches_run += 1
            self.stats.node_slots_total += p
            self.stats.node_slots_real += sum(s.n_nodes for s in chunk)
        return out[:len(chunk)]

    def plan_bins(self, samples: Sequence[GraphSample]) -> List[List[int]]:
        """Split samples into the packed bins :meth:`run_bin` accepts.

        Returns lists of sample *indices*; every index appears exactly
        once, so callers can scatter per-bin results back to input order.
        """
        nb, eb, gb = self._budgets
        return pack_graphs(samples, nb, eb, gb)

    def run_bin(self, chunk: Sequence[GraphSample]) -> np.ndarray:
        """Run one pre-planned bin on the device — **thread-safe**.

        Returns ``[len(chunk), n_targets]`` physical-unit predictions in
        chunk order; raises :class:`PredictionInvalidError` on non-finite
        outputs when ``validate_outputs`` is on.
        """
        chunk = list(chunk)
        if not chunk:
            return np.zeros((0, self.cfg.n_targets), dtype=np.float32)
        out = self._run_packed(chunk)
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
        """Pad, bin-pack, and predict many graphs; one ``Prediction``
        each, in input order."""
        from .predictor import make_prediction
        samples = [
            sample_from_graph(g, buckets=self.engine_cfg.buckets,
                              extended_static=self.engine_cfg.extended_static)
            for g in graphs
        ]
        ys = self.predict_samples(samples)
        return [make_prediction(y, meta=dict(g.meta))
                for g, y in zip(graphs, ys)]
