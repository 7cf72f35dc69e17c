"""Request-oriented serving core — DIPPM as a prediction *service*.

The port of ``repro.serve.service`` over one
:class:`~repro_torch.core.engine.PredictionEngine`. The batched engine
is right when one caller already holds a graph list; serving traffic is
the opposite shape — many concurrent callers each holding ONE graph. A
per-request ``predict_graph`` loop runs a 1-graph bin per call and
leaves the engine's packed bins almost empty. :class:`PredictionService`
closes that gap:

1. **Submit** — any thread calls :meth:`~PredictionService.submit` (or
   ``submit_json``) and gets a
   :class:`~repro_torch.serve.queue.PredictionFuture` back immediately;
   featurization (``sample_from_graph``) happens on the caller's thread
   so the batcher stays on the device hot path.
2. **Coalesce** — a background micro-batcher drains the queue under a
   latency/size policy (:class:`ServeConfig`): flush when
   ``max_batch_graphs`` requests are waiting or the oldest request is
   ``max_wait_ms`` old, whichever comes first.
3. **Bin-pack + run** — the drained batch is planned into the engine's
   budget-rung bins (``PredictionEngine.plan_bins``) and each bin runs
   through the thread-safe ``PredictionEngine.run_bin`` — on the card,
   the batcher thread launches the kernels on its own current stream.
4. **Resolve in arrival order** — per-request ``Prediction``s scatter
   back to submission order; futures resolve FIFO with per-request
   latency stamped, and :attr:`PredictionService.stats` aggregates queue
   depth, batch occupancy, padding waste, and p50/p99 latency.

A **content-addressed cache** (``ServeConfig.cache_size``, on by
default) sits between submission and the engine: predictions are pure
functions of graph content, so a bounded LRU keyed on the canonical
:meth:`~repro_torch.core.ir.OpGraph.fingerprint` serves duplicates
without engine work. Hits resolve on the *submitting* thread,
bit-equal to the cold path (the cached value IS the cold path's output
vector); concurrent misses for one graph coalesce single-flight into one
engine slot. A cache hit resolves ahead of earlier still-queued misses:
arrival-order resolution holds within the engine path only.

Request-lifecycle hardening (``repro_torch.serve.lifecycle``): every
accepted future terminates exactly once, with a result or a typed error —
deadlines checked at every waiting stage, poison bins split-retried to
isolate the offender (then quarantined), ``drain()`` / ``close()``
stopping admission and settling everything in flight, and the counters
conserving ``submitted = completed + failed + deadline_expired + shed``.

Not ported yet: ``ServeConfig(replicas>1)``, the replica fleet
(ROADMAP.md A8b), and ``submit_jax``, which waits for a torch frontend
(A13); both raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.batching import (packed_rung_ladder, resolve_packed_budgets,
                             sample_from_graph)
from ..core.engine import EngineConfig, PredictionEngine
from ..core.ir import GraphValidationError, OpGraph
from .cache import CacheWaiter, PredictionCache
from .fleet import NoHealthyReplicaError
from .lifecycle import (BreakerConfig, DeadlineExceededError,
                        PoisonRequestError, PredictionInvalidError,
                        QuarantineList, ServiceDrainingError)
from .queue import PredictionFuture, QueueFullError, Request, RequestQueue

__all__ = ["ServeConfig", "ServeStats", "PredictionService"]

_NOT_PORTED_FLEET = ("ServeConfig(replicas>1) needs the replica fleet, which "
                     "is not ported yet (ROADMAP.md A8b)")
_NOT_PORTED_JAX = ("submit_jax traces a JAX callable; the port's torch "
                   "frontend is not written yet (ROADMAP.md A13) — submit "
                   "an OpGraph or a repro.opgraph.v1 document instead")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Micro-batching policy knobs — the same fields and defaults as
    ``repro.serve.ServeConfig``.

    ``max_wait_ms`` bounds how long the first request of a batch can
    wait for companions (the latency the service *adds* at low load);
    ``max_batch_graphs`` bounds how many requests coalesce into one
    drain (the throughput lever at high load). ``node_budget`` /
    ``edge_budget`` / ``graph_budget`` size the engine's packed bins
    when the service builds its own engine (ignored when wrapping an
    existing one). ``max_queue=None`` buffers without bound; an int
    turns on admission control — at capacity ``shed_policy="reject"``
    raises :class:`~repro_torch.serve.queue.QueueFullError` at the door,
    ``"oldest"`` evicts the stalest waiting request (its future rejects
    with ``QueueFullError``) and admits the new one.

    ``cache_size`` bounds the content-addressed prediction cache
    (``None``/``0`` disables it). ``replicas`` must be 1 in the port:
    the fleet that takes more, and the circuit-breaker policy
    ``breaker`` that it reads, come with ROADMAP.md A8b.

    Lifecycle knobs: ``default_deadline_ms`` applies to every submit
    that doesn't pass its own ``deadline_ms`` (``None`` = requests wait
    forever). ``quarantine_size`` bounds the poison-fingerprint LRU
    (``None``/``0`` disables quarantine — bisection still isolates
    poison, but resubmits are not fast-failed). ``poison_policy``
    selects what happens when a dispatched bin fails with a
    non-infrastructure error: ``"bisect"`` split-retries to isolate the
    poison request(s) so innocents complete, ``"fail-bin"`` fails every
    rider.
    """

    max_wait_ms: float = 2.0
    max_batch_graphs: int = 256
    node_budget: Optional[int] = None
    edge_budget: Optional[int] = None
    graph_budget: Optional[int] = None
    max_queue: Optional[int] = None
    #: Size of the rolling latency window behind the p50/p99 stats.
    latency_window: int = 2048
    #: LRU capacity of the fingerprint→prediction cache (None/0 = off).
    cache_size: Optional[int] = 2048
    #: Engine replicas behind the micro-batcher (only 1 in the port).
    replicas: int = 1
    #: Who loses when a bounded queue is full: "reject" | "oldest".
    shed_policy: str = "reject"
    #: Deadline applied to submits that don't pass one (None = never).
    default_deadline_ms: Optional[float] = None
    #: LRU capacity of the poison-fingerprint quarantine (None/0 = off).
    quarantine_size: Optional[int] = 256
    #: Failed-bin recovery: "bisect" (isolate poison) | "fail-bin".
    poison_policy: str = "bisect"
    #: Replica circuit-breaker policy, read by the fleet (A8b).
    breaker: Optional[BreakerConfig] = None


@dataclasses.dataclass(frozen=True)
class ServeStats:
    """A detached snapshot of service counters (``service.stats``).

    The fields of ``repro.serve.ServeStats`` that one engine can fill;
    the fleet's (``replicas``, ``replica_bins``, ``requeues``,
    ``breaker_states``, ``revivals``) come with ROADMAP.md A8b and
    ``bf16_max_abs_delta`` with bf16 staging (A10).

    ``batch_occupancy`` is mean graphs per drained batch — how well
    coalescing is working (1.0 ≡ the per-request loop the service
    exists to beat); it counts only engine-path requests, since cache
    hits never join a batch. ``padding_waste_frac`` comes from the
    engine (fraction of device node rows that were padding).
    Percentiles are over the last ``ServeConfig.latency_window``
    resolved requests.

    ``cache_hits`` resolved from the store, ``cache_coalesced`` joined
    an in-flight duplicate, ``cache_misses`` reached the engine.
    ``shed_count`` is requests evicted by ``shed_policy="oldest"``
    (``rejected`` counts turn-aways at the door).

    Lifecycle counters: ``deadline_expired`` requests rejected with
    ``DeadlineExceededError`` at a waiting stage; ``poisoned`` requests
    isolated by split-retry bisection; ``bisect_runs`` sub-bin
    executions spent on that isolation; ``quarantine_fastfail``
    resubmits rejected at the door; ``quarantine_entries`` fingerprints
    currently quarantined; ``invalid`` documents rejected by
    ``submit_json`` validation; ``draining`` is True once
    :meth:`PredictionService.drain` / ``close`` stopped admission.
    """

    submitted: int = 0
    completed: int = 0
    rejected: int = 0
    failed: int = 0
    shed_count: int = 0
    deadline_expired: int = 0
    poisoned: int = 0
    bisect_runs: int = 0
    quarantine_fastfail: int = 0
    quarantine_entries: int = 0
    invalid: int = 0
    draining: bool = False
    batches: int = 0
    bins: int = 0
    queue_depth: int = 0
    queue_peak: int = 0
    batch_occupancy: float = 0.0
    padding_waste_frac: float = 0.0
    latency_ms_p50: float = 0.0
    latency_ms_p99: float = 0.0
    cache_hits: int = 0
    cache_misses: int = 0
    cache_coalesced: int = 0
    cache_entries: int = 0
    hit_rate: float = 0.0
    #: Engine inference precision policy (``f32`` | ``int8-weights``).
    precision: str = "f32"


class PredictionService:
    """Thread-safe micro-batching prediction service over one engine.

    Construct from trained ``(params, cfg)`` on ``device`` (default
    ``"cuda"``) — or wrap an existing
    :class:`~repro_torch.core.engine.PredictionEngine` via ``engine=`` so
    the service shares its shape set and stats with bulk-sweep callers
    (this is how the ``DIPPM`` facade's default service is built). The
    batcher thread starts immediately and is a daemon; call
    :meth:`close` (or use the service as a context manager) for an
    orderly drain.
    """

    def __init__(self, params=None, cfg=None,
                 serve_cfg: Optional[ServeConfig] = None, *,
                 engine: Optional[PredictionEngine] = None,
                 engine_cfg: Optional[EngineConfig] = None,
                 device: Union[None, str, torch.device] = None):
        self.serve_cfg = serve_cfg or ServeConfig()
        sc = self.serve_cfg
        if sc.replicas != 1:
            raise NotImplementedError(_NOT_PORTED_FLEET)
        if engine is None:
            if params is None or cfg is None:
                raise ValueError(
                    "PredictionService needs (params, cfg) or engine=")
            if engine_cfg is None and (sc.node_budget or sc.edge_budget
                                       or sc.graph_budget):
                engine_cfg = EngineConfig(
                    node_budget=sc.node_budget
                    or EngineConfig.node_budget,
                    edge_budget=sc.edge_budget,
                    graph_budget=sc.graph_budget)
            engine = PredictionEngine(params, cfg,
                                      engine_cfg or EngineConfig(),
                                      device=device)
        self.engine = engine
        self._cache = (PredictionCache(sc.cache_size)
                       if sc.cache_size else None)
        self._quarantine = (QuarantineList(sc.quarantine_size)
                            if sc.quarantine_size else None)
        self._queue = RequestQueue(max_size=sc.max_queue,
                                   batch_hint=sc.max_batch_graphs,
                                   shed_policy=sc.shed_policy)
        self._queue.on_shed = self._on_shed
        self._state = threading.Lock()          # guards the counters below
        self._submitted = 0
        self._completed = 0
        self._engine_done = 0                   # completed via the engine path
        self._rejected = 0
        self._failed = 0
        self._shed = 0
        self._batches = 0
        self._bins = 0
        self._deadline_expired = 0
        self._poisoned = 0
        self._bisect_runs = 0
        self._invalid = 0
        self._latencies: deque = deque(maxlen=self.serve_cfg.latency_window)
        self._worker = threading.Thread(
            target=self._run, name="dippm-serve-batcher", daemon=True)
        self._worker.start()

    # -- submission ----------------------------------------------------------
    def _deadline_at(self, deadline_ms: Optional[float]) -> Optional[float]:
        """Absolute ``perf_counter`` deadline for a submit happening now
        (per-call override, else ``ServeConfig.default_deadline_ms``)."""
        ms = (deadline_ms if deadline_ms is not None
              else self.serve_cfg.default_deadline_ms)
        return None if ms is None else time.perf_counter() + ms / 1e3

    def _quarantine_fastfail(self, fp: str) -> Optional[PredictionFuture]:
        """Already-rejected future if ``fp`` is quarantined, else None.
        The caller owns the counter updates (submit vs submit_many
        account differently)."""
        if self._quarantine is None:
            return None
        cause = self._quarantine.check(fp)
        if cause is None:
            return None
        fut = PredictionFuture()
        fut._reject(PoisonRequestError(
            f"request fast-failed: fingerprint {fp[:16]}… is quarantined "
            f"as bin poison (recorded cause: {cause})"))
        return fut

    def submit(self, g: OpGraph,
               deadline_ms: Optional[float] = None) -> PredictionFuture:
        """Enqueue one graph; returns immediately with a future.

        With caching on, the canonical fingerprint is checked first: a
        hit resolves the future right here on the caller's thread
        (bit-equal to the cold path); an in-flight duplicate attaches to
        its leader and never occupies a queue slot. Only genuine misses
        are featurized and enqueued. A quarantined fingerprint returns
        an already-rejected future
        (:class:`~repro_torch.serve.lifecycle.PoisonRequestError`).
        ``deadline_ms`` (else ``ServeConfig.default_deadline_ms``)
        bounds how long the request may wait before it is rejected with
        :class:`~repro_torch.serve.lifecycle.DeadlineExceededError`.
        Raises :class:`~repro_torch.serve.queue.QueueFullError` under
        admission control and
        :class:`~repro_torch.serve.lifecycle.ServiceDrainingError` after
        :meth:`drain` / :meth:`close`.
        """
        # admission stops at drain for EVERY path — a cache hit or
        # quarantine fast-fail must not slip past a closed queue
        if self._queue.closed:
            raise ServiceDrainingError(
                "PredictionService is closed (draining) — not "
                "accepting new requests")
        meta = dict(g.meta)
        deadline = self._deadline_at(deadline_ms)
        fp = None
        flight = None
        if self._cache is not None or self._quarantine is not None:
            fp = g.fingerprint()
            fut = self._quarantine_fastfail(fp)
            if fut is not None:
                with self._state:
                    self._submitted += 1
                    self._failed += 1
                return fut
        if self._cache is not None:
            fut = PredictionFuture()
            waiter = CacheWaiter(fut, meta, time.perf_counter(), deadline)
            status, y, flight = self._cache.claim(fp, waiter)
            if status != "leader":
                with self._state:
                    self._submitted += 1
                if status == "hit":
                    self._resolve_waiter(waiter, y)
                return fut
        ecfg = self.engine.engine_cfg
        sample = sample_from_graph(g, buckets=ecfg.buckets,
                                   extended_static=ecfg.extended_static)
        return self._submit_sample(sample, meta, fp, flight, deadline)

    def submit_json(self, doc: Dict[str, Any],
                    deadline_ms: Optional[float] = None
                    ) -> PredictionFuture:
        """Enqueue a portable serialized graph (``repro.opgraph.v1`` or
        a raw exporter node list) — the ``from_json`` frontend.

        A structurally invalid document returns an already-rejected
        future carrying :class:`~repro_torch.core.ir.GraphValidationError`
        without touching the queue, so callers handling a stream of
        foreign payloads get one future-based error surface.
        """
        from ..core.frontends import from_json
        try:
            g = from_json(doc)
        except GraphValidationError as e:
            fut = PredictionFuture()
            fut._reject(e)
            with self._state:
                self._submitted += 1
                self._failed += 1
                self._invalid += 1
            return fut
        return self.submit(g, deadline_ms=deadline_ms)

    def submit_jax(self, *args, **kwargs) -> PredictionFuture:
        """Not ported: tracing a model needs the torch frontend
        (ROADMAP.md A13). Raises ``NotImplementedError``."""
        raise NotImplementedError(_NOT_PORTED_JAX)

    def _submit_sample(self, sample, meta, fp: Optional[str] = None,
                       flight=None,
                       deadline: Optional[float] = None
                       ) -> PredictionFuture:
        try:
            req = self._queue.put(sample, meta, fp, flight, deadline)
        except (QueueFullError, ServiceDrainingError) as e:
            # this request was the single-flight leader — clear the
            # flight (a leaked one would strand every future duplicate)
            # and reject any follower that attached in the meantime
            if self._cache is not None and fp is not None:
                followers = self._cache.abort(fp, flight)
                for w in followers:
                    w.future._reject(e)
                with self._state:
                    self._rejected += 1 + len(followers)
            else:
                with self._state:
                    self._rejected += 1
            raise
        with self._state:
            self._submitted += 1
        return req.future

    def submit_many(self, graphs: Sequence[OpGraph],
                    deadline_ms: Optional[float] = None
                    ) -> List[PredictionFuture]:
        """Enqueue a burst atomically — one queue transaction, so the
        batcher plans the whole burst into the same bins a direct
        engine sweep would. With caching on, duplicates inside the burst
        (and against the store) collapse first; quarantined fingerprints
        come back as already-rejected futures without occupying slots.
        All-or-nothing under admission control: a rejected burst
        enqueues nothing (its cache claims are rolled back).
        ``deadline_ms`` applies uniformly to every member."""
        if self._queue.closed:
            raise ServiceDrainingError(
                "PredictionService is closed (draining) — not "
                "accepting new requests")
        ecfg = self.engine.engine_cfg
        deadline = self._deadline_at(deadline_ms)

        def _featurize(g):
            return sample_from_graph(g, buckets=ecfg.buckets,
                                     extended_static=ecfg.extended_static)

        # route every graph first: quarantined → already-rejected
        # future, hits/followers resolve without queue slots, leaders
        # featurize and enqueue in one transaction
        slots = []   # ("leader", item_idx, _) | ("hit"/"follower",
        #              waiter, y) | ("fastfail", fut, _)
        items = []   # leaders: (sample, meta, fp, flight, deadline)
        n_fast = 0
        for g in graphs:
            meta = dict(g.meta)
            fp = None
            if self._cache is not None or self._quarantine is not None:
                fp = g.fingerprint()
                fut = self._quarantine_fastfail(fp)
                if fut is not None:
                    slots.append(("fastfail", fut, None))
                    n_fast += 1
                    continue
            if self._cache is None:
                slots.append(("leader", len(items), None))
                items.append((_featurize(g), meta, fp, None, deadline))
                continue
            fut = PredictionFuture()
            waiter = CacheWaiter(fut, meta, time.perf_counter(), deadline)
            status, y, flight = self._cache.claim(fp, waiter)
            if status == "leader":
                slots.append(("leader", len(items), None))
                items.append((_featurize(g), meta, fp, flight, deadline))
            else:
                slots.append((status, waiter, y))
        try:
            reqs = self._queue.put_many(items)
        except (QueueFullError, ServiceDrainingError) as e:
            n_rej = len(graphs) - n_fast
            if self._cache is not None:
                for _, _, fp, flight, _ in items:
                    for w in self._cache.abort(fp, flight):
                        w.future._reject(e)
                        n_rej += 1
            with self._state:
                self._rejected += n_rej
            raise
        with self._state:
            self._submitted += len(graphs)
            self._failed += n_fast
        futs: List[PredictionFuture] = []
        for kind, ref, y in slots:
            if kind == "leader":
                futs.append(reqs[ref].future)
            elif kind == "fastfail":
                futs.append(ref)
            else:
                if kind == "hit":
                    self._resolve_waiter(ref, y)
                futs.append(ref.future)
        return futs

    # -- cache / shed / lifecycle plumbing -----------------------------------
    def _resolve_waiter(self, w: CacheWaiter, y,
                        t_done: Optional[float] = None) -> None:
        """Resolve one cache hit / coalesced follower from a raw target
        vector (per-request meta, per-request latency). A follower whose
        own deadline passed while parked is rejected instead — nobody is
        waiting on that future anymore."""
        from ..core.predictor import make_prediction
        t_done = time.perf_counter() if t_done is None else t_done
        if w.deadline is not None and t_done >= w.deadline:
            w.future._reject(DeadlineExceededError(
                "request deadline expired while parked as a cache "
                "follower on an in-flight duplicate"))
            with self._state:
                self._deadline_expired += 1
            return
        lat_ms = (t_done - w.t_submit) * 1e3
        try:
            pred = make_prediction(np.asarray(y), meta=w.meta)
        except Exception as e:
            w.future._reject(e)
            with self._state:
                self._failed += 1
            return
        w.future._resolve(pred, lat_ms)
        with self._state:
            self._completed += 1
            self._latencies.append(lat_ms)

    def _fail_request(self, r: Request, e: BaseException) -> None:
        """Reject a queued request AND settle its cache flight: abort
        the fingerprint (next duplicate becomes a fresh leader) and
        reject any followers riding on it. The abort is scoped to this
        request's flight token, so it can never tear down a successor
        flight a retry has since opened. Idempotent."""
        if not r.future.done():
            r.future._reject(e)
        if self._cache is not None and r.fp is not None:
            for w in self._cache.abort(r.fp, r.flight):
                if not w.future.done():
                    w.future._reject(e)
                    with self._state:
                        self._failed += 1

    def _expire_request(self, r: Request,
                        e: Optional[BaseException] = None,
                        stage: str = "waiting in the queue") -> None:
        """Reject a request whose deadline passed at a waiting stage
        (and its followers — their leader will never run). Counts every
        rejection under ``deadline_expired``."""
        if e is None:
            e = DeadlineExceededError(
                f"request deadline expired {stage} "
                f"(deadline_ms elapsed before the engine ran it)")
        n = 0
        if not r.future.done():
            r.future._reject(e)
            n += 1
        if self._cache is not None and r.fp is not None:
            for w in self._cache.abort(r.fp, r.flight):
                if not w.future.done():
                    w.future._reject(DeadlineExceededError(
                        "single-flight leader's deadline expired before "
                        "dispatch; resubmit to become a fresh leader"))
                    n += 1
        with self._state:
            self._deadline_expired += n

    def _on_shed(self, shed: List[Request]) -> None:
        """Queue hook (runs on the *admitting* caller's thread, after
        the queue lock drops): reject evicted requests' futures."""
        n = 0
        for r in shed:
            e = QueueFullError(
                "request shed under load (ServeConfig.shed_policy="
                "'oldest'): a newer request took its queue slot")
            if not r.future.done():
                r.future._reject(e)
                n += 1
            if self._cache is not None and r.fp is not None:
                for w in self._cache.abort(r.fp, r.flight):
                    if not w.future.done():
                        w.future._reject(e)
                        n += 1
        with self._state:
            self._shed += n

    # -- synchronous conveniences (the facade's delegation path) -------------
    def flush(self) -> None:
        """Drain what's queued now instead of waiting out ``max_wait_ms``
        — bulk callers use this so delegation adds no idle latency."""
        self._queue.flush()

    def predict_one(self, g: OpGraph,
                    timeout: Optional[float] = None):
        """Synchronous single prediction: submit + flush + wait."""
        fut = self.submit(g)
        self.flush()
        return fut.result(timeout)

    def predict_many(self, graphs: Sequence[OpGraph],
                     timeout: Optional[float] = None) -> List:
        """Synchronous bulk prediction, input order preserved.

        Equivalent to the engine's ``predict_graphs`` (same bins when
        the burst fits one drain — :meth:`submit_many` enqueues
        atomically); under admission control a burst that doesn't fit
        ``max_queue`` raises
        :class:`~repro_torch.serve.queue.QueueFullError` without
        enqueuing anything.
        """
        futs = self.submit_many(list(graphs))
        self.flush()
        return [f.result(timeout) for f in futs]

    # -- lifecycle -----------------------------------------------------------
    def warmup(self, rungs=None) -> int:
        """Run every shape before traffic; returns shapes seen for the
        first time. ``rungs=None`` warms the whole ``(P, Q, G)``
        budget-rung ladder (:func:`~repro_torch.core.batching.packed_rung_ladder`);
        a sequence of ``P`` values selects rungs."""
        return self.engine.warmup(rungs="all" if rungs is None else rungs)

    def expected_rungs(self) -> int:
        """How many shapes :meth:`warmup` runs by default."""
        ecfg = self.engine.engine_cfg
        return len(packed_rung_ladder(*resolve_packed_budgets(
            ecfg.node_budget, ecfg.edge_budget, ecfg.graph_budget)))

    @property
    def draining(self) -> bool:
        """True once :meth:`drain` / :meth:`close` stopped admission."""
        return self._queue.closed

    def drain(self, timeout: Optional[float] = 10.0) -> bool:
        """Graceful drain: stop admission and settle everything in
        flight. New submits raise
        :class:`~repro_torch.serve.lifecycle.ServiceDrainingError`;
        requests already accepted are flushed through the engine — each
        future resolves with its result, a typed error, or
        ``DeadlineExceededError`` if its deadline passes first. Returns
        True when the batcher finished within ``timeout``. Idempotent.
        """
        self._queue.close()
        self._worker.join(timeout)
        return not self._worker.is_alive()

    def close(self, timeout: Optional[float] = 10.0) -> None:
        """:meth:`drain`. The engine holds nothing that needs releasing:
        its parameters are freed with the last reference to it."""
        self.drain(timeout)

    def __enter__(self) -> "PredictionService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- stats ---------------------------------------------------------------
    @property
    def stats(self) -> ServeStats:
        """A detached :class:`ServeStats` snapshot."""
        cache = self._cache
        with self._state:
            lat = np.asarray(self._latencies, dtype=np.float64)
            batches = self._batches
            occupancy = (self._engine_done / batches) if batches else 0.0
            q = self._quarantine
            return ServeStats(
                submitted=self._submitted,
                completed=self._completed,
                rejected=self._rejected,
                failed=self._failed,
                shed_count=self._shed,
                deadline_expired=self._deadline_expired,
                poisoned=self._poisoned,
                bisect_runs=self._bisect_runs,
                quarantine_fastfail=q.fastfails if q is not None else 0,
                quarantine_entries=len(q) if q is not None else 0,
                invalid=self._invalid,
                draining=self._queue.closed,
                batches=batches,
                bins=self._bins,
                queue_depth=len(self._queue),
                queue_peak=self._queue.peak_depth,
                batch_occupancy=round(occupancy, 3),
                padding_waste_frac=self.engine.stats.padding_waste_frac,
                precision=self.engine.stats.precision,
                latency_ms_p50=float(np.percentile(lat, 50))
                if lat.size else 0.0,
                latency_ms_p99=float(np.percentile(lat, 99))
                if lat.size else 0.0,
                cache_hits=cache.hits if cache is not None else 0,
                cache_misses=cache.misses if cache is not None else 0,
                cache_coalesced=(cache.coalesced
                                 if cache is not None else 0),
                cache_entries=len(cache) if cache is not None else 0,
                hit_rate=(round(cache.hit_rate, 4)
                          if cache is not None else 0.0),
            )

    # -- batcher thread ------------------------------------------------------
    def _run(self) -> None:
        sc = self.serve_cfg
        while True:
            batch, _depth = self._queue.wait_batch(
                sc.max_batch_graphs, sc.max_wait_ms / 1e3)
            if not batch:
                return                          # closed and drained
            try:
                self._process(batch)
            except Exception as e:              # pragma: no cover — belt
                # _process guards itself; this keeps ANY escape from
                # killing the batcher (a dead batcher hangs every
                # pending and future request forever)
                for r in batch:
                    self._fail_request(r, e)

    @staticmethod
    def _infra_error(e: BaseException) -> bool:
        """Failures caused by the *service*, not the request content —
        they must never quarantine the bin's riders."""
        return isinstance(e, (NoHealthyReplicaError, DeadlineExceededError))

    @staticmethod
    def _prune_bin(idx, live: List[Request], bin_err) -> List[int]:
        """Drop bin members whose deadline passed while staged behind
        earlier bins; returns the survivors."""
        now = time.perf_counter()
        keep: List[int] = []
        for j in idx:
            if live[j].expired(now):
                bin_err[j] = DeadlineExceededError(
                    "request deadline expired while staged behind "
                    "earlier bins of the same drain")
            else:
                keep.append(j)
        return keep

    def _recover_chunk(self, js: List[int], samples, ys, bin_err,
                       exc: BaseException, live: List[Request]) -> None:
        """A dispatched bin failed with ``exc`` — settle every rider.

        Infrastructure errors fail the whole chunk: the riders are
        innocent. Anything else under ``poison_policy="bisect"`` is
        split-retried: parts that pass complete their riders normally,
        and each singleton that still fails is the isolated poison — it
        alone fails (with ``PoisonRequestError``) and its fingerprint is
        quarantined.

        The split is hint-guided: ``PredictionInvalidError.bad_rows``
        (when it names a proper subset of the chunk) splits suspects
        from the rest. The hint is *advisory only* (in packed bins NaNs
        can bleed across rows through the shared gather/scatter): every
        condemnation still requires the singleton itself to fail its own
        execution, and a useless hint falls back to plain halving —
        O(log n) sub-bin runs per poison.
        """
        if (not js or self._infra_error(exc)
                or self.serve_cfg.poison_policy != "bisect"):
            for j in js:
                bin_err[j] = exc
            return
        stack: List[Tuple[List[int], BaseException]] = [(list(js), exc)]
        while stack:
            cur, err = stack.pop()
            if len(cur) == 1:
                # this request failed a run of its own (the initial
                # chunk, or its singleton sub-bin below) — condemned
                j = cur[0]
                pe = PoisonRequestError(
                    f"request isolated as bin poison by split-retry: "
                    f"{type(err).__name__}: {err}")
                pe.__cause__ = err
                bin_err[j] = pe
                r = live[j]
                if self._quarantine is not None and r.fp is not None:
                    self._quarantine.record(r.fp, err)
                with self._state:
                    self._poisoned += 1
                continue
            parts = None
            if isinstance(err, PredictionInvalidError) and err.bad_rows:
                bad = {k for k in err.bad_rows if 0 <= k < len(cur)}
                if 0 < len(bad) < len(cur):
                    suspects = [cur[k] for k in sorted(bad)]
                    rest = [cur[k] for k in range(len(cur))
                            if k not in bad]
                    parts = (suspects, rest)
            if parts is None:
                mid = len(cur) // 2
                parts = (cur[:mid], cur[mid:])
            for part in parts:
                with self._state:
                    self._bisect_runs += 1
                try:
                    ys[part] = self.engine.run_bin(
                        [samples[j] for j in part])
                except Exception as e2:
                    if self._infra_error(e2):
                        for j in part:
                            bin_err[j] = e2
                    else:
                        stack.append((part, e2))

    def _process(self, batch: List[Request]) -> None:
        from ..core.predictor import make_prediction
        lats: List[float] = []
        done = failed = n_bins = 0
        try:
            # deadline sweep at drain time: requests that expired while
            # queued never cost a bin slot
            now = time.perf_counter()
            live: List[Request] = []
            for r in batch:
                if r.expired(now):
                    self._expire_request(r)
                else:
                    live.append(r)
            if not live:
                return
            samples = [r.sample for r in live]
            # plan once, dispatch each bin through the thread-safe
            # run_bin (bin count tracked locally — the engine may be
            # shared with concurrent direct callers, so diffing its
            # counters would over-count)
            bins = self.engine.plan_bins(samples)
            n_bins = len(bins)
            ys = np.zeros((len(samples), self.engine.cfg.n_targets),
                          dtype=np.float32)
            # a failed bin settles only its own riders — and with
            # poison_policy="bisect" only the isolated offenders
            bin_err: List[Optional[BaseException]] = [None] * len(samples)
            for idx in bins:
                keep = self._prune_bin(idx, live, bin_err)
                if not keep:
                    continue
                try:
                    ys[keep] = self.engine.run_bin(
                        [samples[j] for j in keep])
                except Exception as e:
                    self._recover_chunk(keep, samples, ys, bin_err, e, live)
            t_done = time.perf_counter()
            # batch is FIFO-drained, so walking it resolves futures in
            # submission order; ys is already scattered to batch order
            for j, (r, y) in enumerate(zip(live, ys)):
                err = bin_err[j]
                if err is not None:
                    if isinstance(err, DeadlineExceededError):
                        self._expire_request(r, err)
                    else:
                        self._fail_request(r, err)
                        failed += 1
                    continue
                lat_ms = (t_done - r.t_submit) * 1e3
                try:
                    pred = make_prediction(y, meta=r.meta)
                except Exception as e:          # a bad row fails one future
                    self._fail_request(r, e)
                    failed += 1
                    continue
                lats.append(lat_ms)
                done += 1
                r.future._resolve(pred, lat_ms)
                if self._cache is not None and r.fp is not None:
                    # populate the cache and release this fingerprint's
                    # coalesced followers with the same vector (scoped
                    # to this request's flight token)
                    for w in self._cache.complete(r.fp, y, r.flight):
                        self._resolve_waiter(w, y, t_done)
        except Exception as e:                  # resolve, never hang callers
            for r in batch:
                if not r.future.done():
                    self._fail_request(r, e)
                    failed += 1
        finally:
            with self._state:
                self._completed += done
                self._engine_done += done
                self._failed += failed
                self._batches += 1
                self._bins += n_bins
                self._latencies.extend(lats)
