"""Multi-replica serving fleet: N device-bound engines, one dispatcher.

The port of ``repro.serve.fleet``. One
:class:`~repro_torch.core.engine.PredictionEngine` caps serving
throughput at whatever a single device and a single dispatch thread
sustain. :class:`ReplicaPool` scales the backend horizontally:

* **N device-bound replicas** — each replica is a full
  ``PredictionEngine`` holding the parameters on one device
  (:func:`repro_torch.runtime.elastic.replica_placement` assigns devices
  round-robin; more replicas than devices is allowed). On a card each
  replica owns a ``torch.cuda.Stream``: its whole bin — the pinned
  uploads, every kernel and the readback — runs inside
  ``torch.cuda.stream(own)`` (the kernel wrappers launch on the current
  stream), so replicas on one card overlap one bin's host staging with
  another bin's kernels, and replicas on several cards run side by
  side. The engine lock is narrow (stats and shape bookkeeping only).
* **Least-loaded dispatch over the bin axis** — the serving
  micro-batcher plans a drained batch into bins once (:meth:`plan_bins`,
  identical to the single-engine plan) and each bin goes to the healthy
  replica with the fewest in-flight bins (ties break to the lowest
  index, so dispatch order is deterministic under sequential
  submission). Same bins → the same computations: on the CPU, and for
  kernels that sum in a fixed order on the card, fleet results are
  bit-equal to one engine's.
* **Fault handling, no lost futures** — a replica whose ``run_bin``
  raises trips its :class:`~repro_torch.serve.lifecycle.CircuitBreaker`
  (closed → open) and its bin is *requeued* to the remaining healthy
  replicas (each at most once per bin, so a poisoned bin terminates);
  only when every dispatchable replica has refused the bin does a
  :class:`NoHealthyReplicaError` (chaining the last underlying error)
  propagate to the requests' futures. An open breaker re-admits after
  ``cooldown_s`` via a single half-open *probe* bin: success re-closes
  it, failure re-opens it for another cooldown. Bins carrying a
  deadline abort the requeue loop with ``DeadlineExceededError`` once
  every rider has expired. Chaos drills drive this with
  :class:`repro_torch.runtime.fault.FailureInjector` (one per replica,
  ``step`` = that replica's dispatch count); liveness and breaker state
  are optionally mirrored to file heartbeats
  (:class:`repro_torch.runtime.fault.HeartbeatMonitor`, one file per
  replica).

The pool duck-types the engine surface the service consumes
(``engine_cfg`` / ``cfg`` / ``packed`` / ``plan_bins`` / ``run_bin`` /
``warmup`` / ``stats``), so ``PredictionService(engine=pool)`` — or
``ServeConfig(replicas=N)`` — is the only wiring needed.
"""
from __future__ import annotations

import contextlib
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.batching import GraphSample
from ..core.engine import (EngineConfig, EngineStats, PredictionEngine,
                           PredictionInvalidError)
from ..core.gnn import PMGNSConfig
from ..runtime.elastic import replica_placement
from ..runtime.fault import FailureInjector, HeartbeatMonitor
from .lifecycle import BreakerConfig, CircuitBreaker, DeadlineExceededError

__all__ = ["NoHealthyReplicaError", "ReplicaPool", "cuda_devices"]


class NoHealthyReplicaError(RuntimeError):
    """No replica can take this bin: every breaker is open (or has
    already refused this bin). Chains the last underlying replica
    error via ``__cause__`` — the serving layer treats this as an
    *infrastructure* failure (fail the bin, never quarantine its
    graphs)."""


def cuda_devices() -> List[torch.device]:
    """Every CUDA device of this process, ``cuda:0`` first. Raises when
    CUDA is missing: a fleet never falls back to the CPU by itself."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "ReplicaPool places its replicas on CUDA devices and CUDA is "
            "not available; pass devices=['cpu', ...] to run the plain "
            "versions on the CPU")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


class ReplicaPool:
    """N device-bound :class:`PredictionEngine` replicas behind a
    least-loaded dispatcher with requeue-on-failure.

    ``devices`` defaults to every CUDA device (:func:`cuda_devices`,
    which raises without CUDA); pass ``devices=["cpu", ...]`` for the
    CPU's plain versions. ``n_replicas`` defaults to one per device;
    more share devices round-robin, each on a CUDA stream of its own
    (:attr:`streams`). ``injectors`` maps replica index →
    :class:`FailureInjector` for chaos drills; ``heartbeat_dir`` turns
    on per-replica file heartbeats (replica index = host id).
    ``breaker`` sets the per-replica circuit-breaker policy — the
    default (``failure_threshold=1, cooldown_s=30``) trips on any
    failure like the old mark-dead contract, but re-admits after the
    cooldown via a half-open probe bin instead of staying dead.
    """

    def __init__(self, params, cfg: PMGNSConfig,
                 engine_cfg: Optional[EngineConfig] = None, *,
                 n_replicas: Optional[int] = None,
                 devices: Optional[Sequence[Union[str,
                                                  torch.device]]] = None,
                 injectors: Optional[Dict[int, FailureInjector]] = None,
                 heartbeat_dir: Optional[str] = None,
                 breaker: Optional[BreakerConfig] = None):
        devices = ([torch.device(d) for d in devices]
                   if devices is not None else cuda_devices())
        self.placement = replica_placement(n_replicas, len(devices))
        engine_cfg = engine_cfg or EngineConfig()
        self.replicas: List[PredictionEngine] = [
            PredictionEngine(params, cfg, engine_cfg,
                             device=devices[di])
            for di in self.placement.device_ids
        ]
        #: each replica's own CUDA stream (``None`` on the CPU)
        self.streams: List[Optional[torch.cuda.Stream]] = [
            torch.cuda.Stream(device=r.device)
            if r.device.type == "cuda" else None for r in self.replicas]
        # the parameters were uploaded on the default stream: make them
        # visible to the replica streams before the first bin
        for dev in {r.device for r in self.replicas
                    if r.device.type == "cuda"}:
            torch.cuda.synchronize(dev)
        n = len(self.replicas)
        self.injectors = dict(injectors or {})
        self._monitors = (
            [HeartbeatMonitor(heartbeat_dir, host_id=i) for i in range(n)]
            if heartbeat_dir else None)
        self._lock = threading.Lock()
        self.breaker_cfg = breaker or BreakerConfig()
        self.breakers = [CircuitBreaker(self.breaker_cfg)
                         for _ in range(n)]
        self._inflight = [0] * n
        self._dispatched = [0] * n   # attempts — the injector step counter
        self._bin_counts = [0] * n   # completed bins per replica
        self._requeues = 0
        self._revivals = 0           # half-open probes that re-closed
        self._peak_inflight = 0      # max concurrent in-flight bins, fleet-wide
        self._exec = ThreadPoolExecutor(
            max_workers=n, thread_name_prefix="dippm-replica")
        self._closed = False

    # -- engine-compatible surface (duck-typed by PredictionService) --------
    @property
    def engine_cfg(self) -> EngineConfig:
        return self.replicas[0].engine_cfg

    @property
    def cfg(self) -> PMGNSConfig:
        return self.replicas[0].cfg

    @property
    def packed(self) -> bool:
        return self.replicas[0].packed

    def plan_bins(self, samples: Sequence[GraphSample]) -> List[List[int]]:
        """Same plan as a single engine (pure — no replica state): the
        same bins run the same computations, only on more replicas."""
        return self.replicas[0].plan_bins(samples)

    def _on_stream(self, i: int):
        """The context that runs replica ``i``'s device work on its own
        stream (nothing on the CPU)."""
        s = self.streams[i]
        return (torch.cuda.stream(s) if s is not None
                else contextlib.nullcontext())

    def _warm(self, i: int, *a, **kw) -> int:
        with self._on_stream(i):
            return self.replicas[i].warmup(*a, **kw)

    def warmup(self, *a, **kw) -> int:
        """Warm every replica (same signature as
        ``PredictionEngine.warmup``; each replica keeps its own shape
        set), each on its own stream. Replicas warm concurrently;
        returns the total shapes seen for the first time."""
        futs = [self._exec.submit(self._warm, i, *a, **kw)
                for i in range(len(self.replicas))]
        return sum(f.result() for f in futs)

    # -- dispatch ------------------------------------------------------------
    def submit_bin(self, chunk: Sequence[GraphSample],
                   deadline: Optional[float] = None) -> "Future":
        """Dispatch one planned bin to the fleet; returns a
        ``concurrent.futures.Future`` of the ``[len(chunk), n_targets]``
        result. The micro-batcher fans a whole drain's bins out through
        here so they run on replicas concurrently. ``deadline`` is the
        bin's *latest* rider deadline (absolute ``perf_counter``):
        requeue attempts stop once it passes — nobody is waiting."""
        if self._closed:
            raise RuntimeError("ReplicaPool is closed")
        return self._exec.submit(self._run_with_failover, list(chunk),
                                 deadline)

    def run_bin(self, chunk: Sequence[GraphSample],
                deadline: Optional[float] = None) -> np.ndarray:
        """Synchronous single-bin dispatch (engine-compatible)."""
        return self._run_with_failover(list(chunk), deadline)

    def _pick(self, tried) -> Tuple[int, int]:
        """Least-loaded dispatchable replica not yet tried for this bin.

        Dispatchable = breaker closed, or open past its cooldown (the
        check transitions it to half-open), or half-open with no probe
        in flight. Picking a half-open replica consumes its single
        probe token, so exactly one bin probes a recovering replica.
        """
        with self._lock:
            now = time.perf_counter()
            cands = [i for i in range(len(self.replicas))
                     if i not in tried
                     and self.breakers[i].can_dispatch(now)]
            if not cands:
                raise NoHealthyReplicaError(
                    f"no dispatchable replica left for this bin "
                    f"(breakers={self.breaker_states}, "
                    f"tried={sorted(tried)})")
            i = min(cands, key=lambda j: (self._inflight[j], j))
            self.breakers[i].on_dispatch(now)
            self._inflight[i] += 1
            self._dispatched[i] += 1
            step = self._dispatched[i]
            live = sum(self._inflight)
            self._peak_inflight = max(self._peak_inflight, live)
            return i, step

    def _run_with_failover(self, chunk: List[GraphSample],
                           deadline: Optional[float] = None) -> np.ndarray:
        tried: set = set()
        last: Optional[BaseException] = None
        while True:
            if (tried and deadline is not None
                    and time.perf_counter() >= deadline):
                # requeue stage deadline: every rider of this bin has
                # expired — stop burning replica attempts on it
                raise DeadlineExceededError(
                    f"bin deadline expired after {len(tried)} failed "
                    f"dispatch attempt(s); last error: {last}")
            try:
                i, step = self._pick(tried)
            except NoHealthyReplicaError as e:
                if last is not None:
                    raise NoHealthyReplicaError(
                        f"{e} — last replica error: "
                        f"{type(last).__name__}: {last}") from last
                raise
            try:
                inj = self.injectors.get(i)
                if inj is not None:
                    inj.maybe_fail(step)
                with self._on_stream(i):
                    out = self.replicas[i].run_bin(chunk)
            except PredictionInvalidError:
                # a verdict about the BIN CONTENT (non-finite outputs),
                # not the replica — the kernels ran fine. Credit the
                # breaker as a mechanical success (a half-open probe
                # must release its token and re-close) and let the
                # serving layer bisect the poison out; requeueing the
                # same content on another replica would just fail again
                # and burn the whole fleet's breakers.
                with self._lock:
                    if self.breakers[i].record_success():
                        self._revivals += 1
                    self._inflight[i] -= 1
                self._beat(i, state=self.breakers[i].state,
                           error="PredictionInvalidError (bin content)")
                raise
            except Exception as e:
                # fault contract: ANY dispatch failure trips the
                # replica's breaker and requeues the bin on the
                # survivors (each at most once, so a genuinely poisoned
                # bin still terminates and surfaces its error). The
                # breaker re-admits the replica after its cooldown via
                # a half-open probe — no permanent capacity loss.
                last = e
                tried.add(i)
                with self._lock:
                    self.breakers[i].record_failure()
                    self._requeues += 1
                    self._inflight[i] -= 1
                self._beat(i, state=self.breakers[i].state,
                           error=f"{type(e).__name__}: {e}")
            else:
                with self._lock:
                    revived = self.breakers[i].record_success()
                    if revived:
                        self._revivals += 1
                    self._bin_counts[i] += 1
                    count = self._bin_counts[i]
                    self._inflight[i] -= 1
                self._beat(i, step_override=count,
                           state=self.breakers[i].state)
                return out

    def _beat(self, i: int, step_override: Optional[int] = None,
              **extra) -> None:
        if self._monitors is None:
            return
        step = (step_override if step_override is not None
                else self._bin_counts[i])
        self._monitors[i].beat(step, extra={"replica": i,
                                            "breaker": extra.pop(
                                                "state", "closed"),
                                            **extra})

    # -- health / stats ------------------------------------------------------
    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """The device each replica runs on."""
        return tuple(r.device for r in self.replicas)

    @property
    def health(self) -> Tuple[bool, ...]:
        """Per-replica dispatchability as seen right now: ``True`` only
        for a *closed* breaker (open and half-open replicas are both
        degraded — they get at most a probe, not regular traffic)."""
        with self._lock:
            return tuple(b.state == "closed" for b in self.breakers)

    @property
    def n_healthy(self) -> int:
        with self._lock:
            return sum(b.state == "closed" for b in self.breakers)

    @property
    def breaker_states(self) -> Tuple[str, ...]:
        """Per-replica breaker state (``closed``/``open``/``half-open``)."""
        return tuple(b.state for b in self.breakers)

    @property
    def revivals(self) -> int:
        """Half-open probes that succeeded and re-closed a breaker."""
        with self._lock:
            return self._revivals

    @property
    def replica_bins(self) -> Tuple[int, ...]:
        """Completed bins per replica — the dispatch-balance signal
        surfaced through ``ServeStats.replica_bins``."""
        with self._lock:
            return tuple(self._bin_counts)

    @property
    def requeues(self) -> int:
        with self._lock:
            return self._requeues

    @property
    def peak_inflight(self) -> int:
        """Max bins in flight across the fleet at once — >1 proves the
        replicas genuinely overlapped (the scaling benchmark's
        concurrency gate on hosts too small for wall-clock scaling)."""
        with self._lock:
            return self._peak_inflight

    def revive(self, replica: int) -> None:
        """Force a replica's breaker closed (tests / manual ops) —
        equivalent to a successful half-open probe without the wait."""
        with self._lock:
            self.breakers[replica].force_close()

    @property
    def stats(self) -> EngineStats:
        """Aggregated :class:`EngineStats` across replicas (counters
        summed; padding waste derives from the summed slot counters;
        precision policy is fleet-uniform so replica 0 speaks for it)."""
        agg = EngineStats()
        deltas = []
        for r in self.replicas:
            s = r.stats
            agg.graphs_predicted += s.graphs_predicted
            agg.batches_run += s.batches_run
            agg.cache_hits += s.cache_hits
            agg.cache_misses += s.cache_misses
            agg.cache_entries += s.cache_entries
            agg.recompiles += s.recompiles
            agg.node_slots_total += s.node_slots_total
            agg.node_slots_real += s.node_slots_real
            if s.bf16_max_abs_delta is not None:
                deltas.append(s.bf16_max_abs_delta)
        agg.precision = self.replicas[0].stats.precision
        agg.bf16_max_abs_delta = max(deltas) if deltas else None
        return agg

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        """Stop accepting bins and shut the worker pool down."""
        self._closed = True
        self._exec.shutdown(wait=True)

    def __enter__(self) -> "ReplicaPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
