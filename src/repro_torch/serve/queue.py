"""Request plumbing for the serving core: futures + the bounded queue.

The port of ``repro.serve.queue``, whole: plain Python over the port's
``GraphSample``.

A serving request is one graph wanting one :class:`Prediction`. The
caller gets a :class:`PredictionFuture` back immediately; the
micro-batcher (``repro_torch.serve.service``) drains queued requests, runs
them through the prediction engine in coalesced bins, and resolves the
futures in arrival order.

The queue is deliberately small and explicit (a deque + one condition
variable) rather than ``queue.Queue``: the batcher needs to *peek* the
oldest request's enqueue time to honor ``max_wait_ms``, drain many
requests atomically, and reject — not block — when the bounded-queue
admission control is on.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from ..core.batching import GraphSample
from .lifecycle import ServiceDrainingError


class QueueFullError(RuntimeError):
    """Raised by ``submit`` when admission control rejects a request.

    With ``ServeConfig(max_queue=N)`` the service refuses to buffer more
    than ``N`` waiting requests: an overloaded predictor should shed
    load at the door (the caller can retry, back off, or route
    elsewhere) instead of growing an unbounded queue whose tail
    latencies are already blown.
    """


class PredictionFuture:
    """Handle to one in-flight prediction (``concurrent.futures`` style).

    Resolved by the service's batcher thread; any thread may ``result``
    / ``exception`` / ``add_done_callback``. ``latency_ms`` is the
    request's submit→resolve wall time, filled at resolution.
    """

    __slots__ = ("_event", "_result", "_exc", "_callbacks", "_lock",
                 "latency_ms")

    def __init__(self) -> None:
        self._event = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None
        self._callbacks: List[Callable[["PredictionFuture"], None]] = []
        self._lock = threading.Lock()
        #: submit→resolve wall time in ms (None until resolved).
        self.latency_ms: Optional[float] = None

    def done(self) -> bool:
        """True once resolved (with a result or an exception)."""
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block until resolved; return the :class:`Prediction` or
        re-raise the request's exception. ``timeout`` is in seconds."""
        if not self._event.wait(timeout):
            raise TimeoutError("prediction not resolved within timeout")
        if self._exc is not None:
            raise self._exc
        return self._result

    def exception(self,
                  timeout: Optional[float] = None) -> Optional[BaseException]:
        """Block until resolved; return the exception (None on success)."""
        if not self._event.wait(timeout):
            raise TimeoutError("prediction not resolved within timeout")
        return self._exc

    def add_done_callback(
            self, fn: Callable[["PredictionFuture"], None]) -> None:
        """Run ``fn(self)`` when resolved (immediately if already done).

        Callbacks fire on the batcher thread in resolution order — the
        FIFO guarantee tests hook here. A raising callback is swallowed
        (``concurrent.futures`` semantics): user hooks must never kill
        the batcher thread or other callers' futures.
        """
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        self._run_callback(fn)

    def _run_callback(self, fn) -> None:
        try:
            fn(self)
        except Exception:                        # noqa: BLE001
            import traceback
            traceback.print_exc()

    # -- service-side resolution (single batcher thread) --------------------
    def _settle(self, result, exc: Optional[BaseException],
                latency_ms: Optional[float]) -> None:
        # outcome write + event set + callback handoff all under ONE
        # lock acquisition: a register racing with resolution either
        # lands in `cbs` (fired below) or observes the event set and
        # self-fires — no window where it is appended to the emptied
        # list and lost. First settle wins: a second _resolve/_reject
        # is a no-op, so every future terminates EXACTLY once (the
        # lifecycle invariant tests and the chaos gate assert) and
        # racing failure paths can't overwrite a delivered outcome.
        with self._lock:
            if self._event.is_set():
                return
            self._result = result
            self._exc = exc
            self.latency_ms = latency_ms
            cbs, self._callbacks = self._callbacks, []
            self._event.set()
        for fn in cbs:
            self._run_callback(fn)

    def _resolve(self, result, latency_ms: float) -> None:
        self._settle(result, None, latency_ms)

    def _reject(self, exc: BaseException) -> None:
        self._settle(None, exc, None)


@dataclasses.dataclass
class Request:
    """One queued prediction request (already featurized to a sample).

    ``fp`` is the graph's canonical fingerprint when the service's
    prediction cache or quarantine is on (this request is then a
    single-flight *leader* — the batcher completes/aborts the cache
    flight when it resolves the future) and ``None`` otherwise.
    ``flight`` is the cache-flight token returned by
    ``PredictionCache.claim`` — complete/abort are scoped to it, so a
    stale failure path can never settle a *successor* flight for the
    same fingerprint. ``deadline`` is the absolute ``perf_counter``
    instant after which no stage should spend work on this request
    (``None`` = wait forever).
    """

    sample: GraphSample
    meta: Dict[str, Any]
    future: PredictionFuture
    seq: int
    t_submit: float
    fp: Optional[str] = None
    flight: Optional[object] = None
    deadline: Optional[float] = None

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline is None:
            return False
        return (time.perf_counter() if now is None else now) >= self.deadline


class RequestQueue:
    """Bounded FIFO with coalescing-aware waits.

    At capacity (``max_size`` None = unbounded) ``put`` either raises
    :class:`QueueFullError` (``shed_policy="reject"`` — the *newest*
    request is turned away at the door) or evicts the *oldest* waiting
    requests to make room (``shed_policy="oldest"`` — fresh work
    preempts stale work whose deadline is already blown). Shed requests
    are handed to the ``on_shed`` callback AFTER the queue lock is
    released, so the owner can reject their futures without lock-order
    constraints. The consumer side is built for a micro-batcher:
    :meth:`wait_batch` blocks until a flush condition holds — batch-size
    trigger, the oldest request aging past ``max_wait``, an explicit
    :meth:`flush`, or :meth:`close` — then drains up to ``max_batch``
    requests atomically, in arrival order.
    """

    def __init__(self, max_size: Optional[int] = None,
                 batch_hint: Optional[int] = None,
                 shed_policy: str = "reject"):
        if shed_policy not in ("reject", "oldest"):
            raise ValueError(
                f"shed_policy must be 'reject' or 'oldest', "
                f"got {shed_policy!r}")
        self.max_size = max_size
        self.shed_policy = shed_policy
        #: Owner hook invoked (outside the lock) with the list of
        #: requests evicted by shed_policy="oldest".
        self.on_shed: Optional[Callable[[List[Request]], None]] = None
        #: The consumer's batch size: ``put`` wakes the batcher only on
        #: the empty→non-empty transition and when the backlog reaches
        #: this hint — mid-window arrivals don't need a wakeup (the
        #: batcher sleeps until its ``max_wait`` deadline either way),
        #: and skipping the notify keeps high-rate submit paths from
        #: paying a context switch per request.
        self.batch_hint = batch_hint
        self._items: deque[Request] = deque()
        self._cond = threading.Condition()
        #: flush watermark: drain without coalescing-wait until every
        #: request with ``seq < _flush_upto`` has been dispatched — a
        #: boolean flag would be consumed by the first drain and strand
        #: the tail of a burst larger than ``max_batch`` for a full
        #: ``max_wait`` window
        self._flush_upto = 0
        self._closed = False
        self._seq = 0
        self.peak_depth = 0

    def __len__(self) -> int:
        return len(self._items)

    @property
    def closed(self) -> bool:
        return self._closed

    def _append_locked(self, sample: GraphSample, meta: Dict[str, Any],
                       fp: Optional[str] = None, flight=None,
                       deadline: Optional[float] = None) -> Request:
        """Build + enqueue one request (caller holds the lock and has
        already checked closed/capacity) — the single construction path
        shared by :meth:`put` and :meth:`put_many`."""
        req = Request(sample=sample, meta=meta,
                      future=PredictionFuture(), seq=self._seq,
                      t_submit=time.perf_counter(), fp=fp, flight=flight,
                      deadline=deadline)
        self._seq += 1
        self._items.append(req)
        self.peak_depth = max(self.peak_depth, len(self._items))
        return req

    def _shed_locked(self, need: int) -> List[Request]:
        """Evict the ``need`` oldest waiting requests (caller holds the
        lock and has verified the queue holds at least that many)."""
        return [self._items.popleft() for _ in range(need)]

    def put(self, sample: GraphSample, meta: Dict[str, Any],
            fp: Optional[str] = None, flight=None,
            deadline: Optional[float] = None) -> Request:
        """Enqueue; returns the :class:`Request` carrying a fresh future.

        When bounded and full: ``shed_policy="reject"`` raises
        :class:`QueueFullError`; ``shed_policy="oldest"`` evicts the
        oldest waiting request instead (handed to ``on_shed`` after the
        lock drops) and admits this one. Raises
        :class:`~repro_torch.serve.lifecycle.ServiceDrainingError` (a
        ``RuntimeError``) after :meth:`close`.
        """
        shed: List[Request] = []
        with self._cond:
            if self._closed:
                raise ServiceDrainingError(
                    "PredictionService is closed (draining) — not "
                    "accepting new requests")
            if self.max_size is not None and len(self._items) >= self.max_size:
                if self.shed_policy == "oldest" and self._items:
                    shed = self._shed_locked(1)
                else:
                    raise QueueFullError(
                        f"serving queue full ({self.max_size} waiting "
                        f"requests) — admission control rejected the "
                        f"request; retry with backoff or raise "
                        f"ServeConfig.max_queue")
            req = self._append_locked(sample, meta, fp, flight, deadline)
            depth = len(self._items)
            if depth == 1 or (self.batch_hint is not None
                              and depth >= self.batch_hint):
                self._cond.notify_all()
        if shed and self.on_shed is not None:
            self.on_shed(shed)
        return req

    def put_many(self, items) -> List[Request]:
        """Atomically enqueue a burst of
        ``(sample, meta[, fp[, flight[, deadline]]])`` tuples.

        All-or-nothing under admission control: if the burst doesn't fit
        a bounded queue, nothing is enqueued and
        :class:`QueueFullError` raises — except under
        ``shed_policy="oldest"``, where the oldest waiting requests are
        evicted to make room (a burst larger than ``max_size`` itself is
        still rejected: shedding cannot make it fit). One lock
        acquisition and one wakeup for the whole burst — and, because
        the batcher can't interleave a drain mid-burst, a synchronous
        bulk caller (``predict_many``) gets the same bins a direct
        engine sweep would plan, instead of fragmenting across drains
        while later items are still being featurized.
        """
        items = [(*it, *((None,) * (5 - len(it)))) for it in items]
        shed: List[Request] = []
        with self._cond:
            if self._closed:
                raise ServiceDrainingError(
                    "PredictionService is closed (draining) — not "
                    "accepting new requests")
            if self.max_size is not None:
                need = len(self._items) + len(items) - self.max_size
                if need > 0:
                    if (self.shed_policy == "oldest"
                            and need <= len(self._items)):
                        shed = self._shed_locked(need)
                    else:
                        raise QueueFullError(
                            f"burst of {len(items)} requests does not fit "
                            f"the serving queue ({len(self._items)} "
                            f"waiting, cap {self.max_size}) — admission "
                            f"control rejected it")
            reqs = [self._append_locked(sample, meta, fp, flight, deadline)
                    for sample, meta, fp, flight, deadline in items]
            if reqs:
                self._cond.notify_all()
        if shed and self.on_shed is not None:
            self.on_shed(shed)
        return reqs

    def flush(self) -> None:
        """Ask the batcher to drain what's queued now, skipping the
        remainder of the ``max_wait`` coalescing window. Everything
        queued at flush time drains without coalescing delay even when
        it spans several ``max_batch`` drains; requests submitted later
        get a fresh window. A no-op on an empty queue (a stale
        watermark cannot outlive the items it covers, and an empty
        flush must not eat the *next* batch's window)."""
        with self._cond:
            if self._items:
                self._flush_upto = self._seq
                self._cond.notify_all()

    def close(self) -> None:
        """Refuse new requests and wake the batcher for final drains."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def wait_batch(self, max_batch: int,
                   max_wait: float) -> tuple[List[Request], int]:
        """Block for the next batch; returns ``(requests, depth_after)``.

        Returns ``([], 0)`` only when closed and fully drained. The
        coalescing rule: once the first request arrives, wait until
        ``max_batch`` are queued, the oldest request is ``max_wait``
        seconds old, or a flush/close wakes us — then drain FIFO.
        """
        with self._cond:
            while not self._items and not self._closed:
                self._cond.wait()
            if not self._items:                  # closed and drained
                return [], 0
            deadline = self._items[0].t_submit + max_wait
            while (len(self._items) < max_batch
                   and not (self._items
                            and self._items[0].seq < self._flush_upto)
                   and not self._closed):
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            n = min(len(self._items), max_batch)
            batch = [self._items.popleft() for _ in range(n)]
            return batch, len(self._items)
