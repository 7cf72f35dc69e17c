"""Request-lifecycle resilience primitives for the serving stack.

The port of ``repro.serve.lifecycle``, whole: no line of it touches
JAX, so it carries over with its imports pointed at the port. The
circuit breaker guards each replica of the serving fleet
(:class:`~repro_torch.serve.fleet.ReplicaPool`).

Serving a predictor to open traffic means serving *arbitrary* graphs
from callers with their own latency budgets, on replicas that fail and
recover. This module holds the small, dependency-free pieces the rest
of ``repro_torch.serve`` composes into that story:

* **Typed terminal errors** — every accepted request resolves exactly
  once with a result or one of these, so callers can branch on *why*
  (deadline blown vs. poisoned graph vs. shedding vs. drain) instead
  of string-matching ``RuntimeError``:

  - :class:`DeadlineExceededError` — the request's ``deadline_ms``
    expired at a waiting stage (queue, cache-follower parking, bin
    staging, replica requeue);
  - :class:`PoisonRequestError` — the request was isolated as the
    cause of a failing bin (split-retry bisection) or fast-failed
    because its fingerprint is quarantined;
  - :class:`ServiceDrainingError` — the service stopped admission
    (``drain()`` / ``close()``);
  - :class:`~repro_torch.core.engine.PredictionInvalidError` (re-exported) —
    the engine produced non-finite outputs for the graph;
  - :class:`~repro_torch.core.ir.GraphValidationError` (re-exported) — the
    submitted document failed structural validation before featurizing.

* :class:`CircuitBreaker` — closed → open → half-open per-replica
  health. A replica that keeps failing stops receiving bins (open)
  until a cooldown elapses, then re-admits via a single *probe* bin
  (half-open): success closes the breaker (the replica rejoins the
  fleet), failure re-opens it. This replaces the permanent mark-dead
  of the first fleet cut, so a flapping replica costs bounded retries
  instead of either infinite retries or permanent capacity loss.

* :class:`QuarantineList` — a bounded LRU of poison-request
  fingerprints → recorded cause. A graph that deterministically kills
  its bin is isolated once (O(log n) sub-bin executions) and then
  fast-failed at the door on every resubmission, so one malicious or
  degenerate architecture cannot repeatedly burn bin slots.

Everything here is plain-Python and thread-safe; the serving layer
(``service.py`` / ``fleet.py``) owns the wiring.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from ..core.engine import PredictionInvalidError
from ..core.ir import GraphValidationError

__all__ = [
    "DeadlineExceededError", "PoisonRequestError", "ServiceDrainingError",
    "PredictionInvalidError", "GraphValidationError",
    "BreakerConfig", "CircuitBreaker", "QuarantineList",
]


class DeadlineExceededError(RuntimeError):
    """The request's deadline expired before the engine ran it.

    Raised-into (via the future) at every stage a request can wait:
    still queued at drain time, parked as a cache follower, staged into
    a bin, or stuck in a replica-requeue loop. Once a bin has actually
    been dispatched with the request aboard, a completed result still
    resolves normally — deadlines stop the service *spending* work on
    abandoned requests, they never discard work already done.
    """


class PoisonRequestError(RuntimeError):
    """The request (by content) is the isolated cause of bin failures.

    Carries the underlying cause in ``__cause__`` and its text in the
    message. Also used for quarantine fast-fails — resubmitting a
    quarantined fingerprint rejects immediately with the recorded
    cause, without occupying a queue or bin slot.
    """


class ServiceDrainingError(RuntimeError):
    """The service is draining or closed and admits no new requests."""


# ---------------------------------------------------------------------------
# Circuit breaker
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    """Trip/recovery policy for one replica's :class:`CircuitBreaker`.

    ``failure_threshold`` consecutive failures trip the breaker open
    (1 reproduces the old any-failure-marks-dead contract).
    ``failure_rate`` optionally also trips on a windowed failure
    *fraction* — ``None`` disables the rate path; when set, the breaker
    opens once at least ``min_calls`` of the last ``window`` outcomes
    are recorded and the failing fraction reaches it. ``cooldown_s``
    is how long an open breaker refuses dispatch before offering one
    half-open probe.
    """

    failure_threshold: int = 1
    failure_rate: Optional[float] = None
    window: int = 16
    min_calls: int = 4
    cooldown_s: float = 30.0


class CircuitBreaker:
    """Closed → open → half-open breaker guarding one dispatch target.

    Dispatch protocol (all methods thread-safe):

    1. :meth:`can_dispatch` — may this target take work *now*? An open
       breaker whose cooldown has elapsed transitions to half-open here.
    2. :meth:`on_dispatch` — the caller actually picked this target;
       in half-open this consumes the single probe token so exactly one
       probe bin is in flight.
    3. :meth:`record_success` / :meth:`record_failure` — outcome. A
       half-open probe success closes the breaker (returns ``True`` so
       the owner can log the revival); a failure (re-)opens it.
    """

    def __init__(self, cfg: Optional[BreakerConfig] = None):
        self.cfg = cfg or BreakerConfig()
        self._lock = threading.Lock()
        self._state = "closed"
        self._consecutive = 0
        self._outcomes: List[bool] = []      # rolling window, True = ok
        self._open_until = 0.0
        self._probe_inflight = False
        #: Total closed→open transitions (flap visibility).
        self.trips = 0

    @property
    def state(self) -> str:
        """``"closed"`` | ``"open"`` | ``"half-open"`` (as last stored —
        an elapsed cooldown only takes effect at :meth:`can_dispatch`)."""
        with self._lock:
            return self._state

    def can_dispatch(self, now: Optional[float] = None) -> bool:
        now = time.perf_counter() if now is None else now
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                if now >= self._open_until:
                    self._state = "half-open"
                    self._probe_inflight = False
                    return True
                return False
            return not self._probe_inflight          # half-open

    def on_dispatch(self, now: Optional[float] = None) -> None:
        with self._lock:
            if self._state == "half-open":
                self._probe_inflight = True

    def _push_outcome(self, ok: bool) -> None:
        self._outcomes.append(ok)
        if len(self._outcomes) > self.cfg.window:
            del self._outcomes[:len(self._outcomes) - self.cfg.window]

    def record_success(self) -> bool:
        """Record one successful dispatch; ``True`` iff this was the
        half-open probe that just re-closed the breaker."""
        with self._lock:
            self._consecutive = 0
            self._push_outcome(True)
            if self._state == "half-open":
                self._state = "closed"
                self._probe_inflight = False
                return True
            return False

    def record_failure(self, now: Optional[float] = None) -> bool:
        """Record one failed dispatch; ``True`` iff the breaker is now
        open (tripped by this failure, or re-opened by a failed probe)."""
        now = time.perf_counter() if now is None else now
        with self._lock:
            self._consecutive += 1
            self._push_outcome(False)
            if self._state == "half-open":
                self._state = "open"
                self._open_until = now + self.cfg.cooldown_s
                self._probe_inflight = False
                self.trips += 1
                return True
            if self._state == "closed" and self._tripped():
                self._state = "open"
                self._open_until = now + self.cfg.cooldown_s
                self.trips += 1
                return True
            return self._state == "open"

    def _tripped(self) -> bool:
        if self._consecutive >= self.cfg.failure_threshold:
            return True
        rate = self.cfg.failure_rate
        if rate is not None and len(self._outcomes) >= self.cfg.min_calls:
            bad = sum(1 for ok in self._outcomes if not ok)
            return bad / len(self._outcomes) >= rate
        return False

    def force_close(self) -> None:
        """Manual revive: reset to closed (``ReplicaPool.revive``)."""
        with self._lock:
            self._state = "closed"
            self._consecutive = 0
            self._outcomes.clear()
            self._probe_inflight = False


# ---------------------------------------------------------------------------
# Poison quarantine
# ---------------------------------------------------------------------------

class QuarantineList:
    """Bounded LRU of poison fingerprints → recorded cause text.

    A fingerprint lands here when split-retry bisection isolates it as
    the request whose singleton bin still fails (or the engine flags
    its output non-finite). Subsequent submits of the same fingerprint
    fail fast at the door with the recorded cause. Bounded so an
    attacker streaming unique poison cannot grow it without limit —
    old entries fall off LRU and would simply be re-isolated.
    """

    def __init__(self, capacity: int = 256):
        if capacity <= 0:
            raise ValueError(
                f"quarantine capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, str]" = OrderedDict()
        #: Cumulative counters: fingerprints recorded / door fast-fails.
        self.recorded = 0
        self.fastfails = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, fp: str) -> bool:
        with self._lock:
            return fp in self._entries

    def record(self, fp: str, cause: BaseException) -> None:
        with self._lock:
            self._entries[fp] = f"{type(cause).__name__}: {cause}"
            self._entries.move_to_end(fp)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
            self.recorded += 1

    def check(self, fp: str) -> Optional[str]:
        """The recorded cause if ``fp`` is quarantined (counts a
        fast-fail and LRU-touches the entry), else ``None``."""
        with self._lock:
            cause = self._entries.get(fp)
            if cause is not None:
                self._entries.move_to_end(fp)
                self.fastfails += 1
            return cause

    def entries(self) -> Dict[str, str]:
        """Detached snapshot (ops/debugging)."""
        with self._lock:
            return dict(self._entries)

    def remove(self, fp: str) -> bool:
        """Un-quarantine one fingerprint (manual ops, model updates)."""
        with self._lock:
            return self._entries.pop(fp, None) is not None

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
