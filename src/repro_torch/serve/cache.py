"""Content-addressed prediction cache with single-flight dedup.

The port of ``repro.serve.cache``, whole: the cache keys on the
Weisfeiler–Lehman fingerprint that ``repro_torch.core.ir`` computes byte
for byte as the JAX package does.

At fleet scale most serving requests are duplicate architectures —
everyone queries the same popular models, and a capacity-planning sweep
hits one graph thousands of times. A prediction is a pure function of
the graph content, so the service keys a bounded LRU on the canonical
:meth:`~repro_torch.core.ir.OpGraph.fingerprint` (invariant under node
reordering — two equal graphs always hash equal) and serves duplicates
without touching the engine:

* **hit** — the stored target vector resolves the request immediately,
  on the submitting thread, bit-equal to the cold-path prediction it
  was populated from (the raw ``y`` is cached, not the ``Prediction``,
  so per-request ``meta`` still flows through).
* **single-flight** — N concurrent requests for the same uncached graph
  cost ONE engine slot: the first becomes the *leader* and rides the
  packed path; the rest attach as *followers* and resolve from the
  leader's result. A failed leader rejects its followers and clears the
  slot so the next request retries cleanly.
* **miss** — the leader's resolution populates the cache (LRU-bounded;
  ``capacity`` entries of a few floats each, so even a million-entry
  cache is tens of MB).

The cache is a plain thread-safe object with a claim/complete/abort
life cycle; :class:`~repro_torch.serve.service.PredictionService` owns the
wiring (see ``ServeConfig.cache_size``).
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["CacheWaiter", "PredictionCache"]


@dataclasses.dataclass
class CacheWaiter:
    """A follower parked on an in-flight fingerprint: its future, the
    request's own meta (cached ``y`` is meta-free), the submit time
    used to stamp ``latency_ms`` at resolution, and the absolute
    deadline (``None`` = none) — a follower whose deadline passes while
    parked is rejected with ``DeadlineExceededError`` at settlement
    instead of receiving a result it stopped waiting for."""

    future: Any
    meta: Dict[str, Any]
    t_submit: float
    deadline: Optional[float] = None


class PredictionCache:
    """Bounded LRU of ``fingerprint → y`` plus the single-flight table.

    All methods are thread-safe; the lock is internal and never held
    while user code runs. Counters: ``hits`` (resolved from the store),
    ``coalesced`` (followers that joined an in-flight leader),
    ``misses`` (leader claims — the requests that reached the engine),
    ``evictions`` (LRU pressure).
    """

    def __init__(self, capacity: int = 2048):
        if capacity <= 0:
            raise ValueError(f"cache capacity must be positive, "
                             f"got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._store: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._inflight: Dict[str, List[CacheWaiter]] = {}
        self.hits = 0
        self.misses = 0
        self.coalesced = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._store)

    @property
    def hit_rate(self) -> float:
        """Fraction of lookups served without engine work (store hits +
        coalesced followers over all lookups)."""
        total = self.hits + self.coalesced + self.misses
        return (self.hits + self.coalesced) / total if total else 0.0

    # -- claim / complete / abort -------------------------------------------
    def claim(self, key: str, waiter: CacheWaiter
              ) -> Tuple[str, Optional[np.ndarray], Optional[object]]:
        """Atomically route one lookup. Returns one of:

        * ``("hit", y, None)`` — cached; resolve now, ``waiter`` not
          kept;
        * ``("follower", None, None)`` — ``key`` is in flight;
          ``waiter`` is parked and resolves when the leader
          completes/aborts;
        * ``("leader", None, flight)`` — caller owns the flight: it
          must featurize + enqueue, and later :meth:`complete` or
          :meth:`abort` the key *with that flight token* (also on every
          enqueue-failure path — a leaked flight would strand future
          followers forever). Tokens scope settlement to the claiming
          flight: after an abort, a stale second abort (a racing
          failure path) cannot tear down the *successor* flight a
          retry has since opened for the same fingerprint.
        """
        with self._lock:
            y = self._store.get(key)
            if y is not None:
                self._store.move_to_end(key)
                self.hits += 1
                return "hit", y, None
            if key in self._inflight:
                self._inflight[key].append(waiter)
                self.coalesced += 1
                return "follower", None, None
            flight: List[CacheWaiter] = []
            self._inflight[key] = flight
            self.misses += 1
            return "leader", None, flight

    def _pop_flight(self, key: str, flight) -> List[CacheWaiter]:
        cur = self._inflight.get(key)
        if cur is None or (flight is not None and cur is not flight):
            return []                   # not ours (or already settled)
        del self._inflight[key]
        return cur

    def complete(self, key: str, y: np.ndarray,
                 flight=None) -> List[CacheWaiter]:
        """Leader resolved: store ``y`` (evicting LRU past capacity) and
        return the followers to resolve with it. ``flight`` (when
        given) must match the claiming token or no followers are
        returned. Idempotent-safe: a key that is not in flight just
        updates the store."""
        y = np.asarray(y)
        with self._lock:
            self._store[key] = y
            self._store.move_to_end(key)
            while len(self._store) > self.capacity:
                self._store.popitem(last=False)
                self.evictions += 1
            return self._pop_flight(key, flight)

    def abort(self, key: str, flight=None) -> List[CacheWaiter]:
        """Leader failed (engine error, shed, rejected enqueue): clear
        the flight WITHOUT populating the store and return the
        followers so the caller can reject them. The next request for
        ``key`` becomes a fresh leader. With a ``flight`` token the
        abort is scoped: it never settles a successor flight opened by
        a retry after this leader already failed."""
        with self._lock:
            return self._pop_flight(key, flight)
