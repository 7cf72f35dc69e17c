"""Request-lifecycle hardening in the PyTorch port: deadlines, poison-bin
quarantine, circuit breakers, graceful drain — and the invariant that
every accepted future terminates exactly once with the counters
conserved (``repro_torch.serve.lifecycle`` + its wiring), on
``device="cpu"``.

These are the tests of ``tests/test_lifecycle.py`` that need no replica
fleet (ROADMAP.md A8b), with a timeout on every wait. The lifecycle
schedule runs on one engine: its ``kill`` step fails the engine's next
bin instead of a replica. The structured ``from_json`` validation cases
are held against the JAX package in ``tests/test_torch_frontend.py``.
"""
import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro_torch.core import (DIPPM, OpGraph, OpNode, PMGNSConfig,  # noqa: E402
                              PredictionEngine, pmgns_init,
                              sample_from_graph)
from repro_torch.core.engine import (EngineConfig,  # noqa: E402
                                     PredictionInvalidError)
from repro_torch.core.ir import GraphValidationError  # noqa: E402
from repro_torch.serve import (BreakerConfig, CircuitBreaker,  # noqa: E402
                               DeadlineExceededError, PoisonRequestError,
                               PredictionService, QuarantineList, ServeConfig,
                               ServiceDrainingError)
from repro_torch.serve.cache import CacheWaiter, PredictionCache  # noqa: E402
from repro_torch.serve.queue import PredictionFuture  # noqa: E402

TIMEOUT = 60                          # seconds any single wait may take


def _graph(n_nodes, seed=0, nan_flops=False):
    rng = np.random.default_rng(seed)
    ops = ["dense", "conv", "relu", "add"]
    nodes = [OpNode(i, ops[i % len(ops)],
                    (int(rng.integers(1, 16)), int(rng.integers(1, 64))),
                    flops=(float("nan") if (nan_flops and i == 0)
                           else float(rng.integers(1, 10_000))),
                    macs=float(rng.integers(1, 5_000)))
             for i in range(n_nodes)]
    edges = [(i, i + 1) for i in range(n_nodes - 1)]
    return OpGraph(nodes=nodes, edges=edges, meta={"seed": seed})


def _dippm(variant):
    cfg = PMGNSConfig(variant=variant, hidden=32, layout="packed")
    return DIPPM.from_params(pmgns_init(0, cfg), cfg, device="cpu")


@pytest.fixture(scope="module")
def packed_dippm():
    return _dippm("graphsage")


# ---- circuit breaker (unit) ------------------------------------------------

def test_breaker_transitions():
    b = CircuitBreaker(BreakerConfig(failure_threshold=2, cooldown_s=10.0))
    assert b.state == "closed" and b.can_dispatch(now=0.0)
    assert not b.record_failure(now=0.0)         # 1 failure: still closed
    assert b.record_failure(now=0.0)             # 2nd trips it open
    assert b.state == "open" and b.trips == 1
    assert not b.can_dispatch(now=5.0)           # cooling down
    assert b.can_dispatch(now=11.0)              # cooldown elapsed → probe
    assert b.state == "half-open"
    b.on_dispatch(now=11.0)                      # probe token consumed
    assert not b.can_dispatch(now=11.0)          # only ONE probe in flight
    assert b.record_success() is True            # probe passed → re-closed
    assert b.state == "closed"


def test_breaker_failed_probe_reopens():
    b = CircuitBreaker(BreakerConfig(failure_threshold=1, cooldown_s=10.0))
    b.record_failure(now=0.0)
    assert b.can_dispatch(now=11.0)              # half-open
    b.on_dispatch(now=11.0)
    assert b.record_failure(now=11.0)            # probe failed → open again
    assert b.state == "open" and b.trips == 2
    assert not b.can_dispatch(now=15.0)          # fresh cooldown from probe
    assert b.can_dispatch(now=22.0)


def test_breaker_failure_rate_window():
    b = CircuitBreaker(BreakerConfig(failure_threshold=100,
                                     failure_rate=0.5, window=8,
                                     min_calls=4, cooldown_s=10.0))
    for _ in range(3):
        b.record_success()
    assert not b.record_failure(now=0.0)         # 1/4 failing < 0.5
    b.record_failure(now=0.0)
    b.record_failure(now=0.0)                    # 3/6 failing → trips
    assert b.state == "open"


# ---- quarantine list (unit) ------------------------------------------------

def test_quarantine_lru_bound_and_remove():
    q = QuarantineList(capacity=2)
    q.record("a", RuntimeError("ka"))
    q.record("b", RuntimeError("kb"))
    assert q.check("a") == "RuntimeError: ka"    # touches "a" (LRU)
    q.record("c", RuntimeError("kc"))            # evicts "b", not "a"
    assert "b" not in q and "a" in q and "c" in q
    assert len(q) == 2 and q.recorded == 3 and q.fastfails == 1
    assert q.remove("a") and not q.remove("a")
    assert q.check("a") is None
    with pytest.raises(ValueError, match="positive"):
        QuarantineList(capacity=0)


# ---- flight-token scoping (regression) -------------------------------------

def test_cache_stale_abort_cannot_tear_down_successor_flight():
    cache = PredictionCache(capacity=8)

    def _waiter():
        return CacheWaiter(PredictionFuture(), {}, time.perf_counter())

    status, _, flight1 = cache.claim("k", _waiter())
    assert status == "leader"
    assert cache.abort("k", flight1) == []       # leader fails, no followers
    status, _, flight2 = cache.claim("k", _waiter())
    assert status == "leader" and flight2 is not flight1
    w = _waiter()
    assert cache.claim("k", w)[0] == "follower"  # parked on flight2
    assert cache.abort("k", flight1) == []       # stale abort: a no-op
    followers = cache.complete("k", np.ones(3), flight2)
    assert followers == [w]                      # flight2 still intact


# ---- structured frontend validation ----------------------------------------

def test_submit_json_invalid_rejects_future_without_queue(packed_dippm):
    svc = packed_dippm.serve(max_wait_ms=30_000.0)
    try:
        fut = svc.submit_json({"nodes": [{"op": "dense"}]})
        assert fut.done()                        # rejected immediately
        assert isinstance(fut.exception(timeout=1), GraphValidationError)
        s = svc.stats
        assert s.invalid == 1 and s.failed == 1
        assert s.queue_depth == 0 and s.batches == 0  # queue untouched
    finally:
        svc.close()


# ---- deadlines -------------------------------------------------------------

def test_deadline_expired_in_queue(packed_dippm):
    svc = packed_dippm.serve(max_wait_ms=30_000.0, max_batch_graphs=1024)
    try:
        fut = svc.submit(_graph(8, seed=1), deadline_ms=1.0)
        ok = svc.submit(_graph(9, seed=2))       # no deadline: unaffected
        time.sleep(0.03)
        svc.flush()
        assert isinstance(fut.exception(timeout=TIMEOUT),
                          DeadlineExceededError)
        assert ok.result(timeout=TIMEOUT) is not None
        s = svc.stats
        assert s.deadline_expired == 1 and s.completed == 1
        assert s.failed == 0                     # typed, not a failure
    finally:
        svc.close()


def test_default_deadline_ms_applies(packed_dippm):
    svc = packed_dippm.serve(max_wait_ms=30_000.0, max_batch_graphs=1024,
                             default_deadline_ms=1.0)
    try:
        fut = svc.submit(_graph(8, seed=3))
        time.sleep(0.03)
        svc.flush()
        assert isinstance(fut.exception(timeout=TIMEOUT),
                          DeadlineExceededError)
    finally:
        svc.close()


def test_follower_deadline_expires_while_parked(packed_dippm):
    svc = packed_dippm.serve(max_wait_ms=30_000.0, max_batch_graphs=1024)
    try:
        leader = svc.submit(_graph(11, seed=4))
        follower = svc.submit(_graph(11, seed=4), deadline_ms=1.0)
        time.sleep(0.03)
        svc.flush()
        assert leader.result(timeout=TIMEOUT) is not None
        assert isinstance(follower.exception(timeout=TIMEOUT),
                          DeadlineExceededError)
        assert svc.stats.deadline_expired == 1
    finally:
        svc.close()


def test_expired_leader_rejects_followers_and_clears_flight(packed_dippm):
    svc = packed_dippm.serve(max_wait_ms=30_000.0, max_batch_graphs=1024)
    try:
        leader = svc.submit(_graph(12, seed=5), deadline_ms=1.0)
        follower = svc.submit(_graph(12, seed=5))
        time.sleep(0.03)
        svc.flush()
        assert isinstance(leader.exception(timeout=TIMEOUT),
                          DeadlineExceededError)
        assert isinstance(follower.exception(timeout=TIMEOUT),
                          DeadlineExceededError)
        retry = svc.submit(_graph(12, seed=5))   # fresh leader
        svc.flush()
        assert retry.result(timeout=TIMEOUT) is not None
    finally:
        svc.close()


# ---- poison-bin quarantine -------------------------------------------------

def _poisoned_service(dippm, monkeypatch, poison_seed=99, **serve_kw):
    """Service whose engine fails any bin containing the poison graph
    (deterministic, content-dependent — the bisection target)."""
    svc = dippm.serve(max_wait_ms=30_000.0, max_batch_graphs=1024,
                      **serve_kw)
    orig = svc.engine.run_bin

    def flaky(chunk):
        if any(s.meta.get("seed") == poison_seed for s in chunk):
            raise RuntimeError("kaboom")
        return orig(chunk)

    monkeypatch.setattr(svc.engine, "run_bin", flaky)
    return svc


def test_bisect_isolates_poison_innocents_complete(packed_dippm,
                                                   monkeypatch):
    svc = _poisoned_service(packed_dippm, monkeypatch)
    try:
        futs = [svc.submit(_graph(7, seed=s)) for s in (1, 2, 99, 3, 4)]
        svc.flush()
        errs = [f.exception(timeout=TIMEOUT) for f in futs]
        assert [e is None for e in errs] == [True, True, False, True, True]
        assert isinstance(errs[2], PoisonRequestError)
        assert "kaboom" in str(errs[2])
        assert isinstance(errs[2].__cause__, RuntimeError)
        s = svc.stats
        assert s.completed == 4 and s.failed == 1
        assert s.poisoned == 1 and s.bisect_runs >= 2
        assert s.quarantine_entries == 1
    finally:
        svc.close()


def test_quarantine_fastfails_resubmit_and_readmits(packed_dippm,
                                                    monkeypatch):
    svc = _poisoned_service(packed_dippm, monkeypatch)
    try:
        bad = _graph(7, seed=99)
        first = svc.submit(bad)
        svc.flush()
        assert isinstance(first.exception(timeout=TIMEOUT),
                          PoisonRequestError)
        before = svc.stats.bisect_runs
        again = svc.submit(bad)                  # fast-fail at the door
        assert again.done()
        assert isinstance(again.exception(timeout=1), PoisonRequestError)
        assert "quarantined" in str(again.exception(timeout=1))
        s = svc.stats
        assert s.quarantine_fastfail == 1
        assert s.bisect_runs == before           # no engine work spent
        svc._quarantine.remove(bad.fingerprint())  # manual re-admission
        readmit = svc.submit(bad)
        assert not readmit.done() or readmit.exception(timeout=1) is None
    finally:
        svc.close()


def test_poison_policy_fail_bin_fails_all_riders(packed_dippm,
                                                 monkeypatch):
    svc = _poisoned_service(packed_dippm, monkeypatch,
                            poison_policy="fail-bin")
    try:
        futs = [svc.submit(_graph(7, seed=s)) for s in (1, 2, 99)]
        svc.flush()
        errs = [f.exception(timeout=TIMEOUT) for f in futs]
        assert all(isinstance(e, RuntimeError) for e in errs)
        s = svc.stats
        assert s.failed == 3 and s.completed == 0
        assert s.poisoned == 0 and s.bisect_runs == 0
    finally:
        svc.close()


@pytest.mark.parametrize("variant", ["graphsage", "gat"])
def test_nan_graph_flagged_invalid_and_isolated(variant):
    """A graph whose features are NaN yields non-finite predictions; the
    engine flags it and the service isolates it like any other poison —
    innocents in the same bin still complete. The NaN sits in the first
    node's FLOPs, which reach the static features: GAT has no self term,
    so a NaN node feature alone would not reach an output when its node
    has no real out-edge."""
    svc = _dippm(variant).serve(max_wait_ms=30_000.0, max_batch_graphs=1024)
    try:
        futs = [svc.submit(_graph(6, seed=s, nan_flops=(s == 2)))
                for s in range(5)]
        svc.flush()
        errs = [f.exception(timeout=TIMEOUT) for f in futs]
        assert sum(e is not None for e in errs) == 1
        assert isinstance(errs[2], PoisonRequestError)
        assert isinstance(errs[2].__cause__, PredictionInvalidError)
        assert svc.stats.completed == 4
    finally:
        svc.close()


def test_engine_output_validation_flag(packed_dippm):
    eng = PredictionEngine(packed_dippm.params, packed_dippm.cfg,
                           EngineConfig(node_budget=256), device="cpu")
    bad = sample_from_graph(_graph(6, seed=1, nan_flops=True),
                            buckets=eng.engine_cfg.buckets,
                            extended_static=eng.engine_cfg.extended_static)
    with pytest.raises(PredictionInvalidError) as ei:
        eng.run_bin([bad])
    assert 0 in ei.value.bad_rows
    lax = PredictionEngine(packed_dippm.params, packed_dippm.cfg,
                           EngineConfig(node_budget=256,
                                        validate_outputs=False),
                           device="cpu")
    out = lax.run_bin([bad])                     # opt-out: raw NaNs back
    assert not np.isfinite(out).all()


# ---- graceful drain --------------------------------------------------------

def test_drain_stops_admission_and_settles_in_flight(packed_dippm):
    svc = packed_dippm.serve(max_wait_ms=30_000.0, max_batch_graphs=1024)
    futs = [svc.submit(_graph(8, seed=s)) for s in range(5)]
    assert not svc.draining
    assert svc.drain(timeout=TIMEOUT)            # flushes the queue too
    assert svc.draining
    for f in futs:
        assert f.result(timeout=1) is not None   # all settled pre-return
    with pytest.raises(ServiceDrainingError, match="closed"):
        svc.submit(_graph(5, seed=9))
    # a cached fingerprint must not slip past drain via the hit path
    with pytest.raises(ServiceDrainingError, match="closed"):
        svc.submit(_graph(8, seed=0))
    with pytest.raises(ServiceDrainingError, match="closed"):
        svc.submit_many([_graph(8, seed=0)])
    assert svc.drain(timeout=1)                  # idempotent
    assert svc.stats.draining
    svc.close()


def test_context_manager_drains_on_exit(packed_dippm):
    with packed_dippm.serve(max_wait_ms=30_000.0) as svc:
        fut = svc.submit(_graph(8, seed=1))
    assert fut.result(timeout=1) is not None     # settled by __exit__ drain


# ---- the lifecycle invariant -----------------------------------------------

class _FailNext:
    """Wraps ``run_bin`` so that the next ``n`` bins raise — the
    one-engine stand-in for a replica kill."""

    def __init__(self, run_bin):
        self._run_bin = run_bin
        self._lock = threading.Lock()
        self.armed = 0

    def __call__(self, chunk):
        with self._lock:
            fail, self.armed = self.armed > 0, max(self.armed - 1, 0)
        if fail:
            raise RuntimeError("injected bin failure")
        return self._run_bin(chunk)


class _EngineView:
    """The engine with ``run_bin`` replaced — so the schedule's failures
    never touch the shared engine object itself."""

    def __init__(self, engine, run_bin):
        self._engine = engine
        self.run_bin = run_bin

    def __getattr__(self, name):
        return getattr(self._engine, name)


@pytest.fixture(scope="module")
def chaos_engine(packed_dippm):
    return PredictionEngine(packed_dippm.params, packed_dippm.cfg,
                            EngineConfig(node_budget=256), device="cpu")


_SCHEDULE_OPS = ["submit", "dup", "expired", "poison", "kill", "burst"]


def _run_schedule(engine, ops, seed):
    """Under arbitrary schedules of submits, duplicates, deadline expiries,
    poison graphs, failing bins, load shedding, and a final drain, EVERY
    accepted future terminates with a result or a typed error — exactly
    once, nothing hangs — and the terminal counters conserve: submitted =
    completed + failed + deadline_expired + shed."""
    inject = _FailNext(engine.run_bin)
    svc = PredictionService(
        engine=_EngineView(engine, inject), serve_cfg=ServeConfig(
            max_wait_ms=1.0, max_queue=6, shed_policy="oldest",
            cache_size=64, quarantine_size=None))
    futs, fires = [], []
    uid = seed * 1000

    def track(fut):
        cell = [0]
        fut.add_done_callback(lambda _f: cell.__setitem__(0, cell[0] + 1))
        futs.append(fut)
        fires.append(cell)

    try:
        for op in ops:
            if op == "submit":
                uid += 1
                track(svc.submit(_graph(6 + uid % 9, seed=uid)))
            elif op == "dup":
                track(svc.submit(_graph(6 + uid % 9, seed=uid)))
            elif op == "expired":
                uid += 1
                track(svc.submit(_graph(6 + uid % 9, seed=uid),
                                 deadline_ms=0.01))
            elif op == "poison":
                uid += 1
                track(svc.submit(_graph(6, seed=uid, nan_flops=True)))
            elif op == "kill":
                with inject._lock:
                    inject.armed += 1
            elif op == "burst":
                uid += 1
                for f in svc.submit_many(
                        [_graph(5 + k, seed=uid) for k in range(3)]):
                    track(f)
        svc.flush()
        assert svc.drain(timeout=TIMEOUT)
        for fut, cell in zip(futs, fires):
            assert fut.done()                    # nothing hangs
            assert cell[0] == 1                  # settled exactly once
            err = fut.exception(timeout=1)
            if err is not None:                  # typed terminal errors only
                assert isinstance(err, RuntimeError)
        s = svc.stats
        assert s.submitted == (s.completed + s.failed
                               + s.deadline_expired + s.shed_count)
    finally:
        svc.close()


@settings(max_examples=12, deadline=None)
@given(ops=st.lists(st.sampled_from(_SCHEDULE_OPS),
                    min_size=1, max_size=10),
       seed=st.integers(0, 2**16))
def test_every_accepted_future_terminates_exactly_once(chaos_engine, ops,
                                                       seed):
    _run_schedule(chaos_engine, ops, seed)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_lifecycle_schedule_fixed_seeds(chaos_engine, seed):
    """Deterministic twin of the hypothesis test: seeded pseudo-random
    schedules."""
    rng = np.random.default_rng(seed)
    ops = [_SCHEDULE_OPS[int(i)]
           for i in rng.integers(0, len(_SCHEDULE_OPS), size=10)]
    _run_schedule(chaos_engine, ops, seed)
