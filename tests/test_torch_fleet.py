"""The replica fleet and the runtime helpers of the PyTorch port.

``repro_torch.serve.fleet.ReplicaPool`` puts N engines behind a
least-loaded dispatcher with circuit breakers and requeue on failure;
``repro_torch.runtime`` holds the heartbeats, the failure injector, the
training supervisor and the replica placement it uses. These are the
fleet tests of ``tests/test_serve.py`` and ``tests/test_lifecycle.py``
and the runtime tests of ``tests/test_checkpoint_runtime.py``, run on the
port with ``devices=["cpu"]`` and a timeout on every wait. On the CPU the
plain versions make fleet results bit-equal to one engine's. The card
test holds two replicas on one card, each on its own CUDA stream, to one
engine's bits on the GAT model (its kernels sum in a fixed order).
"""
import os
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro_torch.core import (DIPPM, OpGraph, OpNode, PMGNSConfig,  # noqa: E402
                              PredictionEngine, pmgns_init)
from repro_torch.core.engine import EngineConfig  # noqa: E402
from repro_torch.runtime import (FailureInjector, HeartbeatMonitor,  # noqa: E402
                                 TrainingSupervisor, elastic_restart_plan,
                                 replica_placement, reshard_state)
from repro_torch.serve import (BreakerConfig, NoHealthyReplicaError,  # noqa: E402
                               PoisonRequestError, PredictionService,
                               ReplicaPool, ServeConfig)

TIMEOUT = 120                         # seconds any single wait may take
CPU = ["cpu"]


def _graph(n_nodes, seed=0, nan_flops=False):
    """Chain graph with varied ops/flops so predictions differ per graph."""
    rng = np.random.default_rng(seed)
    ops = ["dense", "conv", "relu", "add"]
    nodes = [OpNode(i, ops[i % len(ops)],
                    (int(rng.integers(1, 16)), int(rng.integers(1, 64))),
                    flops=(float("nan") if (nan_flops and i == 0)
                           else float(rng.integers(1, 10_000))),
                    macs=float(rng.integers(1, 5_000)))
             for i in range(n_nodes)]
    edges = [(i, i + 1) for i in range(n_nodes - 1)]
    return OpGraph(nodes=nodes, edges=edges,
                   meta={"seed": seed, "n": n_nodes})


@pytest.fixture(scope="module")
def packed_dippm():
    cfg = PMGNSConfig(hidden=32, layout="packed")
    return DIPPM.from_params(pmgns_init(0, cfg), cfg, device="cpu")


def _pred_vec(p):
    return np.array([p.latency_ms, p.energy_j, p.memory_mb])


def _pool(dippm, n_replicas=2, node_budget=256, **kw):
    return ReplicaPool(dippm.params, dippm.cfg,
                       EngineConfig(node_budget=node_budget),
                       n_replicas=n_replicas, devices=CPU, **kw)


def _fleet_service(dippm, n_replicas=2, injectors=None, node_budget=256,
                   **serve_kw):
    pool = _pool(dippm, n_replicas, node_budget, injectors=injectors)
    svc = PredictionService(engine=pool, serve_cfg=ServeConfig(
        node_budget=node_budget, **serve_kw))
    return pool, svc


# ---- the fleet (tests/test_serve.py) ----------------------------------------

def test_fleet_dispatches_bins_across_replicas(packed_dippm):
    """An atomic burst that plans into several bins spreads them over the
    replicas, and results are EXACTLY equal to the single-engine path."""
    graphs = [_graph(10 + (s % 13), seed=s) for s in range(30)]
    pool, svc = _fleet_service(packed_dippm, n_replicas=2)
    try:
        preds = svc.predict_many(graphs, timeout=TIMEOUT)
        st = svc.stats
        assert st.replicas == 2
        assert sum(st.replica_bins) == st.bins >= 2
        assert all(b > 0 for b in st.replica_bins)  # both participated
        eng = PredictionEngine(packed_dippm.params, packed_dippm.cfg,
                               EngineConfig(node_budget=256), device="cpu")
        with PredictionService(engine=eng, serve_cfg=ServeConfig(
                node_budget=256)) as ref_svc:
            ref = ref_svc.predict_many(graphs, timeout=TIMEOUT)
        for a, b in zip(preds, ref):
            np.testing.assert_array_equal(_pred_vec(a), _pred_vec(b))
    finally:
        svc.close()
        pool.close()


def test_fleet_replica_kill_mid_stream_no_lost_futures(packed_dippm):
    """A FailureInjector kills replica 0 on its second bin while a Poisson
    stream is in flight: every future still resolves (requeued onto the
    survivor) with the single-engine numbers."""
    inj = {0: FailureInjector(fail_at_steps=[2])}
    pool, svc = _fleet_service(packed_dippm, n_replicas=2, injectors=inj,
                               max_wait_ms=2.0)
    graphs = [_graph(10 + (s % 13), seed=s) for s in range(40)]
    try:
        rng = np.random.default_rng(0)
        futs = []
        for g in graphs:                      # open-loop Poisson arrivals
            futs.append(svc.submit(g))
            time.sleep(float(rng.exponential(0.002)))
        svc.flush()
        preds = [f.result(timeout=TIMEOUT) for f in futs]
        assert all(p is not None for p in preds)
        assert inj[0].failures == 1
        assert pool.health == (False, True)
        st = svc.stats
        assert st.completed == len(graphs) and st.failed == 0
        assert st.requeues >= 1
        ref = [packed_dippm.predict_graph(g) for g in graphs]
        for a, b in zip(preds, ref):
            np.testing.assert_allclose(_pred_vec(a), _pred_vec(b),
                                       atol=1e-5, rtol=1e-5)
    finally:
        svc.close()
        pool.close()


def test_fleet_all_replicas_dead_rejects_not_hangs(packed_dippm):
    """When every replica has failed, pending futures reject with the
    underlying error — nothing blocks forever."""
    inj = {0: FailureInjector(), 1: FailureInjector()}
    inj[0].fail_next(10)
    inj[1].fail_next(10)
    pool, svc = _fleet_service(packed_dippm, n_replicas=2, injectors=inj,
                               cache_size=None, max_wait_ms=30_000.0,
                               max_batch_graphs=1024)
    try:
        futs = svc.submit_many([_graph(8, seed=s) for s in range(5)])
        svc.flush()
        errs = [f.exception(timeout=TIMEOUT) for f in futs]
        assert all(isinstance(e, RuntimeError) for e in errs)
        assert isinstance(errs[0], NoHealthyReplicaError)
        assert isinstance(errs[0].__cause__, RuntimeError)
        assert svc.stats.failed == 5
        assert pool.n_healthy == 0
    finally:
        svc.close()
        pool.close()


def test_fleet_warmup_and_heartbeats(packed_dippm, tmp_path):
    """warmup() runs every replica's ladder; completed bins beat
    per-replica heartbeat files an external supervisor can read."""
    pool = _pool(packed_dippm, heartbeat_dir=str(tmp_path))
    try:
        single = PredictionEngine(packed_dippm.params, packed_dippm.cfg,
                                  EngineConfig(node_budget=256),
                                  device="cpu")
        n_single = single.warmup()
        assert pool.warmup() == 2 * n_single
        with PredictionService(engine=pool, serve_cfg=ServeConfig(
                node_budget=256)) as svc:
            svc.predict_many([_graph(10 + (s % 13), seed=s)
                              for s in range(30)], timeout=TIMEOUT)
        beats = pool._monitors[0].read_all()
        assert {b["replica"] for b in beats} == {0, 1}
        assert all(b["step"] >= 1 for b in beats)
    finally:
        pool.close()


def test_serve_config_replicas_builds_pool(packed_dippm):
    """ServeConfig(replicas=N) is the one-knob fleet entry point — the
    facade's serve() passes it straight through, on the facade's
    device."""
    svc = packed_dippm.serve(replicas=2, node_budget=256)
    try:
        assert isinstance(svc.engine, ReplicaPool)
        assert svc.engine.devices == (torch.device("cpu"),) * 2
        assert svc.engine.streams == [None, None]
        svc.predict_many([_graph(8, seed=s) for s in range(20)],
                         timeout=TIMEOUT)
        st = svc.stats
        assert st.replicas == 2 and sum(st.replica_bins) == st.bins
        assert st.breaker_states == ("closed", "closed")
    finally:
        svc.close()
    assert svc.engine._closed                  # the service built it


def test_serve_config_breaker_and_a_devices_list(packed_dippm):
    """ServeConfig.breaker reaches the pool the service builds; a pool
    over an explicit device list runs one replica a device and its
    synchronous run_bin gives one engine's numbers."""
    with PredictionService(packed_dippm.params, packed_dippm.cfg,
                           ServeConfig(replicas=2, breaker=BreakerConfig(
                               cooldown_s=5.0)), device="cpu") as svc:
        assert svc.engine.breaker_cfg.cooldown_s == 5.0
        preds = svc.predict_many([_graph(9, seed=s) for s in range(4)],
                                 timeout=TIMEOUT)
        assert all(np.isfinite(p.latency_ms) for p in preds)
    from repro_torch.core import sample_from_graph
    samples = [sample_from_graph(_graph(7 + s, seed=s)) for s in range(6)]
    with ReplicaPool(packed_dippm.params, packed_dippm.cfg,
                     devices=["cpu", "cpu"]) as pool:
        assert pool.placement.device_ids == (0, 1)
        (idx,) = pool.plan_bins(samples)
        got = pool.run_bin([samples[j] for j in idx])
    np.testing.assert_array_equal(
        got, packed_dippm.engine().predict_samples(samples))


# ---- the pool in the request lifecycle (tests/test_lifecycle.py) ------------

def test_infra_failure_does_not_quarantine(packed_dippm):
    """All replicas dead is the SERVICE's fault: riders fail with the
    infra error, nobody is bisected or quarantined."""
    inj = {0: FailureInjector(), 1: FailureInjector()}
    inj[0].fail_next(10)
    inj[1].fail_next(10)
    pool = _pool(packed_dippm, injectors=inj)
    svc = PredictionService(engine=pool, serve_cfg=ServeConfig(
        node_budget=256, max_wait_ms=30_000.0, max_batch_graphs=1024))
    try:
        futs = [svc.submit(_graph(8, seed=s)) for s in range(4)]
        svc.flush()
        errs = [f.exception(timeout=TIMEOUT) for f in futs]
        assert all(e is not None for e in errs)
        assert not any(isinstance(e, PoisonRequestError) for e in errs)
        st = svc.stats
        assert st.poisoned == 0 and st.quarantine_entries == 0
        assert st.failed == 4
    finally:
        svc.close()
        pool.close()


def test_breaker_probe_revives_replica_after_outage(packed_dippm):
    inj = {0: FailureInjector()}
    inj[0].fail_window(1, 2)                     # down for dispatch 1 only
    pool = _pool(packed_dippm, injectors=inj,
                 breaker=BreakerConfig(cooldown_s=0.2))
    svc = PredictionService(engine=pool, serve_cfg=ServeConfig(
        node_budget=256, max_wait_ms=2.0))
    try:
        svc.predict_many([_graph(10 + s % 7, seed=s) for s in range(10)],
                         timeout=TIMEOUT)
        assert pool.breaker_states == ("open", "closed")
        assert pool.health == (False, True) and pool.n_healthy == 1
        time.sleep(0.3)                          # cooldown elapses
        preds = svc.predict_many([_graph(9, seed=100 + s)
                                  for s in range(8)], timeout=TIMEOUT)
        assert all(p is not None for p in preds)
        assert pool.breaker_states == ("closed", "closed")
        assert pool.revivals == 1                # half-open probe passed
        assert svc.stats.revivals == 1
        assert svc.stats.breaker_states == ("closed", "closed")
    finally:
        svc.close()
        pool.close()


@pytest.fixture(scope="module")
def chaos_pool(packed_dippm):
    inj = {0: FailureInjector(), 1: FailureInjector()}
    pool = _pool(packed_dippm, injectors=inj,
                 breaker=BreakerConfig(cooldown_s=0.05))
    yield pool, inj
    pool.close()


_SCHEDULE_OPS = ["submit", "dup", "expired", "poison", "kill", "burst"]


def _run_schedule(chaos_pool, ops, seed):
    """Under arbitrary schedules of submits, duplicates, deadline expiries,
    poison graphs, replica kills, load shedding and a final drain, EVERY
    accepted future terminates with a result or a typed error — exactly
    once, nothing hangs — and the terminal counters conserve: submitted =
    completed + failed + deadline_expired + shed."""
    pool, inj = chaos_pool
    for i in range(pool.n_replicas):             # reset breakers/chaos
        pool.revive(i)
    svc = PredictionService(engine=pool, serve_cfg=ServeConfig(
        node_budget=256, max_wait_ms=1.0, max_queue=6,
        shed_policy="oldest", cache_size=64, quarantine_size=None))
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
                inj[uid % 2].fail_next(1)
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
        for i in inj:                            # disarm leftover chaos
            with inj[i]._lock:
                inj[i]._armed = 0


@settings(max_examples=12, deadline=None)
@given(ops=st.lists(st.sampled_from(_SCHEDULE_OPS),
                    min_size=1, max_size=10),
       seed=st.integers(0, 2**16))
def test_every_accepted_future_terminates_exactly_once(chaos_pool, ops,
                                                       seed):
    _run_schedule(chaos_pool, ops, seed)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_lifecycle_schedule_fixed_seeds(chaos_pool, seed):
    """Deterministic twin of the hypothesis test: seeded pseudo-random
    schedules."""
    rng = np.random.default_rng(seed)
    ops = [_SCHEDULE_OPS[int(i)]
           for i in rng.integers(0, len(_SCHEDULE_OPS), size=10)]
    _run_schedule(chaos_pool, ops, seed)


# ---- devices and placement ---------------------------------------------------

@pytest.mark.parametrize("n_replicas,n_devices,want", [
    (None, 1, (0,)), (None, 4, (0, 1, 2, 3)), (2, 1, (0, 0)),
    (4, 1, (0, 0, 0, 0)), (5, 2, (0, 1, 0, 1, 0)), (3, 4, (0, 1, 2)),
])
def test_replica_placement_round_robin(n_replicas, n_devices, want):
    plan = replica_placement(n_replicas, n_devices)
    assert plan.device_ids == want and plan.n_replicas == len(want)
    assert "round-robin" in plan.note


def test_replica_placement_refuses_empty():
    with pytest.raises(ValueError, match="device"):
        replica_placement(2, 0)
    with pytest.raises(ValueError, match="replica"):
        replica_placement(-1, 2)


def test_pool_without_cuda_and_devices_raises(packed_dippm, monkeypatch):
    """No quiet CPU fleet: without CUDA a pool needs devices=."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ReplicaPool(packed_dippm.params, packed_dippm.cfg, n_replicas=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        PredictionService(packed_dippm.params, packed_dippm.cfg,
                          ServeConfig(replicas=2))


def test_reshard_state_names_its_item():
    with pytest.raises(NotImplementedError, match="A14d"):
        reshard_state({}, None, None)


# ---- runtime (tests/test_checkpoint_runtime.py) -----------------------------

def test_supervisor_restarts_through_failures(tmp_path):
    injector = FailureInjector(fail_at_steps=[4, 11])
    sup = TrainingSupervisor(str(tmp_path), save_every=2, injector=injector,
                             monitor=HeartbeatMonitor(str(tmp_path / "hb")))

    def step_fn(state, step):
        return {"x": state["x"] + 1}

    report = sup.run({"x": torch.tensor(0)}, step_fn, total_steps=15)
    assert report.restarts == 2
    assert injector.failures == 2
    assert [h["at_step"] for h in report.history] == [4, 11]
    final, _ = sup.mgr.restore_latest({"x": np.asarray(0)})
    assert int(final["x"]) == 15  # every step applied exactly once
    assert sup.monitor.read_all()[0]["step"] == 14


def test_heartbeat_straggler_detection(tmp_path):
    mon = HeartbeatMonitor(str(tmp_path))
    for host, step in [(0, 10), (1, 10), (2, 3)]:
        HeartbeatMonitor(str(tmp_path), host_id=host).beat(step)
    assert mon.stragglers(lag_steps=2) == [2]
    assert mon.stale_hosts(timeout_s=60.0) == []
    assert sorted(mon.stale_hosts(timeout_s=1.0,
                                  now=time.time() + 5.0)) == [0, 1, 2]
    with open(os.path.join(str(tmp_path), "host_9.json"), "w") as f:
        f.write("{torn")                          # a torn write is no beat
    assert len(mon.read_all()) == 3


def test_failure_injector_drills():
    inj = FailureInjector(fail_at_steps=[3])
    inj.fail_window(5, 7)
    fired = []
    for step in range(9):
        try:
            inj.maybe_fail(step)
        except RuntimeError:
            fired.append(step)
    assert fired == [3, 5, 6] and inj.failures == 3
    inj.fail_next(2)
    with pytest.raises(RuntimeError, match="injected"):
        inj.maybe_fail(100)
    with pytest.raises(RuntimeError):
        inj.maybe_fail(101)
    inj.maybe_fail(102)
    with pytest.raises(ValueError, match="empty"):
        inj.fail_window(4, 4)


def test_elastic_plan_preserves_global_batch():
    plan = elastic_restart_plan(512 - 32, model_parallel=16,
                                global_batch=256)
    assert plan.mesh_shape[1] == 16
    data = plan.mesh_shape[0]
    assert 256 % data == 0
    assert data * 16 <= 480


def test_elastic_plan_too_few_devices():
    with pytest.raises(ValueError):
        elastic_restart_plan(8, model_parallel=16)


# ---- on the card --------------------------------------------------------------

@pytest.mark.cuda
def test_two_replicas_on_one_card_match_one_engine_bitwise():
    """Two replicas on one card, each on its own stream: GAT's kernels sum
    in a fixed order, so every bin of an atomic burst has one engine's
    bits; each replica's bins ran on its own stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    cfg = PMGNSConfig(variant="gat", hidden=64, layout="packed")
    tree = pmgns_init(0, cfg)
    graphs = [_graph(10 + (s % 37), seed=s) for s in range(120)]
    pool = ReplicaPool(tree, cfg, EngineConfig(node_budget=512),
                       n_replicas=2)
    seen = {}
    for i, r in enumerate(pool.replicas):
        run = r.run_bin

        def spy(chunk, run=run, i=i):
            seen.setdefault(i, set()).add(torch.cuda.current_stream())
            return run(chunk)
        r.run_bin = spy
    try:
        assert {d.type for d in pool.devices} == {"cuda"}
        assert len({s for s in pool.streams}) == 2
        with PredictionService(engine=pool, serve_cfg=ServeConfig(
                node_budget=512)) as svc:
            preds = svc.predict_many(graphs, timeout=TIMEOUT)
            st = svc.stats
        eng = PredictionEngine(tree, cfg, EngineConfig(node_budget=512))
        with PredictionService(engine=eng, serve_cfg=ServeConfig(
                node_budget=512)) as ref_svc:
            ref = ref_svc.predict_many(graphs, timeout=TIMEOUT)
        assert sum(st.replica_bins) == st.bins >= 2
        assert all(b > 0 for b in st.replica_bins)
        for a, b in zip(preds, ref):
            np.testing.assert_array_equal(_pred_vec(a), _pred_vec(b))
        assert seen == {i: {pool.streams[i]} for i in range(2)}
    finally:
        pool.close()
