"""Serving in the PyTorch port: micro-batching, FIFO futures, admission
control, warmup, the prediction cache, load shedding and versioned
artifacts (``repro_torch.serve``), on ``device="cpu"``.

These are the tests of ``tests/test_serve.py`` that need no replica
fleet (the fleet's are in ``tests/test_torch_fleet.py``), run on the
port, with a timeout on every wait. The last section holds the port against the JAX package:
the default services of both give the same predictions for the same
graphs and weights (GraphSAGE and GAT), and an artifact written by
either package loads in the other with the same predictions, in all
three encodings.
"""
import dataclasses
import json
import os
import pickle
import sys
import tempfile
import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro_torch.core import (DIPPM, OpGraph, OpNode, PMGNSConfig,  # noqa: E402
                              PredictionEngine, packed_rung_ladder,
                              pmgns_init)
from repro_torch.serve import (ARTIFACT_VERSION, PredictionService,  # noqa: E402
                               QueueFullError, ServeConfig, load_artifact,
                               save_artifact)

TIMEOUT = 60                          # seconds any single wait may take


def _graph(n_nodes, seed=0, graph_cls=OpGraph, node_cls=OpNode):
    """Chain graph with varied ops/flops so predictions differ per graph."""
    rng = np.random.default_rng(seed)
    ops = ["dense", "conv", "relu", "add"]
    nodes = [node_cls(i, ops[i % len(ops)],
                      (int(rng.integers(1, 16)), int(rng.integers(1, 64))),
                      flops=float(rng.integers(1, 10_000)),
                      macs=float(rng.integers(1, 5_000)))
             for i in range(n_nodes)]
    edges = [(i, i + 1) for i in range(n_nodes - 1)]
    return graph_cls(nodes=nodes, edges=edges,
                     meta={"seed": seed, "n": n_nodes})


def _dippm(variant="graphsage", **kw):
    cfg = PMGNSConfig(variant=variant, hidden=32, layout="packed", **kw)
    return DIPPM.from_params(pmgns_init(0, cfg), cfg, device="cpu")


@pytest.fixture(scope="module")
def packed_dippm():
    return _dippm()


def _pred_vec(p):
    return np.array([p.latency_ms, p.energy_j, p.memory_mb])


# ---- concurrent-submit determinism ----------------------------------------

def test_concurrent_submits_match_predict_graph(packed_dippm):
    """Requests racing in from many threads must each get the same
    numbers as a lone predict_graph call (≤ 1e-5)."""
    graphs = [_graph(n, seed=i)
              for i, n in enumerate([5, 40, 100, 7, 60, 90, 12, 31])]
    ref = [packed_dippm.predict_graph(g) for g in graphs]
    with packed_dippm.serve(max_wait_ms=20.0, max_batch_graphs=64) as svc:
        results = [None] * len(graphs)

        def worker(tid):
            for k in range(tid, len(graphs), 4):
                results[k] = svc.submit(graphs[k]).result(timeout=TIMEOUT)

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
    for a, b in zip(ref, results):
        np.testing.assert_allclose(_pred_vec(b), _pred_vec(a),
                                   atol=1e-5, rtol=1e-5)
        assert b.meta == a.meta


def test_facade_predict_paths_share_service_numbers(packed_dippm):
    """predict_graph / predict_many / service futures — one engine,
    identical results, order preserved."""
    graphs = [_graph(n, seed=i) for i, n in enumerate([3, 40, 100, 7])]
    loop = [packed_dippm.predict_graph(g) for g in graphs]
    many = packed_dippm.predict_many(graphs)
    for a, b in zip(loop, many):
        # same engine; bins differ (1-graph vs coalesced) → float tol
        np.testing.assert_allclose(b.latency_ms, a.latency_ms,
                                   atol=1e-5, rtol=1e-5)
        assert b.meta == a.meta


def test_burst_from_many_threads_conserves_and_matches_engine():
    """More threads than cores, a short switch interval, unique and
    repeated graphs mixed: every future resolves, the counters conserve,
    cache hits are bit-equal to the cold prediction of the same graph and
    every answer matches the direct engine's."""
    d = _dippm()
    graphs = [_graph(5 + i % 23, seed=i) for i in range(24)]
    want = d.engine().predict_graphs(graphs)
    futs, errors = [[] for _ in range(16)], []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with d.serve(max_wait_ms=2.0) as svc:
            def worker(tid):
                rng = np.random.default_rng(tid)
                try:
                    for k in rng.integers(0, len(graphs), 12):
                        futs[tid].append((int(k), svc.submit(graphs[k])))
                except Exception as e:  # reported below
                    errors.append(e)
            threads = [threading.Thread(target=worker, args=(t,))
                       for t in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=TIMEOUT)
            assert not errors and not any(t.is_alive() for t in threads)
            got = [(k, f.result(timeout=TIMEOUT)) for fs in futs
                   for k, f in fs]
            st = svc.stats
    finally:
        sys.setswitchinterval(old)
    assert st.submitted == len(got) == 16 * 12
    assert st.submitted == (st.completed + st.failed + st.deadline_expired
                            + st.shed_count)
    assert st.failed == 0 and st.cache_hits + st.cache_coalesced > 0
    first = {}
    for k, p in got:
        np.testing.assert_allclose(_pred_vec(p), _pred_vec(want[k]),
                                   atol=1e-5, rtol=1e-5)
        if k in first:
            np.testing.assert_array_equal(_pred_vec(p), first[k])
        first.setdefault(k, _pred_vec(p))


def test_stats_count_a_request_before_its_future_resolves():
    """A done callback (it runs on the batcher thread as the future
    resolves) reads ``stats``: the request is already counted, on the
    engine path and on the cache-hit path."""
    d = _dippm()
    g = _graph(9, seed=3)
    seen = []
    with d.serve(max_wait_ms=200.0) as svc:
        def hook(f):
            seen.append((threading.current_thread() is not main,
                         svc.stats.completed))
        main = threading.current_thread()
        svc.submit(g).add_done_callback(hook)
        svc.submit(g).result(timeout=TIMEOUT)     # coalesced or a hit
        svc.submit(g).add_done_callback(hook)     # a hit: already done
        st = svc.stats
    assert seen[0] == (True, 1), seen       # on the batcher, counted
    assert seen[1][1] == 3 == st.completed
    assert st.submitted == st.completed + st.failed + st.deadline_expired \
        + st.shed_count


def test_stats_count_a_failure_before_its_future_rejects(packed_dippm,
                                                         monkeypatch):
    """A failed bin's leader and the cache follower riding on it: each
    done callback reads ``stats`` with its own rejection counted."""
    svc = packed_dippm.serve(max_wait_ms=30_000.0, max_batch_graphs=1024,
                             quarantine_size=None)
    seen = []
    try:
        monkeypatch.setattr(
            svc.engine, "run_bin",
            lambda chunk: (_ for _ in ()).throw(RuntimeError("boom")))
        leader = svc.submit(_graph(9, seed=12))
        follower = svc.submit(_graph(9, seed=12))
        leader.add_done_callback(lambda f: seen.append(
            ("leader", svc.stats.failed)))
        follower.add_done_callback(lambda f: seen.append(
            ("follower", svc.stats.failed)))
        svc.flush()
        assert isinstance(follower.exception(timeout=TIMEOUT), RuntimeError)
        assert sorted(seen) == [("follower", 2), ("leader", 1)], seen
        assert svc.stats.failed == 2
    finally:
        svc.close()


# ---- FIFO resolution -------------------------------------------------------

def test_futures_resolve_in_submission_order(packed_dippm):
    with packed_dippm.serve(max_wait_ms=10.0, max_batch_graphs=16) as svc:
        order = []
        futs = []
        for i in range(24):
            fut = svc.submit(_graph(6 + i, seed=i))
            fut.add_done_callback(lambda f, i=i: order.append(i))
            futs.append(fut)
        svc.flush()
        preds = [f.result(timeout=TIMEOUT) for f in futs]
    assert order == sorted(order) == list(range(24))
    assert all(np.isfinite(p.latency_ms) for p in preds)
    assert all(f.latency_ms is not None and f.latency_ms >= 0 for f in futs)


def test_raising_done_callback_does_not_kill_batcher(packed_dippm, capsys):
    """A user callback that raises must be swallowed: later requests on
    the same service must still resolve (the batcher thread survives)."""
    with packed_dippm.serve(max_wait_ms=5.0) as svc:
        bad = svc.submit(_graph(8, seed=0))
        bad.add_done_callback(
            lambda f: (_ for _ in ()).throw(RuntimeError("hook boom")))
        svc.flush()
        assert np.isfinite(bad.result(timeout=TIMEOUT).latency_ms)
        ok = svc.submit(_graph(9, seed=1))
        svc.flush()
        assert np.isfinite(ok.result(timeout=TIMEOUT).latency_ms)
    capsys.readouterr()                          # swallow the traceback


# ---- max_wait_ms straggler flush ------------------------------------------

def test_max_wait_flushes_single_straggler(packed_dippm):
    """One lone request, nobody else coming, no explicit flush: the
    max_wait_ms deadline alone must resolve it."""
    with packed_dippm.serve(max_wait_ms=50.0,
                            max_batch_graphs=1024) as svc:
        t0 = time.perf_counter()
        fut = svc.submit(_graph(10, seed=3))
        pred = fut.result(timeout=TIMEOUT)       # NOT flushed by anyone
        waited = time.perf_counter() - t0
    assert np.isfinite(pred.latency_ms)
    assert 0.05 <= waited < 20.0


def test_flush_covers_burst_larger_than_max_batch(packed_dippm):
    """A flushed burst wider than max_batch_graphs must drain fully
    without waiting out the (here: huge) coalescing window."""
    with packed_dippm.serve(max_wait_ms=30_000.0,
                            max_batch_graphs=4) as svc:
        preds = svc.predict_many([_graph(6 + i, seed=i) for i in range(11)],
                                 timeout=TIMEOUT)
        assert len(preds) == 11
        assert svc.stats.batches == 3            # 4 + 4 + 3, no 30 s stall


def test_batch_size_trigger_beats_max_wait(packed_dippm):
    """max_batch_graphs waiting requests flush immediately."""
    with packed_dippm.serve(max_wait_ms=30_000.0,
                            max_batch_graphs=4) as svc:
        futs = [svc.submit(_graph(8 + i, seed=i)) for i in range(4)]
        preds = [f.result(timeout=TIMEOUT) for f in futs]
    assert len(preds) == 4


# ---- bounded-queue admission control --------------------------------------

def test_bounded_queue_rejects_when_full(packed_dippm):
    svc = packed_dippm.serve(max_wait_ms=30_000.0, max_batch_graphs=1024,
                             max_queue=2)
    try:
        f1 = svc.submit(_graph(5, seed=0))
        f2 = svc.submit(_graph(6, seed=1))
        with pytest.raises(QueueFullError):
            svc.submit(_graph(7, seed=2))
        assert svc.stats.rejected == 1
        svc.flush()
        assert f1.result(timeout=TIMEOUT) and f2.result(timeout=TIMEOUT)
        assert svc.stats.completed == 2
    finally:
        svc.close()


def test_submit_after_close_raises(packed_dippm):
    svc = packed_dippm.serve()
    svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(_graph(5, seed=0))


def test_engine_failure_rejects_futures(packed_dippm, monkeypatch):
    svc = packed_dippm.serve(max_wait_ms=5.0)
    try:
        monkeypatch.setattr(
            svc.engine, "run_bin",
            lambda chunk: (_ for _ in ()).throw(RuntimeError("boom")))
        fut = svc.submit(_graph(5, seed=0))
        svc.flush()
        assert isinstance(fut.exception(timeout=TIMEOUT), RuntimeError)
        with pytest.raises(RuntimeError, match="boom"):
            fut.result(timeout=1)
        assert svc.stats.failed == 1
    finally:
        svc.close()


# ---- warmup ----------------------------------------------------------------

def test_warmup_precompiles_full_rung_ladder(packed_dippm):
    svc = packed_dippm.serve()
    try:
        expected = len(packed_rung_ladder(
            svc.engine.engine_cfg.node_budget))
        assert svc.expected_rungs() == expected == 5
        assert svc.warmup() == expected
        assert svc.engine.stats.cache_entries == expected
        before = svc.engine.stats.cache_misses
        svc.predict_many([_graph(n, seed=i)
                          for i, n in enumerate([4, 60, 300, 900])],
                         timeout=TIMEOUT)
        assert svc.engine.stats.cache_misses == before
    finally:
        svc.close()


def test_engine_warmup_default_still_single_rung(packed_dippm):
    eng = PredictionEngine(packed_dippm.params, packed_dippm.cfg,
                           device="cpu")
    assert eng.warmup() == 1                     # top rung only
    eng2 = PredictionEngine(packed_dippm.params, packed_dippm.cfg,
                            device="cpu")
    assert eng2.warmup(rungs="all") == 5


def test_bucketed_engine_serves_and_refuses_rungs(packed_dippm):
    """A dense (bucketed) engine serves: the service warms every node
    bucket, and the engine refuses rung warmup as the JAX package's
    does (``tests/test_serve.py::test_warmup_rungs_rejected_on_bucketed_engine``)."""
    cfg = dataclasses.replace(packed_dippm.cfg, layout="dense")
    eng = PredictionEngine(pmgns_init(0, cfg), cfg, device="cpu")
    with pytest.raises(ValueError, match="packed"):
        eng.warmup(rungs="all")
    with PredictionService(engine=eng) as svc:
        assert svc.warmup() == svc.expected_rungs() == len(
            eng.engine_cfg.buckets)
        preds = svc.predict_many([_graph(9 + 20 * s, seed=s)
                                  for s in range(4)], timeout=TIMEOUT)
    want = packed_dippm.engine().predict_graphs(
        [_graph(9 + 20 * s, seed=s) for s in range(4)])
    for a, b in zip(preds, want):
        np.testing.assert_allclose(_pred_vec(a), _pred_vec(b),
                                   rtol=1e-5, atol=1e-6)


# ---- serve config plumbing -------------------------------------------------

def test_serve_config_budget_overrides():
    cfg = PMGNSConfig(hidden=32, layout="packed")
    svc = PredictionService(pmgns_init(0, cfg), cfg,
                            ServeConfig(node_budget=512), device="cpu")
    try:
        assert svc.engine.engine_cfg.node_budget == 512
        assert svc.engine.device.type == "cpu"
        assert svc.expected_rungs() == len(packed_rung_ladder(512))
    finally:
        svc.close()


def test_serve_config_replicas_and_submit_jax_not_ported(packed_dippm):
    """``replicas=2`` builds the fleet (``tests/test_torch_fleet.py``);
    ``submit_jax`` still waits for the torch frontend (A13)."""
    with packed_dippm.serve(replicas=2) as svc:
        assert svc.stats.replicas == 2
        with pytest.raises(NotImplementedError, match="A13"):
            svc.submit_jax(lambda p, x: x, None, None)
    with packed_dippm.serve() as svc:
        with pytest.raises(NotImplementedError, match="A13"):
            svc.submit_jax(lambda p, x: x, None, None)


def test_submit_json_frontend(packed_dippm):
    with packed_dippm.serve(max_wait_ms=5.0) as svc:
        doc = {"nodes": [{"id": 0, "op": "gemm", "out_shape": [4, 64]},
                         {"id": 1, "op": "relu", "out_shape": [4, 64]}],
               "edges": [[0, 1]], "meta": {"family": "external", "batch": 8}}
        p1 = svc.submit_json(doc)
        svc.flush()
        r1 = p1.result(timeout=TIMEOUT)
        assert np.isfinite(r1.latency_ms)
        assert r1.meta.get("batch") == 8


def test_serve_stats_counters(packed_dippm):
    with packed_dippm.serve(max_wait_ms=10.0) as svc:
        svc.predict_many([_graph(10, seed=i) for i in range(6)],
                         timeout=TIMEOUT)
        s = svc.stats
    assert s.submitted == s.completed == 6
    assert s.batches >= 1 and s.bins >= 1
    assert s.batch_occupancy > 1.0               # coalesced, not per-request
    assert s.latency_ms_p99 >= s.latency_ms_p50 > 0.0
    assert 0.0 <= s.padding_waste_frac < 1.0


# ---- versioned artifacts ---------------------------------------------------

def test_artifact_roundtrip_and_predictions(packed_dippm, tmp_path):
    path = str(tmp_path / "model.npz")
    packed_dippm.save(path, metadata={"run": "t1"})
    params, cfg, meta = load_artifact(path)
    assert cfg == packed_dippm.cfg
    assert meta == {"run": "t1"}
    back = DIPPM.from_params(params, cfg, device="cpu")
    g = _graph(12, seed=5)
    assert (back.predict_graph(g).latency_ms
            == pytest.approx(packed_dippm.predict_graph(g).latency_ms,
                             rel=1e-6))


def test_artifact_is_pickle_free(packed_dippm, tmp_path):
    path = str(tmp_path / "model.npz")
    packed_dippm.save(path)
    with open(path, "rb") as f:
        assert f.read(2) == b"PK"                # a zip, not a pickle
    params, cfg, _ = load_artifact(path)
    assert isinstance(params, dict) and "gnn" in params


def test_legacy_pickle_is_refused(packed_dippm, tmp_path):
    """The JAX package loads a v1 pickle with a warning; the port never
    unpickles and says how to migrate."""
    path = str(tmp_path / "legacy.pkl")
    with open(path, "wb") as f:
        pickle.dump({"params": {}, "cfg": None}, f)
    with pytest.raises(ValueError, match="pickle"):
        DIPPM.load(path, device="cpu")


def test_artifact_rejects_newer_schema(packed_dippm, tmp_path):
    path = str(tmp_path / "model.npz")
    packed_dippm.save(path)
    with np.load(path, allow_pickle=False) as z:
        doc = json.loads(bytes(z["__dippm_artifact__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__dippm_artifact__"}
    doc["schema_version"] = ARTIFACT_VERSION + 1
    header = np.frombuffer(json.dumps(doc).encode(), np.uint8)
    newer = str(tmp_path / "newer.npz")
    with open(newer, "wb") as f:
        np.savez(f, __dippm_artifact__=header, **arrays)
    with pytest.raises(ValueError, match="schema_version"):
        load_artifact(newer)


def test_artifact_rejects_foreign_npz(tmp_path):
    path = str(tmp_path / "foreign.npz")
    with open(path, "wb") as f:
        np.savez(f, x=np.zeros(3))
    with pytest.raises(ValueError, match="artifact"):
        load_artifact(path)


@settings(deadline=None, max_examples=15)
@given(st.lists(st.integers(1, 6), min_size=1, max_size=3),
       st.sampled_from(["graphsage", "gcn", "gat", "mlp"]),
       st.integers(0, 2 ** 16 - 1))
def test_artifact_roundtrip_property(dims, variant, seed):
    """Property: save→load is exact for arbitrary param trees + configs
    (values, shapes, dtypes, nesting, and cfg fields all survive)."""
    rng = np.random.default_rng(seed)
    params = {
        "gnn": {f"b{i}": {"w": rng.standard_normal((d, d + 1))
                          .astype(np.float32),
                          "b": rng.standard_normal((d + 1,))
                          .astype(np.float32)}
                for i, d in enumerate(dims)},
        "fc": {"head": {"w": rng.standard_normal((3, 2))}},
    }
    cfg = PMGNSConfig(variant=variant, hidden=8 * dims[0],
                      layout="packed" if seed % 2 else "auto")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"prop-{seed}.npz")
        save_artifact(path, params, cfg, metadata={"seed": seed})
        back, cfg2, meta = load_artifact(path)
    assert cfg2 == cfg
    assert meta["seed"] == seed

    def assert_equal(a, b):
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], dict):
                assert_equal(a[k], b[k])
            else:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])

    assert_equal(params, back)


# ---- content-addressed prediction cache ------------------------------------

def test_cache_hit_is_bit_equal_and_skips_engine(packed_dippm):
    svc = packed_dippm.serve(max_wait_ms=2.0)
    try:
        cold = svc.predict_one(_graph(20, seed=7), timeout=TIMEOUT)
        before = svc.stats
        warm = svc.predict_one(_graph(20, seed=7), timeout=TIMEOUT)
        after = svc.stats
        assert after.cache_hits == before.cache_hits + 1
        assert after.cache_misses == before.cache_misses
        assert after.batches == before.batches   # no engine work at all
        np.testing.assert_array_equal(_pred_vec(warm), _pred_vec(cold))
        assert warm.meta == cold.meta
        assert after.hit_rate == pytest.approx(0.5)
    finally:
        svc.close()


def test_cache_single_flight_coalesces_duplicates_to_one_slot(packed_dippm):
    svc = packed_dippm.serve(max_wait_ms=30_000.0, max_batch_graphs=1024)
    try:
        futs = [svc.submit(_graph(30, seed=3)) for _ in range(8)]
        s = svc.stats
        assert s.cache_misses == 1 and s.cache_coalesced == 7
        svc.flush()
        preds = [f.result(timeout=TIMEOUT) for f in futs]
        assert len({tuple(_pred_vec(p)) for p in preds}) == 1
        s = svc.stats
        assert s.completed == 8
        assert s.batches == 1 and s.batch_occupancy == 1.0
        for p in preds:
            assert p.meta == {"seed": 3, "n": 30}
    finally:
        svc.close()


def test_cache_lru_bound_evicts_oldest(packed_dippm):
    svc = packed_dippm.serve(cache_size=4, max_wait_ms=2.0)
    try:
        svc.predict_many([_graph(6, seed=s) for s in range(6)],
                         timeout=TIMEOUT)
        assert svc.stats.cache_entries == 4
        assert svc.stats.cache_misses == 6
        svc.predict_one(_graph(6, seed=5), timeout=TIMEOUT)   # newest: hit
        assert svc.stats.cache_hits == 1
        svc.predict_one(_graph(6, seed=0), timeout=TIMEOUT)   # evicted
        assert svc.stats.cache_misses == 7
    finally:
        svc.close()


def test_cache_meta_participates_in_key(packed_dippm):
    g1 = _graph(8, seed=0)
    g2 = OpGraph(nodes=g1.nodes, edges=g1.edges, meta={"other": True})
    svc = packed_dippm.serve(max_wait_ms=2.0)
    try:
        svc.predict_one(g1, timeout=TIMEOUT)
        svc.predict_one(g2, timeout=TIMEOUT)
        assert svc.stats.cache_misses == 2 and svc.stats.cache_hits == 0
    finally:
        svc.close()


def test_cache_failed_leader_aborts_flight_and_next_retry_succeeds(
        packed_dippm, monkeypatch):
    svc = packed_dippm.serve(max_wait_ms=30_000.0, max_batch_graphs=1024,
                             quarantine_size=None)
    try:
        orig = svc.engine.run_bin
        state = {"fail": True}

        def flaky(chunk):
            if state["fail"]:
                raise RuntimeError("boom")
            return orig(chunk)

        monkeypatch.setattr(svc.engine, "run_bin", flaky)
        leader = svc.submit(_graph(9, seed=11))
        follower = svc.submit(_graph(9, seed=11))
        svc.flush()
        assert isinstance(leader.exception(timeout=TIMEOUT), RuntimeError)
        assert isinstance(follower.exception(timeout=TIMEOUT), RuntimeError)
        assert svc.stats.failed == 2
        state["fail"] = False
        retry = svc.submit(_graph(9, seed=11))  # fresh leader, not follower
        svc.flush()
        assert retry.result(timeout=TIMEOUT) is not None
        assert svc.stats.cache_misses == 2
    finally:
        svc.close()


def test_cache_disabled_with_none(packed_dippm):
    svc = packed_dippm.serve(cache_size=None, max_wait_ms=2.0)
    try:
        svc.predict_one(_graph(5, seed=0), timeout=TIMEOUT)
        svc.predict_one(_graph(5, seed=0), timeout=TIMEOUT)
        s = svc.stats
        assert s.cache_hits == 0 and s.cache_misses == 0
        assert s.batches == 2
    finally:
        svc.close()


# ---- load shedding ----------------------------------------------------------

def test_shed_oldest_evicts_stalest_request(packed_dippm):
    svc = packed_dippm.serve(max_wait_ms=30_000.0, max_batch_graphs=1024,
                             max_queue=2, shed_policy="oldest")
    try:
        f1 = svc.submit(_graph(5, seed=0))
        f2 = svc.submit(_graph(6, seed=1))
        f3 = svc.submit(_graph(7, seed=2))    # sheds f1, admits f3
        assert isinstance(f1.exception(timeout=5), QueueFullError)
        s = svc.stats
        assert s.shed_count == 1 and s.rejected == 0
        svc.flush()
        assert f2.result(timeout=TIMEOUT) and f3.result(timeout=TIMEOUT)
        retry = svc.submit(_graph(5, seed=0))
        svc.flush()
        assert retry.result(timeout=TIMEOUT) is not None
    finally:
        svc.close()


def test_shed_policy_validated(packed_dippm):
    with pytest.raises(ValueError, match="shed_policy"):
        packed_dippm.serve(shed_policy="drop-new")


# ---- the port against the JAX package ---------------------------------------

@pytest.fixture(scope="module")
def jax_side():
    jax = pytest.importorskip("jax")
    from repro.core import DIPPM as JDIPPM
    from repro.core import gnn as jg
    from repro.core.ir import OpGraph as JOpGraph
    from repro.core.ir import OpNode as JOpNode
    return jax, JDIPPM, jg, JOpGraph, JOpNode


def _jax_model(jax_side, variant):
    jax, _, jg, _, _ = jax_side
    jcfg = jg.PMGNSConfig(variant=variant, hidden=32, n_gnn_blocks=2,
                          n_fc_blocks=2, layout="packed")
    tree = jax.tree_util.tree_map(
        np.asarray, jg.pmgns_init(jax.random.PRNGKey(5), jcfg))
    return jcfg, PMGNSConfig(**dataclasses.asdict(jcfg)), tree


@pytest.mark.parametrize("variant", ["graphsage", "gat"])
def test_default_services_match_jax(jax_side, variant):
    jax, JDIPPM, _, JOpGraph, JOpNode = jax_side
    jcfg, tcfg, tree = _jax_model(jax_side, variant)
    sizes = [5, 40, 100, 7, 60, 90, 12, 31, 250]
    jd = JDIPPM.from_params(jax.tree_util.tree_map(jax.numpy.asarray, tree),
                            jcfg)
    td = DIPPM.from_params(tree, tcfg, device="cpu")
    jgraphs = [_graph(n, seed=i, graph_cls=JOpGraph, node_cls=JOpNode)
               for i, n in enumerate(sizes)]
    tgraphs = [_graph(n, seed=i) for i, n in enumerate(sizes)]
    want = [_pred_vec(p) for p in jd.predict_many(jgraphs)]
    got = [_pred_vec(p) for p in td.predict_many(tgraphs)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    one = td.predict_graph(tgraphs[3])
    np.testing.assert_allclose(_pred_vec(one),
                               _pred_vec(jd.predict_graph(jgraphs[3])),
                               rtol=1e-5, atol=1e-6)
    assert td._default_service().stats.submitted == len(sizes) + 1


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8-weights"])
def test_gat_artifacts_load_across_packages(jax_side, tmp_path, precision):
    jax, JDIPPM, _, JOpGraph, JOpNode = jax_side
    from repro.serve.artifact import load_artifact as j_load
    from repro.serve.artifact import save_artifact as j_save
    jcfg, tcfg, tree = _jax_model(jax_side, "gat")
    from_jax, from_port = (str(tmp_path / "jax.npz"),
                           str(tmp_path / "port.npz"))
    j_save(from_jax, tree, jcfg, metadata={"by": "jax"}, precision=precision)
    DIPPM.from_params(tree, tcfg, device="cpu").save(
        from_port, metadata={"by": "port"}, precision=precision)
    leaves = jax.tree_util.tree_leaves
    for path, by in ((from_jax, "jax"), (from_port, "port")):
        jp, jc, jmeta = j_load(path)
        tp, tc, tmeta = load_artifact(path)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert jmeta == tmeta == {"by": by}
        for a, b in zip(leaves(tp), leaves(jp)):
            np.testing.assert_array_equal(a, np.asarray(b))
        g = 12
        want = _pred_vec(JDIPPM.load(path).predict_graph(
            _graph(g, seed=2, graph_cls=JOpGraph, node_cls=JOpNode)))
        got = _pred_vec(DIPPM.load(path, device="cpu").predict_graph(
            _graph(g, seed=2)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # both packages encode the same weights to the same bits
    with np.load(from_jax) as a, np.load(from_port) as b:
        for k in a.files:
            if k != "__dippm_artifact__":
                np.testing.assert_array_equal(a[k], b[k])
