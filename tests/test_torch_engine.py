"""The PyTorch port's prediction engine, facade and artifact loader against
the JAX package's.

The same graphs, given to both packages as ``OpGraph.to_json()``
documents, and the same weights go through ``repro.core.engine`` and
``repro_torch.core.engine`` on the CPU: predictions must agree to 1e-5
relative (1e-6 absolute near zero), with equal ``batches_run``,
``cache_entries`` and ``padding_waste_frac``. Artifacts written by the
JAX package's ``save_artifact`` in each encoding load into the port with
the same parameters and predictions.
"""
import dataclasses
import json
import pickle
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as je  # noqa: E402
from repro.core import frontends as jf  # noqa: E402
from repro.core import gnn as jg  # noqa: E402
from repro.core.batching import collate_packed  # noqa: E402
from repro.dataset.builder import synthetic_samples  # noqa: E402
from repro.serve.artifact import save_artifact  # noqa: E402
from repro_torch.core import DIPPM, frontends as tf  # noqa: E402
from repro_torch.core import engine as te  # noqa: E402
from repro_torch.core import gnn as tg  # noqa: E402
from repro_torch.serve.artifact import load_artifact  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def _doc(seed, n):
    rng = np.random.default_rng(seed)
    ops = ["dense", "conv", "relu", "add", "norm", "softmax", "pool", "gelu"]
    nodes = [{"id": i, "op": str(rng.choice(ops)),
              "out_shape": [int(v) for v in rng.integers(1, 128, 3)],
              "flops": float(rng.integers(1, 1e7)),
              "macs": float(rng.integers(0, 1e6)),
              "param_bytes": float(rng.integers(0, 1e5))}
             for i in range(n)]
    edges = [[int(s), i] for i in range(1, n)
             for s in sorted(set(rng.integers(0, i, min(i, 2)).tolist()))]
    g = jf.from_json({"nodes": nodes, "edges": edges,
                      "meta": {"batch": int(rng.integers(1, 32))}})
    return g.to_json()


DOCS = [_doc(s, n) for s, n in enumerate([5, 12, 30, 64, 90, 150, 200, 33])]


@pytest.fixture(scope="module")
def model():
    jcfg = jg.PMGNSConfig(hidden=32, n_gnn_blocks=2, n_fc_blocks=2,
                          layout="packed")
    tcfg = tg.PMGNSConfig(**dataclasses.asdict(jcfg))
    tree = jax.tree_util.tree_map(
        np.asarray, jg.pmgns_init(jax.random.PRNGKey(3), jcfg))
    return jcfg, tcfg, tree


def _arr(preds):
    return np.asarray([[p.latency_ms, p.energy_j, p.memory_mb]
                       for p in preds])


def test_engine_predict_graphs_matches_jax(model):
    jcfg, tcfg, tree = model
    ecfg = dict(node_budget=256)
    jeng = je.PredictionEngine(jax.tree_util.tree_map(jnp.asarray, tree),
                               jcfg, je.EngineConfig(**ecfg))
    teng = te.PredictionEngine(tree, tcfg, te.EngineConfig(**ecfg),
                               device="cpu")
    assert teng.warmup(rungs="all") == jeng.warmup(rungs="all") == 5
    want = jeng.predict_graphs([jf.from_json(d) for d in DOCS])
    got = teng.predict_graphs([tf.from_json(d) for d in DOCS])
    np.testing.assert_allclose(_arr(got), _arr(want), rtol=RTOL, atol=ATOL)
    assert [p.mig for p in got] == [p.mig for p in want]
    assert [p.meta for p in got] == [p.meta for p in want]
    for k in ("graphs_predicted", "batches_run", "cache_entries",
              "recompiles", "cache_hits", "cache_misses",
              "node_slots_total", "node_slots_real", "precision"):
        assert getattr(teng.stats, k) == getattr(jeng.stats, k), k
    assert teng.stats.padding_waste_frac == jeng.stats.padding_waste_frac
    assert teng.stats.batches_run > 1


def test_facade_paths_agree(model):
    _, tcfg, tree = model
    d = DIPPM.from_params(tree, tcfg, device="cpu")
    graphs = [tf.from_json(doc) for doc in DOCS[:4]]
    many, stats = d.predict_many(graphs, return_stats=True)
    one = d.predict_json(DOCS[2])
    assert _arr([one]).tolist() == _arr([many[2]]).tolist()
    assert d.predict_graph(graphs[0]).memory_mb == many[0].memory_mb
    assert stats.graphs_predicted == 4
    fresh = d.engine(node_budget=128)
    assert fresh is not d.engine() and fresh.params is d.params
    np.testing.assert_allclose(_arr(fresh.predict_graphs(graphs)),
                               _arr(many), rtol=RTOL, atol=ATOL)


def test_run_bin_is_thread_safe(model):
    _, tcfg, tree = model
    eng = te.PredictionEngine(tree, tcfg, te.EngineConfig(node_budget=128),
                              device="cpu")
    samples = synthetic_samples(40, seed=6, n_min=4, n_max=60)
    bins = eng.plan_bins(samples)
    want = [eng.run_bin([samples[j] for j in b]) for b in bins]
    results, errors = {}, []

    def work(k):
        try:
            for i, b in enumerate(bins):
                results[(k, i)] = eng.run_bin([samples[j] for j in b])
        except Exception as e:  # reported below
            errors.append(e)
    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    for (k, i), y in results.items():
        np.testing.assert_array_equal(y, want[i])
    assert eng.stats.batches_run == 5 * len(bins)
    assert eng.stats.graphs_predicted == 5 * len(samples)


def test_non_finite_outputs_raise(model):
    _, tcfg, tree = model
    eng = te.PredictionEngine(tree, tcfg, device="cpu")
    samples = synthetic_samples(3, seed=1, n_min=4, n_max=10)
    samples[1].x[0, 0] = np.nan
    with pytest.raises(te.PredictionInvalidError) as e:
        eng.run_bin(samples)
    assert 1 in e.value.bad_rows
    assert eng.stats.graphs_predicted == 0


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8-weights"])
def test_artifacts_written_by_jax_load_with_same_predictions(
        model, tmp_path, precision):
    jcfg, tcfg, tree = model
    path = str(tmp_path / f"{precision}.npz")
    save_artifact(path, tree, jcfg, metadata={"run": 7},
                  precision=precision)
    from repro.serve.artifact import load_artifact as j_load
    jp, jc, jmeta = j_load(path)
    tp, tc, tmeta = load_artifact(path)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tmeta == jmeta == {"run": 7}
    for a, b in zip(jax.tree_util.tree_leaves(tp),
                    jax.tree_util.tree_leaves(jp)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b))
    batch = {k: v for k, v in collate_packed(
        synthetic_samples(6, seed=9, n_min=4, n_max=40)).items()
        if k not in ("y", "wt")}
    want = np.asarray(jg.pmgns_infer(
        jax.tree_util.tree_map(jnp.asarray, jp), jc,
        {k: jnp.asarray(v) for k, v in batch.items()}))
    d = DIPPM.load(path, device="cpu")
    got = tg.pmgns_infer(d.params, d.cfg, batch).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_artifact_v2_loads_and_bad_files_raise(model, tmp_path):
    jcfg, _, tree = model
    path = str(tmp_path / "v2.npz")
    save_artifact(path, tree, jcfg, precision="f32")
    with np.load(path, allow_pickle=False) as z:
        doc = json.loads(bytes(z["__dippm_artifact__"]).decode("utf-8"))
        arrays = {k: z[k] for k in z.files if k != "__dippm_artifact__"}
    doc["schema_version"] = 2
    for spec in doc["params"].values():
        spec.pop("encoding", None)

    def write(d, p):
        header = np.frombuffer(json.dumps(d).encode("utf-8"), dtype=np.uint8)
        with open(p, "wb") as f:
            np.savez(f, __dippm_artifact__=header, **arrays)
    write(doc, path)
    loaded, _, _ = load_artifact(path)
    np.testing.assert_array_equal(loaded["gnn"]["b0"]["self"]["w"],
                                  tree["gnn"]["b0"]["self"]["w"])
    newer = str(tmp_path / "v9.npz")
    write(dict(doc, schema_version=9), newer)
    with pytest.raises(ValueError, match="newer"):
        load_artifact(newer)
    legacy = tmp_path / "legacy.pkl"
    legacy.write_bytes(pickle.dumps({"params": {}, "cfg": None}))
    with pytest.raises(ValueError, match="pickle"):
        load_artifact(str(legacy))
