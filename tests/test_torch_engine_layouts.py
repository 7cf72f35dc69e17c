"""The PyTorch port's bucketed engine (dense and sparse layouts) against
the JAX package's.

The same graphs, given to both packages as ``OpGraph.to_json()``
documents, and the same numpy weights go through
``repro.core.engine.PredictionEngine`` and
``repro_torch.core.engine.PredictionEngine`` on the CPU, at a small width
(hidden 32, 2 + 2 blocks): predictions must agree to 1e-5 relative
(1e-6 absolute near zero), and ``plan_bins``, ``warmup``'s return value
and every ``EngineStats`` counter must be equal for equal traffic. The
rest ports the dense and sparse tests of ``tests/test_engine.py`` and
holds ``DIPPM``'s default configuration (dense) and ``predict_batch``
against the JAX package.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import DIPPM as JDIPPM  # noqa: E402
from repro.core import engine as je  # noqa: E402
from repro.core import frontends as jf  # noqa: E402
from repro.core import gnn as jg  # noqa: E402
from repro.core.batching import sample_from_graph as j_sample  # noqa: E402
from repro.train import gnn_trainer as jt  # noqa: E402
from repro_torch.core import DIPPM, OpGraph, OpNode  # noqa: E402
from repro_torch.core import engine as te  # noqa: E402
from repro_torch.core import frontends as tf  # noqa: E402
from repro_torch.core import gnn as tg  # noqa: E402
from repro_torch.core.batching import sample_from_graph  # noqa: E402
from repro_torch.train import gnn_trainer as tt  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
VARIANTS = ["graphsage", "gcn", "gat", "gin", "mlp"]


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


#: buckets 32, 64, 128 and 256, several chunks each under max_batch=4
SIZES = [5, 12, 30, 40, 64, 90, 150, 200, 33, 20, 8, 70, 9, 31, 17]
DOCS = [_doc(s, n) for s, n in enumerate(SIZES)]


def _cfgs(variant, layout, hidden=32, **kw):
    jcfg = jg.PMGNSConfig(variant=variant, hidden=hidden, n_gnn_blocks=2,
                          n_fc_blocks=2, layout=layout, **kw)
    return jcfg, tg.PMGNSConfig(**dataclasses.asdict(jcfg))


def _tree(jcfg, seed=3):
    tree = jax.tree_util.tree_map(
        np.asarray, jg.pmgns_init(jax.random.PRNGKey(seed), jcfg))
    if jcfg.variant == "gin":       # a non-zero ε exercises the scale
        for i, blk in enumerate(tree["gnn"].values()):
            blk["eps"] = np.float32(0.1 * (i + 1))
    return tree


def _engines(variant, layout, **ecfg):
    jcfg, tcfg = _cfgs(variant, layout)
    tree = _tree(jcfg)
    jeng = je.PredictionEngine(jax.tree_util.tree_map(jnp.asarray, tree),
                               jcfg, je.EngineConfig(**ecfg))
    teng = te.PredictionEngine(tree, tcfg, te.EngineConfig(**ecfg),
                               device="cpu")
    return jeng, teng


def _arr(preds):
    return np.asarray([[p.latency_ms, p.energy_j, p.memory_mb]
                       for p in preds])


def _graph(n_nodes, seed=0):
    """Chain graph with varied ops/flops (``tests/test_engine.py``)."""
    rng = np.random.default_rng(seed)
    ops = ["dense", "conv", "relu", "add"]
    nodes = [OpNode(i, ops[i % len(ops)],
                    (int(rng.integers(1, 16)), int(rng.integers(1, 64))),
                    flops=float(rng.integers(1, 10_000)),
                    macs=float(rng.integers(1, 5_000)))
             for i in range(n_nodes)]
    edges = [(i, i + 1) for i in range(n_nodes - 1)]
    return OpGraph(nodes=nodes, edges=edges, meta={"seed": seed, "n": n_nodes})


@pytest.fixture(scope="module")
def dense_model():
    cfg = tg.PMGNSConfig(hidden=32)
    return DIPPM.from_params(tg.pmgns_init(0, cfg), cfg, device="cpu")


# ---- the bucketed engine against the JAX package ---------------------------

@pytest.mark.parametrize("layout", ["dense", "sparse"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_engine_layouts_match_jax(variant, layout):
    """Predictions, the bin plan, warmup's count and every EngineStats
    counter equal the JAX engine's for the same traffic."""
    jeng, teng = _engines(variant, layout, max_batch=4)
    assert teng.layout == jeng.layout == layout
    assert (teng.sparse, teng.packed) == (jeng.sparse, jeng.packed)
    assert teng.warmup(node_buckets=(32,), batch_buckets=(4,)) == \
        jeng.warmup(node_buckets=(32,), batch_buckets=(4,)) == 1
    jgraphs = [jf.from_json(d) for d in DOCS]
    tgraphs = [tf.from_json(d) for d in DOCS]
    jsamples = [j_sample(g) for g in jgraphs]
    tsamples = [sample_from_graph(g) for g in tgraphs]
    assert teng.plan_bins(tsamples) == jeng.plan_bins(jsamples)
    assert len(teng.plan_bins(tsamples)) > 4
    want = _arr(jeng.predict_graphs(jgraphs))
    got = _arr(teng.predict_graphs(tgraphs))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert dataclasses.asdict(teng.stats) == dataclasses.asdict(jeng.stats)
    assert teng.stats.padding_waste_frac == jeng.stats.padding_waste_frac


@pytest.mark.parametrize("layout", ["auto", "dense", "sparse"])
def test_engine_dense_and_sparse_layouts_match_jax(layout):
    """The layouts the engine used to refuse run, each on its own bucketed
    path, and predict as the JAX engine does (the default ``auto`` is
    dense)."""
    jeng, teng = _engines("graphsage", layout)
    assert teng.layout == ("dense" if layout == "auto" else layout)
    assert not teng.packed
    graphs = [tf.from_json(d) for d in DOCS[:6]]
    want = _arr(jeng.predict_graphs([jf.from_json(d) for d in DOCS[:6]]))
    np.testing.assert_allclose(_arr(teng.predict_graphs(graphs)), want,
                               rtol=RTOL, atol=ATOL)
    assert teng.stats.batches_run == jeng.stats.batches_run


def test_inference_buckets_match_jax():
    assert te.INFERENCE_BUCKETS == je.INFERENCE_BUCKETS
    jeng, teng = _engines("gcn", "dense", buckets=te.INFERENCE_BUCKETS)
    graphs = [tf.from_json(d) for d in DOCS]
    want = _arr(jeng.predict_graphs([jf.from_json(d) for d in DOCS]))
    np.testing.assert_allclose(_arr(teng.predict_graphs(graphs)), want,
                               rtol=RTOL, atol=ATOL)
    assert dataclasses.asdict(teng.stats) == dataclasses.asdict(jeng.stats)
    assert teng.stats.cache_entries > len(te.EngineConfig().buckets) // 2


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_warmup_grid_matches_jax(layout):
    """Warmup's default grid (every bucket × its batch cap) and an
    explicit one count the same shapes as the JAX engine's; the wrong
    kind of warmup raises as there."""
    jeng, teng = _engines("mlp", layout, max_batch=4,
                          buckets=(32, 64, 128))
    assert teng.warmup() == jeng.warmup() == 3
    assert teng.warmup(node_buckets=(32, 64), batch_buckets=(2, 3)) == \
        jeng.warmup(node_buckets=(32, 64), batch_buckets=(2, 3)) == 2
    assert dataclasses.asdict(teng.stats) == dataclasses.asdict(jeng.stats)
    with pytest.raises(ValueError, match="packed"):
        teng.warmup(rungs="all")
    _, packed = _engines("mlp", "packed")
    with pytest.raises(ValueError, match="rung"):
        packed.warmup(node_buckets=(32,))


# ---- ports of tests/test_engine.py (dense and sparse) -----------------------

def test_memory_envelope_splits_large_buckets(dense_model):
    """With a tiny max_batch the engine must chunk, still in order."""
    eng = te.PredictionEngine(dense_model.params, dense_model.cfg,
                              te.EngineConfig(max_batch=2), device="cpu")
    graphs = [_graph(10, seed=i) for i in range(5)]
    out = eng.predict_graphs(graphs)
    assert eng.stats.batches_run == 3        # 2 + 2 + 1
    ref = [dense_model.predict_graph(g) for g in graphs]
    for a, b in zip(ref, out):
        np.testing.assert_allclose(a.latency_ms, b.latency_ms,
                                   atol=1e-5, rtol=1e-5)


def test_warmup_precompiles(dense_model):
    eng = te.PredictionEngine(dense_model.params, dense_model.cfg,
                              device="cpu")
    assert eng.warmup(node_buckets=(32, 64)) == 2
    eng.predict_graphs([_graph(10, seed=0) for _ in range(64)])
    assert eng.stats.cache_misses == 2       # all served from warmup


def test_sparse_engine_matches_dense(dense_model):
    """sparse_mp engine: same predictions, same order, no dense adj."""
    cfg_s = tg.PMGNSConfig(hidden=32, sparse_mp=True)
    # the same seed-0 weights as dense_model's (init ignores the layout)
    eng_s = te.PredictionEngine(tg.pmgns_init(0, cfg_s), cfg_s,
                                device="cpu")
    sizes = [3, 40, 100, 7, 60, 90, 12]
    graphs = [_graph(n, seed=i) for i, n in enumerate(sizes)]
    dense_out = dense_model.predict_many(graphs)
    sparse_out = eng_s.predict_graphs(graphs)
    for a, b in zip(dense_out, sparse_out):
        np.testing.assert_allclose(
            [b.latency_ms, b.energy_j, b.memory_mb],
            [a.latency_ms, a.energy_j, a.memory_mb], atol=1e-5, rtol=1e-5)


def test_sparse_engine_cache_keys_include_edge_bucket():
    cfg_s = tg.PMGNSConfig(hidden=32, sparse_mp=True)
    eng = te.PredictionEngine(tg.pmgns_init(0, cfg_s), cfg_s, device="cpu")
    assert eng.sparse
    eng.predict_graphs([_graph(10, seed=i) for i in range(4)])
    assert eng.stats.cache_misses == 1
    # chunks up to the bucket's edge floor (~2 edges/node) share the
    # shape: 30-node chains reuse the 10-node one
    eng.predict_graphs([_graph(30, seed=9 + i) for i in range(4)])
    assert eng.stats.cache_misses == 1
    assert eng.stats.cache_hits >= 1

    def _dense_graph(seed):
        g = _graph(30, seed=seed)
        return OpGraph(nodes=g.nodes,
                       edges=[(i, j) for i in range(30)
                              for j in range(i + 1, 30) if (i + j) % 3],
                       meta=dict(g.meta))
    assert len(_dense_graph(0).edges) > 64   # past edge_bucket_for(2 · 32)
    eng.predict_graphs([_dense_graph(s) for s in range(4)])
    assert eng.stats.cache_misses == 2       # a larger edge bucket


def test_sparse_warmup_precompiles():
    cfg_s = tg.PMGNSConfig(hidden=32, sparse_mp=True)
    eng = te.PredictionEngine(tg.pmgns_init(0, cfg_s), cfg_s, device="cpu")
    assert eng.warmup(node_buckets=(32,)) == 1


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_run_bin_rejects_mixed_buckets(dense_model, layout):
    cfg = dataclasses.replace(dense_model.cfg, layout=layout)
    eng = te.PredictionEngine(tg.pmgns_init(0, cfg), cfg, device="cpu")
    mixed = [sample_from_graph(_graph(5, seed=0)),
             sample_from_graph(_graph(60, seed=1))]
    with pytest.raises(ValueError, match="single-bucket"):
        eng.run_bin(mixed)


def test_plan_bins_partition_and_run_bin(dense_model):
    """plan_bins covers every index exactly once; run_bin on the planned
    bins reproduces predict_samples."""
    for layout in ("dense", "sparse"):
        cfg = dataclasses.replace(dense_model.cfg, layout=layout)
        eng = te.PredictionEngine(tg.pmgns_init(0, cfg), cfg, device="cpu")
        samples = [sample_from_graph(_graph(n, seed=i))
                   for i, n in enumerate([3, 40, 100, 7, 60, 90, 12])]
        bins = eng.plan_bins(samples)
        assert sorted(i for b in bins for i in b) == list(range(len(samples)))
        out = np.zeros((len(samples), 3), np.float32)
        for idx in bins:
            out[idx] = eng.run_bin([samples[j] for j in idx])
        ref = te.PredictionEngine(tg.pmgns_init(0, cfg), cfg,
                                  device="cpu").predict_samples(samples)
        np.testing.assert_array_equal(out, ref)
        assert eng.stats.graphs_predicted == len(samples)


# ---- the facade's default configuration and predict_batch ------------------

def test_dippm_default_config_matches_jax():
    """``DIPPM(params, PMGNSConfig())`` — the paper's width, layout
    ``auto`` (dense) — serves, as the JAX package's does."""
    jcfg = jg.PMGNSConfig()
    tree = jax.tree_util.tree_map(
        np.asarray, jg.pmgns_init(jax.random.PRNGKey(0), jcfg))
    tcfg = tg.PMGNSConfig()
    assert tcfg.resolved_layout == "dense"
    d = DIPPM(tree, tcfg, device="cpu")
    assert d.engine().layout == "dense"
    docs = DOCS[:4]
    got = d.predict_many([tf.from_json(x) for x in docs])
    want = JDIPPM(jax.tree_util.tree_map(jnp.asarray, tree), jcfg
                  ).predict_many([jf.from_json(x) for x in docs])
    np.testing.assert_allclose(_arr(got), _arr(want), rtol=RTOL, atol=ATOL)
    fresh = d.engine(buckets=te.INFERENCE_BUCKETS, max_batch=8)
    assert fresh.engine_cfg.max_batch == 8 and fresh.params is d.params


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_predict_batch_matches_jax(layout):
    jcfg, tcfg = _cfgs("gcn", layout)
    tree = _tree(jcfg)
    samples = [sample_from_graph(tf.from_json(d)) for d in DOCS]
    jsamples = [j_sample(jf.from_json(d)) for d in DOCS]
    want = jt.predict_batch(jax.tree_util.tree_map(jnp.asarray, tree),
                            jcfg, jsamples)
    got = tt.predict_batch(tree, tcfg, samples, device="cpu")
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
