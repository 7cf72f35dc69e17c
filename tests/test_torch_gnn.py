"""The PyTorch port's PMGNS against the JAX package's.

The same numpy weights (carried over by ``params_from_numpy``) and the
same packed batches go through ``repro.core.gnn.pmgns_infer`` and
``repro_torch.core.gnn.pmgns_infer`` on the CPU, at a small width
(hidden 64, 2 + 2 blocks); the predictions must agree to 1e-5 relative
(1e-6 absolute for values near zero).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import gnn as jg  # noqa: E402
from repro.core import mig as jm  # noqa: E402
from repro.core.batching import collate_packed  # noqa: E402
from repro.dataset.builder import synthetic_samples  # noqa: E402
from repro_torch.core import gnn as tg  # noqa: E402
from repro_torch.core import mig as tm  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
VARIANTS = ["graphsage", "gcn", "gin", "mlp"]


def _cfgs(variant, **kw):
    jcfg = jg.PMGNSConfig(variant=variant, hidden=64, n_gnn_blocks=2,
                          n_fc_blocks=2, layout="packed", **kw)
    return jcfg, tg.PMGNSConfig(**dataclasses.asdict(jcfg))


def _params(jcfg, seed=0):
    tree = jax.tree_util.tree_map(
        np.asarray, jg.pmgns_init(jax.random.PRNGKey(seed), jcfg))
    if jcfg.variant == "gin":       # a non-zero ε exercises the scale
        for i, blk in enumerate(tree["gnn"].values()):
            blk["eps"] = np.float32(0.1 * (i + 1))
    return tree


def _batch(seed=11, n=10):
    samples = synthetic_samples(n, seed=seed, n_min=4, n_max=40)
    return {k: v for k, v in collate_packed(samples).items()
            if k not in ("y", "wt")}


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("readout", ["mean_max", "mean"])
def test_pmgns_infer_matches_jax(variant, readout):
    jcfg, tcfg = _cfgs(variant, readout=readout)
    tree = _params(jcfg)
    batch = _batch()
    want = np.asarray(jg.pmgns_infer(
        jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
        {k: jnp.asarray(v) for k, v in batch.items()}))
    model = tg.params_from_numpy(tree, tcfg, device="cpu")
    got = tg.pmgns_infer(model, tcfg, batch).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("variant", ["graphsage", "gin"])
def test_staged_packed_infer_matches_jax(variant):
    jcfg, tcfg = _cfgs(variant)
    tree = _params(jcfg, seed=1)
    p, q, g = 256, 416, 16
    o1, o2, o3, f_len, i_len = jg.packed_staging_layout(jcfg, p, q, g)
    assert tg.packed_staging_layout(tcfg, p, q, g) == (o1, o2, o3, f_len,
                                                       i_len)
    samples = synthetic_samples(8, seed=2, n_min=4, n_max=30)
    fbuf = np.zeros(f_len, np.float32)
    ibuf = np.zeros(i_len, np.int32)
    collate_packed(samples, out={
        "x": fbuf[:o1].reshape(p, -1), "mask": fbuf[o1:o2],
        "edge_mask": fbuf[o2:o3], "static": fbuf[o3:].reshape(g, -1),
        "edges": ibuf[:2 * q].reshape(q, 2), "graph_ids": ibuf[2 * q:]})
    want = np.asarray(jg.make_staged_packed_infer_fn(jcfg, p, q, g)(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(fbuf),
        jnp.asarray(ibuf)))
    model = tg.params_from_numpy(tree, tcfg, device="cpu")
    got = tg.make_staged_packed_infer_fn(tcfg, p, q, g)(
        model, torch.as_tensor(fbuf), torch.as_tensor(ibuf)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_params_round_trip_and_names():
    jcfg, tcfg = _cfgs("gin")
    tree = _params(jcfg)
    model = tg.params_from_numpy(tree, tcfg, device="cpu")
    names = dict(model.named_parameters())
    assert "gnn.b0.mlp.l0.w" in names and "gnn.b1.eps" in names
    assert "fc.b1.b" in names
    # JAX's [d_in, d_out] layout, not nn.Linear's [out, in]
    assert tuple(names["gnn.b0.mlp.l0.w"].shape) == (tcfg.node_feat_dim, 64)
    back = tg.params_to_numpy(model)
    flat_a = jax.tree_util.tree_leaves(tree)
    flat_b = jax.tree_util.tree_leaves(back)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(back)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    sage = tg.params_from_numpy(_params(_cfgs("graphsage")[0]),
                                _cfgs("graphsage")[1], device="cpu")
    assert "gnn.b0.self.w" in dict(sage.named_parameters())


def test_params_tree_shape_mismatch_raises():
    jcfg, tcfg = _cfgs("graphsage")
    tree = _params(jcfg)
    tree["gnn"]["b0"]["self"]["w"] = tree["gnn"]["b0"]["self"]["w"][:, :8]
    with pytest.raises(ValueError, match="does not match"):
        tg.params_from_numpy(tree, tcfg, device="cpu")


def test_port_init_has_jax_structure():
    for variant in VARIANTS:
        jcfg, tcfg = _cfgs(variant)
        jt = jax.tree_util.tree_map(np.shape, _params(jcfg))
        tt = jax.tree_util.tree_map(np.shape, tg.pmgns_init(0, tcfg))
        assert tt == jt


def test_config_mirrors_jax():
    assert dataclasses.asdict(tg.PMGNSConfig()) == \
        dataclasses.asdict(jg.PMGNSConfig())
    assert [f.name for f in dataclasses.fields(tg.PMGNSConfig)] == \
        [f.name for f in dataclasses.fields(jg.PMGNSConfig)]
    for kw in ({"precision": "fp8"}, {"layout": "ragged"},
               {"layout": "packed", "fused_mp": "maybe"},
               {"layout": "sparse", "fused_mp": "on"}):
        for mod in (jg, tg):
            cfg = mod.PMGNSConfig(**kw)
            with pytest.raises(ValueError):
                cfg.resolved_precision, cfg.resolved_layout, \
                    cfg.resolved_fused


@pytest.mark.parametrize("variant", VARIANTS + ["gat"])
def test_composed_engine_matches_fused(variant):
    """``fused_mp="off"`` predicts through the engine on the composed
    packed layers (segment aggregate / scatter, edge softmax, readout)
    and gives the fused layers' predictions for the same weights and
    samples."""
    from repro_torch.core.engine import PredictionEngine
    from repro_torch.dataset.builder import synthetic_samples as samples_of
    samples = samples_of(12, seed=1)
    outs = []
    for fused in ("off", "on"):
        cfg = tg.PMGNSConfig(variant=variant, hidden=32, n_gnn_blocks=2,
                             n_fc_blocks=1, layout="packed", fused_mp=fused)
        model = tg.params_from_numpy(tg.pmgns_init(0, cfg), cfg,
                                     device="cpu")
        outs.append(PredictionEngine(model, cfg, device="cpu")
                    .predict_samples(samples))
    assert outs[0].shape == (12, 3) and np.isfinite(outs[0]).all()
    np.testing.assert_allclose(outs[0], outs[1], rtol=RTOL, atol=ATOL)


def test_int8_weights_runs_as_f32():
    jcfg, tcfg = _cfgs("graphsage", precision="int8-weights")
    tree = _params(jcfg)
    batch = _batch(seed=3, n=5)
    a = tg.pmgns_infer(tg.params_from_numpy(tree, tcfg, device="cpu"),
                       tcfg, batch)
    cfg32 = dataclasses.replace(tcfg, precision="f32")
    b = tg.pmgns_infer(tg.params_from_numpy(tree, cfg32, device="cpu"),
                       cfg32, batch)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_target_transforms_match_jax():
    y = np.array([-1.0, 0.0, 1e-3, 2.5, 1e4], np.float32)
    np.testing.assert_allclose(tg.encode_targets(torch.as_tensor(y)).numpy(),
                               np.asarray(jg.encode_targets(jnp.asarray(y))),
                               rtol=1e-6)
    np.testing.assert_allclose(tg.decode_targets(torch.as_tensor(y)).numpy(),
                               np.asarray(jg.decode_targets(jnp.asarray(y))),
                               rtol=1e-6)


def test_mig_rules_match_jax():
    for mb in (-1.0, 0.0, 1.0, 5119.0, 5120.0, 20000.0, 40959.0, 40960.0,
               1e5, 3.6e6, 1e7):
        assert tm.predict_mig(mb) == jm.predict_mig(mb)
        assert tm.predict_tpu_slice(mb) == jm.predict_tpu_slice(mb)
        assert tm.predict_pods(mb) == jm.predict_pods(mb)
        assert tm.mig_utilization(mb) == jm.mig_utilization(mb)
