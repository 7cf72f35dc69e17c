"""bf16 staging in the PyTorch port against the JAX package's.

Under ``PMGNSConfig(precision="bf16")`` a packed engine stages its float
buffer in bfloat16 and upcasts it on the device; parameters and compute
stay float32. The JAX engine rounds through ``ml_dtypes.bfloat16``, the
port through one ``torch`` copy: the staged bits must be equal, including
values that round up, ties, subnormals and ±inf. bf16 predictions and
the warmup probe ``bf16_max_abs_delta`` are held against the JAX bf16
engine (1e-5 relative + 1e-6 absolute), the drift against float32 to the
reference's ≤ 0.5 % MAPE bar (``benchmarks/fused_mp.py``, on a trained
predictor, as there), and the artifact and serving paths as in
``tests/test_precision.py``. Everything runs on the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as je  # noqa: E402
from repro.core import gnn as jg  # noqa: E402
from repro.core.batching import packed_shape  # noqa: E402
from repro.dataset.builder import synthetic_samples as j_samples  # noqa: E402
from repro.serve.artifact import save_artifact as j_save  # noqa: E402
from repro_torch.core import DIPPM  # noqa: E402
from repro_torch.core import engine as te  # noqa: E402
from repro_torch.core import gnn as tg  # noqa: E402
from repro_torch.core.batching import resolve_packed_budgets  # noqa: E402
from repro_torch.dataset.builder import synthetic_samples  # noqa: E402
from repro_torch.serve import PredictionService, load_artifact  # noqa: E402
from repro_torch.train.gnn_trainer import TrainConfig, train_pmgns  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
#: bf16 staging against float32: the reference's end-to-end bar
MAPE_BAR = 0.005

#: float32 values whose bfloat16 rounding is easy to get wrong
SPECIAL = np.array([
    1.0 + 2.0 ** -8,                 # tie, rounds down to even
    1.0 + 3 * 2.0 ** -8,             # tie, rounds up to even
    1.0 + 2.0 ** -8 + 2.0 ** -20,    # just past the tie: rounds up
    -(1.0 + 2.0 ** -7 + 2.0 ** -9),  # negative, rounds away
    1e-39, 1e-40, -3e-39,            # subnormals
    1.1754942e-38,                   # the largest subnormal
    np.float32(2.0 ** -133),         # the smallest bf16 subnormal's half
    np.inf, -np.inf,
    3.4e38,                          # past bf16's largest: to inf
    0.1, -0.0, 65504.0, 1e30,
], dtype=np.float32)


def _cfgs(variant="graphsage", hidden=32, **kw):
    jcfg = jg.PMGNSConfig(variant=variant, hidden=hidden, n_gnn_blocks=2,
                          n_fc_blocks=2, layout="packed", **kw)
    return jcfg, tg.PMGNSConfig(**dataclasses.asdict(jcfg))


def _tree(jcfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jg.pmgns_init(jax.random.PRNGKey(seed), jcfg))


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def trained():
    """A GraphSAGE predictor trained a little on the CPU: MAPE is
    relative to the float32 predictions, so it needs them at calibrated
    magnitudes (random weights decode some graphs to ~0)."""
    cfg = tg.PMGNSConfig(hidden=32, layout="packed", dropout=0.0)
    samples = synthetic_samples(96, seed=1, n_min=16, n_max=200)
    tree, _ = train_pmgns(cfg, samples, (), TrainConfig(
        epochs=20, batch_size=16, lr=1e-3, seed=0), device="cpu")
    return tree, cfg, samples


@pytest.mark.parametrize("seed", [0, 1])
def test_staged_bf16_bits_equal_jax(seed):
    """The port's staged bfloat16 buffer has the JAX engine's bits, the
    special values included (written into both packages' samples)."""
    jcfg, tcfg = _cfgs(precision="bf16")
    tree = _tree(jcfg)
    jeng = je.PredictionEngine(_jtree(tree), jcfg)
    teng = te.PredictionEngine(tree, tcfg, device="cpu")
    jchunk = j_samples(12, seed=seed, n_min=4, n_max=40)
    tchunk = synthetic_samples(12, seed=seed, n_min=4, n_max=40)
    rng = np.random.default_rng(seed)
    for js, ts in zip(jchunk, tchunk):
        np.testing.assert_array_equal(js.x, ts.x)
        pos = rng.choice(js.n_nodes * js.x.shape[1], len(SPECIAL),
                         replace=len(SPECIAL) > js.n_nodes * js.x.shape[1])
        for arr in (js.x, ts.x):
            arr.reshape(-1)[pos] = SPECIAL
    # and every finite float32 pattern class in bulk: random bits
    bits = rng.integers(0, 2 ** 32, tchunk[0].x.size, dtype=np.uint64)
    noise = bits.astype(np.uint32).view(np.float32)
    noise = np.where(np.isnan(noise), np.float32(1.5), noise)
    jchunk[0].x.reshape(-1)[:] = noise
    tchunk[0].x.reshape(-1)[:] = noise
    nb, eb, gb = resolve_packed_budgets(te.EngineConfig().node_budget)
    p, q, g = packed_shape(jchunk, nb, eb, gb)
    jf, ji = jeng._stage_packed(jchunk, p, q, g)
    tf, ti = teng._stage_packed(tchunk, p, q, g)
    assert tf.dtype == torch.bfloat16 and ti.dtype == torch.int32
    assert jf.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(tf.view(torch.int16).numpy().view(np.uint16),
                                  jf.view(np.uint16))
    np.testing.assert_array_equal(ti.numpy(), ji)


def test_stage_bf16_rounds_as_ml_dtypes():
    got = te.stage_bf16(SPECIAL).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(
        got, SPECIAL.astype(ml_dtypes.bfloat16).view(np.uint16))
    assert te.stage_bf16(np.array([np.nan], np.float32)).isnan().all()


@pytest.mark.parametrize("variant", ["graphsage", "gcn", "gat", "gin"])
def test_bf16_predictions_and_delta_match_jax(variant):
    jcfg, tcfg = _cfgs(variant, precision="bf16")
    tree = _tree(jcfg, seed=2)
    jeng = je.PredictionEngine(_jtree(tree), jcfg,
                               je.EngineConfig(node_budget=512))
    teng = te.PredictionEngine(tree, tcfg, te.EngineConfig(node_budget=512),
                               device="cpu")
    assert teng.warmup() == jeng.warmup()
    jd, td = jeng.stats.bf16_max_abs_delta, teng.stats.bf16_max_abs_delta
    assert td is not None and np.isfinite(td) and td > 0
    samples = synthetic_samples(30, seed=4, n_min=4, n_max=120)
    want = jeng.predict_samples(j_samples(30, seed=4, n_min=4, n_max=120))
    got = teng.predict_samples(samples)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert abs(td - jd) <= 1e-5 * np.max(np.abs(want)) + 1e-6
    counters = [dataclasses.asdict(e.stats) for e in (teng, jeng)]
    for c in counters:
        c.pop("bf16_max_abs_delta")          # held to its bar above
    assert counters[0] == counters[1]


def test_bf16_against_f32_mape(trained):
    """Staging-only rounding drifts by at most the reference's 0.5 %."""
    tree, cfg32, samples = trained
    cfg16 = dataclasses.replace(cfg32, precision="bf16")
    e32 = te.PredictionEngine(tree, cfg32, device="cpu")
    e16 = te.PredictionEngine(tree, cfg16, device="cpu")
    y32 = e32.predict_samples(samples)
    y16 = e16.predict_samples(samples)
    assert np.isfinite(y16).all() and not np.array_equal(y16, y32)
    mape = float(np.mean(np.abs(y16 - y32) / np.maximum(np.abs(y32), 1e-6)))
    assert mape <= MAPE_BAR, mape


def test_bf16_configuration_runs():
    """bf16 used to be refused: the configuration, its parameters and
    the staged function take it; the float buffer is upcast before
    compute, so an exactly representable buffer predicts as float32."""
    cfg = tg.PMGNSConfig(hidden=8, n_gnn_blocks=1, n_fc_blocks=1,
                         layout="packed", precision="bf16")
    tg.check_supported(cfg)
    model = tg.params_from_numpy(tg.pmgns_init(0, cfg), cfg, device="cpu")
    p, q, g = 64, 128, 4
    _, _, _, f_len, i_len = tg.packed_staging_layout(cfg, p, q, g)
    rng = np.random.default_rng(0)
    fbuf = torch.from_numpy(rng.integers(-4, 4, f_len).astype(np.float32))
    ibuf = torch.from_numpy(np.sort(rng.integers(0, g, i_len)).astype(
        np.int32))
    y16 = tg.make_staged_packed_infer_fn(cfg, p, q, g)(
        model, fbuf.to(torch.bfloat16), ibuf)
    cfg32 = dataclasses.replace(cfg, precision="f32")
    y32 = tg.make_staged_packed_infer_fn(cfg32, p, q, g)(model, fbuf, ibuf)
    assert y16.dtype == torch.float32
    torch.testing.assert_close(y16, y32, rtol=0, atol=0)


def test_engine_bf16_stats_and_drift(trained):
    tree, cfg32, samples = trained
    cfg16 = dataclasses.replace(cfg32, precision="bf16")
    e32 = te.PredictionEngine(tree, cfg32, device="cpu")
    e16 = te.PredictionEngine(tree, cfg16, device="cpu")
    e16.warmup()
    assert e16.stats.precision == "bf16"
    assert np.isfinite(e16.stats.bf16_max_abs_delta)
    e32.warmup()
    assert e32.stats.precision == "f32"
    assert e32.stats.bf16_max_abs_delta is None
    y32 = e32.predict_samples(samples[:12])
    y16 = e16.predict_samples(samples[:12])
    assert np.all(np.isfinite(y16))
    np.testing.assert_allclose(y16, y32, rtol=0.05, atol=0.05)


def test_serve_stats_carry_precision(trained):
    tree, cfg32, _ = trained
    cfg16 = dataclasses.replace(cfg32, precision="bf16")
    eng = te.PredictionEngine(tree, cfg16, device="cpu")
    eng.warmup()
    with PredictionService(engine=eng) as svc:
        st = svc.stats
    assert st.precision == "bf16"
    assert st.bf16_max_abs_delta == eng.stats.bf16_max_abs_delta
    with PredictionService(tree, cfg32, device="cpu") as svc:
        assert svc.stats.bf16_max_abs_delta is None


@pytest.mark.parametrize("stored", ["f32", "bf16"])
def test_bf16_engine_from_jax_artifact(tmp_path, stored):
    """A bf16-runtime artifact written by the JAX package (weights stored
    as float32 or as bfloat16 bits) loads into a bf16 engine of the port
    that predicts as the JAX engine on the loaded weights."""
    jcfg, _ = _cfgs(precision="bf16")
    tree = _tree(jcfg, seed=5)
    path = str(tmp_path / f"bf16_{stored}.npz")
    j_save(path, _jtree(tree), jcfg, precision=stored)
    params, cfg, _ = load_artifact(path)
    assert cfg.precision == "bf16"
    eng = te.PredictionEngine(params, cfg, device="cpu")
    assert eng.stats.precision == "bf16" and eng._stage_bf16
    from repro.serve.artifact import load_artifact as j_load
    jparams, jcfg2, _ = j_load(path)
    want = je.PredictionEngine(jparams, jcfg2).predict_samples(
        j_samples(6, seed=1, n_min=4, n_max=16))
    got = eng.predict_samples(synthetic_samples(6, seed=1, n_min=4,
                                                n_max=16))
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    d = DIPPM.load(path, device="cpu")
    assert d.engine().stats.precision == "bf16"


def test_dense_bf16_stages_float32():
    """bf16 is a packed-staging policy: a dense bf16 engine stages float32,
    measures no delta and predicts as the float32 one, as in the JAX
    package."""
    jcfg = jg.PMGNSConfig(hidden=16, n_gnn_blocks=2, n_fc_blocks=2,
                          precision="bf16")
    tcfg = tg.PMGNSConfig(**dataclasses.asdict(jcfg))
    tree = _tree(jcfg)
    e16 = te.PredictionEngine(tree, tcfg, device="cpu")
    e32 = te.PredictionEngine(tree, dataclasses.replace(tcfg, precision="f32"),
                              device="cpu")
    assert e16.layout == "dense" and not e16._stage_bf16
    assert e16.warmup(node_buckets=(32,), batch_buckets=(2,)) == 1
    assert e16.stats.precision == "bf16"
    assert e16.stats.bf16_max_abs_delta is None
    samples = synthetic_samples(8, seed=3, n_min=4, n_max=30)
    np.testing.assert_array_equal(e16.predict_samples(samples),
                                  e32.predict_samples(samples))
    want = je.PredictionEngine(_jtree(tree), jcfg).predict_samples(
        j_samples(8, seed=3, n_min=4, n_max=30))
    np.testing.assert_allclose(e16.predict_samples(samples), want,
                               rtol=RTOL, atol=ATOL)
