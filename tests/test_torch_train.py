"""PMGNS training in the PyTorch port against the JAX package.

On the CPU, where every kernel takes its plain version and its backward
runs through ``repro_torch.kernels.autograd``:

* one step's loss and gradients against ``jax.value_and_grad`` of the
  JAX trainer's ``_loss_terms``, for every variant on every layout;
* two epochs of ``train_pmgns`` from the JAX initial tree (the port's
  ``pmgns_init`` is monkeypatched to return it) with dropout 0: per-epoch
  loss within 1e-4 relative and parameters within 1e-4 + 1e-3 relative,
  the bar of ``tests/test_trainer.py``, on the dense, sparse and packed
  layouts;
* scan equals eager, padding rows are no-ops, grad clipping is wired,
  resume is bit-exact with dropout on, checkpoints restore across the two
  packages, and the refusals (``data_parallel`` on the packed layout or in
  eager mode, ``device=None`` without CUDA).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.batching import stack_epoch_segments  # noqa: E402
from repro_torch.core.gnn import (PMGNSConfig, params_from_numpy,  # noqa: E402
                                  pmgns_init)
from repro_torch.dataset.builder import synthetic_samples  # noqa: E402
from repro_torch.train import gnn_trainer as tt  # noqa: E402
from repro_torch.train.gnn_trainer import TrainConfig, train_pmgns  # noqa: E402

CFG = PMGNSConfig(hidden=32, dropout=0.0)
LOSS_RTOL = 1e-4
PARAM_ATOL, PARAM_RTOL = 1e-4, 1e-3
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6     # float32, 3 layers + readout + head
VARIANTS = ("graphsage", "gcn", "gat", "gin", "mlp")
LAYOUTS = ("dense", "sparse", "packed")


def _jax_tree(cfg, seed=0):
    """The JAX trainer's initial tree for ``seed``, as numpy."""
    import jax
    from repro.core.gnn import PMGNSConfig as JCfg
    from repro.core.gnn import pmgns_init as jinit
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    tree = jinit(key, JCfg(**dataclasses.asdict(cfg)))
    return jax.tree_util.tree_map(np.asarray, tree)


def _jcfg(cfg):
    from repro.core.gnn import PMGNSConfig as JCfg
    return JCfg(**dataclasses.asdict(cfg))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree)]


def _assert_params_close(got, want, atol=PARAM_ATOL, rtol=PARAM_RTOL):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol)


def _first_step(layout, samples):
    seg = stack_epoch_segments(samples, 8, rng=np.random.default_rng(0),
                               layout=layout)[0]
    return {k: v[0] for k, v in seg.items()}


# ---------------------------------------------------------------------------
# one step against jax.value_and_grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_one_step_loss_and_grads_match_jax(variant, layout):
    import jax
    import jax.numpy as jnp
    from repro.train.gnn_trainer import _loss_terms as jloss
    from repro.train.gnn_trainer import _target_stats as jstats
    cfg = dataclasses.replace(CFG, variant=variant, layout=layout)
    samples = synthetic_samples(14, seed=21, n_min=4, n_max=45)
    batch = _first_step(layout, samples)
    tree = _jax_tree(cfg)
    mean, std = (np.array(a) for a in jstats(samples))
    p_mean, p_std = tt._target_stats(samples)
    np.testing.assert_allclose(p_mean, mean, rtol=1e-6)
    np.testing.assert_allclose(p_std, std, rtol=1e-6)

    def jfn(p):
        wl, wn = jloss(p, _jcfg(cfg), {k: jnp.asarray(v)
                                       for k, v in batch.items()},
                       None, 1.0, jnp.asarray(mean), jnp.asarray(std))
        return wl / jnp.maximum(wn, 1.0)
    jl, jg = jax.value_and_grad(jfn)(jax.tree_util.tree_map(jnp.asarray,
                                                            tree))
    model = params_from_numpy(tree, cfg, "cpu", requires_grad=True)
    wl, wn = tt._loss_terms(model.tree(), cfg,
                            {k: torch.as_tensor(v) for k, v in batch.items()},
                            None, 1.0, torch.as_tensor(mean),
                            torch.as_tensor(std))
    loss = wl / torch.clamp_min(wn, 1.0)
    leaves = tt.tree_leaves(model.tree())
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for g, w in zip(grads, _leaves(jg)):
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


# ---------------------------------------------------------------------------
# two epochs against the JAX trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS)
def test_two_epochs_match_the_jax_trainer(layout, monkeypatch):
    from repro.dataset.builder import synthetic_samples as jsynth
    from repro.train.gnn_trainer import TrainConfig as JTrain
    from repro.train.gnn_trainer import train_pmgns as jtrain
    cfg = dataclasses.replace(CFG, layout=layout)
    common = dict(epochs=2, batch_size=8, lr=3e-3, seed=0)
    j_params, j_hist = jtrain(_jcfg(cfg), jsynth(24, seed=12), (),
                              JTrain(**common))
    tree = _jax_tree(cfg)
    monkeypatch.setattr(tt, "pmgns_init", lambda seed, c: tree)
    p_params, p_hist = train_pmgns(cfg, synthetic_samples(24, seed=12), (),
                                   TrainConfig(**common), device="cpu")
    assert [h["steps"] for h in p_hist] == [h["steps"] for h in j_hist]
    np.testing.assert_allclose([h["train_loss"] for h in p_hist],
                               [h["train_loss"] for h in j_hist],
                               rtol=LOSS_RTOL)
    _assert_params_close(p_params, j_params)


# ---------------------------------------------------------------------------
# the trainer's own contracts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS)
def test_scan_equals_eager(layout):
    cfg = dataclasses.replace(CFG, layout=layout, dropout=0.1)
    samples = synthetic_samples(24, seed=1)
    common = dict(epochs=2, batch_size=8, lr=3e-3, seed=0, scan_steps=2)
    p_scan, h_scan = train_pmgns(cfg, samples, (),
                                 TrainConfig(mode="scan", **common),
                                 device="cpu")
    p_eager, h_eager = train_pmgns(cfg, samples, (),
                                   TrainConfig(mode="eager", **common),
                                   device="cpu")
    for hs, he in zip(h_scan, h_eager):
        assert hs["steps"] == he["steps"]
        np.testing.assert_allclose(hs["train_loss"], he["train_loss"],
                                   rtol=1e-12)
    _assert_params_close(p_scan, p_eager, atol=0.0, rtol=0.0)


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_padding_rows_are_noops(layout):
    """A step whose batch ends in padding rows (``wt`` 0) has the loss
    and gradients of the same step with those rows cut off."""
    cfg = dataclasses.replace(CFG, layout=layout)
    samples = synthetic_samples(13, seed=2)        # 13 % 8: padded rows
    segs = stack_epoch_segments(samples, 8, layout=layout)
    batch = next({k: v[si] for k, v in s.items()} for s in segs
                 for si in range(s["wt"].shape[0])
                 if 0 < s["wt"][si].sum() < s["wt"].shape[1])
    real = int(batch["wt"].sum())
    cut = {k: v[:real] for k, v in batch.items()}
    mean, std = (torch.as_tensor(a) for a in tt._target_stats(samples))
    out = []
    for b in (batch, cut):
        model = params_from_numpy(pmgns_init(0, cfg), cfg, "cpu",
                                  requires_grad=True)
        wl, wn = tt._loss_terms(model.tree(), cfg,
                                {k: torch.as_tensor(v) for k, v in b.items()},
                                None, 1.0, mean, std)
        loss = wl / wn
        out.append((float(loss.detach()), torch.autograd.grad(
            loss, tt.tree_leaves(model.tree()))))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7)


def test_grad_clip_is_wired_through():
    """A near-zero clip norm freezes training on huge-gradient data; no
    clip moves the parameters at the scale of the learning rate."""
    samples = synthetic_samples(8, seed=3, y_scale=1e8)
    common = dict(epochs=1, batch_size=8, lr=0.1, seed=0)
    p_clip, _ = train_pmgns(CFG, samples, (),
                            TrainConfig(grad_clip=1e-12, **common),
                            device="cpu")
    p_free, _ = train_pmgns(CFG, samples, (),
                            TrainConfig(grad_clip=None, **common),
                            device="cpu")
    t_mean, t_std = tt._target_stats(samples)
    p0 = tt._fold_stats(pmgns_init(0, CFG), CFG, t_mean, t_std)
    d = [max(float(np.max(np.abs(a - b)))
             for a, b in zip(_leaves(p), _leaves(p0)))
         for p in (p_clip, p_free)]
    assert d[0] < 1e-3
    assert d[1] > 10 * max(d[0], 1e-6)
    assert all(np.isfinite(a).all() for a in _leaves(p_free))


def test_checkpoint_resume_is_bit_exact_with_dropout(tmp_path):
    """4 epochs straight == 2 epochs, checkpoint, restore, 2 more — with
    dropout on, since each step's generator comes from (seed, epoch,
    step)."""
    cfg = dataclasses.replace(CFG, dropout=0.2)
    samples = synthetic_samples(20, seed=5)
    val = synthetic_samples(8, seed=6)
    ckpt = str(tmp_path / "ckpt")
    common = dict(batch_size=8, lr=3e-3, seed=0)
    p_straight, h_straight = train_pmgns(
        cfg, samples, val, TrainConfig(epochs=4, **common), device="cpu")
    _, h_first = train_pmgns(
        cfg, samples, val,
        TrainConfig(epochs=2, checkpoint_dir=ckpt, checkpoint_every=1,
                    **common), device="cpu")
    p_resumed, h_second = train_pmgns(
        cfg, samples, val, TrainConfig(epochs=4, **common),
        resume_from=ckpt, device="cpu")
    assert [h["epoch"] for h in h_second] == [2, 3]
    assert [h["train_loss"] for h in h_first + h_second] == \
        [h["train_loss"] for h in h_straight]
    _assert_params_close(p_resumed, p_straight, atol=0.0, rtol=0.0)
    assert h_second[-1]["val_mape"] == h_straight[-1]["val_mape"]


def test_resume_at_completion_and_from_nothing(tmp_path):
    samples = synthetic_samples(10, seed=9)
    val = synthetic_samples(6, seed=10)
    ckpt = str(tmp_path / "ckpt")
    cfg = TrainConfig(epochs=2, batch_size=8, lr=1e-3,
                      checkpoint_dir=ckpt, checkpoint_every=1)
    train_pmgns(CFG, samples, val, cfg, device="cpu")
    params, hist = train_pmgns(CFG, samples, val, cfg, resume_from=ckpt,
                               device="cpu")
    assert hist[-1].get("resumed_complete") is True
    assert np.isfinite(hist[-1]["val_mape"])
    _, hist = train_pmgns(CFG, samples, (), TrainConfig(epochs=1),
                          resume_from=str(tmp_path / "nothing-here"),
                          device="cpu")
    assert [h["epoch"] for h in hist] == [0]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_restore_across_packages(direction, tmp_path,
                                             monkeypatch):
    """One epoch in one package with a checkpoint, the second epoch in
    each package resumed from it: the same restored state, and the two
    second epochs agree to the trainer's bar."""
    from repro.checkpoint import restore_checkpoint as jrestore
    from repro.dataset.builder import synthetic_samples as jsynth
    from repro.train.gnn_trainer import TrainConfig as JTrain
    from repro.train.gnn_trainer import train_pmgns as jtrain
    from repro_torch.checkpoint import restore_checkpoint
    cfg = dataclasses.replace(CFG, layout="sparse")
    tree = _jax_tree(cfg)
    monkeypatch.setattr(tt, "pmgns_init", lambda seed, c: tree)
    ckpt = str(tmp_path / "ckpt")
    common = dict(batch_size=8, lr=3e-3, seed=0)
    first = dict(epochs=1, checkpoint_dir=ckpt, checkpoint_every=1, **common)
    ours, theirs = synthetic_samples(20, seed=5), jsynth(20, seed=5)
    if direction == "jax_to_port":
        jtrain(_jcfg(cfg), theirs, (), JTrain(**first))
    else:
        train_pmgns(cfg, ours, (), TrainConfig(**first), device="cpu")
    like = {"params": tree, "opt_state": {"m": tree, "v": tree},
            "step": 0, "epoch": 0, "t_mean": 0, "t_std": 0}
    for a, b in zip(_leaves(restore_checkpoint(ckpt, None, like)),
                    _leaves(jrestore(ckpt, None, like))):
        np.testing.assert_array_equal(a, b)
    p_j, h_j = jtrain(_jcfg(cfg), theirs, (), JTrain(epochs=2, **common),
                      resume_from=ckpt)
    p_t, h_t = train_pmgns(cfg, ours, (), TrainConfig(epochs=2, **common),
                           resume_from=ckpt, device="cpu")
    assert [h["epoch"] for h in h_t] == [h["epoch"] for h in h_j] == [1]
    np.testing.assert_allclose(h_t[0]["train_loss"], h_j[0]["train_loss"],
                               rtol=LOSS_RTOL)
    _assert_params_close(p_t, p_j)


def test_evaluate_and_predict_batch_across_layouts():
    """Eval on every layout and the engine-backed predictions agree:
    dense and sparse predict on their own layouts and match packed."""
    samples = synthetic_samples(10, seed=17)
    tree = pmgns_init(0, CFG)
    evs = [tt.evaluate(tree, dataclasses.replace(CFG, layout=lay), samples,
                       device="cpu") for lay in LAYOUTS]
    for ev in evs[1:]:
        np.testing.assert_allclose(ev["loss"], evs[0]["loss"], rtol=1e-5)
        np.testing.assert_allclose(ev["mape"], evs[0]["mape"], rtol=1e-4)
        assert ev["n"] == evs[0]["n"] == len(samples)
    packed = dataclasses.replace(CFG, layout="packed")
    preds = tt.predict_batch(tree, packed, samples, device="cpu")
    assert preds.shape == (10, 3) and np.isfinite(preds).all()
    for lay in ("dense", "sparse"):
        got = tt.predict_batch(tree, dataclasses.replace(CFG, layout=lay),
                               samples, device="cpu")
        np.testing.assert_allclose(got, preds, rtol=1e-5, atol=1e-5)


def test_refusals():
    samples = synthetic_samples(4, seed=11)
    with pytest.raises(ValueError, match="mode"):
        train_pmgns(CFG, samples, (), TrainConfig(epochs=1, mode="fused"),
                    device="cpu")
    with pytest.raises(ValueError, match="layout='sparse'"):
        train_pmgns(dataclasses.replace(CFG, layout="packed"), samples, (),
                    TrainConfig(epochs=1, data_parallel=True), device="cpu")
    with pytest.raises(ValueError, match="mode='scan'"):
        train_pmgns(CFG, samples, (),
                    TrainConfig(epochs=1, mode="eager", data_parallel=True),
                    device="cpu")


def test_device_none_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_pmgns(CFG, synthetic_samples(4, seed=11), (),
                    TrainConfig(epochs=1))


def test_trained_parameters_serve_through_the_packed_engine(tmp_path):
    """A model trained on the dense layout saves as an artifact and
    predicts through ``DIPPM.load`` under the packed layout, equal to
    the trainer's own evaluation of the same bin."""
    from repro_torch.core import DIPPM
    from repro_torch.core.batching import collate_packed
    from repro_torch.serve.artifact import save_artifact
    samples = synthetic_samples(16, seed=4)
    params, _ = train_pmgns(CFG, samples, (),
                            TrainConfig(epochs=1, batch_size=8, lr=1e-3),
                            device="cpu")
    packed = dataclasses.replace(CFG, layout="packed")
    path = str(tmp_path / "m.npz")
    save_artifact(path, params, packed)
    got = DIPPM.load(path, device="cpu").engine().predict_samples(samples)
    batch = {k: torch.as_tensor(v)
             for k, v in collate_packed(samples).items()}
    _, _, want = tt._eval_batch(params_from_numpy(params, packed,
                                                  "cpu").tree(),
                                packed, batch)
    np.testing.assert_allclose(got, want[:len(samples)], rtol=1e-5,
                               atol=1e-6)
