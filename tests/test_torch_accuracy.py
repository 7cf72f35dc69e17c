"""The port's accuracy harness (``repro_torch.train.accuracy``) against
the JAX package's ``repro.train.accuracy``.

The records come from the JAX package's ``build_dataset(24, seed=0,
extra_families=("convnext",))``, carried field by field into the port's
``DatasetRecord`` (so nothing is traced twice). Both packages run the
protocol at hidden 32 for up to 4 epochs in chunks of 2 with patience 1,
the port on the CPU's plain versions, from the JAX trainer's initial tree
and at dropout 0 (the port draws its initial weights and dropout masks
from torch, not ``jax.random``; ``tests/test_torch_train.py`` compares
the trainers the same way):

* the splits, ``epochs_trained``, ``best_epoch`` and ``converged`` are
  equal, and the val MAPE of every epoch and every head of ``val`` /
  ``test`` / ``unseen`` and of ``per_family`` within 1e-4 relative
  (float32 training in another summation order: XLA's CPU products
  against torch's, over a few dozen Adam steps);
* ``evaluate_per_family`` on the JAX package's trained tree gives the
  reference's numbers;
* a split too small to train raises; a factory (v2) dataset path gives
  the report of its records; validation that never gives a finite MAPE
  keeps the final parameters with ``best_val_mape`` NaN.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.gnn import PMGNSConfig  # noqa: E402
from repro_torch.dataset import builder as tb  # noqa: E402
from repro_torch.train import accuracy as ta  # noqa: E402
from repro_torch.train import gnn_trainer  # noqa: E402

RTOL = 1e-4
N_GRAPHS, SEED = 24, 0
PROTO = dict(hidden=32, lr=1e-3, lr_boost=1.0, max_epochs=4, chunk_epochs=2,
             patience=1)
METRICS = ("loss", "mape", "mape_latency", "mape_energy", "mape_memory")


def _to_port(r) -> tb.DatasetRecord:
    return tb.DatasetRecord(x=np.asarray(r.x), edges=np.asarray(r.edges),
                            static=np.asarray(r.static), y=np.asarray(r.y),
                            family=r.family, n_nodes=int(r.n_nodes),
                            meta=dict(r.meta))


class _Proto(ta.AccuracyProtocol):
    """The protocol at dropout 0."""

    def model_config(self):
        return dataclasses.replace(super().model_config(), dropout=0.0)


def _jax_init(cfg: PMGNSConfig, seed: int):
    """The JAX trainer's initial tree of ``cfg`` for ``seed``, as numpy."""
    import jax
    from repro.core.gnn import PMGNSConfig as JCfg
    from repro.core.gnn import pmgns_init as jinit
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    return jax.tree_util.tree_map(
        np.asarray, jinit(key, JCfg(**dataclasses.asdict(cfg))))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: hidden 32 on a few dozen graphs, and test workers
    that share the host's cores otherwise oversubscribe it many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    jax = pytest.importorskip("jax")
    from repro.dataset import builder as jb
    from repro.train import accuracy as ja

    class JProto(ja.AccuracyProtocol):
        def model_config(self):
            return dataclasses.replace(super().model_config(), dropout=0.0)

    ref_records = list(jb.build_dataset(N_GRAPHS, seed=SEED,
                                        extra_families=("convnext",)))
    ref = ja.run_accuracy(ref_records, JProto(**PROTO))
    ref["params"] = jax.tree_util.tree_map(np.asarray, ref["params"])
    records = [_to_port(r) for r in ref_records]
    proto = _Proto(**PROTO)
    init = _jax_init(proto.model_config(), proto.seed)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gnn_trainer, "pmgns_init", lambda seed, cfg: init)
        port = ta.run_accuracy(records, proto, device="cpu")
    return dict(ja=ja, ref_records=ref_records, ref=ref, records=records,
                port=port)


def _close(got, want, what):
    assert math.isclose(got, want, rel_tol=RTOL, abs_tol=1e-7), \
        f"{what}: {got} vs {want}"


def _same_metrics(got: dict, want: dict, what: str) -> None:
    assert got["n"] == want["n"], what
    for k in METRICS:
        _close(got[k], want[k], f"{what} {k}")


def test_protocol_matches_reference():
    from repro.train.accuracy import AccuracyProtocol
    port, ref = ta.AccuracyProtocol(), AccuracyProtocol()
    assert port.to_json() == ref.to_json()
    cfg, ref_cfg = port.model_config(), ref.model_config()
    assert (cfg.variant, cfg.hidden) == (ref_cfg.variant, ref_cfg.hidden)
    assert isinstance(cfg, PMGNSConfig)


def test_run_accuracy_matches_reference(runs):
    ref, port = runs["ref"], runs["port"]
    assert port["protocol"] == dict(ref["protocol"])
    assert port["splits"] == ref["splits"]
    for k in ("epochs_trained", "best_epoch", "converged"):
        assert port[k] == ref[k], k
    _close(port["best_val_mape"], ref["best_val_mape"], "best_val_mape")
    assert len(port["history_val_mape"]) == len(ref["history_val_mape"]) \
        == ref["epochs_trained"]
    for i, (g, w) in enumerate(zip(port["history_val_mape"],
                                   ref["history_val_mape"])):
        _close(g, w, f"val MAPE of epoch {i}")
    for split in ("val", "test", "unseen"):
        assert (split in port) == (split in ref)
        if split in ref:
            _same_metrics(port[split], ref[split], split)
    assert port["per_family"].keys() == ref["per_family"].keys()
    for split, fams in ref["per_family"].items():
        assert port["per_family"][split].keys() == fams.keys()
        for fam, m in fams.items():
            _same_metrics(port["per_family"][split][fam], m,
                          f"{split}/{fam}")
    assert "unseen" in port["per_family"] and \
        set(port["per_family"]["unseen"]) == {"convnext"}
    ref_leaves = _leaves(ref["params"])
    port_leaves = _leaves(port["params"])
    assert [p.shape for p in port_leaves] == [p.shape for p in ref_leaves]
    assert all(isinstance(p, np.ndarray) for p in port_leaves)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def test_evaluate_per_family_matches_reference(runs):
    ja, ref = runs["ja"], runs["ref"]
    from repro.core.gnn import PMGNSConfig as JCfg
    from repro.dataset.builder import records_to_samples as jsamples
    proto = ta.AccuracyProtocol(**PROTO)
    records = runs["records"]
    want = ja.evaluate_per_family(ref["params"], JCfg(hidden=32),
                                  jsamples(runs["ref_records"]))
    got = ta.evaluate_per_family(ref["params"], proto.model_config(),
                                 tb.records_to_samples(records),
                                 device="cpu")
    assert got.keys() == want.keys() and len(got) == 11
    for fam, m in want.items():
        _same_metrics(got[fam], m, fam)


def test_split_too_small_raises(runs):
    """One record fills one split at most, so train or val is empty."""
    with pytest.raises(ValueError, match="split too small to train"):
        ta.run_accuracy(runs["records"][:1], ta.AccuracyProtocol(**PROTO),
                        device="cpu")
    with pytest.raises(ValueError, match="split too small to train"):
        runs["ja"].run_accuracy(runs["ref_records"][:1],
                                runs["ja"].AccuracyProtocol(**PROTO))


def test_dataset_path_v2_gives_its_records_report(tmp_path):
    """A factory (v2) dataset written by the JAX package: the port's
    report from its path equals the report from its records, read by the
    port, bit for bit."""
    from repro.dataset import factory as jf
    path = str(tmp_path / "ds")
    jf.build(path, jf.FactoryConfig(n_graphs=16, seed=SEED, shard_size=8,
                                    extra_families=("convnext",)))
    proto = ta.AccuracyProtocol(**dict(PROTO, max_epochs=2, chunk_epochs=1))
    from_path = ta.run_accuracy(path, proto, device="cpu")
    records = tb.load_dataset(path)
    assert len(records) == sum(from_path["splits"].values())
    from_records = ta.run_accuracy(records, proto, device="cpu")
    params = (from_path.pop("params"), from_records.pop("params"))
    assert from_path == from_records
    assert all(np.array_equal(a, b) for a, b in
               zip(_leaves(params[0]), _leaves(params[1])))


def test_never_finite_validation_keeps_final_params(runs, tmp_path):
    """No validation samples: every chunk's val MAPE is NaN, so nothing
    counts as best; the final parameters come back with best_val_mape NaN,
    and the stall stops training after ``patience`` chunks."""
    samples = tb.records_to_samples(runs["records"][:12])
    proto = ta.AccuracyProtocol(**dict(PROTO, patience=2))
    ckpt = tmp_path / "ckpt"
    params, history, info = ta.train_to_convergence(
        proto.model_config(), samples, (), proto, checkpoint_dir=str(ckpt),
        device="cpu")
    assert math.isnan(info["best_val_mape"])
    assert info == dict(info, epochs_trained=4, best_epoch=3, converged=True)
    assert [h["epoch"] for h in history] == [0, 1, 2, 3]
    assert any(ckpt.iterdir())          # the chunks resumed from it
    assert all(np.isfinite(p).all() for p in _leaves(params))


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_accuracy_plan_is_the_gate_plan():
    """``chip_smoke.py``'s accuracy phase builds the JAX gate's CI plan
    (``benchmarks/accuracy_mape.py``): the same config, the same hash in
    both packages, and the gate's bounds and verdicts per head."""
    import json
    from benchmarks import accuracy_mape
    from repro.dataset import factory as jf
    from repro_torch.dataset import factory as tf
    cs = _chip_smoke()
    want = accuracy_mape._factory_config(accuracy_mape.CI_N_GRAPHS)
    assert cs.accuracy_config(jf) == want
    assert jf.plan_hash(want) == tf.plan_hash(cs.accuracy_config(tf)) \
        == cs.ACCURACY_PLAN_HASH
    assert tf.make_plan(cs.accuracy_config(tf)).to_json() == \
        jf.make_plan(want).to_json()
    assert cs.ACCURACY_MIN_COVERAGE == accuracy_mape.MIN_COVERAGE
    baseline = json.loads((cs.ROOT / cs.ACCURACY_BASELINE).read_text())
    tol = baseline["tolerance"]
    for split in ("test", "unseen"):
        for scale in (1.0, 1.9, 2.5):
            got = {h: v * scale for h, v in baseline[split].items()}
            gates = cs.gate_mape(got, baseline[split], tol)
            ref = accuracy_mape._gate_mape(got, baseline[split], tol)
            assert set(gates) == set(ref) == set(cs.ACCURACY_HEADS)
            for head, c in gates.items():
                assert c["ok"] == ref[head]["ok"], (split, scale, head)
                assert round(c["bound"], 4) == ref[head]["bound"]


def test_chip_smoke_accuracy_gate_reads_the_median_over_seeds():
    """Each head's median over the seeds' reports, held to the bound
    around a base: one seed's miss does not decide, a miss in most of them
    does."""
    cs = _chip_smoke()
    assert len(set(cs.ACCURACY_SEEDS)) == len(cs.ACCURACY_SEEDS) >= 5
    assert cs.ACCURACY_SEEDS[0] == ta.AccuracyProtocol().seed
    tol = {"rel": 1.75, "abs": 0.25}
    base = dict.fromkeys(cs.ACCURACY_HEADS, 0.3)          # bound 0.55
    lat = [0.9, 0.5, 0.4, 0.52, 0.6]
    reports = [{"unseen": dict(base, mape_latency=v)} for v in lat]
    med = cs.median_heads(reports, "unseen")
    assert med == dict(base, mape_latency=0.52)
    assert all(c["ok"] for c in cs.gate_mape(med, base, tol).values())
    reports[1]["unseen"]["mape_latency"] = 0.7            # 3 of 5 miss
    med = cs.median_heads(reports, "unseen")
    gates = cs.gate_mape(med, base, tol)
    assert not gates["mape_latency"]["ok"] and \
        math.isclose(gates["mape_latency"]["bound"], 0.55)
    assert all(gates[h]["ok"] for h in cs.ACCURACY_HEADS
               if h != "mape_latency")


def test_chip_smoke_accuracy_reference_is_the_jax_package_run(tmp_path):
    """The gate's base, ``chip_smoke.ACCURACY_REFERENCE``, is the JAX
    package's default protocol at every seed of ``ACCURACY_SEEDS`` on the
    gate's plan (all 341 records), its medians its reports' medians, and
    ``accuracy_reference`` refuses a file that is not."""
    import json
    ja = pytest.importorskip("repro.train.accuracy")
    cs = _chip_smoke()
    proto = ja.AccuracyProtocol().to_json()
    assert json.loads(json.dumps(proto)) == json.loads(json.dumps(
        ta.AccuracyProtocol().to_json()))
    ref = cs.accuracy_reference(proto)
    assert ref["platform"] == "cpu" and ref["n_built"] == 341
    assert [r["seed"] for r in ref["reports"]] == list(cs.ACCURACY_SEEDS)
    for r in ref["reports"]:
        assert sum(r["splits"].values()) == ref["n_built"]
        assert r["splits"]["unseen"] == r["unseen"]["n"] > 0
        for split in ("test", "unseen"):
            assert set(cs.ACCURACY_HEADS) <= set(r[split])
    for key, bad in (("seeds", [0, 1, 2]),
                     ("protocol", dict(proto, lr_boost=1.0)),
                     ("median", {"test": ref["median"]["test"],
                                 "unseen": dict(ref["median"]["unseen"],
                                                mape_latency=0.01)})):
        path = tmp_path / f"{key}.json"
        path.write_text(json.dumps(dict(ref, **{key: bad})))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(cs, "ACCURACY_REFERENCE", str(path))
            with pytest.raises(AssertionError, match="accuracy"):
                cs.accuracy_reference(proto)


#: the protocol's 100x rate: one epoch on the first records of the train
#: split, three steps on 8 and five on 12
BOOST_AGREE, BOOST_PARTED = 8, 12


@pytest.fixture(scope="module")
def boosted(runs):
    """One epoch of ``train_to_convergence`` at the protocol's own rate
    (lr 2.754e-5 x lr_boost 100, grad clip 1.0, GraphSAGE-512, batch 32)
    from the JAX initial tree at dropout 0: the JAX package on the first
    ``BOOST_AGREE`` and ``BOOST_PARTED`` train records, the port on the
    first ``BOOST_AGREE``."""
    import jax
    from repro.dataset.builder import records_to_samples as jsamples
    from repro.dataset.builder import split_dataset as jsplit
    ja = runs["ja"]

    class JProto(ja.AccuracyProtocol):
        def model_config(self):
            return dataclasses.replace(super().model_config(), dropout=0.0)

    kw = dict(max_epochs=1, chunk_epochs=1)
    jproto, proto = JProto(**kw), _Proto(**kw)
    jsp = jsplit(runs["ref_records"], seed=SEED)
    tsp = tb.split_dataset(runs["records"], seed=SEED)
    out = {"proto": proto, "jproto": jproto}
    for n in (BOOST_AGREE, BOOST_PARTED):
        samples = jsamples(jsp["train"][:n])
        jp, jh, _ = ja.train_to_convergence(
            jproto.model_config(), samples, jsamples(jsp["val"]), jproto)
        out[n] = dict(samples=samples, hist=jh,
                      params=jax.tree_util.tree_map(np.asarray, jp),
                      port_samples=tb.records_to_samples(tsp["train"][:n]))
    init = _jax_init(proto.model_config(), proto.seed)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gnn_trainer, "pmgns_init", lambda seed, cfg: init)
        tp, th, _ = ta.train_to_convergence(
            proto.model_config(),
            tb.records_to_samples(tsp["train"][:BOOST_AGREE]),
            tb.records_to_samples(tsp["val"]), proto, device="cpu")
    out["port"] = dict(params=tp, hist=th)
    return out


def test_boosted_rate_first_steps_match_reference(boosted):
    """At the protocol's rate, the first three steps: the train loss within
    1e-4 relative and every parameter within 1e-4 + 1e-3 relative, the
    trainer's bar (a hundred times the rate makes it a hundred times
    harder to meet: a parameter moves up to 2.8e-3 a step)."""
    proto = boosted["proto"]
    assert proto.lr * proto.lr_boost == pytest.approx(2.754e-3)
    assert (proto.hidden, proto.grad_clip, proto.batch_size) == \
        (512, 1.0, 32)
    ref, port = boosted[BOOST_AGREE], boosted["port"]
    assert [h["steps"] for h in port["hist"]] == \
        [h["steps"] for h in ref["hist"]] == [3]
    _close(port["hist"][0]["train_loss"], ref["hist"][0]["train_loss"],
           "train loss")
    got, want = _leaves(port["params"]), _leaves(ref["params"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-3)


def test_boosted_rate_gradients_match_where_trajectories_part(boosted):
    """Five steps at the protocol's rate, two more than the test above
    holds the parameters over: at the point the reference reaches, the
    port's loss and gradient on every batch of the epoch are the
    reference's within 1e-5 of each leaf's largest. Where the two
    trajectories part further on, it is the steps amplifying float32
    rounding, not another gradient."""
    import jax
    import jax.numpy as jnp
    from repro.train.gnn_trainer import _loss_terms as jloss
    from repro.train.gnn_trainer import _target_stats as jstats
    from repro_torch.core.batching import stack_epoch_segments
    from repro_torch.core.gnn import params_from_numpy
    ref = boosted[BOOST_PARTED]
    assert [h["steps"] for h in ref["hist"]] == [5]
    cfg, jcfg = boosted["proto"].model_config(), \
        boosted["jproto"].model_config()
    mean, std = (np.asarray(a) for a in jstats(ref["samples"]))
    tree = jax.tree_util.tree_map(np.array, ref["params"])
    head = tree["fc"][f"b{cfg.n_fc_blocks - 1}"]     # unfold the stats
    head["w"], head["b"] = head["w"] / std, (head["b"] - mean) / std
    segs = stack_epoch_segments(ref["port_samples"], 32,
                                rng=np.random.default_rng(0), layout="dense")
    model = params_from_numpy(tree, cfg, "cpu", requires_grad=True)
    leaves = gnn_trainer.tree_leaves(model.tree())

    def jfn(p, batch):
        wl, wn = jloss(p, jcfg, batch, None, 1.0, jnp.asarray(mean),
                       jnp.asarray(std))
        return wl / jnp.maximum(wn, 1.0)
    jgrad = jax.jit(jax.value_and_grad(jfn))
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    n_batches = 0
    for seg in segs:
        for i in range(seg["wt"].shape[0]):
            batch = {k: v[i] for k, v in seg.items()}
            jl, jg = jgrad(jtree, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
            wl, wn = gnn_trainer._loss_terms(
                model.tree(), cfg, {k: torch.as_tensor(v)
                                    for k, v in batch.items()},
                None, 1.0, torch.from_numpy(mean.copy()),
                torch.from_numpy(std.copy()))
            loss = wl / torch.clamp_min(wn, 1.0)
            _close(float(loss.detach()), float(jl), "loss")
            for g, w in zip(torch.autograd.grad(loss, leaves),
                            _leaves(jax.tree_util.tree_map(np.asarray, jg))):
                scale = max(float(np.abs(w).max()), 1e-30)
                assert float(np.abs(g.numpy() - w).max()) <= 1e-5 * scale
            n_batches += 1
    assert n_batches == 5
