"""Data-parallel PMGNS training in the PyTorch port, on the CPU.

Four ``gloo`` ranks, spawned processes of one group, run
``train_pmgns(..., TrainConfig(data_parallel=True), device="cpu")``
against:

* the JAX trainer's ``data_parallel=True`` on 4 host devices (a
  subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``),
  dense and sparse from the same initial tree, at dropout 0: losses
  within 1e-4 relative, parameters within 1e-4 + 1e-3 relative (the bars
  of ``tests/test_torch_train.py``);
* the port on one device: losses within 1e-5, parameters 1e-5 + 1e-4;
* a remainder step whose last ranks hold only padding rows (a loss
  divided by the local weight or averaged over the ranks differs there),
  a gradient clip, dropout (per-rank masks, repeatable), and rank 0's
  checkpoints with a bit-exact resume.

A world of one (a ``gloo`` group of one, or no group) is the single
device run bit for bit. Every rank returns the same parameters.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import time
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

from repro_torch.core.batching import stack_epoch_segments  # noqa: E402
from repro_torch.core.gnn import PMGNSConfig, pmgns_init  # noqa: E402
from repro_torch.dataset.builder import synthetic_samples  # noqa: E402
from repro_torch.train import gnn_trainer as tt  # noqa: E402
from repro_torch.train.gnn_trainer import TrainConfig, train_pmgns  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
CFG = PMGNSConfig(hidden=32, dropout=0.0)
WORLD = 4
LAYOUTS = ("dense", "sparse")
COMMON = dict(batch_size=8, lr=3e-3, seed=0)
#: against JAX: the trainer's bars (tests/test_torch_train.py)
LOSS_RTOL = 1e-4
PARAM_ATOL, PARAM_RTOL = 1e-4, 1e-3
#: against the port on one device: the same float32 sums, cut at other
#: rows and added over the ranks in another order
ONE_LOSS_RTOL = 1e-5
ONE_PARAM_ATOL, ONE_PARAM_RTOL = 1e-5, 1e-4
#: the clip that binds on these data (the unclipped global norm is larger)
CLIP = 0.05
#: seconds: a collective waits this long for a missing rank; the spawned
#: ranks and the JAX subprocess get the rest of a few minutes
PG_TIMEOUT, JOIN_TIMEOUT = 60, 180
JOB_SAMPLES = {"jax": (24, 12), "remainder": (26, 3), "clip": (24, 4),
               "dropout": (20, 5)}

#: the JAX trainer on 4 host devices, from the initial tree in argv[2]
#: (the test's own pickle); its (params, history) pickled to argv[3]
_JAX_SCRIPT = r"""
import pickle, sys
import jax
import jax.numpy as jnp
import numpy as np
from repro.core.gnn import PMGNSConfig
from repro.dataset.builder import synthetic_samples
from repro.train import gnn_trainer
assert len(jax.devices()) == 4, jax.devices()
with open(sys.argv[2], "rb") as f:
    tree = pickle.load(f)
gnn_trainer.pmgns_init = lambda key, cfg: jax.tree_util.tree_map(
    jnp.asarray, tree)
p, h = gnn_trainer.train_pmgns(
    PMGNSConfig(hidden=32, dropout=0.0, layout=sys.argv[1]),
    synthetic_samples(24, seed=12), (),
    gnn_trainer.TrainConfig(epochs=2, batch_size=8, lr=3e-3, seed=0,
                            data_parallel=True))
with open(sys.argv[3], "wb") as f:
    pickle.dump((jax.tree_util.tree_map(np.asarray, p), h), f)
"""


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree)]


def _assert_params_close(got, want, atol, rtol):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol)


def _assert_bits_equal(got, want):
    for a, b in zip(_leaves(got), _leaves(want)):
        np.testing.assert_array_equal(a, b)


def _losses(hist):
    return [h["train_loss"] for h in hist]


# ---------------------------------------------------------------------------
# the jobs every rank runs, and the spawned ranks
# ---------------------------------------------------------------------------

def _run_job(job: dict, rank: int, out_dir: str):
    """One ``train_pmgns`` of a job on this rank → (params, history)."""
    cfg = dataclasses.replace(CFG, **job.get("cfg", {}))
    kw = dict(COMMON, **job["train"])
    if "checkpoint" in job:
        name = job["checkpoint"]
        # every rank but 0 gets a directory of its own: it must stay absent
        kw["checkpoint_dir"] = os.path.join(
            out_dir, name if rank == 0 else f"{name}_rank{rank}")
        kw["checkpoint_every"] = 1
    resume = (os.path.join(out_dir, job["resume"]) if "resume" in job
              else None)
    n, seed = JOB_SAMPLES[job["samples"]]
    return train_pmgns(cfg, synthetic_samples(n, seed=seed), (),
                       TrainConfig(data_parallel=True, **kw),
                       resume_from=resume, device="cpu")


def _rank_main(rank: int, world: int, store: str, out_dir: str,
               jobs: dict) -> None:
    """A spawned rank: join the group, run every job in order, write the
    results (or the first failure's traceback) to ``rank<r>.pkl``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=PG_TIMEOUT))
    results, failed = {}, False
    try:
        for name, job in jobs.items():
            try:
                results[name] = _run_job(job, rank, out_dir)
            except Exception:  # recorded for the test that reads it
                results[name] = traceback.format_exc()
                failed = True
                break
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
        if not failed:
            dist.destroy_process_group()
    if failed:
        os._exit(1)          # the other ranks' collectives time out


def _spawn(world: int, jobs: dict, out_dir: Path) -> list:
    """Run ``jobs`` on ``world`` spawned ranks; each rank's results."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, str(out_dir / "store"),
                               str(out_dir), jobs))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_TIMEOUT
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
    assert not hung, f"{len(hung)} ranks still running after {JOIN_TIMEOUT} s"
    out = []
    for r in range(world):
        path = out_dir / f"rank{r}.pkl"
        assert path.exists(), f"rank {r} wrote no results"
        with open(path, "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every four-rank job in one spawn, beside the JAX trainer on four
    host devices in a subprocess a layout."""
    out = tmp_path_factory.mktemp("dp")
    # one thread a device: the suite's other workers share the cores
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1",
               PYTHONPATH=os.pathsep.join(
                   [str(SRC), os.environ.get("PYTHONPATH", "")]))
    jax_procs = {}
    for lay in LAYOUTS:
        # the port's initial tree, the one every rank starts from
        with open(out / f"tree_{lay}.pkl", "wb") as f:
            pickle.dump(pmgns_init(0, dataclasses.replace(CFG, layout=lay)),
                        f)
        with open(out / f"jax_{lay}.log", "w") as log:
            jax_procs[lay] = subprocess.Popen(
                [sys.executable, "-c", _JAX_SCRIPT, lay,
                 str(out / f"tree_{lay}.pkl"), str(out / f"jax_{lay}.pkl")],
                env=env, stdout=log, stderr=subprocess.STDOUT)
    dropout = dict(cfg={"dropout": 0.2}, samples="dropout")
    jobs = {
        "dense": dict(cfg={"layout": "dense"}, train={"epochs": 2},
                      samples="jax"),
        "sparse": dict(cfg={"layout": "sparse"}, train={"epochs": 2},
                       samples="jax"),
        "remainder": dict(train={"epochs": 1}, samples="remainder"),
        "clip": dict(train={"epochs": 1, "grad_clip": CLIP},
                     samples="clip"),
        "straight_a": dict(train={"epochs": 2}, **dropout),
        "straight_b": dict(train={"epochs": 2}, **dropout),
        "first": dict(train={"epochs": 1}, checkpoint="ckpt", **dropout),
        "resumed": dict(train={"epochs": 2}, resume="ckpt", **dropout),
    }
    deadline = time.monotonic() + JOIN_TIMEOUT
    try:
        ranks = _spawn(WORLD, jobs, out)
        for proc in jax_procs.values():
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for proc in jax_procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    jax_res = {}
    for lay, proc in jax_procs.items():
        if proc.returncode == 0:
            with open(out / f"jax_{lay}.pkl", "rb") as f:
                jax_res[lay] = pickle.load(f)
        else:
            jax_res[lay] = (out / f"jax_{lay}.log").read_text()
    return {"ranks": ranks, "jax": jax_res, "out": out}


def _job(runs, name):
    """A job's rank-0 result, after checking every rank finished it with
    the same parameters and history."""
    per_rank = [r.get(name) for r in runs["ranks"]]
    for r, res in enumerate(per_rank):
        assert isinstance(res, tuple), f"rank {r}, job {name}: {res}"
    params, hist = per_rank[0]
    for other, other_hist in per_rank[1:]:
        _assert_bits_equal(other, params)
        assert _losses(other_hist) == _losses(hist)
    return params, hist


def _one_device(name, layout="dense", **train):
    """The same run as job ``name`` on one device, without a group."""
    n, seed = JOB_SAMPLES[name]
    return train_pmgns(dataclasses.replace(CFG, layout=layout),
                       synthetic_samples(n, seed=seed), (),
                       TrainConfig(**dict(COMMON, **train)), device="cpu")


# ---------------------------------------------------------------------------
# four ranks against JAX on four devices, and against one device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS)
def test_four_ranks_match_the_jax_trainer_on_four_devices(runs, layout):
    assert isinstance(runs["jax"][layout], tuple), runs["jax"][layout]
    j_params, j_hist = runs["jax"][layout]
    params, hist = _job(runs, layout)
    assert [h["steps"] for h in hist] == [h["steps"] for h in j_hist]
    np.testing.assert_allclose(_losses(hist), _losses(j_hist),
                               rtol=LOSS_RTOL)
    _assert_params_close(params, j_params, PARAM_ATOL, PARAM_RTOL)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_four_ranks_match_the_port_on_one_device(runs, layout):
    params, hist = _job(runs, layout)
    o_params, o_hist = _one_device("jax", layout, epochs=2)
    assert [h["steps"] for h in hist] == [h["steps"] for h in o_hist]
    np.testing.assert_allclose(_losses(hist), _losses(o_hist),
                               rtol=ONE_LOSS_RTOL)
    _assert_params_close(params, o_params, ONE_PARAM_ATOL, ONE_PARAM_RTOL)


def test_remainder_step_divides_by_the_whole_step(runs):
    """26 graphs at batch 8 over 4 ranks: the last step of the epoch has 2
    real rows, all on rank 0, so ranks 1–3 hold only padding. Averaging
    the ranks' losses would quarter that step's gradient."""
    n, seed = JOB_SAMPLES["remainder"]
    samples = synthetic_samples(n, seed=seed)
    per = 8 // WORLD
    padded_ranks = set()
    for seg in stack_epoch_segments(samples, 8, rng=tt._epoch_rng(0, 0),
                                    batch_multiple=WORLD):
        for wt in seg["wt"]:
            shards = wt.reshape(WORLD, per).sum(axis=1)
            if shards[0] > 0 and shards[-1] == 0:
                padded_ranks.add(int((shards == 0).sum()))
    assert padded_ranks and max(padded_ranks) == WORLD - 1
    params, hist = _job(runs, "remainder")
    o_params, o_hist = _one_device("remainder", epochs=1)
    np.testing.assert_allclose(_losses(hist), _losses(o_hist),
                               rtol=ONE_LOSS_RTOL)
    _assert_params_close(params, o_params, ONE_PARAM_ATOL, ONE_PARAM_RTOL)


def test_grad_clip_acts_on_the_summed_gradient(runs):
    params, hist = _job(runs, "clip")
    o_params, o_hist = _one_device("clip", epochs=1, grad_clip=CLIP)
    free, _ = _one_device("clip", epochs=1)
    assert max(float(np.max(np.abs(a - b))) for a, b in
               zip(_leaves(free), _leaves(o_params))) > 1e-3, \
        "the clip does not bind on these data"
    np.testing.assert_allclose(_losses(hist), _losses(o_hist),
                               rtol=ONE_LOSS_RTOL)
    _assert_params_close(params, o_params, ONE_PARAM_ATOL, ONE_PARAM_RTOL)


def test_dropout_masks_differ_by_rank_and_repeat(runs):
    """Each rank's dropout generator differs (rank 0's is the single
    device one), and a four-rank dropout run repeats bit for bit."""
    draws = [torch.rand(64, generator=tt._step_generator(0, 1, 2, "cpu", r))
             for r in range(WORLD)]
    alone = torch.rand(64, generator=tt._step_generator(0, 1, 2, "cpu"))
    assert torch.equal(draws[0], alone)
    assert all(not torch.equal(draws[a], draws[b])
               for a in range(WORLD) for b in range(a))
    a_params, a_hist = _job(runs, "straight_a")
    b_params, b_hist = _job(runs, "straight_b")
    _assert_bits_equal(a_params, b_params)
    assert _losses(a_hist) == _losses(b_hist)


def test_rank_zero_checkpoints_and_a_resume_is_bit_exact(runs):
    out = runs["out"]
    assert any((out / "ckpt").iterdir())
    for r in range(1, WORLD):
        assert not (out / f"ckpt_rank{r}").exists()
    _, first = _job(runs, "first")
    resumed_params, resumed = _job(runs, "resumed")
    straight_params, straight = _job(runs, "straight_a")
    assert [h["epoch"] for h in resumed] == [1]
    assert _losses(first + resumed) == _losses(straight)
    _assert_bits_equal(resumed_params, straight_params)


# ---------------------------------------------------------------------------
# a world of one, and the refusals' order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("group", ["none", "gloo-of-one"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_a_world_of_one_is_the_single_device_run(group, layout, tmp_path):
    """With dropout on: rank 0 draws the single-device run's masks."""
    cfg = dataclasses.replace(CFG, layout=layout, dropout=0.1)
    samples = synthetic_samples(20, seed=7)
    common = dict(COMMON, epochs=2)
    want_params, want = train_pmgns(cfg, samples, (), TrainConfig(**common),
                                    device="cpu")
    if group == "gloo-of-one":
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
            world_size=1, timeout=timedelta(seconds=PG_TIMEOUT))
    try:
        params, hist = train_pmgns(cfg, samples, (), TrainConfig(
            data_parallel=True, **common), device="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert _losses(hist) == _losses(want)
    _assert_bits_equal(params, want_params)


def test_the_packed_refusal_comes_before_initialisation(monkeypatch):
    def no_init(seed, cfg):
        raise AssertionError("initialised before the refusal")
    monkeypatch.setattr(tt, "pmgns_init", no_init)
    with pytest.raises(ValueError, match="layout='sparse'"):
        train_pmgns(dataclasses.replace(CFG, layout="packed"),
                    synthetic_samples(4, seed=11), (),
                    TrainConfig(epochs=1, data_parallel=True), device="cpu")
