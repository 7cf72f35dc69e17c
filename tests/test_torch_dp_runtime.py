"""The data-parallel runtime of the PyTorch port against the JAX package,
on the CPU: device meshes (``repro_torch.launch.mesh``), the int8
all-reduce with error feedback (``repro_torch.runtime.compression``) and
the host-sharded token pipeline (``repro_torch.data.pipeline``).

Meshes and the all-reduce run over ``gloo``: a group of one in this
process, and four spawned ranks. The quantizer is held bit for bit to
``repro.runtime.compression`` (zero rows at the 1e-12 scale floor, exact
half ties rounding to even); at four ranks the mean is held to the exact
mean of the JAX-dequantized values within 1e-6 of its terms' magnitude
(gloo adds in its own order), and each rank's new error bit for bit.
"""
import os
import pickle
import time
import traceback
from datetime import timedelta

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

from repro_torch.data import pipeline as tp  # noqa: E402
from repro_torch.launch import mesh as tm  # noqa: E402
from repro_torch.runtime import compression as tc  # noqa: E402

WORLD = 4
PG_TIMEOUT, JOIN_TIMEOUT = 60, 120
#: the mean of four ranks' dequantized values, float32 sums in gloo's
#: order, against the exact mean: relative to the mean of the terms'
#: magnitudes, the scale of a sum's rounding error (an element whose terms
#: cancel has a larger error relative to itself)
MEAN_RTOL = 1e-6
SHAPES = {"w": (4, 8), "b": {"x": (16,)}, "h": (3, 5, 6)}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _tree(shapes, fn):
    if isinstance(shapes, dict):
        return {k: _tree(v, fn) for k, v in shapes.items()}
    return fn(shapes)


def _grads(seed):
    """A seeded gradient tree and error tree (numpy float32); one row of
    zeros and one of exact half ties in ``w``."""
    rng = np.random.default_rng(seed)
    g = _tree(SHAPES, lambda s: (rng.standard_normal(s) * 3).astype(
        np.float32))
    g["w"][1] = 0.0
    g["w"][2] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -127.0]
    e = _tree(SHAPES, lambda s: (rng.standard_normal(s) * 1e-2).astype(
        np.float32))
    e["w"][1:3] = 0.0
    return g, e


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _group_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 's'}",
                            rank=0, world_size=1,
                            timeout=timedelta(seconds=PG_TIMEOUT))


# ---------------------------------------------------------------------------
# int8 helpers, bit for bit
# ---------------------------------------------------------------------------

def _quant_cases():
    rng = np.random.default_rng(3)
    ties = np.array([[254.0, 1.0, 3.0, 5.0, -1.0, -3.0, -5.0, 7.0],
                     [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]],
                    np.float32)
    return {
        "normal": (rng.standard_normal((16, 33)) * 10).astype(np.float32),
        "zero-rows": np.concatenate([np.zeros((2, 8), np.float32),
                                     rng.standard_normal((2, 8)).astype(
                                         np.float32) * 1e-30]),
        "half-ties": ties,
        "1-d": rng.standard_normal(40).astype(np.float32),
        "3-d": rng.standard_normal((2, 3, 17)).astype(np.float32) * 1e5,
    }


@pytest.mark.parametrize("case", list(_quant_cases()))
def test_int8_helpers_are_bit_equal_to_jax(case):
    import jax.numpy as jnp
    from repro.runtime import compression as jc
    x = _quant_cases()[case]
    err = np.random.default_rng(4).standard_normal(x.shape).astype(
        np.float32) * 1e-3
    q, scale = tc.int8_compress(torch.as_tensor(x))
    jq, jscale = jc.int8_compress(jnp.asarray(x))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(
        tc.int8_decompress(q, scale).numpy(),
        np.asarray(jc.int8_decompress(jq, jscale)))
    got = tc.compress_with_error_feedback(torch.as_tensor(x),
                                          torch.as_tensor(err))
    want = jc.compress_with_error_feedback(jnp.asarray(x), jnp.asarray(err))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if case == "half-ties":       # round half to even
        np.testing.assert_array_equal(q.numpy()[:, 1:7],
                                      [[0, 2, 2, 0, -2, -2],
                                       [0, 2, 2, 0, -2, -2]])


def test_error_feedback_recovers_signal():
    """Compressing one small gradient again and again with error feedback
    sums to the gradient (the reference's own check)."""
    g = torch.linspace(-1e-3, 1e-3, 64).reshape(1, 64)
    err, acc = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(50):
        q, scale, err = tc.compress_with_error_feedback(g, err)
        acc += tc.int8_decompress(q, scale)
    np.testing.assert_allclose((acc / 50).numpy(), g.numpy(),
                               atol=float(g.abs().max()) * 0.02)


# ---------------------------------------------------------------------------
# one rank: the mesh and the all-reduce
# ---------------------------------------------------------------------------

def test_mesh_needs_a_group_and_production_mesh_waits():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        tm.make_mesh((1,), ("data",), "cpu")
    with pytest.raises(NotImplementedError, match="A14d"):
        tm.make_production_mesh()
    with pytest.raises(NotImplementedError, match="A14d"):
        tm.make_production_mesh(multi_pod=True)


def test_meshes_of_one_rank_name_their_axes_as_jax(tmp_path):
    import jax
    from repro.launch import mesh as jm
    names = [("data",), ("data", "model"), ("pod", "data", "model"),
             ("model", "data"), ("model",)]
    _group_of_one(tmp_path)
    try:
        for axes in names:
            m = tm.make_mesh((1,) * len(axes), axes, "cpu")
            assert m.mesh_dim_names == axes
            assert m.shape == (1,) * len(axes)
            assert tm.data_axes_of(m) == jm.data_axes_of(
                jax.make_mesh((1,) * len(axes), axes))
        host = tm.make_host_mesh(device_type="cpu")
        assert host.mesh_dim_names == ("data", "model")
        assert host.shape == (1, 1)
    finally:
        dist.destroy_process_group()


def test_compressed_allreduce_of_one_rank_is_bit_equal_to_jax(tmp_path):
    import jax
    import jax.numpy as jnp
    from repro.runtime.compression import compressed_grad_allreduce as jall
    g, e = _grads(0)
    jmesh = jax.make_mesh((1,), ("pod",))
    jg = jax.tree_util.tree_map(jnp.asarray, g)
    jg["h"] = jg["h"].astype(jnp.bfloat16)        # cast back to bf16
    j_out, j_err = jall(jg, jax.tree_util.tree_map(jnp.asarray, e), jmesh,
                        "pod")
    tg, te = _tree_to_torch(g), _tree_to_torch(e)
    tg["h"] = tg["h"].to(torch.bfloat16)
    _group_of_one(tmp_path)
    try:
        mesh = tm.make_mesh((1,), ("pod",), "cpu")
        out, err = tc.compressed_grad_allreduce(tg, te, mesh)
    finally:
        dist.destroy_process_group()
    assert out["h"].dtype == torch.bfloat16
    assert err["h"].dtype == torch.float32
    for a, b in zip(_leaves(out) + _leaves(err),
                    _leaves(j_out) + _leaves(j_err)):
        np.testing.assert_array_equal(_np(a), np.asarray(b, np.float32))
    # one rank: the mean is the dequantized value; with the residual it
    # is the corrected gradient
    np.testing.assert_allclose((out["w"] + err["w"]).numpy(),
                               g["w"] + e["w"], atol=1e-5)


def test_compressed_psum_tree_keeps_the_error_in_the_optimizer_state(
        tmp_path):
    tg = _tree_to_torch(_grads(1)[0])
    opt_state = {"m": 1}
    _group_of_one(tmp_path)
    try:
        mesh = tm.make_mesh((1,), ("pod",), "cpu")
        out1, state1 = tc.compressed_psum_tree(tg, opt_state, mesh, "pod")
        out2, state2 = tc.compressed_psum_tree(tg, state1, mesh, "pod")
        want1 = tc.compressed_grad_allreduce(tg, tc.init_error_state(tg),
                                             mesh, "pod")
        want2 = tc.compressed_grad_allreduce(tg, want1[1], mesh, "pod")
    finally:
        dist.destroy_process_group()
    assert opt_state == {"m": 1} and state1["m"] == state2["m"] == 1
    for got, want in (((out1, state1["grad_err"]), want1),
                      ((out2, state2["grad_err"]), want2)):
        for a, b in zip(_leaves(got[0]) + _leaves(got[1]),
                        _leaves(want[0]) + _leaves(want[1])):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# four ranks
# ---------------------------------------------------------------------------

def _rank_main(rank: int, world: int, store: str, out_dir: str) -> None:
    """A spawned rank: meshes, then the all-reduce of its own gradients;
    the facts (or the traceback) go to ``rank<r>.pkl``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=PG_TIMEOUT))
    out = {}
    try:
        flat = tm.make_mesh((world,), ("data",), "cpu")
        grid = tm.make_mesh((2, world // 2), ("pod", "data"), "cpu")
        host = tm.make_host_mesh(model=2, device_type="cpu")
        out["meshes"] = {
            "flat": (flat.shape, flat.mesh_dim_names,
                     dist.get_process_group_ranks(flat.get_group("data"))),
            "grid": (grid.shape, grid.mesh_dim_names,
                     dist.get_process_group_ranks(grid.get_group("pod")),
                     dist.get_process_group_ranks(grid.get_group("data")),
                     tm.data_axes_of(grid)),
            "host": (host.shape, host.mesh_dim_names,
                     dist.get_process_group_ranks(host.get_group("model")),
                     tm.data_axes_of(host)),
        }
        g, e = _grads(10 + rank)
        red, err = tc.compressed_grad_allreduce(
            _tree_to_torch(g), _tree_to_torch(e), flat, axis="data")
        out["reduced"] = [t.numpy() for t in _leaves(red)]
        out["err"] = [t.numpy() for t in _leaves(err)]
        dist.destroy_process_group()
    except Exception:  # recorded for the test that reads it
        out["error"] = traceback.format_exc()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _tree_to_torch(tree):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v) for k, v in tree.items()}
    return torch.as_tensor(tree)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_runtime")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, WORLD, str(out / "store"), str(out)))
             for r in range(WORLD)]
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
    res = []
    for r in range(WORLD):
        with open(out / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
        assert "error" not in res[-1], res[-1]["error"]
    return res


def test_meshes_over_four_ranks(four_ranks):
    """Rank-major meshes: the last axis varies fastest, as a JAX mesh over
    devices in order."""
    for rank, res in enumerate(four_ranks):
        m = res["meshes"]
        assert m["flat"] == ((4,), ("data",), [0, 1, 2, 3])
        shape, names, pod, data, axes = m["grid"]
        assert (shape, names, axes) == ((2, 2), ("pod", "data"),
                                        ("pod", "data"))
        assert pod == [rank % 2, rank % 2 + 2]
        assert data == [rank // 2 * 2, rank // 2 * 2 + 1]
        shape, names, model, axes = m["host"]
        assert (shape, names, axes) == ((2, 2), ("data", "model"),
                                        ("data",))
        assert model == [rank // 2 * 2, rank // 2 * 2 + 1]


def test_compressed_allreduce_over_four_ranks(four_ranks):
    import jax.numpy as jnp
    from repro.runtime import compression as jc
    deq, errs = [], []
    for rank in range(WORLD):
        g, e = _grads(10 + rank)
        per = [jc.compress_with_error_feedback(jnp.asarray(a), jnp.asarray(b))
               for a, b in zip(_leaves(g), _leaves(e))]
        deq.append([np.asarray(jc.int8_decompress(q, s)) for q, s, _ in per])
        errs.append([np.asarray(n) for _, _, n in per])
    terms = [np.stack([d[i] for d in deq]).astype(np.float64)
             for i in range(len(deq[0]))]
    for rank, res in enumerate(four_ranks):
        for got, t in zip(res["reduced"], terms):
            err = np.abs(got - t.sum(axis=0) / WORLD)
            assert np.all(err <= MEAN_RTOL * np.abs(t).sum(axis=0) / WORLD)
        for got, want in zip(res["err"], errs[rank]):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(res["reduced"], four_ranks[0]["reduced"]):
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the token pipeline
# ---------------------------------------------------------------------------

def test_synthetic_tokens_equal_the_reference():
    from repro.data import pipeline as jp
    for vocab, seq, seed in ((1000, 130, 3), (50_000, 64, 0), (300, 65, 7)):
        ours = tp.SyntheticLMDataset(vocab, seq, seed=seed)
        theirs = jp.SyntheticLMDataset(vocab, seq, seed=seed)
        for step, bs, start in ((0, 4, 0), (5, 3, 11)):
            a, b = ours.batch(step, bs, start), theirs.batch(step, bs, start)
            assert set(a) == set(b) == {"tokens", "labels"}
            for k in a:
                assert a[k].dtype == b[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], b[k])


def test_deterministic_shard_over_a_grid():
    from repro.data import pipeline as jp
    for global_batch in range(0, 19):
        for n_hosts in range(1, 7):
            shards = [tp.deterministic_shard(global_batch, h, n_hosts)
                      for h in range(n_hosts)]
            assert shards == [jp.deterministic_shard(global_batch, h, n_hosts)
                              for h in range(n_hosts)]
            assert [i for s in shards for i in s] == list(range(global_batch))


@pytest.mark.parametrize("n_hosts", [1, 3, 4])
def test_lm_batches_per_host_make_the_global_batch(n_hosts):
    from repro.data import pipeline as jp
    ds = tp.SyntheticLMDataset(500, 40, seed=2)
    ref = jp.SyntheticLMDataset(500, 40, seed=2)
    streams = [tp.make_lm_batches(ds, 7, h, n_hosts, start_step=3)
               for h in range(n_hosts)]
    refs = [jp.make_lm_batches(ref, 7, h, n_hosts, start_step=3)
            for h in range(n_hosts)]
    for step in (3, 4):
        parts = [next(s) for s in streams]
        for p, r in zip(parts, (next(s) for s in refs)):
            np.testing.assert_array_equal(p["tokens"], r["tokens"])
        whole = ds.batch(step, 7)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(
                np.concatenate([p[k] for p in parts]), whole[k])


def test_host_data_loader_keeps_order_and_closes():
    loader = tp.HostDataLoader(iter(range(10)), prefetch=2)
    assert list(loader) == list(range(10))
    loader._thread.join(5)
    assert not loader._thread.is_alive()
    loader = tp.HostDataLoader(iter(range(1000)), prefetch=2)
    assert next(loader) == 0
    loader.close()
    rest = list(loader)
    assert rest == list(range(1, 1 + len(rest))) and len(rest) <= 3
    loader._thread.join(5)
    assert not loader._thread.is_alive()
