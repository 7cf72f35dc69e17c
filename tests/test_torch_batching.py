"""Batch assembly in the PyTorch port against the JAX package.

``collate`` (dense and sparse), ``batches_by_bucket`` and
``stack_epoch_segments`` on all three layouts must give arrays exactly
equal to ``repro.core.batching``'s for the same samples and the same
``numpy`` rng: the trainers of both packages then see the same batches
in the same order. Both packages build their samples with numpy, so the
port's ``synthetic_samples`` and the JAX package's are the same data.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.core import batching as tb  # noqa: E402
from repro_torch.dataset.builder import synthetic_samples  # noqa: E402


def _jax_samples(n, seed, **kw):
    from repro.dataset.builder import synthetic_samples as jsynth
    return jsynth(n, seed=seed, **kw)


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_samples_are_the_same_data():
    for a, b in zip(synthetic_samples(12, seed=4, n_min=4, n_max=80),
                    _jax_samples(12, seed=4, n_min=4, n_max=80)):
        for k in ("x", "edges", "mask", "static", "y"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_collate_matches_jax(sparse):
    from repro.core import batching as jb
    ours = synthetic_samples(20, seed=1, n_min=4, n_max=30)
    theirs = _jax_samples(20, seed=1, n_min=4, n_max=30)
    for size in sorted(tb.group_by_bucket(ours)):
        idx = tb.group_by_bucket(ours)[size]
        assert idx == jb.group_by_bucket(theirs)[size]
        _assert_batches_equal(
            [tb.collate([ours[i] for i in idx], sparse=sparse)],
            [jb.collate([theirs[i] for i in idx], sparse=sparse)])
    # an explicit edge bucket pads the edge axis further
    _assert_batches_equal(
        [tb.collate(ours[:3], sparse=True, edge_bucket=128)],
        [jb.collate(theirs[:3], sparse=True, edge_bucket=128)])


def test_dense_adj_and_pack_edges_match_jax():
    from repro.core import batching as jb
    ours = synthetic_samples(6, seed=2, n_min=4, n_max=30)
    theirs = _jax_samples(6, seed=2, n_min=4, n_max=30)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(tb.dense_adj(a.edges, a.x.shape[0]),
                                      jb.dense_adj(b.edges, b.x.shape[0]))
    for g, w in zip(tb.pack_edges(ours), jb.pack_edges(theirs)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="edge bucket"):
        tb.pack_edges(ours, e_pad=1)


@pytest.mark.parametrize("edges", [None, 16, 2048])
@pytest.mark.parametrize("size", [32, 256, 1024])
def test_max_batch_for_bucket_matches_jax(size, edges):
    from repro.core import batching as jb
    for bs in (1, 8, 32):
        assert tb.max_batch_for_bucket(size, bs, edges=edges) == \
            jb.max_batch_for_bucket(size, bs, edges=edges)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_batches_by_bucket_matches_jax(sparse):
    from repro.core import batching as jb
    ours = synthetic_samples(40, seed=3, n_min=4, n_max=300)
    theirs = _jax_samples(40, seed=3, n_min=4, n_max=300)
    for drop in (False, True):
        _assert_batches_equal(
            tb.batches_by_bucket(ours, 8, rng=np.random.default_rng(5),
                                 drop_remainder=drop, sparse=sparse),
            jb.batches_by_bucket(theirs, 8, rng=np.random.default_rng(5),
                                 drop_remainder=drop, sparse=sparse))


@pytest.mark.parametrize("layout", ["dense", "sparse", "packed"])
def test_stack_epoch_segments_matches_jax(layout):
    from repro.core import batching as jb
    ours = synthetic_samples(45, seed=6, n_min=4, n_max=140)
    theirs = _jax_samples(45, seed=6, n_min=4, n_max=140)
    for kw in (dict(batch_size=8, max_steps=2),
               dict(batch_size=5, max_steps=32, batch_multiple=4)):
        _assert_batches_equal(
            tb.stack_epoch_segments(ours, rng=np.random.default_rng([0, 1, 3]),
                                    layout=layout, **kw),
            jb.stack_epoch_segments(theirs,
                                    rng=np.random.default_rng([0, 1, 3]),
                                    layout=layout, **kw))


def test_stack_epoch_segments_legacy_flag_and_errors():
    from repro.core import batching as jb
    ours = synthetic_samples(10, seed=7)
    theirs = _jax_samples(10, seed=7)
    _assert_batches_equal(tb.stack_epoch_segments(ours, 4, sparse=True),
                          jb.stack_epoch_segments(theirs, 4, sparse=True))
    with pytest.raises(ValueError, match="layout"):
        tb.stack_epoch_segments(ours, 4, layout="ragged")
    with pytest.raises(ValueError, match="batch_multiple"):
        tb.stack_epoch_segments(ours, 4, batch_multiple=0)
    unlabeled = [tb.pad_sample(s.x[:s.n_nodes], s.edges, s.static)
                 for s in ours]
    with pytest.raises(ValueError, match="labeled"):
        tb.stack_epoch_segments(unlabeled, 4)
