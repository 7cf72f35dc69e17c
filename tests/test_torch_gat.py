"""GAT in the PyTorch port against the JAX package.

On the CPU: the plain versions ``edge_softmax_ref`` and
``fused_gat_aggregate_ref`` are held against ``edge_softmax_pallas`` and
``fused_gat_aggregate_pallas`` in interpret mode on the JAX package's own
edge-case sweeps, and the port's packed GAT model against
``repro.core.gnn`` on the same weights and batches, to 1e-5 relative /
1e-6 absolute in float32. On a card (tests marked ``cuda``): the CUDA
kernels against their plain versions, to 1e-4 absolute + 1e-4 relative,
since they sum with atomics in another order.

JAX is imported only inside the fixtures that compare with it, so the
card's tests run where JAX is not installed:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_gat.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import gnn as tg  # noqa: E402
from repro_torch.kernels import ops, ref, segment_spmm  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6              # plain version vs Pallas, float32
CARD_RTOL = CARD_ATOL = 1e-4         # CUDA kernel vs plain version


# ---------------------------------------------------------------------------
# inputs (numpy, from a seed)
# ---------------------------------------------------------------------------

def _softmax_case(b, e, h, n, mask_frac=0.8, seed=0):
    """Random logits, destinations and a random edge mask
    (``tests/test_kernel_edges.py``)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, e, h)).astype(np.float32),
            rng.integers(0, n, (b, e)).astype(np.int32),
            (rng.random((b, e)) < mask_frac).astype(np.float32))


def _ragged_case(n, h, e_per_graph, seed):
    """Ragged edge lists padded to one E, padding rows (0, 0) with mask 0,
    logits ×3 (``tests/test_kernels.py``)."""
    rng = np.random.default_rng(seed)
    b = len(e_per_graph)
    e_pad = max(max(e_per_graph, default=1), 1)
    edges = np.zeros((b, e_pad, 2), np.int32)
    emask = np.zeros((b, e_pad), np.float32)
    for i, e in enumerate(e_per_graph):
        if e:
            edges[i, :e] = rng.integers(0, n, (e, 2))
            emask[i, :e] = 1.0
    s = rng.standard_normal((b, e_pad, h)).astype(np.float32) * 3
    return s, edges[..., 1].copy(), emask


def _fixed_case(name):
    """The hand-written cases: one fully masked destination, a padded
    edge whose raw score dwarfs the real ones, an all-padding bin."""
    if name == "masked_destination":
        s = np.random.default_rng(5).standard_normal((1, 8, 2)).astype(
            np.float32)
        return (s, np.array([[0, 0, 0, 0, 1, 1, 1, 1]], np.int32),
                np.array([[1, 1, 1, 1, 0, 0, 0, 0]], np.float32), 2)
    if name == "huge_padded_score":
        return (np.array([[[-100.0], [-101.0], [100.0]]], np.float32),
                np.zeros((1, 3), np.int32),
                np.array([[1.0, 1.0, 0.0]], np.float32), 4)
    if name == "all_masked":
        s, d, _ = _softmax_case(1, 192, 4, 24, seed=3)
        return s, d, np.zeros((1, 192), np.float32), 24
    raise KeyError(name)


SOFTMAX_CASES = (
    [dict(kind="random", b=2, e=e, h=h, n=40, seed=e + h)
     for e in (256, 129) for h in (4, 8)]
    + [dict(kind="ragged", n=n, h=h, epg=epg, seed=n + 1)
       for n, h, epg in ((16, 2, (5, 13, 0)), (33, 4, (40, 7, 29)),
                         (200, 4, (150, 380, 1)), (1024, 4, (2048, 100, 0)))]
    + [dict(kind=k) for k in ("masked_destination", "huge_padded_score",
                              "all_masked")])


def _softmax_inputs(case):
    if case["kind"] == "random":
        return (*_softmax_case(case["b"], case["e"], case["h"], case["n"],
                               seed=case["seed"]), case["n"])
    if case["kind"] == "ragged":
        return (*_ragged_case(case["n"], case["h"], case["epg"],
                              case["seed"]), case["n"])
    return _fixed_case(case["kind"])


def _case_id(c):
    return "-".join(str(v) for v in c.values())


def _gat_case(p, q, h, d=16, seed=9):
    """``tests/test_fused_mp.py``'s GAT aggregate inputs."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((p, d)).astype(np.float32),
            (rng.integers(0, p, (q, 2)).astype(np.int32) if q
             else np.zeros((0, 2), np.int32)),
            (rng.random(q) < 0.8).astype(np.float32),
            rng.random((q, h)).astype(np.float32),
            (rng.random(p) < 0.9).astype(np.float32))


GAT_CASES = [(64, 96, 4), (130, 257, 2), (64, 0, 4)]


def _tensors(arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) if isinstance(a, np.ndarray)
            else a for a in arrays]


# ---------------------------------------------------------------------------
# plain versions vs the JAX package's Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pallas():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.segment_spmm import (edge_softmax_pallas,
                                            fused_gat_aggregate_pallas)
    return edge_softmax_pallas, fused_gat_aggregate_pallas, jnp.asarray


@pytest.mark.parametrize("case", SOFTMAX_CASES, ids=_case_id)
def test_edge_softmax_plain_matches_pallas(pallas, case):
    edge_softmax_pallas, _, asarray = pallas
    s, dst, em, n = _softmax_inputs(case)
    want = np.asarray(edge_softmax_pallas(asarray(s), asarray(dst),
                                          asarray(em), n, interpret=True))
    got = ref.edge_softmax_ref(*_tensors((s, dst, em)), n).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.isfinite(got).all()
    # each destination's weights over its real edges sum to 1, or to 0
    # with no real edge; masked edges are exact zeros
    b, _, h = s.shape
    sums = np.zeros((b, n, h), np.float64)
    for bi in range(b):
        np.add.at(sums[bi], dst[bi], got[bi] * em[bi][:, None])
    assert np.all((np.abs(sums - 1.0) < 1e-5) | (sums == 0.0))
    assert np.all(got[em == 0] == 0.0)


@pytest.mark.parametrize("p,q,h", GAT_CASES)
def test_gat_aggregate_plain_matches_pallas(pallas, p, q, h):
    _, fused_gat_aggregate_pallas, asarray = pallas
    arrays = _gat_case(p, q, h)
    want = np.asarray(fused_gat_aggregate_pallas(
        *[asarray(a) for a in arrays], interpret=True))
    got = ref.fused_gat_aggregate_ref(*_tensors(arrays)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_edge_softmax_nan_score_poisons_its_destination_only():
    s, dst, em, n = _fixed_case("masked_destination")
    s[0, 1, 0] = np.nan
    got = ref.edge_softmax_ref(*_tensors((s, dst, em)), n).numpy()
    assert np.isnan(got[0, :4, 0]).all()          # head 0 of destination 0
    assert np.isfinite(got[0, :4, 1]).all()       # its other head
    assert (got[0, 4:] == 0.0).all()              # the masked destination


def test_ops_route_cpu_tensors_to_the_plain_versions():
    s, dst, em, n = _softmax_inputs(SOFTMAX_CASES[0])
    t = _tensors((s, dst, em))
    before = (segment_spmm.edge_softmax_cuda.launches,
              segment_spmm.fused_gat_aggregate_cuda.launches)
    torch.testing.assert_close(ops.edge_softmax(*t, n),
                               ref.edge_softmax_ref(*t, n), rtol=0, atol=0)
    g = _tensors(_gat_case(64, 96, 4))
    torch.testing.assert_close(ops.fused_gat_aggregate(*g),
                               ref.fused_gat_aggregate_ref(*g),
                               rtol=0, atol=0)
    assert (segment_spmm.edge_softmax_cuda.launches,
            segment_spmm.fused_gat_aggregate_cuda.launches) == before


def test_gat_wrappers_refuse_cpu_tensors_and_bad_heads():
    s, dst, em, n = _softmax_inputs(SOFTMAX_CASES[0])
    with pytest.raises(ValueError, match="CUDA tensors"):
        segment_spmm.edge_softmax_cuda(*_tensors((s, dst, em)), n)
    g = _tensors(_gat_case(64, 96, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        segment_spmm.fused_gat_aggregate_cuda(*g)
    z, edges, emask, att, nmask = _tensors(_gat_case(64, 96, 3, d=16))
    with pytest.raises(ValueError, match="must divide"):
        ref.fused_gat_aggregate_ref(z, edges, emask, att, nmask)


# ---------------------------------------------------------------------------
# the packed GAT model vs repro.core.gnn
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_gnn():
    jax = pytest.importorskip("jax")
    from repro.core import gnn as jg
    from repro.core.batching import collate_packed
    from repro.dataset.builder import synthetic_samples
    return jax, jg, collate_packed, synthetic_samples


def _model(jax_gnn, readout="mean_max", seed=0):
    jax, jg, _, _ = jax_gnn
    jcfg = jg.PMGNSConfig(variant="gat", hidden=64, n_gnn_blocks=2,
                          n_fc_blocks=2, layout="packed", readout=readout)
    tcfg = tg.PMGNSConfig(**dataclasses.asdict(jcfg))
    tree = jax.tree_util.tree_map(
        np.asarray, jg.pmgns_init(jax.random.PRNGKey(seed), jcfg))
    return jcfg, tcfg, tree


def _jax_infer(jax_gnn, jcfg, tree, batch):
    jax, jg, _, _ = jax_gnn
    jnp = jax.numpy
    return np.asarray(jg.pmgns_infer(
        jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
        {k: jnp.asarray(v) for k, v in batch.items()}))


def _packed_batch(jax_gnn, seed=11, n=10):
    _, _, collate_packed, synthetic_samples = jax_gnn
    samples = synthetic_samples(n, seed=seed, n_min=4, n_max=40)
    return {k: v for k, v in collate_packed(samples).items()
            if k not in ("y", "wt")}


@pytest.mark.parametrize("readout", ["mean_max", "mean"])
def test_gat_pmgns_infer_matches_jax(jax_gnn, readout):
    jcfg, tcfg, tree = _model(jax_gnn, readout)
    batch = _packed_batch(jax_gnn)
    want = _jax_infer(jax_gnn, jcfg, tree, batch)
    model = tg.params_from_numpy(tree, tcfg, device="cpu")
    got = tg.pmgns_infer(model, tcfg, batch).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_gat_staged_packed_infer_matches_jax(jax_gnn):
    _, jg, collate_packed, synthetic_samples = jax_gnn
    jax = jax_gnn[0]
    jnp = jax.numpy
    jcfg, tcfg, tree = _model(jax_gnn, seed=1)
    p, q, g = 256, 416, 16
    o1, o2, o3, f_len, i_len = tg.packed_staging_layout(tcfg, p, q, g)
    fbuf = np.zeros(f_len, np.float32)
    ibuf = np.zeros(i_len, np.int32)
    collate_packed(synthetic_samples(8, seed=2, n_min=4, n_max=30), out={
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


def test_gat_empty_neighbourhood_is_finite_and_matches_jax(jax_gnn):
    """Every edge masked: each destination's softmax row is all padding,
    the NaN risk; the predictions must stay finite and equal JAX's."""
    jcfg, tcfg, tree = _model(jax_gnn, seed=2)
    batch = _packed_batch(jax_gnn, seed=4, n=6)
    batch["edge_mask"] = np.zeros_like(batch["edge_mask"])
    want = _jax_infer(jax_gnn, jcfg, tree, batch)
    got = tg.pmgns_infer(tg.params_from_numpy(tree, tcfg, device="cpu"),
                         tcfg, batch).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_gat_edgeless_graph_in_a_mixed_bin(jax_gnn):
    """A graph with every edge killed, packed beside normal graphs, must
    leave their predictions as they are alone, and match JAX's."""
    _, _, collate_packed, synthetic_samples = jax_gnn
    jcfg, tcfg, tree = _model(jax_gnn, seed=3)
    samples = synthetic_samples(4, seed=8, n_min=6, n_max=30)
    model = tg.params_from_numpy(tree, tcfg, device="cpu")

    def run(chunk, kill_first=False):
        batch = {k: v for k, v in collate_packed(chunk).items()
                 if k not in ("y", "wt")}
        if kill_first:
            first = batch["graph_ids"][batch["edges"][:, 1]] == 0
            assert (batch["edge_mask"][first] > 0).any()
            batch["edge_mask"] = np.where(first, 0.0, batch["edge_mask"]
                                          ).astype(np.float32)
        return (tg.pmgns_infer(model, tcfg, batch).numpy(),
                _jax_infer(jax_gnn, jcfg, tree, batch))
    got, want = run(samples, kill_first=True)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    alone, _ = run(samples[1:])
    np.testing.assert_allclose(got[1:len(samples)], alone[:len(samples) - 1],
                               rtol=RTOL, atol=ATOL)


def test_gat_params_round_trip_and_init_structure(jax_gnn):
    jax = jax_gnn[0]
    _, tcfg, tree = _model(jax_gnn)
    model = tg.params_from_numpy(tree, tcfg, device="cpu")
    names = dict(model.named_parameters())
    assert tuple(names["gnn.b0.proj.w"].shape) == (tcfg.node_feat_dim, 64)
    assert tuple(names["gnn.b1.att_src"].shape) == (tg.GAT_HEADS,
                                                    64 // tg.GAT_HEADS)
    back = tg.params_to_numpy(model)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    init = tg.pmgns_init(0, tcfg)
    assert jax.tree_util.tree_map(np.shape, init) == \
        jax.tree_util.tree_map(np.shape, tree)
    att = init["gnn"]["b0"]["att_src"]
    assert att.dtype == np.float32 and 0.005 < att.std() < 0.05


# ---------------------------------------------------------------------------
# on the card: hand-written kernel vs plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", SOFTMAX_CASES, ids=_case_id)
def test_edge_softmax_kernel_matches_plain_on_card(cuda_dev, case):
    s, dst, em, n = _softmax_inputs(case)
    t = _tensors((s, dst, em), cuda_dev)
    before = segment_spmm.edge_softmax_cuda.launches
    got = segment_spmm.edge_softmax_cuda(*t, n)
    want = ref.edge_softmax_ref(*t, n)
    torch.cuda.synchronize()
    assert segment_spmm.edge_softmax_cuda.launches == before + 1
    torch.testing.assert_close(got, want, rtol=CARD_RTOL, atol=CARD_ATOL)
    assert bool((got[torch.as_tensor(em, device=cuda_dev) == 0] == 0).all())


@pytest.mark.cuda
def test_edge_softmax_kernel_nan_and_empty_on_card(cuda_dev):
    s, dst, em, n = _fixed_case("masked_destination")
    s[0, 1, 0] = np.nan
    got = segment_spmm.edge_softmax_cuda(*_tensors((s, dst, em), cuda_dev),
                                         n).cpu().numpy()
    assert np.isnan(got[0, :4, 0]).all()
    assert np.isfinite(got[0, :4, 1]).all()
    assert (got[0, 4:] == 0.0).all()
    empty = torch.zeros((2, 0, 4), device=cuda_dev)
    before = segment_spmm.edge_softmax_cuda.launches
    out = segment_spmm.edge_softmax_cuda(
        empty, torch.zeros((2, 0), dtype=torch.int32, device=cuda_dev),
        torch.zeros((2, 0), device=cuda_dev), 5)
    assert out.shape == (2, 0, 4)
    assert segment_spmm.edge_softmax_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("p,q,h", GAT_CASES + [(4096, 6656, 4)])
def test_gat_aggregate_kernel_matches_plain_on_card(cuda_dev, p, q, h):
    t = _tensors(_gat_case(p, q, h, d=512 if p == 4096 else 16), cuda_dev)
    before = segment_spmm.fused_gat_aggregate_cuda.launches
    got = segment_spmm.fused_gat_aggregate_cuda(*t)
    want = ref.fused_gat_aggregate_ref(*t)
    torch.cuda.synchronize()
    assert segment_spmm.fused_gat_aggregate_cuda.launches == \
        before + (1 if q else 0)
    torch.testing.assert_close(got, want, rtol=CARD_RTOL, atol=CARD_ATOL)


@pytest.mark.cuda
def test_gat_wrappers_reject_bad_inputs_on_card(cuda_dev):
    z, edges, emask, att, nmask = _tensors(_gat_case(64, 96, 4), cuda_dev)
    with pytest.raises(ValueError, match="must divide"):
        segment_spmm.fused_gat_aggregate_cuda(z, edges, emask, att[:, :3],
                                              nmask)
    with pytest.raises(TypeError, match="int32"):
        segment_spmm.fused_gat_aggregate_cuda(z, edges.long(), emask, att,
                                              nmask)
    s, dst, em, n = _softmax_inputs(SOFTMAX_CASES[0])
    s, dst, em = _tensors((s, dst, em), cuda_dev)
    with pytest.raises(ValueError, match="contiguous"):
        segment_spmm.edge_softmax_cuda(s.transpose(0, 1).contiguous()
                                       .transpose(0, 1), dst, em, n)
