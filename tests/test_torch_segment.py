"""The training path's kernels in the PyTorch port against the JAX package.

On the CPU: the plain versions ``segment_aggregate_ref``,
``segment_scatter_ref`` and ``dense_aggregate_ref`` are held against
``segment_aggregate_pallas``, ``segment_scatter_pallas`` and
``dense_aggregate_pallas`` in interpret mode on an edge-case sweep, to
1e-5 relative / 1e-6 absolute in float32; the backward passes of
``repro_torch.kernels.autograd`` pass ``torch.autograd.gradcheck`` in
float64 and agree with ``jax.grad`` of the JAX package's plain versions
in float32 to 1e-5; the raw CUDA wrappers refuse inputs that require
grad. On a card (tests marked ``cuda``): the CUDA kernels, forward and
backward, against the plain versions to 1e-4 absolute + 1e-4 relative,
since they add with atomics in another order.

JAX is imported only inside the tests that compare with it, so the
card's tests run where JAX is not installed:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_segment.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref, sage_spmm, segment_spmm  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6              # plain version vs Pallas, float32
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-5    # float32 gradients vs jax.grad
CARD_RTOL = CARD_ATOL = 1e-4         # CUDA kernel vs plain version


# ---------------------------------------------------------------------------
# inputs (numpy, from a seed)
# ---------------------------------------------------------------------------

def _edges(b, n, e, weighted, seed, pad=0.25):
    """``[B, E, 2]`` edges with padded tails ((0, 0), mask 0), a self-loop
    and a duplicate in every row with two real edges; with ``E`` small
    against ``N`` most nodes are isolated destinations."""
    rng = np.random.default_rng(seed)
    edges = np.zeros((b, e, 2), np.int32)
    em = np.zeros((b, e), np.float32)
    for i in range(b):
        real = e - int(e * pad)
        if real:
            edges[i, :real] = rng.integers(0, n, (real, 2))
            em[i, :real] = (rng.uniform(0.2, 2.0, real) if weighted else 1.0)
        if real >= 2:
            edges[i, 0, 1] = edges[i, 0, 0]
            edges[i, 1] = edges[i, 0]
    return edges, em


SEG_CASES = [
    dict(b=1, n=1, e=1, f=3, weighted=False),
    dict(b=2, n=37, e=0, f=8, weighted=False),
    dict(b=1, n=130, e=129, f=7, weighted=True),
    dict(b=3, n=37, e=129, f=130, weighted=False),
    dict(b=3, n=130, e=300, f=16, weighted=True),
]
SEG_IDS = [f"b{c['b']}-n{c['n']}-e{c['e']}-f{c['f']}"
           f"{'-w' if c['weighted'] else ''}" for c in SEG_CASES]


def _seg_inputs(c, seed=0):
    edges, em = _edges(c["b"], c["n"], c["e"], c["weighted"], seed)
    rng = np.random.default_rng(seed + 1)
    h = rng.standard_normal((c["b"], c["n"], c["f"])).astype(np.float32)
    msgs = rng.standard_normal((c["b"], c["e"], c["f"])).astype(np.float32)
    return edges, em, h, msgs


DENSE_CASES = [(1, 1, 1), (2, 5, 7), (1, 32, 32), (3, 130, 70), (2, 129, 16)]


def _dense_inputs(b, n, f, weighted, seed=0):
    rng = np.random.default_rng(seed)
    adj = (rng.random((b, n, n)) < 0.1).astype(np.float32)
    if weighted:
        adj *= rng.uniform(0.1, 1.0, adj.shape).astype(np.float32)
    h = rng.standard_normal((b, n, f)).astype(np.float32)
    return adj, h


def _t(arrays, device="cpu", dtype=None):
    out = []
    for a in arrays:
        t = torch.as_tensor(a, device=device)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out.append(t)
    return out


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("case", SEG_CASES, ids=SEG_IDS)
def test_segment_aggregate_ref_matches_pallas(case, mode):
    import jax.numpy as jnp
    from repro.kernels.segment_spmm import segment_aggregate_pallas
    edges, em, h, _ = _seg_inputs(case)
    want = segment_aggregate_pallas(jnp.asarray(edges), jnp.asarray(em),
                                    jnp.asarray(h), mode=mode,
                                    interpret=True)
    got = ref.segment_aggregate_ref(*_t((edges, em, h)), mode)
    _close(got, want)


@pytest.mark.parametrize("case", SEG_CASES, ids=SEG_IDS)
def test_segment_scatter_ref_matches_pallas(case):
    import jax.numpy as jnp
    from repro.kernels.segment_spmm import segment_scatter_pallas
    edges, em, _, msgs = _seg_inputs(case, seed=3)
    dst = edges[..., 1].copy()
    want = segment_scatter_pallas(jnp.asarray(dst), jnp.asarray(em),
                                  jnp.asarray(msgs), case["n"],
                                  interpret=True)
    got = ref.segment_scatter_ref(*_t((dst, em, msgs)), case["n"])
    _close(got, want)


@pytest.mark.parametrize("weighted", [False, True], ids=["01", "weighted"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("b,n,f", DENSE_CASES)
def test_dense_aggregate_ref_matches_pallas(b, n, f, mode, weighted):
    import jax.numpy as jnp
    from repro.kernels.sage_spmm import dense_aggregate_pallas
    adj, h = _dense_inputs(b, n, f, weighted, seed=n + f)
    want = dense_aggregate_pallas(jnp.asarray(adj), jnp.asarray(h),
                                  mode=mode, interpret=True)
    got = ref.dense_aggregate_ref(*_t((adj, h)), mode)
    _close(got, want)


def test_plain_versions_match_the_jax_refs_on_nan_in_a_masked_row():
    """A masked edge multiplies its message by 0, so NaN·0 reaches its
    destination in both packages (the kernels keep that: they skip a
    zero-weight edge only when its message is finite)."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    edges, em = _edges(2, 40, 64, True, seed=77)
    edges[1, edges[1, :, 0] == 39, 0] = 0
    edges[1, 2] = (39, 5)
    em[1, 2] = 0.0
    h = np.random.default_rng(1).standard_normal((2, 40, 9)).astype(
        np.float32)
    h[1, 39] = np.nan
    for mode in ("sum", "mean"):
        want = np.asarray(jref.segment_aggregate_ref(
            jnp.asarray(edges), jnp.asarray(em), jnp.asarray(h), mode=mode))
        got = ref.segment_aggregate_ref(*_t((edges, em, h)), mode).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(got[1, 5]).all()
        _close(got[~np.isnan(want)], want[~np.isnan(want)])


def test_degree_and_transpose_forms():
    """``return_degree``, ``transpose`` and ``scale`` (the backward's
    forms) against their direct definitions."""
    edges, em, h, _ = _seg_inputs(SEG_CASES[-1])
    out, deg = ref.segment_aggregate_ref(*_t((edges, em, h)), "mean",
                                         return_degree=True)
    want_deg = ref.segment_degree_ref(*_t((edges, em)), h.shape[1])
    torch.testing.assert_close(deg, want_deg)
    adj, hd = _dense_inputs(2, 20, 6, True, seed=9)
    s = np.random.default_rng(2).random((2, 20)).astype(np.float32)
    got = ref.dense_aggregate_ref(*_t((adj, hd)), "sum",
                                  scale=torch.as_tensor(s), transpose=True)
    want = np.einsum("bkn,bkf->bnf", adj, hd * s[..., None])
    _close(got, want)


def test_gather_is_the_weighted_take():
    edges, em, h, _ = _seg_inputs(SEG_CASES[3])
    got = ref.segment_gather_ref(*_t((h, edges[..., 0], em)))
    want = np.take_along_axis(h, edges[..., 0:1].astype(np.int64), axis=1) \
        * em[..., None]
    _close(got, want)


# ---------------------------------------------------------------------------
# the autograd.Functions: gradcheck in float64, jax.grad in float32
# ---------------------------------------------------------------------------

def _readout_inputs(p=40, f=3, g=6, seed=0):
    """Small integers, so maxima tie; the last graph has no node."""
    rng = np.random.default_rng(seed)
    h = rng.integers(-2, 3, (p, f)).astype(np.float32)
    ids = np.sort(rng.integers(0, g - 1, p)).astype(np.int32)
    nm = (rng.random(p) < 0.8).astype(np.float32)
    return h, ids, nm, g


#: gradcheck's finite differences take two forward passes per input
#: element, so its inputs are small; they keep every edge case (weights,
#: padded rows, a self-loop, a duplicate, isolated nodes, an empty graph)
GRADCHECK_SEG = dict(b=2, n=12, e=20, f=3, weighted=True)


def _function_cases(small=False):
    """(id, torch function, jax function, numpy inputs, index of the
    differentiable input) for every Function."""
    from repro.kernels import ref as jref
    c = GRADCHECK_SEG if small else SEG_CASES[-1]
    edges, em, h, msgs = _seg_inputs(c, seed=5)
    dst = edges[..., 1].copy()
    adj, hd = _dense_inputs(2, 9 if small else 17, 3 if small else 5, True,
                            seed=11)
    s = np.random.default_rng(6).standard_normal(
        (c["b"], c["e"], 4)).astype(np.float32) * 3
    live = (em > 0).astype(np.float32)
    rh, rid, rnm, rg = _readout_inputs(p=16 if small else 40)
    n = c["n"]
    cases = []
    for mode in ("sum", "mean"):
        cases.append((f"segment_aggregate-{mode}",
                      lambda e, m, x, mode=mode: ops.segment_aggregate(
                          e, m, x, mode),
                      lambda e, m, x, mode=mode: jref.segment_aggregate_ref(
                          e, m, x, mode=mode),
                      (edges, em, h), 2))
        cases.append((f"dense_aggregate-{mode}",
                      lambda a, x, mode=mode: ops.dense_aggregate(a, x, mode),
                      lambda a, x, mode=mode: jref.dense_aggregate_ref(
                          a, x, mode=mode),
                      (adj, hd), 1))
    cases.append(("segment_scatter",
                  lambda d, m, x: ops.segment_scatter(d, m, x, n),
                  lambda d, m, x: jref.segment_scatter_ref(d, m, x, n),
                  (dst, em, msgs), 2))
    cases.append(("edge_softmax",
                  lambda x, d, m: ops.edge_softmax(x, d, m, n),
                  lambda x, d, m: jref.edge_softmax_ref(x, d, m, n),
                  (s, dst, live), 0))
    for kind in ("mean", "mean_max"):
        cases.append((f"segment_readout-{kind}",
                      lambda x, i, m, kind=kind: ops.segment_readout(
                          x, i, m, rg, kind=kind),
                      lambda x, i, m, kind=kind: jref.segment_readout_ref(
                          x, i, m, rg, kind=kind),
                      (rh, rid, rnm), 0))
    return cases


FUNCTION_IDS = ["segment_aggregate-sum", "dense_aggregate-sum",
                "segment_aggregate-mean", "dense_aggregate-mean",
                "segment_scatter", "edge_softmax", "segment_readout-mean",
                "segment_readout-mean_max"]


def _case(name, small=False):
    for c in _function_cases(small):
        if c[0] == name:
            return c
    raise KeyError(name)


@pytest.mark.parametrize("name", FUNCTION_IDS)
def test_gradcheck_float64(name):
    _, fn, _, arrays, k = _case(name, small=True)
    if name.startswith("segment_readout"):
        # finite differences cannot cross a tie: lift the maxima apart here;
        # the tied inputs are held against jax.grad and the 1/3 split below
        arrays = list(arrays)
        h = arrays[0] + np.random.default_rng(3).random(
            arrays[0].shape).astype(np.float32) * 0.1
        arrays[0] = h
    ts = _t(arrays, dtype=torch.float64)
    ts[k].requires_grad_(True)
    assert torch.autograd.gradcheck(lambda x: fn(*ts[:k], x, *ts[k + 1:]),
                                    (ts[k],), eps=1e-6, atol=1e-6,
                                    rtol=1e-5)


def test_gradcheck_gather_float64():
    edges, _, h, _ = _seg_inputs(GRADCHECK_SEG, seed=8)
    x, idx = _t((h, edges[..., 0].copy()), dtype=torch.float64)
    x.requires_grad_(True)
    assert torch.autograd.gradcheck(lambda v: ops.segment_gather(v, idx),
                                    (x,), eps=1e-6, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("name", FUNCTION_IDS)
def test_gradients_match_jax_grad(name):
    """The float32 backward of each Function against ``jax.grad`` of the
    JAX package's plain version under the same upstream gradient; the
    readout's inputs hold tied maxima, split evenly by both."""
    import jax
    import jax.numpy as jnp
    _, fn, jfn, arrays, k = _case(name)
    ts = _t(arrays)
    ts[k].requires_grad_(True)
    y = fn(*ts)
    g = np.random.default_rng(len(name)).standard_normal(
        tuple(y.shape)).astype(np.float32)
    y.backward(torch.as_tensor(g))
    jargs = [jnp.asarray(a) for a in arrays]

    def loss(x):
        return jnp.sum(jfn(*jargs[:k], x, *jargs[k + 1:]) * g)
    want = jax.grad(loss)(jargs[k])
    _close(y.detach(), jfn(*jargs), RTOL, ATOL)
    _close(ts[k].grad, want, GRAD_RTOL, GRAD_ATOL)


def test_readout_ties_split_evenly():
    """Three tied maxima each take a third of the max part's gradient; a
    padded row at the same value takes none."""
    h = torch.tensor([[1.0], [3.0], [3.0], [3.0], [3.0]], requires_grad=True)
    ids = torch.zeros(5, dtype=torch.int32)
    nm = torch.tensor([1.0, 1.0, 1.0, 1.0, 0.0])
    z = ops.segment_readout(h, ids, nm, 1, kind="mean_max")
    z.backward(torch.tensor([[0.0, 1.0]]))
    torch.testing.assert_close(h.grad[:, 0],
                               torch.tensor([0.0, 1 / 3, 1 / 3, 1 / 3, 0.0]))


def test_no_gradient_for_the_data():
    edges, em, h, _ = _seg_inputs(SEG_CASES[-1])
    e, m, x = _t((edges, em, h))
    m.requires_grad_(True)
    with pytest.raises(RuntimeError, match="edge_mask has no gradient"):
        ops.segment_aggregate(e, m, x, "sum")


# ---------------------------------------------------------------------------
# the raw wrappers refuse to drop autograd history
# ---------------------------------------------------------------------------

def _raw_calls():
    edges, em, h, msgs = _seg_inputs(SEG_CASES[3])
    e, m, x, g = _t((edges, em, h, msgs))
    adj, hd = _t(_dense_inputs(2, 8, 4, False))
    return {
        "segment_aggregate": (segment_spmm.segment_aggregate_cuda,
                              (e, m, x), 2),
        "segment_scatter": (segment_spmm.segment_scatter_cuda,
                            (e[..., 1], m, g, 37), 2),
        "segment_gather": (segment_spmm.segment_gather_cuda,
                           (x, e[..., 0], m), 0),
        "dense_aggregate": (sage_spmm.dense_aggregate_cuda, (adj, hd), 1),
    }


@pytest.mark.parametrize("name", ["segment_aggregate", "segment_scatter",
                                  "segment_gather", "dense_aggregate"])
def test_raw_wrappers_refuse_inputs_that_require_grad(name, monkeypatch):
    """With grad mode on and an input that requires grad, the raw wrapper
    raises and names the entry of ``ops`` to use, before it looks at the
    device; the launch is stubbed so nothing could run."""
    launched = []
    monkeypatch.setattr(segment_spmm, "_call",
                        lambda *a: launched.append(a))
    fn, args, k = _raw_calls()[name]
    args = list(args)
    args[k] = args[k].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match=f"ops.{name}"):
        fn(*args)
    with torch.no_grad():            # no history to drop: the device check
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(*args)
    assert not launched


def test_inference_wrappers_refuse_inputs_that_require_grad(monkeypatch):
    monkeypatch.setattr(segment_spmm, "_call", lambda *a: None)
    x = torch.zeros((4, 3), requires_grad=True)
    e = torch.zeros((2, 2), dtype=torch.int32)
    m = torch.ones(2)
    w = torch.zeros((3, 5))
    with pytest.raises(RuntimeError, match="inference only"):
        segment_spmm.fused_mp_layer_cuda(x, e, m, None, w_neigh=w, w_self=w)
    with pytest.raises(RuntimeError, match="ops.segment_readout"):
        segment_spmm.segment_readout_cuda(x, torch.zeros(4, dtype=torch.int32),
                                          torch.ones(4), 2)
    with pytest.raises(RuntimeError, match="ops.edge_softmax"):
        segment_spmm.edge_softmax_cuda(torch.zeros((1, 2, 1),
                                                   requires_grad=True),
                                       e[None, :, 1], m[None], 4)


def test_ops_route_cpu_tensors_to_the_plain_versions():
    edges, em, h, msgs = _seg_inputs(SEG_CASES[2])
    e, m, x, g = _t((edges, em, h, msgs))
    before = (segment_spmm.segment_aggregate_cuda.launches,
              segment_spmm.segment_scatter_cuda.launches,
              segment_spmm.segment_gather_cuda.launches,
              sage_spmm.dense_aggregate_cuda.launches)
    torch.testing.assert_close(ops.segment_aggregate(e, m, x, "mean"),
                               ref.segment_aggregate_ref(e, m, x, "mean"))
    torch.testing.assert_close(ops.segment_scatter(e[..., 1], m, g, 130),
                               ref.segment_scatter_ref(e[..., 1], m, g, 130))
    torch.testing.assert_close(ops.segment_gather(x, e[..., 0]),
                               ref.segment_gather_ref(x, e[..., 0]))
    adj, hd = _t(_dense_inputs(2, 8, 4, False))
    torch.testing.assert_close(ops.dense_aggregate(adj, hd),
                               ref.dense_aggregate_ref(adj, hd))
    assert (segment_spmm.segment_aggregate_cuda.launches,
            segment_spmm.segment_scatter_cuda.launches,
            segment_spmm.segment_gather_cuda.launches,
            sage_spmm.dense_aggregate_cuda.launches) == before


# ---------------------------------------------------------------------------
# on the card: hand-written kernels, forward and backward, vs plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    from repro_torch.core.gnn import resolve_device
    return resolve_device("cuda")


def _card_close(got, want):
    torch.testing.assert_close(got.cpu(), want.cpu(), rtol=CARD_RTOL,
                               atol=CARD_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", SEG_CASES, ids=SEG_IDS)
def test_segment_kernels_match_plain_on_card(case, cuda_dev):
    edges, em, h, msgs = _seg_inputs(case)
    e, m, x, g = _t((edges, em, h, msgs), cuda_dev)
    for mode in ("sum", "mean"):
        got = segment_spmm.segment_aggregate_cuda(e, m, x, mode,
                                                  return_degree=True)
        want = ref.segment_aggregate_ref(e, m, x, mode, return_degree=True)
        _card_close(got[0], want[0])
        _card_close(got[1], want[1])
    _card_close(segment_spmm.segment_scatter_cuda(e[..., 1], m, g,
                                                  case["n"]),
                ref.segment_scatter_ref(e[..., 1], m, g, case["n"]))
    _card_close(segment_spmm.segment_gather_cuda(x, e[..., 0], m),
                ref.segment_gather_ref(x, e[..., 0], m))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,f", DENSE_CASES + [(2, 256, 512)])
def test_dense_kernel_matches_plain_on_card(b, n, f, cuda_dev):
    adj, h = _t(_dense_inputs(b, n, f, True, seed=n), cuda_dev)
    s = torch.rand((b, n), device=cuda_dev)
    for mode in ("sum", "mean"):
        for kw in (dict(), dict(transpose=True, scale=s)):
            got = sage_spmm.dense_aggregate_cuda(adj, h, mode,
                                                 return_degree=True, **kw)
            want = ref.dense_aggregate_ref(adj, h, mode, return_degree=True,
                                           **kw)
            _card_close(got[0], want[0])
            _card_close(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", FUNCTION_IDS)
def test_backward_on_card_matches_cpu(name, cuda_dev):
    _, fn, _, arrays, k = _case(name)
    grads = []
    for dev in (cuda_dev, torch.device("cpu")):
        ts = _t(arrays, dev)
        ts[k].requires_grad_(True)
        y = fn(*ts)
        g = np.random.default_rng(1).standard_normal(tuple(y.shape))
        y.backward(torch.as_tensor(g.astype(np.float32), device=dev))
        grads.append(ts[k].grad)
    _card_close(grads[0], grads[1])
