"""The packed readout and its gradient (``csrc/segment_readout.cu``, B2).

On the CPU: a float32 emulation of the kernel's order — on the runs route
(``segment_spmm.readout_plan``: the real rows a prefix of ids that do not
decrease) a graph of at most ``READOUT_WINDOW`` rows summed in ascending
order, a longer one cut into ``min(READOUT_WARPS, ceil(n / window))``
pieces of equal length, each summed in ascending order and the pieces
added in order; on the general route every graph's rows in ascending
order; each term ``h · w`` rounded apart, the max keeping NaN — held
against ``segment_readout_pallas`` in interpret mode (finite inputs and
0/1 masks: its one-hot product spreads a non-finite value over its tile
and counts a real row as 1 whatever its mask value),
``repro.kernels.ref.segment_readout_ref`` and the plain version, to 1e-5
relative / 1e-6 absolute with NaN and inf where they put them; a graph
of at most one window bit-equal to the plain version's ``index_add_``
sum; ``readout_plan`` on five layouts and a packed bin. The gradient's
plain version against ``jax.grad`` of the JAX reference (ties,
fractional masks, empty graphs), ``gradcheck`` in float64, and an
emulation of the backward kernel's order. On a card (tests marked ``cuda``): the kernel bit-equal
to the emulation and to a second run, within 1e-4 absolute + 1e-4
relative of the plain version with NaN in the same places, its route
counted as ``readout_plan`` says; the gradient likewise, and through
``ops.segment_readout`` with no gather, scatter or CSR launched.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref, segment_spmm  # noqa: E402

from test_torch_kernels import READOUT_CASES, _readout_case  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6              # emulation vs Pallas and references
CARD_RTOL = CARD_ATOL = 1e-4         # CUDA kernel vs plain version
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6    # plain gradient vs jax.grad, float32
F32 = np.float32
NEG = np.finfo(np.float32).min
WINDOW, WARPS = segment_spmm.READOUT_WINDOW, segment_spmm.READOUT_WARPS


# ---------------------------------------------------------------------------
# inputs (numpy, from a seed)
# ---------------------------------------------------------------------------

def _runs(sizes, p, f, seed, frac=False):
    """A packed bin: graph k's ``sizes[k]`` real rows in a run, the runs in
    order from row 0, then padded rows (id 0, mask 0, h 1e6 that must not
    leak); ``frac`` gives the real rows mask values in (0.05, 1]."""
    rng = np.random.default_rng(seed)
    n_real = sum(sizes)
    h = rng.standard_normal((p, f)).astype(F32)
    h[n_real:] = 1e6
    ids = np.zeros(p, np.int32)
    ids[:n_real] = np.repeat(np.arange(len(sizes)), sizes)
    nm = np.zeros(p, F32)
    nm[:n_real] = (rng.uniform(0.05, 1.0, n_real) if frac else 1.0)
    return h, ids, nm


def _cases():
    """(id, h, ids, nm, G): the packed layout's shapes, graphs longer than
    a window and than the warps' pieces, fractional masks, empty graphs,
    ids in no order, and a masked row inside the real ones."""
    rng = np.random.default_rng(21)
    out = []
    for name, (kind, p, f, g, layout) in zip(
            ["runs-300", "runs-130", "random", "empty"], READOUT_CASES[4:]):
        out.append((name, *_readout_case(kind, p, f, g, layout), g))
    # graphs of 1, one window, one more, 4 windows, more than 16 windows
    out.append(("long", *_runs([1, WINDOW, WINDOW + 1, 4 * WINDOW - 3, 700],
                               1100, 40, seed=1), 7))
    out.append(("fractional", *_runs([5, 40, 17, 0, 90], 200, 12, seed=2,
                                     frac=True), 6))
    h, ids, nm = _runs([3, 50, 8], 80, 9, seed=3)
    nm[20] = 0.0                                 # masked inside the runs
    out.append(("masked-inside", h, ids, nm, 4))
    h = rng.standard_normal((150, 33)).astype(F32)
    ids = rng.integers(0, 5, 150).astype(np.int32)
    ids[:60] = 2                                 # a long graph, no order
    out.append(("random-long", h, ids, (rng.random(150) < 0.9).astype(F32),
                6))
    return out


CASES = _cases()
CASE_IDS = [c[0] for c in CASES]


def _nonfinite_cases():
    """C1 (NaN in a real row, ROADMAP §C's inputs and a packed bin), a
    column whose every real value is NaN, and ±inf (on the runs route and
    on the general one)."""
    h = (np.arange(24, dtype=F32) / 7).reshape(6, 4)
    h[1, 2] = np.nan
    c1 = (h, np.array([0, 0, 0, 1, 1, 1], np.int32), np.ones(6, F32), 2)
    h, ids, nm = _runs([12, 40, 5, 70], 160, 16, seed=4)
    h[20, 3] = np.nan
    nan_bin = (h, ids, nm, 6)
    h = h.copy()
    h[:127, 5] = np.nan                          # every real value
    all_nan = (h, ids, nm, 6)
    h, ids, nm = _runs([12, 40, 5, 70], 160, 16, seed=5)
    h[3, 1], h[30, 2], h[31, 2], h[100, 7] = np.inf, -np.inf, np.inf, -np.inf
    inf_runs = (h, ids, nm, 6)
    rng = np.random.default_rng(6)
    hr = rng.standard_normal((100, 10)).astype(F32)
    hr[7, 0], hr[50, 4], hr[51, 9] = np.nan, np.inf, -np.inf
    inf_random = (hr, rng.integers(0, 4, 100).astype(np.int32),
                  np.ones(100, F32), 4)
    return {"C1": c1, "nan-bin": nan_bin, "all-nan-column": all_nan,
            "inf-runs": inf_runs, "inf-random": inf_random}


NONFINITE = _nonfinite_cases()


# ---------------------------------------------------------------------------
# the emulation
# ---------------------------------------------------------------------------

def _max_nan(m, v):
    return np.where((v > m) | np.isnan(v), v, m)


def _pieces(ids, nm, g):
    """Each graph's rows, cut as the kernel cuts them: a list of row
    arrays per graph, summed each in order and added in order."""
    route = segment_spmm.readout_plan(ids, nm)
    real = nm > 0
    out = []
    if route == "general":
        for k in range(g):
            out.append([np.flatnonzero(real & (ids == k))])
        return route, out
    prefix = ids[:int(real.sum())]
    for k in range(g):
        lo = int(np.searchsorted(prefix, k, "left"))
        hi = int(np.searchsorted(prefix, k + 1, "left"))
        n = hi - lo
        if n <= WINDOW:
            out.append([np.arange(lo, hi)])
            continue
        nw = min(WARPS, -(-n // WINDOW))
        c = -(-n // nw)
        out.append([np.arange(lo + j * c, min(hi, lo + (j + 1) * c))
                    for j in range(nw)])
    return route, out


@np.errstate(invalid="ignore")         # inf − inf is NaN, as on the card
def emulate_readout(h, ids, nm, g, kind="mean_max"):
    """The kernel's forward in float32, term by term."""
    f = h.shape[1]
    out = np.zeros((g, 2 * f if kind == "mean_max" else f), F32)
    _, graphs = _pieces(ids, nm, g)
    for k, parts in enumerate(graphs):
        total = None
        for rows in parts:
            s, c, m = np.zeros(f, F32), F32(0), np.full(f, NEG, F32)
            for r in rows:
                s = s + h[r] * nm[r]
                c = F32(c + nm[r])
                m = _max_nan(m, h[r])
            if total is None:
                total = (s, c, m)
            else:
                total = (total[0] + s, F32(total[1] + c), _max_nan(total[2], m))
        s, c, m = total
        out[k, :f] = s / max(c, F32(1))
        if kind == "mean_max":
            out[k, f:] = m if c > 0 else 0.0
    return out


def emulate_readout_backward(h, ids, nm, z, gz, kind="mean_max"):
    """The kernel's gradient in float32: the count in the forward's order,
    the ties, then ``w · fa + eq · fb`` rounded term by term; 0 on the
    rows of no graph."""
    f = h.shape[1]
    g = z.shape[0]
    dh = np.zeros_like(h)
    _, graphs = _pieces(ids, nm, g)
    for k, parts in enumerate(graphs):
        c = None
        for rows in parts:
            cp = F32(0)
            for r in rows:
                cp = F32(cp + nm[r])
            c = cp if c is None else F32(c + cp)
        rows = np.concatenate(parts)
        fa = gz[k, :f] / max(c, F32(1))
        if kind == "mean_max":
            eq = (h[rows] == z[k, f:]).astype(F32)
            ties = eq.sum(axis=0, dtype=F32)
            fb = gz[k, f:] / np.maximum(ties, F32(1))
        for i, r in enumerate(rows):
            d = nm[r] * fa
            if kind == "mean_max":
                d = d + eq[i] * fb
            dh[r] = d
    return dh


# ---------------------------------------------------------------------------
# the references
# ---------------------------------------------------------------------------

def _plain(h, ids, nm, g, kind="mean_max"):
    return ref.segment_readout_ref(*(torch.as_tensor(a) for a in (h, ids, nm)),
                                   g, kind=kind).numpy()


def _jax_ref(h, ids, nm, g, kind="mean_max"):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jref
    return np.asarray(jref.segment_readout_ref(
        jnp.asarray(h), jnp.asarray(ids), jnp.asarray(nm), g, kind=kind))


def _pallas(h, ids, nm, g, kind="mean_max"):
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.segment_spmm import segment_readout_pallas
    return np.asarray(segment_readout_pallas(
        jnp.asarray(h), jnp.asarray(ids), jnp.asarray(nm), g, kind=kind,
        interpret=True))


def _close_nan(got, want, rtol=RTOL, atol=ATOL):
    """NaN in the same places, infinities equal, the rest close."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    inf = np.isinf(want)
    np.testing.assert_array_equal(got[inf], want[inf])
    fin = ~np.isnan(want) & ~inf
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# the forward's order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["mean", "mean_max"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_readout_order_matches_pallas_and_references(case, kind):
    _, h, ids, nm, g = case
    got = emulate_readout(h, ids, nm, g, kind)
    wants = [_jax_ref(h, ids, nm, g, kind), _plain(h, ids, nm, g, kind)]
    if set(np.unique(nm)) <= {0.0, 1.0}:
        # the Pallas kernel selects real rows and counts each as 1,
        # whatever its mask value
        wants.append(_pallas(h, ids, nm, g, kind))
    for want in wants:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_readout_window_graphs_are_the_plain_sum_bit_for_bit(case):
    """A graph of at most one window, and every graph on the general
    route, is summed in the plain version's order: the same bits."""
    _, h, ids, nm, g = case
    got = emulate_readout(h, ids, nm, g)
    want = _plain(h, ids, nm, g)
    route, graphs = _pieces(ids, nm, g)
    short = [k for k, parts in enumerate(graphs) if len(parts) == 1]
    assert short
    np.testing.assert_array_equal(got[short], want[short])
    if route == "general":
        assert len(short) == g


@pytest.mark.parametrize("name", list(NONFINITE))
def test_readout_order_places_nan_and_inf_as_the_references(name):
    """Fault C1: a NaN of a real row reaches both halves of its graph, and
    only there, in the emulation as in the JAX reference and the plain
    version; ±inf likewise."""
    h, ids, nm, g = NONFINITE[name]
    got = emulate_readout(h, ids, nm, g)
    for want in (_jax_ref(h, ids, nm, g), _plain(h, ids, nm, g)):
        _close_nan(got, want)
    if name == "C1":
        assert np.isnan(got[0, 6]) and np.isnan(got[0, 2])
        assert np.isfinite(got[1]).all()


def test_readout_column_of_minus_inf_reads_finfo_min():
    """A column whose every real value is −inf: the max starts at
    finfo.min, as the plain version and the Pallas kernel start it (the
    JAX reference's segment_max starts at −inf)."""
    h, ids, nm = _runs([4, 6], 12, 3, seed=7)
    h[:10, 1] = -np.inf
    got = emulate_readout(h, ids, nm, 2)
    _close_nan(got, _plain(h, ids, nm, 2))
    np.testing.assert_array_equal(got[:, 4], NEG)


def test_readout_empty_graphs_read_exact_zero():
    h, ids, nm = _runs([0, 7, 0, 40, 0], 64, 5, seed=8)
    got = emulate_readout(h, ids, nm, 6)
    empty = [0, 2, 4, 5]
    np.testing.assert_array_equal(got[empty], 0.0)
    np.testing.assert_array_equal(_plain(h, ids, nm, 6)[empty], 0.0)


@pytest.mark.parametrize("layout,route", [
    ("runs", "runs"), ("random", "general"), ("empty", "runs"),
    ("masked-inside", "general"), ("unmasked-tail", "general")])
def test_readout_plan_names_the_route(layout, route):
    if layout in ("runs", "random", "empty"):
        _, ids, nm = _readout_case("mean_max", 300, 4, 12, layout)
    else:
        _, ids, nm = _runs([3, 5, 9], 30, 2, seed=9)
        if layout == "masked-inside":
            nm[4] = 0.0
        else:
            nm[-1] = 1.0                          # a real row after the pad
    assert segment_spmm.readout_plan(ids, nm) == route
    assert segment_spmm.readout_plan(torch.as_tensor(ids),
                                     torch.as_tensor(nm)) == route


def test_readout_plan_takes_a_packed_bin_as_runs():
    from repro_torch.core.batching import collate_packed, pack_graphs
    from repro_torch.dataset.builder import synthetic_samples
    samples = synthetic_samples(40, seed=3, n_min=16, n_max=200)
    chunk = [samples[j] for j in pack_graphs(samples, 1024, None, None)[0]]
    batch = collate_packed(chunk, 1024, 2048, 64)
    assert segment_spmm.readout_plan(batch["graph_ids"],
                                     batch["mask"]) == "runs"


# ---------------------------------------------------------------------------
# the gradient
# ---------------------------------------------------------------------------

def _grad_cases():
    """(id, h, ids, nm, G): small integers, so maxima tie; fractional
    masks; empty graphs; a graph longer than one window."""
    rng = np.random.default_rng(30)
    out = []
    h, ids, nm = _runs([9, 0, 14, 6], 40, 5, seed=10)
    out.append(("ties", np.round(h).astype(F32), ids, nm, 5))
    h, ids, nm = _runs([9, 0, 14, 6], 40, 5, seed=11, frac=True)
    out.append(("fractional", np.round(h).astype(F32), ids, nm, 5))
    h, ids, nm = _runs([0, 3, 0, 0], 12, 4, seed=12)
    out.append(("empty", np.round(h).astype(F32), ids, nm, 6))
    h, ids, nm = _runs([5, 90, 3], 110, 6, seed=13)
    out.append(("long", np.round(h * 2).astype(F32), ids, nm, 3))
    h = rng.integers(-2, 3, (50, 4)).astype(F32)
    out.append(("random", h, rng.integers(0, 5, 50).astype(np.int32),
                (rng.random(50) < 0.8).astype(F32), 5))
    return out


GRAD_CASES = _grad_cases()
GRAD_IDS = [c[0] for c in GRAD_CASES]


@pytest.mark.parametrize("kind", ["mean", "mean_max"])
@pytest.mark.parametrize("case", GRAD_CASES, ids=GRAD_IDS)
def test_readout_backward_plain_matches_jax_grad(case, kind):
    import jax
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    _, h, ids, nm, g = case
    z = _plain(h, ids, nm, g, kind)
    gz = np.random.default_rng(g).standard_normal(z.shape).astype(F32)
    got = ref.segment_readout_backward_ref(
        *(torch.as_tensor(a) for a in (h, ids, nm, z, gz)), kind=kind).numpy()
    ji, jm = jnp.asarray(ids), jnp.asarray(nm)
    want = jax.grad(lambda x: jnp.sum(
        jref.segment_readout_ref(x, ji, jm, g, kind=kind) * gz))(
            jnp.asarray(h))
    np.testing.assert_allclose(got, np.asarray(want), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(
        emulate_readout_backward(h, ids, nm, z, gz, kind), got, rtol=RTOL,
        atol=ATOL)


@pytest.mark.parametrize("kind", ["mean", "mean_max"])
def test_readout_backward_gradcheck_float64(kind):
    _, h, ids, nm, g = GRAD_CASES[1]
    # finite differences cannot cross a tie: lift the maxima apart
    h = h + np.random.default_rng(3).random(h.shape) * 0.1
    x = torch.as_tensor(h, dtype=torch.float64).requires_grad_(True)
    i, m = torch.as_tensor(ids), torch.as_tensor(nm, dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda v: ops.segment_readout(v, i, m, g, kind=kind), (x,), eps=1e-6,
        atol=1e-6, rtol=1e-5)


def test_readout_backward_runs_no_gather_or_scatter(monkeypatch):
    """``SegmentReadout.backward`` is one call of the readout's own
    gradient: no gather, scatter or CSR build."""
    for name in ("segment_gather_ref", "segment_scatter_ref", "dst_csr_ref"):
        monkeypatch.setattr(ref, name, lambda *a, _n=name, **k: pytest.fail(
            f"the readout's backward called {_n}"))
    _, h, ids, nm, g = GRAD_CASES[0]
    x = torch.as_tensor(h).requires_grad_(True)
    ops.segment_readout(x, torch.as_tensor(ids), torch.as_tensor(nm), g
                        ).sum().backward()
    assert torch.isfinite(x.grad).all()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


ALL_CARD = CASES + [(k, *v) for k, v in NONFINITE.items()]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mean", "mean_max"])
@pytest.mark.parametrize("case", ALL_CARD, ids=[c[0] for c in ALL_CARD])
def test_readout_kernel_on_card(case, kind, cuda_dev):
    """Two runs the same bits, the emulation's bits, the plain version's
    NaN and inf, and the route ``readout_plan`` names."""
    _, h, ids, nm, g = case
    t = [torch.as_tensor(a, device=cuda_dev) for a in (h, ids, nm)]
    before = segment_spmm.readout_route_counts(cuda_dev)["forward"]
    got = segment_spmm.segment_readout_cuda(*t, g, kind=kind)
    again = segment_spmm.segment_readout_cuda(*t, g, kind=kind)
    want = ref.segment_readout_ref(*t, g, kind=kind)
    after = segment_spmm.readout_route_counts(cuda_dev)["forward"]
    assert _same_bits(got, again)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  emulate_readout(h, ids, nm, g, kind))
    _close_nan(got.cpu().numpy(), want.cpu().numpy(), CARD_RTOL, CARD_ATOL)
    route = segment_spmm.readout_plan(ids, nm)
    assert {r: after[r] - before[r] for r in after} == {
        r: 2 * (r == route) for r in after}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mean", "mean_max"])
@pytest.mark.parametrize("case", GRAD_CASES + CASES[:4],
                         ids=GRAD_IDS + CASE_IDS[:4])
def test_readout_backward_kernel_on_card(case, kind, cuda_dev):
    _, h, ids, nm, g = case
    t = [torch.as_tensor(a, device=cuda_dev) for a in (h, ids, nm)]
    z = ref.segment_readout_ref(*t, g, kind=kind)
    gz = torch.as_tensor(np.random.default_rng(g).standard_normal(
        tuple(z.shape)).astype(F32), device=cuda_dev)
    before = segment_spmm.readout_route_counts(cuda_dev)["backward"]
    got = segment_spmm.segment_readout_backward_cuda(*t, z, gz, kind=kind)
    again = segment_spmm.segment_readout_backward_cuda(*t, z, gz, kind=kind)
    want = ref.segment_readout_backward_ref(*t, z, gz, kind=kind)
    after = segment_spmm.readout_route_counts(cuda_dev)["backward"]
    assert _same_bits(got, again)
    np.testing.assert_array_equal(got.cpu().numpy(), emulate_readout_backward(
        h, ids, nm, z.cpu().numpy(), gz.cpu().numpy(), kind))
    torch.testing.assert_close(got, want, rtol=CARD_RTOL, atol=CARD_ATOL)
    route = segment_spmm.readout_plan(ids, nm)
    assert {r: after[r] - before[r] for r in after} == {
        r: 2 * (r == route) for r in after}


@pytest.mark.cuda
def test_readout_backward_launches_one_kernel_on_card(cuda_dev):
    _, h, ids, nm, g = GRAD_CASES[0]
    x = torch.as_tensor(h, device=cuda_dev).requires_grad_(True)
    wrappers = [segment_spmm.segment_readout_backward_cuda,
                segment_spmm.segment_gather_cuda,
                segment_spmm.segment_scatter_cuda, segment_spmm.dst_csr_cuda]
    before = [w.launches for w in wrappers]
    ops.segment_readout(x, torch.as_tensor(ids, device=cuda_dev),
                        torch.as_tensor(nm, device=cuda_dev), g
                        ).sum().backward()
    assert [w.launches - b for w, b in zip(wrappers, before)] == [1, 0, 0, 0]
