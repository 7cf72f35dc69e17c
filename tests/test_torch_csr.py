"""The destination-sorted CSR and the segmented sums of
``csrc/segment_aggregate.cu`` (B5's aggregate, B6's scatter).

On the CPU: ``ref.dst_csr_ref`` against numpy's stable argsort and
``np.bincount``; a float32 emulation of each route's order of addition —
ascending CSR order (a warp a row on the wide routes, a thread a row on
the narrow one), a segment longer than the route's chunk summed in the
pieces that the batch row's entries, cut every chunk, make of it (on the
narrow route a warp's lanes one entry each, meeting in a fixed shuffle
tree), the pieces added in order by groups of 16 and the groups' sums in
order, the division by
``max(deg, 1)`` in registers — held against
``segment_aggregate_pallas`` / ``segment_scatter_pallas`` in interpret
mode and against the plain versions, to 1e-5 relative / 1e-6 absolute,
with NaN and inf placed as the plain versions place them; and
``segment_plan``'s choices at the training path's shapes. On a card
(tests marked ``cuda``): every route against the plain versions to 1e-4
absolute + 1e-4 relative, two runs of each route to the same bits, and
the card's CSR equal to ``dst_csr_ref``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref, segment_spmm  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6              # emulation vs Pallas and plain, float32
CARD_RTOL = CARD_ATOL = 1e-4         # CUDA kernel vs plain version
F32 = np.float32


# ---------------------------------------------------------------------------
# inputs (numpy, from a seed)
# ---------------------------------------------------------------------------

def _edges(b, n, e, seed, pad=0.25, weighted=True, hub=None):
    """``[B, E, 2]`` edges ending in padding ((0, 0), weight 0), with a
    self-loop and a duplicate in every row; ``hub=(d, k)`` sends k real
    edges of row 0 into destination d."""
    rng = np.random.default_rng(seed)
    edges = np.zeros((b, e, 2), np.int32)
    em = np.zeros((b, e), F32)
    for i in range(b):
        real = e - int(e * pad)
        edges[i, :real] = rng.integers(0, n, (real, 2))
        em[i, :real] = rng.uniform(0.2, 2.0, real) if weighted else 1.0
        if real >= 2:
            edges[i, 0, 1] = edges[i, 0, 0]
            edges[i, 1] = edges[i, 0]
    if hub is not None:
        d, k = hub
        edges[0, 2:2 + k, 1] = d
    return edges, em


# ---------------------------------------------------------------------------
# the CSR
# ---------------------------------------------------------------------------

def _numpy_csr(dst, n, src=None):
    b, e = dst.shape
    live = (dst >= 0) & (dst < n)
    if src is not None:
        live &= (src >= 0) & (src < n)
    rowptr = np.zeros((b, n + 1), np.int64)
    perm = np.full((b, e), -1, np.int64)
    for i in range(b):
        key = np.where(live[i], dst[i], n)
        order = np.argsort(key, kind="stable")
        cnt = np.bincount(dst[i][live[i]], minlength=n) if n else \
            np.zeros(0, np.int64)
        rowptr[i, 1:] = np.cumsum(cnt)
        perm[i, :rowptr[i, n]] = order[:rowptr[i, n]]
    return rowptr, perm


def _csr_cases():
    out = []
    for b, n, e in ((1, 1, 1), (3, 37, 129), (3, 130, 300), (2, 5, 0),
                    (1, 40, 8)):
        edges, _ = _edges(b, n, e, seed=b + n + e) if e else (
            np.zeros((b, 0, 2), np.int32), None)
        out.append((f"b{b}-n{n}-e{e}", edges, n))
    edges, _ = _edges(3, 23, 64, seed=9)
    edges[0, 5, 1] = 23          # destination past N
    edges[1, 6, 1] = -1          # negative destination
    edges[2, 7, 0] = 99          # source past N
    out.append(("out-of-range", edges, 23))
    return out


CSR_CASES = _csr_cases()


@pytest.mark.parametrize("with_src", [False, True], ids=["dst", "dst+src"])
@pytest.mark.parametrize("case", CSR_CASES, ids=[c[0] for c in CSR_CASES])
def test_dst_csr_ref_matches_numpy(case, with_src):
    """Duplicates, self-loops, padded and isolated rows, out-of-range
    indices and E = 0, read through the strided column views of
    ``[B, E, 2]`` edges."""
    _, edges, n = case
    e = torch.as_tensor(edges)
    src = e[..., 0] if with_src else None
    rowptr, perm = ref.dst_csr_ref(e[..., 1], n, src)
    want_rp, want_perm = _numpy_csr(edges[..., 1], n,
                                    edges[..., 0] if with_src else None)
    assert rowptr.dtype == perm.dtype == torch.int32
    np.testing.assert_array_equal(rowptr.numpy(), want_rp)
    np.testing.assert_array_equal(perm.numpy(), want_perm)
    for i in range(edges.shape[0]):          # each segment is ascending
        for d in range(n):
            seg = want_perm[i, want_rp[i, d]:want_rp[i, d + 1]]
            assert (np.diff(seg) > 0).all()
            assert (edges[i, seg, 1] == d).all()


# ---------------------------------------------------------------------------
# a float32 emulation of the routes' order of addition
# ---------------------------------------------------------------------------

def _sequential(terms, w):
    """Ascending order from +0, each term rounded before it is added."""
    acc = np.zeros(terms.shape[1], F32)
    deg = F32(0)
    for t, wt in zip(terms, w):
        acc = (acc + t).astype(F32)
        deg = F32(deg + wt)
    return acc, deg


def _tree(terms, w):
    """A warp's lanes one entry each (the rest +0), then lane i adds lane
    i + 16, i + 8, 4, 2, 1 (``__shfl_down_sync``): lane 0's sums."""
    lanes = np.zeros((32, terms.shape[1]), F32)
    lane_w = np.zeros(32, F32)
    lanes[:len(terms)] = (np.zeros_like(terms) + terms).astype(F32)
    lane_w[:len(w)] = w
    off = 16
    while off:
        lanes[:off] = (lanes[:off] + lanes[off:2 * off]).astype(F32)
        lane_w[:off] = (lane_w[:off] + lane_w[off:2 * off]).astype(F32)
        off //= 2
    return lanes[0], lane_w[0]


#: chunks whose partials one warp adds before the groups are added
GROUP = 16


def _in_order(parts):
    """((0 + p0) + p1) + ... of (sum, degree) partials."""
    acc, dg = np.zeros_like(parts[0][0]), F32(0)
    for p, pd in parts:
        acc = (acc + p).astype(F32)
        dg = F32(dg + pd)
    return acc, dg


def emulate_segment_sum(route, dst, em, msg_rows, n, mean, src=None):
    """``out, deg`` as the route adds them: ``msg_rows`` [B, E, F] (the
    scatter's messages) or, with ``src``, [B, N, F] (h, read at src)."""
    b, e = dst.shape
    f = msg_rows.shape[-1]
    chunk = segment_spmm.SEGMENT_CHUNK[route]
    piece = _tree if route == "narrow" else _sequential
    rowptr, perm = ref.dst_csr_ref(torch.as_tensor(dst), n,
                                   None if src is None else
                                   torch.as_tensor(src))
    rowptr, perm = rowptr.numpy(), perm.numpy()
    out = np.zeros((b, n, f), F32)
    deg = np.zeros((b, n), F32)
    with np.errstate(invalid="ignore", over="ignore"):
        for i in range(b):
            for d in range(n):
                seg = perm[i, rowptr[i, d]:rowptr[i, d + 1]]
                rows = msg_rows[i, seg if src is None else src[i, seg]]
                w = em[i, seg]
                terms = (w[:, None] * rows).astype(F32)
                if len(seg) <= chunk:
                    acc, dg = _sequential(terms, w)
                else:
                    # the row's entries cut every `chunk`: the segment's
                    # pieces, each summed alone, added in order by groups
                    # of GROUP, and the groups' sums added in order
                    start = rowptr[i, d]
                    parts = []
                    for c0 in range(start // chunk * chunk, start + len(seg),
                                    chunk):
                        lo, hi = max(c0, start) - start, c0 + chunk - start
                        parts.append(piece(terms[lo:hi], w[lo:hi]))
                    groups = [_in_order(parts[g:g + GROUP])
                              for g in range(0, len(parts), GROUP)]
                    acc, dg = _in_order(groups)
                if mean:
                    acc = (acc / (F32(1) if dg < 1 else dg)).astype(F32)
                out[i, d], deg[i, d] = acc, dg
    return out, deg


def _route_cases():
    """(id, route, b, n, e, f, hub): every route at F in {1, 4, 5} and 512,
    each with a segment split into chunks (a hub, and the padding pile)."""
    return [
        ("narrow-f1", "narrow", 2, 37, 400, 1, (3, 150)),
        ("narrow-f4", "narrow", 1, 40, 420, 4, (7, 260)),
        ("narrow-f5", "narrow", 3, 20, 600, 5, None),
        ("wide_vec-f512", "wide_vec", 1, 24, 120, 512, (5, 70)),
        ("wide_scalar-f512", "wide_scalar", 2, 20, 90, 512, (2, 50)),
        ("wide_scalar-f13", "wide_scalar", 3, 11, 100, 13, (4, 33)),
    ]


ROUTE_CASES = _route_cases()


def _route_inputs(case, seed=0, grid=True):
    """Rows and weights for a route case. On the grid (the default) the
    rows lie on a 1/256 grid in (-4, 4) and the weights in [0.2, 2] on a
    1/16 grid, so that every order of addition gives the same sum: the
    cases then hold what each route adds (its CSR, its chunks, the mean)
    against Pallas's one-hot products and the plain versions exactly (on
    Gaussian rows of 512 columns, tens of terms a row, the plain version
    itself can sit more than 1e-6 from Pallas). Off the grid they are
    Gaussian, for the order of addition itself."""
    _, route, b, n, e, f, hub = case
    edges, em = _edges(b, n, e, seed=seed + n + f, hub=hub)
    rng = np.random.default_rng(seed + f)
    h = rng.standard_normal((b, n, f)).astype(F32)
    msgs = rng.standard_normal((b, e, f)).astype(F32)
    if grid:
        h, msgs = (np.clip(np.round(a * 256) / 256, -3.99, 3.99).astype(F32)
                   for a in (h, msgs))
        em = (np.round(em * 16) / 16).astype(F32)
    return edges, em, h, msgs


def _close(got, want, rtol=RTOL, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin & ~np.isnan(want)],
                                  want[~fin & ~np.isnan(want)])
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_route_order_matches_pallas_and_plain(case):
    """Each route's emulated sums, aggregate (sum, mean and the degree) and
    scatter, against the Pallas kernels in interpret mode and the plain
    versions; the segments longer than the route's chunk take the split."""
    import jax.numpy as jnp
    from repro.kernels.segment_spmm import (segment_aggregate_pallas,
                                            segment_scatter_pallas)
    _, route, b, n, e, f, _ = case
    edges, em, h, msgs = _route_inputs(case)
    counts = np.stack([np.bincount(edges[i, :, 1], minlength=n)
                       for i in range(b)])
    assert counts.max() > segment_spmm.SEGMENT_CHUNK[route]
    dst, src = edges[..., 1].copy(), edges[..., 0].copy()
    te = torch.as_tensor(edges)
    for mode in ("sum", "mean"):
        got, gdeg = emulate_segment_sum(route, dst, em, h, n, mode == "mean",
                                        src=src)
        want = segment_aggregate_pallas(jnp.asarray(edges), jnp.asarray(em),
                                        jnp.asarray(h), mode=mode,
                                        interpret=True)
        plain, pdeg = ref.segment_aggregate_ref(
            te, torch.as_tensor(em), torch.as_tensor(h), mode,
            return_degree=True)
        _close(got, want)
        _close(got, plain)
        _close(gdeg, pdeg)
    got, _ = emulate_segment_sum(route, dst, em, msgs, n, False)
    want = segment_scatter_pallas(jnp.asarray(dst), jnp.asarray(em),
                                  jnp.asarray(msgs), n, interpret=True)
    _close(got, want)
    _close(got, ref.segment_scatter_ref(torch.as_tensor(dst),
                                        torch.as_tensor(em),
                                        torch.as_tensor(msgs), n))


@pytest.mark.parametrize("case", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_unsplit_rows_are_the_plain_sum_bit_for_bit(case):
    """Off the grid, every row of at most one chunk is the plain version's
    sequential sum (index_add_ in edge order on the CPU) bit for bit, the
    mean its division; a chunked row adds in another order, so it is held
    to 1e-5 relative and absolute (up to 260 terms a row, each of size 1).
    """
    _, route, b, n, e, f, _ = case
    edges, em, h, msgs = _route_inputs(case, grid=False)
    dst, src = edges[..., 1].copy(), edges[..., 0].copy()
    rowptr, _ = ref.dst_csr_ref(torch.as_tensor(dst), n)
    whole = np.diff(rowptr.numpy(), axis=1) <= segment_spmm.SEGMENT_CHUNK[
        route]
    assert (~whole).any()
    got, gdeg = emulate_segment_sum(route, dst, em, h, n, True, src=src)
    want, wdeg = ref.segment_aggregate_ref(
        torch.as_tensor(edges), torch.as_tensor(em), torch.as_tensor(h),
        "mean", return_degree=True)
    np.testing.assert_array_equal(got[whole], want.numpy()[whole])
    np.testing.assert_array_equal(gdeg[whole], wdeg.numpy()[whole])
    _close(got, want.numpy(), RTOL, 1e-5)
    got, _ = emulate_segment_sum(route, dst, em, msgs, n, False)
    want = ref.segment_scatter_ref(torch.as_tensor(dst), torch.as_tensor(em),
                                   torch.as_tensor(msgs), n).numpy()
    np.testing.assert_array_equal(got[whole], want[whole])
    _close(got, want, RTOL, 1e-5)


def _nonfinite_inputs(f):
    """NaN and inf in the message of a masked (weight-0) edge, NaN in the
    padding pile's message, an inf weight on a real edge, and -inf in a
    real message: NaN * 0, inf * 0 and inf * w reach their destinations."""
    edges, em, h, msgs = _route_inputs(("", "", 2, 30, 300, f, (4, 140)),
                                       seed=11)
    edges[1, edges[1, :, 0] == 29, 0] = 1     # no real edge leaves 29
    edges[1, 2] = (29, 5)
    em[1, 2] = 0.0
    h[1, 29, 0] = np.nan
    h[1, 29, -1] = np.inf
    msgs[1, 2, 0] = np.nan
    msgs[1, 2, -1] = -np.inf
    msgs[0, -1, 0] = np.nan                   # a padded edge (0, 0)
    em[0, 3] = np.inf
    msgs[0, 4, -1] = -np.inf
    return edges, em, h, msgs


@pytest.mark.parametrize("f", [1, 4, 5, 512])
def test_route_order_places_nan_and_inf_as_the_plain_versions(f):
    """Weight-0 edges stay in their segments, so the emulation places NaN
    and inf exactly where the plain versions and the JAX package's do,
    on a split segment too."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    edges, em, h, msgs = _nonfinite_inputs(f)
    n = h.shape[1]
    dst, src = edges[..., 1].copy(), edges[..., 0].copy()
    routes = ["narrow"] if f <= 8 else ["wide_vec", "wide_scalar"]
    for route in routes:
        for mode in ("sum", "mean"):
            got, _ = emulate_segment_sum(route, dst, em, h, n,
                                         mode == "mean", src=src)
            plain = ref.segment_aggregate_ref(
                torch.as_tensor(edges), torch.as_tensor(em),
                torch.as_tensor(h), mode).numpy()
            jax_plain = np.asarray(jref.segment_aggregate_ref(
                jnp.asarray(edges), jnp.asarray(em), jnp.asarray(h),
                mode=mode))
            assert np.isnan(got[1, 5, 0])
            _close(got, plain)
            _close(got, jax_plain)
        got, _ = emulate_segment_sum(route, dst, em, msgs, n, False)
        plain = ref.segment_scatter_ref(torch.as_tensor(dst),
                                        torch.as_tensor(em),
                                        torch.as_tensor(msgs), n).numpy()
        assert np.isnan(got[0, 0, 0]) and np.isnan(got[1, 5, 0])
        _close(got, plain)


def test_segment_plan_at_the_path_shapes():
    """The packed step's 512-wide rows on float4 lanes, GAT's per-head
    scores and the degree on the narrow route, the packed readout's
    backward (1 + 512 columns) on scalar lanes; the padding pile splits."""
    plan = segment_spmm.segment_plan
    assert plan(512, 8192, True) == ("wide_vec", 4, 32, True)
    assert plan(512, 8192, False) == ("wide_scalar", 8, 32, True)
    assert plan(4, 8192, True) == ("narrow", 0, 16, True)
    assert plan(1, 4096, True) == ("narrow", 0, 16, True)
    assert plan(513, 4096, True) == ("wide_scalar", 8, 32, True)
    assert plan(1025, 40, True).units_per_lane == 8
    assert plan(16, 30, True) == ("wide_vec", 1, 32, False)
    assert plan(8, 16, True) == ("narrow", 0, 16, False)
    assert plan(9, 33, True) == ("wide_scalar", 1, 32, True)
    for f in range(1, 600, 7):
        p = plan(f, 100, True)
        units = f // 4 if p.route == "wide_vec" else f
        assert p.route == "narrow" or 32 * p.units_per_lane >= min(units, 256)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    from repro_torch.core.gnn import resolve_device
    return resolve_device("cuda")


def _on_card(case, dev, aligned=True):
    """The wrappers' outputs for a route case: aggregate (sum with degree,
    mean) and scatter; an unaligned view of the rows forces the scalar
    lanes."""
    edges, em, h, msgs = _route_inputs(case)
    te, tm = torch.as_tensor(edges, device=dev), torch.as_tensor(em,
                                                                 device=dev)
    th, tg = torch.as_tensor(h, device=dev), torch.as_tensor(msgs,
                                                              device=dev)
    if not aligned:
        th = torch.empty(th.numel() + 1, device=dev)[1:].view(
            th.shape).copy_(th)
        tg = torch.empty(tg.numel() + 1, device=dev)[1:].view(
            tg.shape).copy_(tg)
    n = case[3]
    got = [*segment_spmm.segment_aggregate_cuda(te, tm, th, "sum",
                                                return_degree=True),
           segment_spmm.segment_aggregate_cuda(te, tm, th, "mean"),
           segment_spmm.segment_scatter_cuda(te[..., 1], tm, tg, n)]
    want = [*ref.segment_aggregate_ref(te, tm, th, "sum",
                                       return_degree=True),
            ref.segment_aggregate_ref(te, tm, th, "mean"),
            ref.segment_scatter_ref(te[..., 1], tm, tg, n)]
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("case", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_routes_match_plain_on_card(case, cuda_dev):
    route = case[1]
    before = dict(segment_spmm.segment_scatter_cuda.route_launches)
    got, want = _on_card(case, cuda_dev, aligned=route != "wide_scalar")
    after = segment_spmm.segment_scatter_cuda.route_launches
    assert after[route] == before[route] + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w.cpu(), rtol=CARD_RTOL,
                                   atol=CARD_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_routes_repeat_bitwise_on_card(case, cuda_dev):
    """Two runs of each route give the same bits: no atomic decides an
    order of addition."""
    aligned = case[1] != "wide_scalar"
    first, _ = _on_card(case, cuda_dev, aligned)
    second, _ = _on_card(case, cuda_dev, aligned)
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 4, 5, 512])
def test_nonfinite_on_card(f, cuda_dev):
    edges, em, h, msgs = (torch.as_tensor(a, device=cuda_dev)
                          for a in _nonfinite_inputs(f))
    n = h.shape[1]
    for mode in ("sum", "mean"):
        got = segment_spmm.segment_aggregate_cuda(edges, em, h, mode)
        _close(got.cpu(), ref.segment_aggregate_ref(edges, em, h, mode).cpu(),
               CARD_RTOL, CARD_ATOL)
    got = segment_spmm.segment_scatter_cuda(edges[..., 1], em, msgs, n)
    _close(got.cpu(), ref.segment_scatter_ref(edges[..., 1], em, msgs,
                                              n).cpu(), CARD_RTOL, CARD_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("with_src", [False, True], ids=["dst", "dst+src"])
@pytest.mark.parametrize("case", CSR_CASES, ids=[c[0] for c in CSR_CASES])
def test_dst_csr_matches_ref_on_card(case, with_src, cuda_dev):
    _, edges, n = case
    e = torch.as_tensor(edges, device=cuda_dev)
    src = e[..., 0] if with_src else None
    got = segment_spmm.dst_csr_cuda(e[..., 1], n, src)
    want = ref.dst_csr_ref(e[..., 1], n, src)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())
