"""The GAT kernels over a destination-sorted CSR (``csrc/edge_softmax.cu``,
B3, and ``csrc/gat_aggregate.cu``, B4), built once a bin by ``ops.dst_csr``.

On the CPU: a float32 emulation of each kernel's order — B4: ascending CSR
entries, each term ``(z · α) · em`` rounded apart, a segment longer than
32 entries summed in the window pieces the batch row's entries make of it,
the pieces added in order by groups of 16 and the groups in order, the
node mask after the sum; B3: a short segment's max and denominator in
ascending order by one thread, a long one's by 256 threads in a fixed tree
— held against ``fused_gat_aggregate_pallas`` / ``edge_softmax_pallas`` in
interpret mode and against the plain versions, to 1e-5 relative / 1e-6
absolute (float32 sums in another order; B3 also numpy's exp against
torch's), with NaN where the plain versions put it; B4's unsplit rows
bit-equal to the plain version's ``index_add_`` sum. Then the packed GAT
model with its shared CSR against ``repro.core.gnn`` and ``ops.dst_csr``'s
routing. On a card (tests marked ``cuda``): both kernels with the shared
CSR equal, bit for bit, to the same calls building their own and to a
second run, and within 1e-4 absolute + 1e-4 relative of the plain versions
(``expf`` and the atomics of the card's ``index_add_``); a CSR of the wrong
shape or device raises.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import gnn as tg  # noqa: E402
from repro_torch.kernels import ops, ref, segment_spmm  # noqa: E402

from test_torch_gat import SOFTMAX_CASES, _case_id, _softmax_inputs  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6              # emulation vs Pallas and plain, float32
CARD_RTOL = CARD_ATOL = 1e-4         # CUDA kernel vs plain version
F32 = np.float32
NEG = np.finfo(np.float32).min
TINY = np.finfo(np.float32).tiny


# ---------------------------------------------------------------------------
# inputs (numpy, from a seed)
# ---------------------------------------------------------------------------

def _gat_inputs(p, q, h, d, seed, pile=0, hub=None, grid=True):
    """B4's inputs: ``pile`` padded edges at (0, 0) with mask 0 at the end
    (as ``collate_packed`` pads), ``hub=(node, k)`` sending k real edges
    into one node. On the grid (the default) z lies on a 1/64 grid in
    (-4, 4) and the weights on a 1/8 grid in [0, 1), so that every order
    of addition gives the same sum; off it, Gaussian and uniform."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((p, d)).astype(F32)
    edges = rng.integers(0, p, (q, 2)).astype(np.int32)
    em = (rng.random(q) < 0.8).astype(F32)
    att = rng.random((q, h)).astype(F32)
    nm = (rng.random(p) < 0.9).astype(F32)
    if pile:
        edges[-pile:] = 0
        em[-pile:] = 0.0
    if hub is not None:
        node, k = hub
        edges[3:3 + k, 1] = node
        em[3:3 + k] = 1.0
    if grid:
        z = np.clip(np.round(z * 64) / 64, -3.98, 3.98).astype(F32)
        att = (np.floor(att * 8) / 8).astype(F32)
    return z, edges, em, att, nm


def _gat_cases():
    """(id, p, q, h, d, pile, hub): ``test_torch_gat.py``'s shapes, then
    segments split into chunks: a 2,048-edge padding pile, a 1,200-edge
    hub, both together, a pile of one group, and odd heads."""
    return [
        ("small", 64, 96, 4, 16, 0, None),
        ("odd-p", 130, 257, 2, 16, 0, None),
        ("pile-2048", 300, 2600, 4, 32, 2048, None),
        ("hub-1200", 200, 1500, 2, 16, 0, (7, 1200)),
        ("pile-and-hub", 300, 3000, 4, 16, 1000, (11, 600)),
        ("pile-one-group", 150, 700, 4, 16, 400, None),
        ("odd-heads", 90, 500, 3, 30, 120, None),
    ]


GAT_CASES = _gat_cases()


def _softmax_extra():
    """B3's segments split over a block: a 2,048-edge padding pile at
    (0, 0), a 1,200-edge hub, a NaN score on a live edge, an empty
    destination, and B = 3 rows each with its own pile."""
    out = {}
    rng = np.random.default_rng(41)
    e, n, h = 2600, 200, 4
    s = (rng.standard_normal((1, e, h)) * 3).astype(F32)
    dst = rng.integers(1, n, (1, e)).astype(np.int32)
    em = (rng.random((1, e)) < 0.8).astype(F32)
    dst[0, -2048:] = 0
    em[0, -2048:] = 0.0
    em[0, 0] = 1.0
    dst[0, 0] = 0                       # node 0 holds one live edge
    out["pile-2048"] = (s, dst, em, n)
    s2, dst2, em2 = s.copy(), rng.integers(0, n, (1, 1500)).astype(np.int32), \
        (rng.random((1, 1500)) < 0.9).astype(F32)
    dst2[0, 10:1210] = 9
    out["hub-1200"] = ((rng.standard_normal((1, 1500, 2)) * 3).astype(F32),
                       dst2, em2, n)
    s3 = s.copy()
    s3[0, 0, 1] = np.nan               # node 0's live edge, head 1
    out["nan-score-on-pile"] = (s3, dst, em, n)
    s4, m4 = s2[:, :40, :1].copy(), em2[:, :40].copy()
    d4 = rng.integers(0, 12, (1, 40)).astype(np.int32)
    d4[d4 == 3] = 4                    # destination 3 gets no edge
    out["empty-destination"] = (s4, d4, m4, 12)
    b, e5 = 3, 700
    s5 = (rng.standard_normal((b, e5, h)) * 3).astype(F32)
    d5 = rng.integers(0, 60, (b, e5)).astype(np.int32)
    m5 = (rng.random((b, e5)) < 0.85).astype(F32)
    for i, pile in enumerate((300, 0, 500)):
        if pile:
            d5[i, -pile:] = 0
            m5[i, -pile:] = 0.0
    out["b3-piles"] = (s5, d5, m5, 60)
    return out


SOFTMAX_EXTRA = _softmax_extra()


# ---------------------------------------------------------------------------
# float32 emulations of the kernels' orders
# ---------------------------------------------------------------------------

def _csr(dst_row, n):
    rowptr, perm = ref.dst_csr_ref(torch.as_tensor(dst_row[None]), n)
    return rowptr.numpy()[0], perm.numpy()[0]


def _in_order(parts):
    """((0 + p0) + p1) + ..."""
    acc = np.zeros_like(parts[0])
    for x in parts:
        acc = (acc + x).astype(F32)
    return acc


def emulate_gat_aggregate(z, edges, em, att, nm):
    """``out [P, D]`` as ``gat_aggregate.cu`` adds it."""
    chunk, group = segment_spmm.GAT_CHUNK, segment_spmm.GAT_GROUP
    p, d = z.shape
    h = att.shape[1]
    heads = np.arange(d) // (d // h)
    rowptr, perm = _csr(edges[:, 1], p)
    out = np.zeros((p, d), F32)
    with np.errstate(invalid="ignore", over="ignore"):
        for i in range(p):
            s0, t0 = rowptr[i], rowptr[i + 1]
            seg = perm[s0:t0]
            src = edges[seg, 0]
            ok = (src >= 0) & (src < p)
            terms = ((z[np.where(ok, src, 0)] * att[seg][:, heads]).astype(F32)
                     * em[seg][:, None]).astype(F32)

            def piece(lo, hi):
                acc = np.zeros(d, F32)
                for j in range(lo, hi):
                    if ok[j]:
                        acc = (acc + terms[j]).astype(F32)
                return acc
            if t0 - s0 <= chunk:
                acc = piece(0, t0 - s0)
            else:
                # the row's entries cut every `chunk`: the segment's pieces,
                # added in order by groups, then the groups in order
                parts = [piece(max(c0, s0) - s0, min(c0 + chunk, t0) - s0)
                         for c0 in range(s0 // chunk * chunk, t0, chunk)]
                sums = [_in_order(parts[g:g + group])
                        for g in range(0, len(parts), group)]
                acc = sums[0] if len(sums) == 1 else _in_order(sums)
            out[i] = (acc * nm[i]).astype(F32)
    return out


def _max_live(v, live):
    """The max over live entries from finfo.min, a NaN winning."""
    return np.max(np.where(live[:, None], v, NEG), axis=0, initial=NEG)


def _block_tree(p):
    """The long segment's denominator: thread t sums entries t, t + 256,
    ... in order, then each warp's lane i adds lane i + 16, 8, 4, 2, 1, and
    the warps' sums are added in warp order from +0."""
    threads = segment_spmm.SOFTMAX_BLOCK
    th = np.zeros((threads, p.shape[1]), F32)
    for t in range(threads):
        for k in range(t, p.shape[0], threads):
            th[t] = (th[t] + p[k]).astype(F32)
    warps = th.reshape(threads // 32, 32, -1)
    off = 16
    while off:
        warps[:, :off] = (warps[:, :off] + warps[:, off:2 * off]).astype(F32)
        off //= 2
    return _in_order(list(warps[:, 0]))


def emulate_edge_softmax(s, dst, em, n):
    """``att [B, E, H]`` as ``edge_softmax.cu`` computes it."""
    b, e, h = s.shape
    out = np.zeros((b, e, h), F32)
    with np.errstate(invalid="ignore", over="ignore", under="ignore"):
        for bi in range(b):
            rowptr, perm = _csr(dst[bi], n)
            for d in range(n):
                seg = perm[rowptr[d]:rowptr[d + 1]]
                if not len(seg):
                    continue
                w, v = em[bi, seg], s[bi, seg]
                live = w > 0
                m = _max_live(v, live)
                ms = np.where(m > NEG, m, F32(0)).astype(F32)
                sc = np.where(live[:, None], v, NEG).astype(F32)
                p = (np.exp((sc - ms).astype(F32)).astype(F32)
                     * w[:, None]).astype(F32)
                if len(seg) <= segment_spmm.SOFTMAX_SHORT:
                    den = _in_order(list(p))
                else:
                    den = _block_tree(p)
                den = np.where(den < TINY, TINY, den).astype(F32)
                out[bi, seg] = (p / den).astype(F32)
    return out


def _close(got, want, rtol=RTOL, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)


def _pallas():
    import jax.numpy as jnp
    from repro.kernels.segment_spmm import (edge_softmax_pallas,
                                            fused_gat_aggregate_pallas)
    return edge_softmax_pallas, fused_gat_aggregate_pallas, jnp.asarray


# ---------------------------------------------------------------------------
# B4: the emulation vs Pallas and the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", GAT_CASES, ids=[c[0] for c in GAT_CASES])
def test_gat_aggregate_order_matches_pallas_and_plain(case):
    """On the grid every order of addition gives the same sum, so the
    emulated order (its CSR, its pieces, its two levels, the mask) is held
    against Pallas's one-hot products and the plain version exactly to
    float32's 1e-5 / 1e-6."""
    _, p, q, h, d, pile, hub = case
    arrays = _gat_inputs(p, q, h, d, seed=p + q, pile=pile, hub=hub)
    _, gat_pallas, asarray = _pallas()
    got = emulate_gat_aggregate(*arrays)
    want = np.asarray(gat_pallas(*[asarray(a) for a in arrays],
                                 interpret=True))
    plain = ref.fused_gat_aggregate_ref(
        *[torch.as_tensor(a) for a in arrays]).numpy()
    _close(got, want)
    _close(got, plain)


@pytest.mark.parametrize("case", GAT_CASES, ids=[c[0] for c in GAT_CASES])
def test_gat_aggregate_unsplit_rows_are_the_plain_sum_bit_for_bit(case):
    """Off the grid, every row of at most one chunk is the plain version's
    sequential index_add_ sum times the mask, bit for bit; a split row adds
    in pieces, so it is held to 1e-5 relative and absolute (up to 2,048
    terms of size 1)."""
    _, p, q, h, d, pile, hub = case
    arrays = _gat_inputs(p, q, h, d, seed=p + q + 1, pile=pile, hub=hub,
                         grid=False)
    z, edges = arrays[:2]
    rowptr, _ = _csr(edges[:, 1], p)
    whole = np.diff(rowptr) <= segment_spmm.GAT_CHUNK
    assert whole.any()
    if pile or hub:
        assert (~whole).any()
    got = emulate_gat_aggregate(*arrays)
    plain = ref.fused_gat_aggregate_ref(
        *[torch.as_tensor(a) for a in arrays]).numpy()
    np.testing.assert_array_equal(got[whole], plain[whole])
    _close(got, plain, RTOL, 1e-5)


def test_gat_aggregate_order_places_nan_as_the_plain_version():
    """A NaN in the padded source z[0] reaches node 0 through NaN · 0 (the
    padded edges stay in their segment), a NaN weight's row goes NaN, and
    the node mask multiplies after the sum (NaN · 0 stays NaN)."""
    z, edges, em, att, nm = _gat_inputs(120, 900, 4, 16, seed=3, pile=500)
    z[0, 5] = np.nan
    em[2] = np.nan
    nm[edges[2, 1]] = 0.0
    got = emulate_gat_aggregate(z, edges, em, att, nm)
    plain = ref.fused_gat_aggregate_ref(
        *[torch.as_tensor(a) for a in (z, edges, em, att, nm)]).numpy()
    assert np.isnan(got[0, 5]) and np.isnan(got[edges[2, 1]]).all()
    _close(got, plain)


# ---------------------------------------------------------------------------
# B3: the emulation vs Pallas and the plain version
# ---------------------------------------------------------------------------

SOFTMAX_ALL = ([(_case_id(c), _softmax_inputs(c)) for c in SOFTMAX_CASES]
               + list(SOFTMAX_EXTRA.items()))


@pytest.mark.parametrize("name,inputs", SOFTMAX_ALL,
                         ids=[c[0] for c in SOFTMAX_ALL])
def test_edge_softmax_order_matches_pallas_and_plain(name, inputs):
    """Short segments by one thread in edge order, long ones by a block's
    tree: the same weights as Pallas and the plain version to float32's
    1e-5 / 1e-6, NaN where the plain version puts it, masked edges exact
    zeros. (A NaN score is held against the plain version alone: Pallas's
    one-hot products carry it into every destination of its tile.)"""
    s, dst, em, n = inputs
    sm_pallas, _, asarray = _pallas()
    got = emulate_edge_softmax(s, dst, em, n)
    plain = ref.edge_softmax_ref(*[torch.as_tensor(a) for a in (s, dst, em)],
                                 n).numpy()
    _close(got, plain)
    if not np.isnan(s).any():
        want = np.asarray(sm_pallas(asarray(s), asarray(dst), asarray(em), n,
                                    interpret=True))
        _close(got, want)
    masked = (em == 0)[..., None] & ~np.isnan(plain)
    assert (got[masked] == 0).all()


def test_edge_softmax_extra_cases_split_over_a_block():
    """The extra cases do take the long path, and the NaN poisons every
    weight of its destination's head only."""
    for name in ("pile-2048", "hub-1200", "b3-piles"):
        s, dst, em, n = SOFTMAX_EXTRA[name]
        counts = np.stack([np.bincount(r, minlength=n) for r in dst])
        assert counts.max() > segment_spmm.SOFTMAX_BLOCK
    s, dst, em, n = SOFTMAX_EXTRA["nan-score-on-pile"]
    got = emulate_edge_softmax(s, dst, em, n)
    node0 = dst[0] == 0
    assert np.isnan(got[0, node0, 1]).all()
    assert not np.isnan(got[0, ~node0]).any()
    assert not np.isnan(got[0, :, [0, 2, 3]]).any()


# ---------------------------------------------------------------------------
# the packed GAT model with its shared CSR, and ops.dst_csr
# ---------------------------------------------------------------------------

def test_gat_stack_shares_one_csr_and_matches_jax(monkeypatch):
    """``_fused_mp_stack`` builds one CSR a bin and hands it to every
    layer's edge softmax and aggregate; the predictions equal
    ``repro.core.gnn``'s to 1e-5 relative / 1e-6 absolute."""
    jax = pytest.importorskip("jax")
    from repro.core import gnn as jg
    from repro.core.batching import collate_packed
    from repro.dataset.builder import synthetic_samples
    jcfg = jg.PMGNSConfig(variant="gat", hidden=64, n_gnn_blocks=3,
                          n_fc_blocks=2, layout="packed")
    tcfg = tg.PMGNSConfig(**dataclasses.asdict(jcfg))
    tree = jax.tree_util.tree_map(
        np.asarray, jg.pmgns_init(jax.random.PRNGKey(5), jcfg))
    batch = {k: v for k, v in collate_packed(
        synthetic_samples(12, seed=6, n_min=4, n_max=40)).items()
        if k not in ("y", "wt")}
    want = np.asarray(jg.pmgns_infer(
        jax.tree_util.tree_map(jax.numpy.asarray, tree), jcfg,
        {k: jax.numpy.asarray(v) for k, v in batch.items()}))
    seen = {"dst_csr": [], "edge_softmax": [], "fused_gat_aggregate": []}
    for name in seen:
        real = getattr(ref, f"{name}_ref")

        def spy(*args, _real=real, _name=name, **kw):
            out = _real(*args, **kw)
            seen[_name].append(out if _name == "dst_csr" else kw.get("csr"))
            return out
        monkeypatch.setattr(ref, f"{name}_ref", spy)
    got = tg.pmgns_infer(tg.params_from_numpy(tree, tcfg, device="cpu"),
                         tcfg, batch).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert len(seen["dst_csr"]) == 1
    csr = seen["dst_csr"][0]
    assert len(seen["edge_softmax"]) == len(seen["fused_gat_aggregate"]) == 3
    assert all(c is csr for c in seen["edge_softmax"]
               + seen["fused_gat_aggregate"])
    p = batch["x"].shape[0]
    assert tuple(csr[0].shape) == (1, p + 1)
    assert tuple(csr[1].shape) == (1, batch["edges"].shape[0])


def test_ops_dst_csr_routes_cpu_tensors_to_the_plain_version():
    edges = np.random.default_rng(2).integers(0, 30, (1, 80, 2)).astype(
        np.int32)
    e = torch.as_tensor(edges)
    before = segment_spmm.dst_csr_cuda.launches
    for src in (None, e[..., 0]):
        got = ops.dst_csr(e[..., 1], 30, src)
        want = ref.dst_csr_ref(e[..., 1], 30, src)
        assert len(got) == 2
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert segment_spmm.dst_csr_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        segment_spmm.dst_csr_cuda(e[..., 1], 30)


def test_plain_versions_check_the_csr_shapes_and_ignore_it():
    s, dst, em, n = _softmax_inputs(SOFTMAX_CASES[0])
    t = [torch.as_tensor(a) for a in (s, dst, em)]
    csr = ref.dst_csr_ref(t[1], n)
    assert torch.equal(ref.edge_softmax_ref(*t, n, csr=csr),
                       ref.edge_softmax_ref(*t, n))
    with pytest.raises(ValueError, match="csr has rowptr"):
        ref.edge_softmax_ref(*t, n, csr=ref.dst_csr_ref(t[1], n + 1))
    g = [torch.as_tensor(a) for a in _gat_inputs(40, 90, 4, 16, seed=1)]
    gcsr = ref.dst_csr_ref(g[1][:, 1][None], 40)
    assert torch.equal(ref.fused_gat_aggregate_ref(*g, csr=gcsr),
                       ref.fused_gat_aggregate_ref(*g))
    with pytest.raises(ValueError, match="csr has rowptr"):
        ref.fused_gat_aggregate_ref(*g, csr=(gcsr[0], gcsr[1][:, :5]))


def test_edge_softmax_autograd_takes_the_csr_and_gives_it_no_gradient():
    s, dst, em, n = _softmax_inputs(SOFTMAX_CASES[1])
    t = [torch.as_tensor(a) for a in (s, dst, em)]
    scores = t[0].double().requires_grad_(True)
    csr = ops.dst_csr(t[1], n)
    out = ops.edge_softmax(scores, t[1], t[2].double(), n, csr=csr)
    g = torch.as_tensor(np.random.default_rng(3).standard_normal(
        out.shape))
    (out * g).sum().backward()
    scores2 = t[0].double().requires_grad_(True)
    (ops.edge_softmax(scores2, t[1], t[2].double(), n) * g).sum().backward()
    assert torch.equal(scores.grad, scores2.grad)


def test_gat_plan_picks_the_route_by_shape_and_alignment():
    plan = segment_spmm.gat_plan
    assert plan(512, 4, True) == ("wide_vec", 4)      # the full bin
    assert plan(512, 4, False) == ("wide_scalar", 8)
    assert plan(16, 4, True) == ("wide_vec", 1)
    assert plan(30, 3, True) == ("wide_scalar", 1)    # dh = 10
    assert plan(24, 4, True) == ("wide_scalar", 1)    # dh = 6
    assert plan(4096, 4, True).units_per_lane == 8


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    from repro_torch.core.gnn import resolve_device
    return resolve_device("cuda")


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", GAT_CASES + [
    ("full-bin", 4096, 6656, 4, 512, 562, None)], ids=lambda c: c[0])
def test_gat_aggregate_shared_csr_on_card(case, cuda_dev):
    _, p, q, h, d, pile, hub = case
    t = [torch.as_tensor(a, device=cuda_dev) for a in _gat_inputs(
        p, q, h, d, seed=p + q + 1, pile=pile, hub=hub, grid=False)]
    csr = segment_spmm.dst_csr_cuda(t[1][:, 1][None], p)
    k = segment_spmm.fused_gat_aggregate_cuda
    before = dict(k.csr_launches)
    shared = k(*t, csr=csr)
    again = k(*t, csr=csr)
    own = k(*t)
    want = ref.fused_gat_aggregate_ref(*t)
    torch.cuda.synchronize()
    assert k.csr_launches == {"shared": before["shared"] + 2,
                              "own": before["own"] + 1}
    assert _same_bits(shared, again) and _same_bits(shared, own)
    torch.testing.assert_close(shared, want, rtol=CARD_RTOL, atol=CARD_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name,inputs", SOFTMAX_ALL,
                         ids=[c[0] for c in SOFTMAX_ALL])
def test_edge_softmax_shared_csr_on_card(name, inputs, cuda_dev):
    s, dst, em, n = inputs
    t = [torch.as_tensor(a, device=cuda_dev) for a in (s, dst, em)]
    csr = segment_spmm.dst_csr_cuda(t[1], n)
    k = segment_spmm.edge_softmax_cuda
    shared, again, own = k(*t, n, csr=csr), k(*t, n, csr=csr), k(*t, n)
    want = ref.edge_softmax_ref(*t, n)
    torch.cuda.synchronize()
    assert _same_bits(shared, again) and _same_bits(shared, own)
    _close(shared.cpu(), want.cpu(), CARD_RTOL, CARD_ATOL)
    assert bool((shared[(t[2] == 0) & ~torch.isnan(want).any(-1)] == 0)
                .all())


@pytest.mark.cuda
def test_gat_kernels_refuse_a_wrong_csr_on_card(cuda_dev):
    z, edges, em, att, nm = (torch.as_tensor(a, device=cuda_dev)
                             for a in _gat_inputs(64, 96, 4, 16, seed=2))
    csr = segment_spmm.dst_csr_cuda(edges[:, 1][None], 64)
    other = segment_spmm.dst_csr_cuda(edges[:, 1][None], 65)
    with pytest.raises(ValueError, match="csr rowptr"):
        segment_spmm.fused_gat_aggregate_cuda(z, edges, em, att, nm,
                                              csr=other)
    with pytest.raises(ValueError, match="expected cuda"):
        segment_spmm.fused_gat_aggregate_cuda(
            z, edges, em, att, nm,
            csr=segment_spmm.DstCsr(*(x.cpu() for x in csr)))
    with pytest.raises(TypeError, match="DstCsr"):
        segment_spmm.fused_gat_aggregate_cuda(z, edges, em, att, nm,
                                              csr=tuple(csr[:2]))
    s = torch.randn((1, 96, 4), device=cuda_dev)
    with pytest.raises(ValueError, match="csr perm"):
        segment_spmm.edge_softmax_cuda(
            s, edges[:, 1].contiguous()[None], em[None], 64,
            csr=(csr.rowptr, csr.perm[:, :50]))
    with pytest.raises(ValueError, match="expected cuda"):
        segment_spmm.edge_softmax_cuda(
            s, edges[:, 1].contiguous()[None], em[None], 64,
            csr=ref.dst_csr_ref(edges[:, 1].cpu()[None], 64))


@pytest.mark.cuda
def test_ops_dst_csr_routes_cuda_tensors_to_the_kernel(cuda_dev):
    edges = torch.randint(0, 30, (2, 80, 2), dtype=torch.int32,
                          device=cuda_dev)
    before = segment_spmm.dst_csr_cuda.launches
    got = ops.dst_csr(edges[..., 1], 30)
    assert isinstance(got, segment_spmm.DstCsr)
    assert segment_spmm.dst_csr_cuda.launches == before + 1
    for g, w in zip(got, ref.dst_csr_ref(edges[..., 1], 30)):
        assert torch.equal(g.cpu(), w.cpu())
