"""Kernels of the PyTorch port against the JAX package's Pallas kernels.

On the CPU: the plain PyTorch versions (``repro_torch.kernels.ref``) are
held against ``fused_mp_layer_pallas`` and ``segment_readout_pallas`` in
interpret mode, on the same numpy inputs, to 1e-5 relative / 1e-6
absolute in float32. On a card (tests marked ``cuda``): the hand-written
CUDA kernels are held against the plain versions, to 1e-4 absolute +
1e-4 relative, since the kernels add with atomics in another order.

The module imports JAX only inside the tests that compare with it, so the
card's tests also run where JAX is not installed:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref, segment_spmm  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6              # plain version vs Pallas, float32
CARD_RTOL = CARD_ATOL = 1e-4         # CUDA kernel vs plain version

PQ = [(128, 128), (128, 129), (100, 50), (257, 300), (64, 0)]


def _packed_graph(p, q, f=16, seed=0, masked_tail=0.2):
    """Packed flat-axis inputs: x [P,F], globally-offset edges [Q,2],
    edge and node masks with a padded tail."""
    rng = np.random.default_rng(seed)
    n_real = max(1, int(p * (1 - masked_tail)))
    x = rng.standard_normal((p, f)).astype(np.float32)
    edges = (rng.integers(0, n_real, (q, 2)).astype(np.int32) if q
             else np.zeros((0, 2), np.int32))
    emask = np.zeros((q,), np.float32)
    if q:
        emask[:max(1, q * 3 // 4)] = 1.0
    nmask = np.zeros((p,), np.float32)
    nmask[:n_real] = 1.0
    return x, edges, emask, nmask


def _weights(f, h, seed=0):
    rng = np.random.default_rng(seed + 100)
    return {"w_neigh": rng.standard_normal((f, h)).astype(np.float32) * .1,
            "w_self": rng.standard_normal((f, h)).astype(np.float32) * .1,
            "bias": rng.standard_normal((h,)).astype(np.float32) * .1}


def _scale(kind, p, seed=0):
    rng = np.random.default_rng(seed + 200)
    return {"vector": rng.random(p).astype(np.float32),
            "scalar": np.float32(1.37), None: None}[kind]


def _mp_case(p, q, mode, combine, scale, act, node_mask=True,
             weighted=False, f=16, h=24, seed=0):
    x, edges, emask, nmask = _packed_graph(p, q, f=f, seed=seed)
    if weighted:
        emask = emask * np.random.default_rng(seed + 300).random(q).astype(
            np.float32)
    kw = dict(_weights(f, h, seed), mode=mode, combine=combine,
              self_scale=_scale(scale, p, seed), act=act)
    return (x, edges, emask, nmask if node_mask else None), kw


def _to(arrays, kw, conv):
    arrays = [None if a is None else conv(a) for a in arrays]
    kw = {k: (conv(v) if isinstance(v, np.ndarray) else v)
          for k, v in kw.items()}
    return arrays, kw


MP_CASES = (
    [dict(p=p, q=q, mode=m, combine=c, scale="vector", act="relu")
     for p, q in PQ for m in ("sum", "mean") for c in ("split", "pre")]
    + [dict(p=96, q=140, mode="sum", combine="pre", scale=s, act=a)
       for s in ("vector", "scalar", None) for a in ("relu", "none")]
    + [dict(p=80, q=200, mode="sum", combine="split", scale=None, act="none",
            node_mask=False, weighted=True),
       dict(p=80, q=200, mode="mean", combine="pre", scale="vector",
            act="relu", node_mask=False, weighted=True),
       # widths that are not multiples of 4 take the scalar-load kernel
       dict(p=300, q=500, mode="mean", combine="split", scale=None,
            act="relu", weighted=True, f=70, h=130),
       dict(p=150, q=90, mode="mean", combine="pre", scale="vector",
            act="relu", f=13, h=7)])


def _mp_id(c):
    return "-".join(str(v) for v in c.values())


@pytest.fixture(scope="module")
def pallas():
    """The JAX package's Pallas kernels (run in interpret mode) and
    ``jnp.asarray``."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.segment_spmm import (fused_mp_layer_pallas,
                                            segment_readout_pallas)
    return fused_mp_layer_pallas, segment_readout_pallas, jnp.asarray


@pytest.mark.parametrize("case", MP_CASES, ids=_mp_id)
def test_fused_mp_plain_matches_pallas(pallas, case):
    fused_mp_layer_pallas, _, asarray = pallas
    arrays, kw = _mp_case(**case)
    ja, jkw = _to(arrays, kw, asarray)
    ta, tkw = _to(arrays, kw, torch.as_tensor)
    want = np.asarray(fused_mp_layer_pallas(*ja, **jkw, interpret=True))
    got = ref.fused_mp_layer_ref(*ta, **tkw).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _readout_case(kind, p, f, g, layout, seed=7):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((p, f)).astype(np.float32)
    if layout == "runs":          # contiguous runs, padded tail, empty tail
        n_real = p * 3 // 4
        ids = np.zeros(p, np.int32)
        ids[:n_real] = np.sort(rng.integers(0, g - 3, n_real))
        nm = np.zeros(p, np.float32)
        nm[:n_real] = 1.0
        h[n_real:] = 1e6          # padding garbage must not leak
    elif layout == "random":      # ids in no order, some rows masked
        ids = rng.integers(0, g, p).astype(np.int32)
        nm = (rng.random(p) < 0.8).astype(np.float32)
    else:                         # every row masked
        ids = np.zeros(p, np.int32)
        nm = np.zeros(p, np.float32)
    return h, ids, nm


READOUT_CASES = [(kind, p, f, g, layout)
                 for kind in ("mean", "mean_max")
                 for p, f, g, layout in ((300, 16, 12, "runs"),
                                         (130, 130, 8, "runs"),
                                         (257, 40, 9, "random"),
                                         (64, 8, 4, "empty"))]


@pytest.mark.parametrize("kind,p,f,g,layout", READOUT_CASES)
def test_segment_readout_plain_matches_pallas(pallas, kind, p, f, g, layout):
    _, segment_readout_pallas, asarray = pallas
    h, ids, nm = _readout_case(kind, p, f, g, layout)
    want = np.asarray(segment_readout_pallas(
        asarray(h), asarray(ids), asarray(nm), g, kind=kind, interpret=True))
    got = ref.segment_readout_ref(torch.as_tensor(h), torch.as_tensor(ids),
                                  torch.as_tensor(nm), g, kind=kind).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if layout != "random":
        np.testing.assert_array_equal(got[g - 3:], 0.0)   # empty graphs


def test_segment_degree_counts_mask_values():
    edges = torch.tensor([[[0, 1], [2, 1], [1, 0], [0, 0]]], dtype=torch.int32)
    w = torch.tensor([[1.0, 0.5, 2.0, 0.0]])
    got = ref.segment_degree_ref(edges, w, 3)
    np.testing.assert_array_equal(got.numpy(), [[2.0, 1.5, 0.0]])


def test_ops_routes_cpu_tensors_to_the_plain_version():
    arrays, kw = _mp_case(100, 50, "mean", "split", None, "relu")
    ta, tkw = _to(arrays, kw, torch.as_tensor)
    before = segment_spmm.fused_mp_layer_cuda.launches
    got = ops.fused_mp_layer(*ta, **tkw)
    torch.testing.assert_close(got, ref.fused_mp_layer_ref(*ta, **tkw),
                               rtol=0, atol=0)
    h, ids, nm = _readout_case("mean_max", 300, 16, 12, "runs")
    t = [torch.as_tensor(a) for a in (h, ids, nm)]
    torch.testing.assert_close(ops.segment_readout(*t, 12),
                               ref.segment_readout_ref(*t, 12),
                               rtol=0, atol=0)
    assert segment_spmm.fused_mp_layer_cuda.launches == before


def test_cuda_wrappers_refuse_cpu_tensors():
    arrays, kw = _mp_case(64, 32, "mean", "split", None, "relu")
    ta, tkw = _to(arrays, kw, torch.as_tensor)
    with pytest.raises(ValueError, match="CUDA tensors"):
        segment_spmm.fused_mp_layer_cuda(*ta, **tkw)
    h, ids, nm = _readout_case("mean", 64, 8, 4, "runs")
    with pytest.raises(ValueError, match="CUDA tensors"):
        segment_spmm.segment_readout_cuda(
            torch.as_tensor(h), torch.as_tensor(ids), torch.as_tensor(nm), 4)


# ---------------------------------------------------------------------------
# the node phase's tensor-core route (csrc/tf32x3_tile.cuh), emulated
# ---------------------------------------------------------------------------
#
# The kernel splits each float32 operand v into hi = tf32_rna(v) and
# lo = v − hi, of which the tensor cores read the top 19 bits, and per
# depth step of 8 (one wgmma m64n128k8) adds A_lo·B_hi and A_hi·B_lo into
# one float32 accumulator and A_hi·B_hi into another; the epilogue adds the
# two. Depth runs per segment (x, then agg / d) in stages of 32, zero past
# F. A 128×128 tile whose split result holds a non-finite value is
# computed again in plain float32. The emulation below does the same in
# numpy, rounding each product step's sum of 8 exact products to float32
# before it is accumulated.

TC_TILE, TC_DEPTH = 128, 32          # the kernel's output tile and stage


def _tf32_rna(v):
    """float32 → TF32 (10 mantissa bits), round to nearest, ties away from
    zero, by bit operations; inf and NaN pass unchanged."""
    v = np.ascontiguousarray(v, np.float32)
    u = v.view(np.uint32)
    r = np.where(np.isfinite(v), (u + np.uint32(0x1000)) & np.uint32(
        0xFFFFE000), u)
    return r.astype(np.uint32).view(np.float32)


def _tf32_cut(v):
    """float32 → its top 19 bits, as the tensor cores read a raw float32;
    inf and NaN pass unchanged."""
    v = np.ascontiguousarray(v, np.float32)
    u = v.view(np.uint32)
    r = np.where(np.isfinite(v), u & np.uint32(0xFFFFE000), u)
    return r.astype(np.uint32).view(np.float32)


def _tf32_product(a, b, terms=3):
    """a [M, K] @ b [K, N] as the tensor cores sum it: ``terms=3`` the
    split, ``terms=1`` one TF32 product; K a multiple of 8."""
    f32 = np.float32
    big = np.zeros((a.shape[0], b.shape[1]), f32)
    small = np.zeros_like(big)

    def mma(x, y):
        return (x.astype(np.float64) @ y).astype(f32)
    with np.errstate(invalid="ignore", over="ignore"):
        ah, bh = _tf32_rna(a), _tf32_rna(b)
        al, bl = _tf32_cut(a - ah), _tf32_cut(b - bh)
        for k in range(0, a.shape[1], 8):
            s = slice(k, k + 8)
            if terms == 3:
                small = small + mma(al[:, s], bh[s])
                small = small + mma(ah[:, s], bl[s])
            big = big + mma(ah[:, s], bh[s])
    return big + small


def _pad_depth(a, axis):
    """Zeros past F up to the next stage, as the kernel's copies give."""
    pad = -a.shape[axis] % TC_DEPTH
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, pad)
    return np.pad(a, widths)


def _emulated_layer(x, edges, emask, nmask, *, w_neigh, w_self=None,
                    bias=None, mode="mean", combine="split",
                    self_scale=None, act="relu", terms=3, routed=True):
    """``fused_mp_layer`` with the node phase as the tensor-core kernel
    computes it (the edge phase in float32, as the plain version)."""
    f32 = np.float32
    p = x.shape[0]
    src, dst = edges[:, 0], edges[:, 1]
    with np.errstate(invalid="ignore", over="ignore"):
        agg = np.zeros_like(x)
        np.add.at(agg, dst, x[src] * emask[:, None])
        inv = np.ones((p, 1), f32)
        if mode == "mean":
            deg = np.zeros((p,), f32)
            np.add.at(deg, dst, emask)
            inv = (f32(1) / np.maximum(deg, f32(1)))[:, None]
        neigh = agg * inv
        if combine == "split":
            a = np.concatenate([_pad_depth(x, 1), _pad_depth(neigh, 1)], 1)
            b = np.concatenate([_pad_depth(w_self, 0),
                                _pad_depth(w_neigh, 0)], 0)
        else:
            s = np.broadcast_to(np.asarray(
                1.0 if self_scale is None else self_scale, f32),
                (p,))[:, None]
            # fmaf(s, x, agg * inv): one rounding of the exact s·x + v
            a = _pad_depth((s.astype(np.float64) * x + neigh).astype(f32), 1)
            b = _pad_depth(w_neigh, 0)
    y = np.empty((p, b.shape[1]), f32)
    for r in range(0, p, TC_TILE):
        for c in range(0, b.shape[1], TC_TILE):
            at, bt = a[r:r + TC_TILE], b[:, c:c + TC_TILE]
            t = _tf32_product(at, bt, terms)
            if routed and not np.isfinite(t).all():
                t = (torch.as_tensor(at) @ torch.as_tensor(bt)).numpy()
            y[r:r + TC_TILE, c:c + TC_TILE] = t
    with np.errstate(invalid="ignore", over="ignore"):
        if bias is not None:
            y = y + bias
        if act == "relu":
            y = np.where(y < 0, f32(0), y)     # keeps NaN, as relu does
        if nmask is not None:
            y = y * nmask[:, None]
    return y


def _within_card_bar(got, want):
    """max |got − want| / (CARD_ATOL + CARD_RTOL·|want|)"""
    return float(np.max(np.abs(got.astype(np.float64) - want) /
                        (CARD_ATOL + CARD_RTOL * np.abs(want))))


def _full_bin_layer(f, h=512, p=256, q=416, seed=0):
    """One GraphSAGE layer at the full bin's width: relu activations in,
    Glorot weights (``pmgns_init``'s), depth 2F."""
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.standard_normal((p, f)), 0).astype(np.float32)
    edges = rng.integers(0, p, (q, 2)).astype(np.int32)
    lim = np.sqrt(6.0 / (f + h))
    kw = dict(w_neigh=rng.uniform(-lim, lim, (f, h)).astype(np.float32),
              w_self=rng.uniform(-lim, lim, (f, h)).astype(np.float32),
              bias=np.zeros((h,), np.float32), mode="mean",
              combine="split", act="relu")
    return (x, edges, np.ones((q,), np.float32),
            np.ones((p,), np.float32)), kw


@pytest.mark.parametrize("f", [32, 512], ids=["depth64", "depth1024"])
def test_tf32x3_split_holds_the_float32_bar_where_one_tf32_product_does_not(
        f):
    arrays, kw = _full_bin_layer(f)
    ta, tkw = _to(arrays, kw, torch.as_tensor)
    want = ref.fused_mp_layer_ref(*ta, **tkw).numpy()
    split = _emulated_layer(*arrays, **kw)
    one = _emulated_layer(*arrays, **kw, terms=1)
    assert _within_card_bar(split, want) < 0.1     # measured: 0.002, 0.011
    assert _within_card_bar(one, want) > 1.0       # measured: 4.5, 10.9


def _nonfinite_case(where, combine):
    """A layer over two row tiles and two column tiles with inf, −inf and
    NaN in x (rows that send no edge), in agg (through the edges of the
    rows that carry them) or in the weights."""
    (x, edges, emask, nmask), kw = _mp_case(
        200, 300, "mean" if combine == "split" else "sum", combine,
        "vector", "relu", f=24, h=160, seed=3)
    bad = {5: np.inf, 150: np.nan, 170: -np.inf}
    if where == "x":
        edges = edges[~np.isin(edges[:, 0], list(bad))]
        emask = emask[:edges.shape[0]]
    elif where == "agg":
        edges[:3, 0] = list(bad)
        emask[:3] = 1.0
    for r, v in bad.items():
        if where in ("x", "agg"):
            x[r, 7] = v
        elif where == "w":
            w = kw["w_self" if combine == "split" and r == 5 else "w_neigh"]
            w[r % 24, (r * 7) % 160] = v
    return (x, edges, emask, nmask), kw


@pytest.mark.parametrize("combine", ["split", "pre"])
@pytest.mark.parametrize("where", ["x", "agg", "w"])
def test_tf32x3_non_finite_rule_gives_the_plain_results(where, combine):
    arrays, kw = _nonfinite_case(where, combine)
    ta, tkw = _to(arrays, kw, torch.as_tensor)
    want = ref.fused_mp_layer_ref(*ta, **tkw).numpy()
    assert not np.isfinite(want).all()
    got = _emulated_layer(*arrays, **kw)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin & ~np.isnan(want)],
                                  want[~fin & ~np.isnan(want)])
    assert _within_card_bar(got[fin], want[fin]) <= 1.0
    # the reason for the rule: the split alone turns inf into NaN
    unrouted = _emulated_layer(*arrays, **kw, routed=False)
    assert np.isnan(unrouted).sum() > np.isnan(want).sum()


@pytest.mark.parametrize("f,h,aligned,route", [
    (32, 512, True, "tf32x3"),        # the full bin's first layer
    (512, 512, True, "tf32x3"),       # and its 512 -> 512 layers
    (12, 20, True, "tf32x3"),         # F not a multiple of 8, H < a tile
    (70, 130, True, "fma"),           # chip_smoke.py's odd widths
    (13, 7, True, "fma"),
    (16, 24, False, "fma"),           # a view one float into its storage
])
def test_fused_mp_plan_picks_the_route_by_shape_and_alignment(f, h, aligned,
                                                             route):
    assert segment_spmm.fused_mp_plan(f, h, aligned) == route
    assert set(segment_spmm.fused_mp_layer_cuda.route_launches) == \
        set(segment_spmm.FUSED_MP_ROUTES)


# ---------------------------------------------------------------------------
# on the card: hand-written kernel vs plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", MP_CASES, ids=_mp_id)
def test_fused_mp_kernel_matches_plain_on_card(cuda_dev, case):
    arrays, kw = _mp_case(**case)
    ta, tkw = _to(arrays, kw, lambda a: torch.as_tensor(a, device=cuda_dev))
    before = segment_spmm.fused_mp_layer_cuda.launches
    got = segment_spmm.fused_mp_layer_cuda(*ta, **tkw)
    want = ref.fused_mp_layer_ref(*ta, **tkw)
    torch.cuda.synchronize()
    assert segment_spmm.fused_mp_layer_cuda.launches == before + 1
    torch.testing.assert_close(got, want, rtol=CARD_RTOL, atol=CARD_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,p,f,g,layout", READOUT_CASES)
def test_segment_readout_kernel_matches_plain_on_card(cuda_dev, kind, p, f,
                                                      g, layout):
    t = [torch.as_tensor(a, device=cuda_dev)
         for a in _readout_case(kind, p, f, g, layout)]
    got = segment_spmm.segment_readout_cuda(*t, g, kind=kind)
    want = ref.segment_readout_ref(*t, g, kind=kind)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=CARD_RTOL, atol=CARD_ATOL)


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_inputs_on_card(cuda_dev):
    arrays, kw = _mp_case(64, 32, "mean", "split", None, "relu")
    ta, tkw = _to(arrays, kw, lambda a: torch.as_tensor(a, device=cuda_dev))
    x, edges, emask, nmask = ta
    with pytest.raises(TypeError, match="int32"):
        segment_spmm.fused_mp_layer_cuda(x, edges.long(), emask, nmask, **tkw)
    with pytest.raises(ValueError, match="contiguous"):
        segment_spmm.fused_mp_layer_cuda(x.t().contiguous().t(), edges,
                                         emask, nmask, **tkw)
    with pytest.raises(ValueError, match="shape"):
        segment_spmm.fused_mp_layer_cuda(x, edges, emask[:-1], nmask, **tkw)


@pytest.mark.cuda
def test_fused_mp_kernel_takes_unaligned_views_on_card(cuda_dev):
    # a view that starts one float into its storage cannot take float4
    # loads; the wrapper must pick the scalar-load kernel
    arrays, kw = _mp_case(128, 129, "mean", "split", None, "relu")
    ta, tkw = _to(arrays, kw, lambda a: torch.as_tensor(a, device=cuda_dev))
    x = ta[0]
    shifted = torch.empty(x.numel() + 1, device=cuda_dev)[1:].view(x.shape)
    shifted.copy_(x)
    got = segment_spmm.fused_mp_layer_cuda(shifted, *ta[1:], **tkw)
    want = ref.fused_mp_layer_ref(*ta, **tkw)
    torch.testing.assert_close(got, want, rtol=CARD_RTOL, atol=CARD_ATOL)


@pytest.mark.cuda
def test_readout_nan_in_real_row_reaches_the_mean_on_card(cuda_dev):
    h, ids, nm = _readout_case("mean_max", 300, 16, 12, "runs")
    h[5, 3] = np.nan
    t = [torch.as_tensor(a, device=cuda_dev) for a in (h, ids, nm)]
    out = segment_spmm.segment_readout_cuda(*t, 12).cpu().numpy()
    assert not np.isfinite(out[ids[5]]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False], ids=["tf32x3", "fma"])
@pytest.mark.parametrize("combine", ["split", "pre"])
@pytest.mark.parametrize("where", ["x", "agg", "w"])
def test_fused_mp_non_finite_values_match_plain_on_card(cuda_dev, where,
                                                       combine, aligned):
    arrays, kw = _nonfinite_case(where, combine)
    ta, tkw = _to(arrays, kw, lambda a: torch.as_tensor(a, device=cuda_dev))
    x = ta[0]
    if not aligned:
        x = torch.empty(x.numel() + 1, device=cuda_dev)[1:].view(
            x.shape).copy_(x)
    routes = dict(segment_spmm.fused_mp_layer_cuda.route_launches)
    got = segment_spmm.fused_mp_layer_cuda(x, *ta[1:], **tkw).cpu().numpy()
    want = ref.fused_mp_layer_ref(*ta, **tkw).cpu().numpy()
    route = "tf32x3" if aligned else "fma"
    assert segment_spmm.fused_mp_layer_cuda.route_launches[route] == \
        routes[route] + 1
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    torch.testing.assert_close(torch.as_tensor(got[fin]),
                               torch.as_tensor(want[fin]),
                               rtol=CARD_RTOL, atol=CARD_ATOL)
