"""The SSD scan's backward in the PyTorch port, on the CPU.

* ``ref.ssd_scan_bwd_ref`` (the closed form that the CPU runs and the
  card's ``ssd_scan_bwd`` kernel is held to) against ``jax.vjp`` of the
  reference's ``_ssd_chunked`` (``repro/models/layers.py``), whose B and C
  are the groups repeated to heads (``jnp.repeat``), so that its dB and dC
  are summed over each group's heads here: G = 1, 2 and H of H = 4; S a
  chunk multiple and not; with and without s0; with and without a
  gradient on the last state; dt = 0 inside S and a state at 100x;
  float32, within 1e-5 of each gradient's largest magnitude (float32 sums
  in another order).
* The same twin against ``torch.autograd.grad`` through ``ssd_scan_ref``,
  and the blocking: the twin at two chunks gives one function.
* ``ops.ssd_scan_train`` on the CPU runs ``autograd.SsdScan`` (the twin in
  its backward) and computes what ``ops.ssd_scan`` does.
* On a card (marked ``cuda``, skipped here): ``ssd_scan_bwd_cuda`` against
  the twin, twice with the same bits, dt = 0 and a state at 100x included.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from test_torch_lm_train import _close_scaled, one_thread  # noqa: E402,F401

#: the twin against jax.vjp / autograd: float32 sums in another order
TWIN_RTOL = 1e-5
NAMES = ("dx", "ddt", "dA", "dB", "dC", "ds0")
H, P, N = 4, 8, 16
#: (S, chunk): a chunk multiple, and a ragged last chunk
LENGTHS = [(16, 8), (13, 8)]


def _inputs(bt, s, h, g, p, n, seed, kind=""):
    """Seeded inputs; ``kind`` "dt0" sets dt to 0 on rows 5-10 and the
    last (steps that neither decay nor add, across a chunk edge at 8),
    "s0x100" scales the initial state by 100."""
    rng = np.random.default_rng(seed)
    f = np.float32
    a = dict(
        x=rng.standard_normal((bt, s, h, p)).astype(f),
        dt=(rng.random((bt, s, h)) * 0.4 + 0.05).astype(f),
        A=(-(rng.random(h) + 0.2)).astype(f),
        B=(rng.standard_normal((bt, s, g, n)) * 0.5).astype(f),
        C=(rng.standard_normal((bt, s, g, n)) * 0.5).astype(f),
        s0=rng.standard_normal((bt, h, n, p)).astype(f),
        dy=rng.standard_normal((bt, s, h, p)).astype(f),
        d_last=rng.standard_normal((bt, h, n, p)).astype(f))
    if kind == "dt0":
        a["dt"][:, 5:11] = 0.0
        a["dt"][:, -1] = 0.0
    elif kind == "s0x100":
        a["s0"] *= 100.0
    return a


def _twin(a, chunk, s0, d_last):
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    return ref.ssd_scan_bwd_ref(t["x"], t["dt"], t["A"], t["B"], t["C"],
                                t["dy"], chunk=chunk,
                                s0=t["s0"] if s0 else None,
                                d_last=t["d_last"] if d_last else None)


def _jax_vjp(a, g, chunk, s0, d_last):
    """``jax.vjp`` of the reference's ``_ssd_chunked`` at ``a``, B and C
    repeated from G groups to the H heads."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models.layers import _ssd_chunked
    rep = lambda v: jnp.repeat(jnp.asarray(v), H // g, axis=2)  # noqa: E731

    def fn(x, dt, A, B, C, st):
        return _ssd_chunked(x, dt, A, rep(B), rep(C), chunk,
                            st if s0 else None)

    _, vjp = jax.vjp(fn, *(jnp.asarray(a[k]) for k in
                           ("x", "dt", "A", "B", "C", "s0")))
    glast = a["d_last"] if d_last else np.zeros_like(a["d_last"])
    return vjp((jnp.asarray(a["dy"]), jnp.asarray(glast)))


@pytest.mark.parametrize("d_last", [False, True], ids=["no_dlast", "dlast"])
@pytest.mark.parametrize("s0", [False, True], ids=["zero_s0", "s0"])
@pytest.mark.parametrize("s,chunk", LENGTHS, ids=["S16", "S13"])
@pytest.mark.parametrize("g", [1, 2, H], ids=["G1", "G2", "GH"])
def test_ssd_bwd_twin_matches_jax_vjp(g, s, chunk, s0, d_last):
    a = _inputs(2, s, H, g, P, N, 100 + g + s)
    want = _jax_vjp(a, g, chunk, s0, d_last)
    got = _twin(a, chunk, s0, d_last)
    for name, mine, theirs in zip(NAMES, got, want):
        if name == "ds0" and not s0:
            assert mine is None
            continue
        _close_scaled(mine.numpy(), np.asarray(theirs), TWIN_RTOL, name)


@pytest.mark.parametrize("kind", ["dt0", "s0x100"])
def test_ssd_bwd_twin_matches_jax_vjp_at_edges(kind):
    """dt = 0 inside S (no term of the closed form divides by dt) and a
    large initial state, on a ragged length with groups."""
    a = _inputs(2, 13, H, 2, P, N, 150, kind)
    want = _jax_vjp(a, 2, 8, True, True)
    for name, mine, theirs in zip(NAMES, _twin(a, 8, True, True), want):
        _close_scaled(mine.numpy(), np.asarray(theirs), TWIN_RTOL, name)


@pytest.mark.parametrize("g,s,chunk", [(1, 16, 8), (2, 13, 8), (H, 7, 8)],
                         ids=["G1", "G2_ragged", "GH_one_chunk"])
def test_ssd_bwd_twin_matches_autograd_of_scan(g, s, chunk):
    a = _inputs(2, s, H, g, P, N, 200 + g)
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    leaves = [t[k].clone().requires_grad_() for k in
              ("x", "dt", "A", "B", "C", "s0")]
    y, last = ref.ssd_scan_ref(*leaves[:5], chunk=chunk, s0=leaves[5])
    loss = (y * t["dy"]).sum() + (last * t["d_last"]).sum()
    want = torch.autograd.grad(loss, leaves)
    got = _twin(a, chunk, True, True)
    for name, mine, theirs in zip(NAMES, got, want):
        _close_scaled(mine.numpy(), theirs.numpy(), TWIN_RTOL, name)


def test_ssd_bwd_twin_is_one_function_over_chunks():
    """The kernel blocks in 64 rows whatever the model's chunk: any
    blocking is the same function."""
    a = _inputs(1, 40, H, 2, P, N, 300)
    for got, want in zip(_twin(a, 8, True, True), _twin(a, 64, True, True)):
        _close_scaled(got.numpy(), want.numpy(), TWIN_RTOL)


def test_ssd_scan_train_runs_the_function_on_cpu():
    a = _inputs(2, 13, H, 2, P, N, 400)
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    leaves = [t[k].clone().requires_grad_() for k in
              ("x", "dt", "A", "B", "C", "s0")]
    y, last = ops.ssd_scan_train(*leaves[:5], chunk=8, s0=leaves[5])
    assert type(y.grad_fn).__name__ == "SsdScanBackward"
    with torch.no_grad():
        y_inf, last_inf = ops.ssd_scan(*(t[k] for k in
                                         ("x", "dt", "A", "B", "C")),
                                       chunk=8, s0=t["s0"])
    assert torch.equal(y.detach(), y_inf) and torch.equal(last.detach(),
                                                          last_inf)
    loss = (y * t["dy"]).sum() + (last * t["d_last"]).sum()
    got = torch.autograd.grad(loss, leaves)
    want = _twin(a, 8, True, True)
    for name, mine, theirs in zip(NAMES, got, want):
        assert torch.equal(mine, theirs), name
    with pytest.raises(RuntimeError, match="inference only"):
        ops.ssd_scan(*leaves[:5], chunk=8)


# ---------------------------------------------------------------------------
# the bf16 kernel's arithmetic, emulated in float32
# ---------------------------------------------------------------------------

#: the bf16 kernel (or its emulation) against the twin and jax.vjp, of each
#: gradient's largest magnitude: dx, dB and dC round to bf16 once at the end
TC_BAR = 1e-2
#: the float32 outputs (ddt, dA, ds0) of the emulation with every float
#: operand in two bf16 terms: 16 bits carried, float32 sums elsewhere
TC_F32_OUT = 1e-4
LOG2E = 1.4426950408889634


def _terms(t, n):
    """``t`` (float32) as ``n`` bf16 terms: hi, then the rest's hi, ..."""
    out, rest = [], t.float()
    for _ in range(n):
        hi = rest.to(torch.bfloat16).float()
        out.append(hi)
        rest = rest - hi
    return out


def _prod(eq, a, b):
    """The products of two split operands that the kernel issues: every
    pair of terms but the two smallest (hi·hi, hi·lo, lo·hi for two)."""
    out = 0.0
    for i, u in enumerate(a):
        for j, v in enumerate(b):
            if len(a) == 1 or len(b) == 1 or i + j < max(len(a), len(b)):
                out = out + torch.einsum(eq, u, v)
    return out


def tc_ssd_bwd_emulation(x, dt, A, B, C, dy, s0, d_last, terms=2):
    """``csrc/ssd_scan_bwd.cu``'s bf16 route in float32: 64-row chunks;
    the walks carry the entry states (from s0) and exit gradients (from
    d_last) in float32, their chunk terms (w B)ᵀ x and (e^cum C)ᵀ dy with
    the scaled operand and dy in ``terms`` bf16 terms, and store each state
    in ``terms`` terms; the gradients take C Bᵀ and dy xᵀ in float32 from
    exact bf16 products, build K dt and Q D dt from them and split each
    into ``terms`` terms before its product, and sum a group's heads in
    slices of at most 8 (ascending), the slices' float32 partials in
    order; dx, dB and dC round to bf16 once. x, B and C are bf16; the
    decays are powers of 2 of dt A log2(e), as on the card."""
    bt, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    hpg = h // g
    lc = 64
    nc = -(-s // lc)
    pad = nc * lc - s

    def rows(t, heads=False):
        t = t.float()
        if heads and g != h:
            t = t.repeat_interleave(hpg, dim=2)
        t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape((bt, nc, lc) + tuple(t.shape[2:]))

    xc, dtc, bc, cc = rows(x), rows(dt), rows(B, True), rows(C, True)
    dyt = [rows(t) for t in _terms(dy, terms)]
    dy2 = sum(dyt)
    cum = torch.cumsum(dtc * (A.float() * LOG2E), 2)        # [bt,nc,lc,h]
    tot = cum[:, :, -1]
    ecum, ew = torch.exp2(cum), torch.exp2(tot[:, :, None] - cum)
    w = ew * dtc
    decay = torch.exp2(tot)[..., None, None]                  # [bt,nc,h,1,1]
    # the walks
    state = torch.zeros((bt, h, n, p)) if s0 is None else s0.float()
    sin = []
    for c in range(nc):
        sin.append(state)
        local = sum(torch.einsum("bjhn,bjhp->bhnp", u, xc[:, c]) for u in
                    _terms(bc[:, c] * w[:, c, ..., None], terms))
        state = state * decay[:, c] + local
    grad = torch.zeros((bt, h, n, p)) if d_last is None else d_last.float()
    gout = [None] * nc
    for c in reversed(range(nc)):
        gout[c] = grad
        local = _prod("bihn,bihp->bhnp",
                      _terms(cc[:, c] * ecum[:, c, ..., None], terms),
                      [t[:, c] for t in dyt])
        grad = grad * decay[:, c] + local
    sin_t = _terms(torch.stack(sin, 1), terms)
    gout_t = _terms(torch.stack(gout, 1), terms)
    s2, g2 = sum(sin_t), sum(gout_t)
    # the gradients of each (b, chunk, h)
    li = torch.arange(lc)
    keep = (li[:, None] >= li[None, :])[None, None, :, :, None]   # [i, j]
    diff = (cum[:, :, :, None] - cum[:, :, None, :]).masked_fill(~keep, 0.0)
    dd = torch.exp2(diff).masked_fill(~keep, 0.0)              # [b,nc,i,j,h]
    sij = torch.einsum("bnihd,bnjhd->bnijh", cc, bc)
    qij = torch.einsum("bnihp,bnjhp->bnijh", dy2, xc)
    kdt = sij * dd * dtc[:, :, None]
    qdt = qij * dd * dtc[:, :, None]
    bg = torch.einsum("bnjhd,bnhdp->bnjhp", bc, g2)
    dx = _prod("bnijh,bnihp->bnjhp", _terms(kdt, terms), dyt) \
        + w[..., None] * bg
    qdt_t = _terms(qdt, terms)
    db = sum(torch.einsum("bnijh,bnihd->bnjhd", u, cc) for u in qdt_t) \
        + w[..., None] * torch.einsum("bnjhp,bnhdp->bnjhd", xc, g2)
    dc = sum(torch.einsum("bnijh,bnjhd->bnihd", u, bc) for u in qdt_t) \
        + ecum[..., None] * _prod("bnihp,bnhdp->bnihd", dyt, sin_t)
    t = kdt * qij
    r = (bg * xc).sum(-1)
    u = w * r
    v = ecum * (torch.einsum("bnihd,bnhdp->bnihp", cc, s2) * dy2).sum(-1)
    gcum = t.sum(3) - t.sum(2) + v - u
    gcum[:, :, -1] += u.sum(2) + torch.exp2(tot) * (g2 * s2).sum((-2, -1))
    suffix = torch.flip(torch.cumsum(torch.flip(gcum, [2]), 2), [2])
    ddt = (sij * dd * qij).sum(2) + ew * r + A.float() * suffix
    da = (dtc * suffix).sum((0, 1, 2))

    def out_rows(t):
        return t.reshape((bt, nc * lc) + tuple(t.shape[3:]))[:, :s]

    slices = -(-hpg // 8)
    per = -(-hpg // slices)

    def group_sum(t):                # [bt, S, h, n] -> [bt, S, g, n]
        t = out_rows(t).reshape(bt, s, g, hpg, n)
        parts = [t[:, :, :, k:k + per].sum(3) for k in range(0, hpg, per)]
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        return total.to(B.dtype)

    return (out_rows(dx).to(x.dtype), out_rows(ddt), da, group_sum(db),
            group_sum(dc), None if s0 is None else grad)


#: (G, S, kind): G = 1, 2 and H of H = 4; three chunks of 64 with a ragged
#: last one; dt = 0 inside S (``_inputs``' rows 5-10 and the last) and the
#: state at 100x
TC_CASES = [(1, 150, ""), (2, 150, ""), (H, 150, ""), (2, 150, "dt0"),
            (1, 150, "s0x100"), (H, 40, "")]


def _tc_inputs(g, s, kind, seed):
    a = _inputs(2, s, H, g, 16, 16, seed, kind)
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    for k in ("x", "B", "C"):
        t[k] = t[k].to(torch.bfloat16)
        a[k] = t[k].float().numpy()        # what the reference sees
    return a, t


@pytest.mark.parametrize("s0", [False, True], ids=["zero_s0", "s0_dlast"])
@pytest.mark.parametrize("case", TC_CASES, ids=str)
def test_ssd_bwd_bf16_emulation_matches_twin_and_jax(case, s0):
    """The bf16 kernel's arithmetic (every float operand in two bf16
    terms) within the card's bf16 bar of the twin and of ``jax.vjp`` of
    ``_ssd_chunked``, and its float32 outputs within 1e-4."""
    g, s, kind = case
    a, t = _tc_inputs(g, s, kind, 600 + g + s)
    got = tc_ssd_bwd_emulation(t["x"], t["dt"], t["A"], t["B"], t["C"],
                               t["dy"], t["s0"] if s0 else None,
                               t["d_last"] if s0 else None)
    twin = ref.ssd_scan_bwd_ref(t["x"], t["dt"], t["A"], t["B"], t["C"],
                                t["dy"], chunk=32,
                                s0=t["s0"] if s0 else None,
                                d_last=t["d_last"] if s0 else None)
    want = _jax_vjp(a, g, 32, s0, s0)
    for name, mine, plain, theirs in zip(NAMES, got, twin, want):
        if not s0 and name == "ds0":
            assert mine is None
            continue
        assert mine.dtype == plain.dtype, name
        mine = mine.float().numpy()
        _close_scaled(mine, plain.float().numpy(), TC_BAR, name + " vs twin")
        _close_scaled(mine, np.asarray(theirs), TC_BAR, name + " vs jax.vjp")
        if name in ("ddt", "dA", "ds0"):
            _close_scaled(mine, plain.numpy(), TC_F32_OUT, name)


def test_ssd_bwd_bf16_one_term_misses_the_float32_outputs():
    """Why the split: one bf16 term a float operand moves ddt and dA by far
    more than float32 does (and dx, dB, dC nearer the bar), the state at
    100x."""
    _, t = _tc_inputs(1, 150, "s0x100", 700)
    args = [t[k] for k in ("x", "dt", "A", "B", "C", "dy")]
    twin = ref.ssd_scan_bwd_ref(*args, chunk=64, s0=t["s0"],
                                d_last=t["d_last"])
    for terms, worse in ((1, True), (2, False)):
        got = tc_ssd_bwd_emulation(*args, t["s0"], t["d_last"], terms=terms)
        rel = max(float((u - v).abs().max() / v.abs().max())
                  for u, v in zip(got[1:3], twin[1:3]))
        assert (rel > TC_F32_OUT) == worse, (terms, rel)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ssd_bwd_plan_over_widths(dtype):
    """``ssd_bwd_plan`` over N, P ≤ 128 (multiples of 4) and the heads
    and groups of the SSD archs: float32 on the FMA route with the
    parent's 189,184 bytes at N 128 / P 64; bf16 on the tensor cores up to
    N 128 / P 64 (padded to powers of two ≥ 16) and refused past them; a
    group's heads in slices of at most 8, as even as they go."""
    from repro_torch.kernels import ssd_scan as ss
    widths = [4, 8, 12, 16, 20, 32, 48, 64, 96, 128]
    for n in widths:
        for p in widths:
            for h, g in ((32, 1), (80, 1), (4, 2), (4, 4), (12, 1)):
                if dtype == torch.bfloat16 and (n > 128 or p > 64):
                    with pytest.raises(ValueError, match="bfloat16 kernel"):
                        ss.ssd_bwd_plan(n, p, h, g, dtype)
                    continue
                plan = ss.ssd_bwd_plan(n, p, h, g, dtype)
                assert plan.lc == 64
                hpg = h // g
                if dtype == torch.float32:
                    assert plan.route == "fma" and plan.heads == 1
                    assert plan.partials == hpg
                    assert (plan.n_pad, plan.p_pad) == (n, p)
                    continue
                assert plan.route == "tc"
                for v, pad in ((n, plan.n_pad), (p, plan.p_pad)):
                    assert max(v, 16) <= pad < 2 * max(v, 16)
                    assert pad & (pad - 1) == 0
                assert plan.heads <= 8
                assert plan.heads * plan.partials >= hpg
                assert (plan.partials - 1) * plan.heads < hpg
                assert plan.partials == -(-hpg // 8)
                assert plan.smem_bytes <= ss.MAX_SMEM
                assert plan.smem_bytes == 256 * plan.n_pad + 2 * (
                    384 * plan.p_pad + 8 * plan.n_pad * plan.p_pad) + 5184
    big = ss.ssd_bwd_plan(128, 64, 32, 1, dtype)
    if dtype == torch.float32:
        assert big.smem_bytes == 189184
    else:
        assert (big.heads, big.partials, big.smem_bytes) == (8, 4, 218176)
        assert ss.ssd_bwd_plan(64, 64, 80, 1, dtype)[4:6] == (8, 10)


# ---------------------------------------------------------------------------
# on a card: the backward kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    from repro_torch.core.gnn import resolve_device
    return resolve_device("cuda")


#: the kernel against its plain version on the card, of each gradient's
#: largest magnitude: float32 sums in another order; bf16 x, B, C are exact
#: in float32, and dx, dB, dC round to 8 bits at the end
CARD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
#: (Bt, S, H, G, P, N, chunk, kind): the smoke configs' widths, a ragged
#: length, groups, the two SSD archs' N and P, dt = 0 inside S and the
#: state at 100x (``_inputs``' kinds)
CARD_CASES = [(2, 40, 8, 1, 16, 16, 32, ""), (1, 100, 4, 2, 16, 16, 32, ""),
              (2, 130, 4, 4, 8, 16, 64, ""), (1, 200, 4, 1, 64, 128, 128, ""),
              (1, 150, 6, 1, 64, 64, 128, ""),
              (2, 100, 4, 1, 64, 64, 128, "dt0"),
              (1, 200, 4, 1, 64, 128, 128, "s0x100")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CARD_CASES, ids=str)
def test_ssd_bwd_kernel_matches_plain_on_card(card, case, dtype):
    from repro_torch.kernels import ssd_scan as ss
    bt, s, h, g, p, n, chunk, kind = case
    a = {k: torch.as_tensor(v, device=card)
         for k, v in _inputs(bt, s, h, g, p, n, 500, kind).items()}
    for k in ("x", "B", "C"):
        a[k] = a[k].to(dtype)
    args = [a[k] for k in ("x", "dt", "A", "B", "C", "dy")]
    kw = dict(chunk=chunk, s0=a["s0"], d_last=a["d_last"])
    before = ss.ssd_scan_bwd_cuda.launches
    got = ss.ssd_scan_bwd_cuda(*args, **kw)
    again = ss.ssd_scan_bwd_cuda(*args, **kw)
    want = ref.ssd_scan_bwd_ref(*args, **kw)
    torch.cuda.synchronize()
    assert ss.ssd_scan_bwd_cuda.launches == before + 2
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    for name, u, v in zip(NAMES, got, want):
        assert u.dtype == v.dtype, name
        _close_scaled(u.float().cpu().numpy(), v.float().cpu().numpy(),
                      CARD_TOL[dtype], name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ssd_bwd_plan_matches_the_library(card, dtype):
    """``ssd_bwd_plan``'s shared memory, chunk and heads a block are the
    library's own (``ssd_scan_bwd_smem`` / ``_chunk`` / ``_heads``)."""
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels.segment_spmm import _entry
    for n, p, h, g in ((128, 64, 32, 1), (64, 64, 80, 1), (16, 16, 4, 2),
                       (20, 12, 2, 1), (4, 8, 12, 1)):
        plan = ss.ssd_bwd_plan(n, p, h, g, dtype)
        code = ss._DTYPES[dtype]
        assert _entry("ssd_scan_bwd_smem")(code, n, p) == plan.smem_bytes
        assert _entry("ssd_scan_bwd_chunk")(code) == plan.lc
        assert _entry("ssd_scan_bwd_heads")(code, h, g) == plan.heads
