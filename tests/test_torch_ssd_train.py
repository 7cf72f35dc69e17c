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
