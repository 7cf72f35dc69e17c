"""The LM stack's kernels in the PyTorch port against the JAX package.

On the CPU: ``flash_attention_ref`` is held against ``flash_attention_pallas``
in interpret mode on ``tests/test_kernels.py``'s cases plus head dim 80
(2e-5 in float32, 2e-2 in bfloat16, that file's own bars), and against
``blockwise_attention`` on grouped heads, offsets (a negative
``kv_offset`` included), windows, ragged chunk lengths, one-row decode and
a fully masked row, which must read 0; the decode's split plan
(``decode_split_plan``) and its split-and-merge step
(``flash_decode_split_ref``) against ``flash_attention_ref`` and
``blockwise_attention`` (1e-5: float32 sums in another order), on grouped
heads of 1, 4 and 8, splits that the causal or window bound masks wholly,
the ring's negative ``kv_offset``, fewer keys than one split, and rows with
no kept key, which read exactly 0; ``ssd_scan_ref`` against
``ssd_scan_pallas`` in interpret mode on ``test_kernels.py``'s grid
(2e-4 absolute / 2e-3 relative, its bar) and against ``_ssd_chunked``
with and without an initial state, y and the last state (1e-5 relative,
with 1e-6 absolute for elements near zero); prefill-then-decode
continuity. On a card (tests marked ``cuda``): the CUDA kernels against
their plain versions, 1e-4 absolute + 1e-4 relative in float32 (sums in
another order), 2e-2 in bfloat16 (the output rounds to 8 mantissa bits).

JAX is imported only inside the fixtures that compare with it, so the
card's tests run where JAX is not installed:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_lm_kernels.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402

FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # test_kernels.py's bars
SSD_PALLAS_ATOL, SSD_PALLAS_RTOL = 2e-4, 2e-3     # test_kernels.py's bar
SSD_RTOL, SSD_ATOL = 1e-5, 1e-6                   # vs _ssd_chunked, float32
BLOCKWISE_RTOL, BLOCKWISE_ATOL = 1e-5, 1e-6       # vs blockwise_attention
CARD_RTOL = CARD_ATOL = 1e-4                      # kernel vs plain, float32
CARD_BF16 = 2e-2                                  # kernel vs plain, bfloat16


@pytest.fixture(scope="module")
def jx():
    """jax.numpy, the Pallas kernels (interpret mode) and the model code."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention import flash_attention_pallas
    from repro.kernels.ssd_scan import ssd_scan_pallas
    from repro.kernels import ref as jref
    from repro.models import layers
    return dict(jnp=jnp, flash=flash_attention_pallas, ssd=ssd_scan_pallas,
                layers=layers, ref=jref)


def _qkv(rng, b, sq, skv, h, hkv, d):
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32))


def _ssd_inputs(rng, bt, s, h, p, n, g):
    return (rng.standard_normal((bt, s, h, p)).astype(np.float32) * 0.5,
            (rng.random((bt, s, h)) * 0.1 + 0.01).astype(np.float32),
            (-(rng.random(h) * 0.5 + 0.1)).astype(np.float32),
            rng.standard_normal((bt, s, g, n)).astype(np.float32) * 0.3,
            rng.standard_normal((bt, s, g, n)).astype(np.float32) * 0.3)


# ---------------------------------------------------------------------------
# flash attention: plain version vs the JAX package
# ---------------------------------------------------------------------------

# test_kernels.py:272-278, then its head-dim-80 case (:294)
PALLAS_FLASH = [
    (128, 128, True, 0, 0, "float32", 64),
    (96, 96, False, 0, 0, "float32", 64),
    (128, 128, True, 32, 0, "float32", 64),
    (1, 256, False, 0, 255, "float32", 64),
    (128, 128, True, 0, 0, "bfloat16", 64),
    (64, 64, True, 0, 0, "float32", 80),
]


@pytest.mark.parametrize("sq,skv,causal,window,qoff,dtype,d", PALLAS_FLASH)
def test_flash_ref_matches_pallas(jx, sq, skv, causal, window, qoff, dtype, d):
    jnp = jx["jnp"]
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((1, 2, s, d)).astype(np.float32)
               for s in (sq, skv, skv))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    blk = 32 if d == 80 else 64
    want = jx["flash"](jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                       jnp.asarray(v, jdt), causal=causal, window=window,
                       q_offset=qoff, bq=blk, bk=blk)
    tdt = getattr(torch, dtype)
    # the port's layout is the model's [B, S, H, D]
    tq, tk, tv = (torch.as_tensor(a).to(tdt).transpose(1, 2).contiguous()
                  for a in (q, k, v))
    got = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window,
                                  q_offset=qoff)
    assert got.dtype == tdt
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(got.float().transpose(1, 2).numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


BLOCKWISE = {
    "gqa2-causal": dict(b=2, sq=40, skv=40, h=4, hkv=2, causal=True),
    "gqa4-window": dict(b=1, sq=50, skv=50, h=8, hkv=2, causal=True,
                        window=7),
    "offsets": dict(b=2, sq=9, skv=64, h=4, hkv=4, causal=True, qoff=30),
    "ring-negative-kv-offset": dict(b=2, sq=5, skv=21, h=4, hkv=2,
                                    causal=True, window=16, qoff=3,
                                    kvoff=-16),
    "ragged-chunks": dict(b=1, sq=37, skv=53, h=2, hkv=1, causal=False),
    "decode-row": dict(b=3, sq=1, skv=70, h=4, hkv=2, causal=True, qoff=45),
    "head-dim-80": dict(b=1, sq=20, skv=20, h=2, hkv=2, d=80, causal=True),
}


@pytest.mark.parametrize("case", list(BLOCKWISE), ids=list(BLOCKWISE))
def test_flash_ref_matches_blockwise(jx, case):
    c = {"d": 16, "window": 0, "qoff": 0, "kvoff": 0, **BLOCKWISE[case]}
    jnp = jx["jnp"]
    rng = np.random.default_rng(11)
    q, k, v = _qkv(rng, c["b"], c["sq"], c["skv"], c["h"], c["hkv"], c["d"])
    kw = dict(causal=c["causal"], window=c["window"], q_offset=c["qoff"],
              kv_offset=c["kvoff"])
    # small chunks, so the JAX twin walks several ragged q and kv chunks
    want = jx["layers"].blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_chunk=16,
        kv_chunk=16, **kw)
    got = ref.flash_attention_ref(torch.as_tensor(q), torch.as_tensor(k),
                                  torch.as_tensor(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=BLOCKWISE_RTOL, atol=BLOCKWISE_ATOL)


def test_flash_ref_fully_masked_row_reads_zero(jx):
    """Rows 0–2 sit before every key (q_offset 0, kv_offset 3, causal):
    no kept key. They read exactly 0 in both packages, not NaN."""
    jnp = jx["jnp"]
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 1, 6, 8, 2, 1, 16)
    kw = dict(causal=True, q_offset=0, kv_offset=3)
    got = ref.flash_attention_ref(torch.as_tensor(q), torch.as_tensor(k),
                                  torch.as_tensor(v), **kw).numpy()
    want = np.asarray(jx["layers"].blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    assert np.all(got[:, :3] == 0.0) and np.all(want[:, :3] == 0.0)
    assert np.isfinite(got).all() and np.abs(got[:, 3:]).max() > 0
    np.testing.assert_allclose(got, want, rtol=BLOCKWISE_RTOL,
                               atol=BLOCKWISE_ATOL)


# ---------------------------------------------------------------------------
# flash decode: the split plan and the split-and-merge step (no card needed)
# ---------------------------------------------------------------------------

#: one-row decode steps; "empty" names the cases with no kept key at all
DECODE_SPLIT = {
    "gqa1-long-cache": dict(b=2, skv=576, h=4, hkv=4, d=16, qoff=500),
    "gqa4-mid-cache": dict(b=1, skv=300, h=8, hkv=2, d=16, qoff=250),
    "gqa8": dict(b=2, skv=200, h=16, hkv=2, d=32, qoff=120),
    "gqa8-whole-cache": dict(b=2, skv=200, h=16, hkv=2, d=32, qoff=199),
    "gqa4-ring-window": dict(b=2, skv=70, h=8, hkv=2, d=16, window=16,
                             qoff=40, kvoff=-3),
    "gqa2-ring-early": dict(b=2, skv=21, h=4, hkv=2, d=16, window=16, qoff=3,
                            kvoff=-16),
    "gqa8-keys-under-one-split": dict(b=1, skv=20, h=8, hkv=1, d=16, qoff=19),
    "window-mid-cache": dict(b=1, skv=256, h=4, hkv=1, d=16, window=40,
                             qoff=180, kvoff=-10),
    "empty-causal": dict(b=1, skv=20, h=4, hkv=1, d=16, qoff=5, kvoff=10),
    "empty-window": dict(b=1, skv=50, h=4, hkv=1, d=16, window=8, qoff=60,
                         kvoff=-20),
}
#: the cases whose cache holds a whole tile of keys that the causal bound
#: (keys after the row), the window (keys before it) or negative positions
#: mask: cut into tile-long splits, such a split has no kept key
WHOLLY_MASKED = {"gqa1-long-cache", "gqa4-mid-cache", "gqa8",
                 "gqa4-ring-window", "window-mid-cache", "empty-causal",
                 "empty-window"}
#: the SMs the plans below aim at (an H100 SXM's 132)
PLAN_SMS = 132


def _decode_case(name, seed):
    c = {"window": 0, "kvoff": 0, **DECODE_SPLIT[name]}
    rng = np.random.default_rng(seed)
    q, k, v = (torch.as_tensor(t) for t in
               _qkv(rng, c["b"], 1, c["skv"], c["h"], c["hkv"], c["d"]))
    kw = dict(causal=True, window=c["window"], q_offset=c["qoff"],
              kv_offset=c["kvoff"])
    return c, q, k, v, kw


def _plan(c, kw, tile):
    rows = -(-(c["h"] // c["hkv"]) // fa._DECODE_ROWS)
    return fa.decode_split_plan(c["skv"], ctas=c["b"] * c["hkv"] * rows,
                                sm_count=PLAN_SMS, tile=tile, **kw)


@pytest.mark.parametrize("tile", sorted(set(fa._DECODE_TILE.values())))
@pytest.mark.parametrize("case", list(DECODE_SPLIT), ids=list(DECODE_SPLIT))
def test_decode_split_ref_matches_flash_ref(case, tile):
    """The split-and-merge step over the real plan, and over a plan that
    cuts every key into splits (so the causal or window bound masks whole
    splits), equals the one-piece softmax."""
    c, q, k, v, kw = _decode_case(case, 17)
    want = ref.flash_attention_ref(q, k, v, **kw)
    uncut = fa.SplitPlan(0, c["skv"], tile, -(-c["skv"] // tile))
    for plan in (_plan(c, kw, tile), uncut):
        got = ref.flash_decode_split_ref(q, k, v, plan=plan, **kw)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
    if case.startswith("empty"):
        assert torch.equal(got, torch.zeros_like(got))
    live = _plan(c, kw, tile)
    starts = range(0, c["skv"], tile)
    masked = [j0 for j0 in starts
              if min(j0 + tile, live.key_hi) <= max(j0, live.key_lo)]
    assert bool(masked) == (case in WHOLLY_MASKED), masked


@pytest.mark.parametrize("case", list(DECODE_SPLIT), ids=list(DECODE_SPLIT))
def test_decode_split_ref_matches_blockwise(jx, case):
    jnp = jx["jnp"]
    c, q, k, v, kw = _decode_case(case, 19)
    got = ref.flash_decode_split_ref(q, k, v, plan=_plan(c, kw, 64), **kw)
    want = np.asarray(jx["layers"].blockwise_attention(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), q_chunk=16,
        kv_chunk=16, **kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if case.startswith("empty"):
        assert np.all(got.numpy() == 0.0) and np.all(want == 0.0)


@pytest.mark.parametrize("ctas", [1, 16, 256, 1024])
@pytest.mark.parametrize("tile", sorted(set(fa._DECODE_TILE.values())))
def test_decode_split_plan_covers_the_kept_keys(ctas, tile):
    """The plan's range is exactly the keys the mask keeps, its splits are
    whole tiles that cover the range in order with none empty, and there
    are enough of them that the CTAs cover the plan's waves of the card
    (``_DECODE_WAVES`` CTAs an SM) where the keys allow."""
    grid = [(skv, causal, window, qoff, kvoff)
            for skv in (1, 20, 64, 65, 576)
            for causal in (True, False)
            for window in (0, 8, 100)
            for qoff, kvoff in ((0, 0), (skv - 1, 0), (skv // 2, 0),
                                (40, -30), (5, 10), (700, 0))]
    for skv, causal, window, qoff, kvoff in grid:
        kw = dict(causal=causal, window=window, q_offset=qoff,
                  kv_offset=kvoff)
        plan = fa.decode_split_plan(skv, ctas=ctas, sm_count=PLAN_SMS,
                                    tile=tile, **kw)
        cols = kvoff + np.arange(skv)
        keep = cols >= 0
        if causal:
            keep &= cols <= qoff
        if window > 0:
            keep &= cols >= qoff - window + 1
        kept_j = np.flatnonzero(keep)
        if kept_j.size == 0:
            assert plan == fa.SplitPlan(0, 0, 0, 1), (skv, kw)
            continue
        assert (plan.key_lo, plan.key_hi) == (kept_j[0], kept_j[-1] + 1)
        assert kept_j.size == plan.key_hi - plan.key_lo        # contiguous
        assert plan.split_len % tile == 0 and plan.split_len > 0
        starts = plan.key_lo + plan.split_len * np.arange(plan.n_splits)
        assert starts[-1] < plan.key_hi                        # none empty
        assert starts[-1] + plan.split_len >= plan.key_hi      # all covered
        n_tiles = -(-(plan.key_hi - plan.key_lo) // tile)
        assert (ctas * plan.n_splits >= fa._DECODE_WAVES * PLAN_SMS
                or plan.n_splits == n_tiles), (skv, kw, plan)


@pytest.mark.parametrize("waves", [0, 1, 2, 4])
@pytest.mark.parametrize("ctas", [1, 16, 256])
def test_decode_split_plan_waves(ctas, waves):
    """``waves`` sets the CTAs the plan aims for: 0 is one split over the
    whole live range; more waves never give fewer splits, and each target
    is met where the keys allow. The plan under any target is still the
    one-piece softmax."""
    tile = 64
    for skv, qoff, window in ((576, 575, 0), (4096, 4095, 0), (300, 250, 40),
                              (20, 19, 0)):
        kw = dict(causal=True, window=window, q_offset=qoff)
        plan = fa.decode_split_plan(skv, ctas=ctas, sm_count=PLAN_SMS,
                                    tile=tile, waves=waves, **kw)
        fewer = fa.decode_split_plan(skv, ctas=ctas, sm_count=PLAN_SMS,
                                     tile=tile, waves=max(waves - 1, 0), **kw)
        assert plan.n_splits >= fewer.n_splits
        n_tiles = -(-(plan.key_hi - plan.key_lo) // tile)
        if waves == 0:
            assert plan.n_splits == 1
            assert plan.split_len >= plan.key_hi - plan.key_lo
        else:
            assert (ctas * plan.n_splits >= waves * PLAN_SMS
                    or plan.n_splits == n_tiles), (skv, plan)
    c, q, k, v, kw = _decode_case("gqa8", 23)
    plan = fa.decode_split_plan(c["skv"], ctas=ctas, sm_count=PLAN_SMS,
                                tile=32, waves=waves, **kw)
    np.testing.assert_allclose(
        ref.flash_decode_split_ref(q, k, v, plan=plan, **kw).numpy(),
        ref.flash_attention_ref(q, k, v, **kw).numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# SSD scan: plain version vs the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,h,p,n,chunk", [
    (128, 2, 16, 8, 32), (96, 1, 8, 4, 32), (256, 2, 32, 16, 64)])
def test_ssd_ref_matches_pallas(jx, s, h, p, n, chunk):
    jnp = jx["jnp"]
    rng = np.random.default_rng(5)
    x, dt, a, b, c = _ssd_inputs(rng, 2, s, h, p, n, h)
    want = jx["ssd"](*(jnp.asarray(t) for t in (x, dt, a, b, c)),
                     chunk=chunk)
    got, _ = ref.ssd_scan_ref(*(torch.as_tensor(t) for t in (x, dt, a, b, c)),
                              chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=SSD_PALLAS_ATOL, rtol=SSD_PALLAS_RTOL)


SSD_CHUNKED = {
    "heads": dict(bt=2, s=64, h=4, p=8, n=4, g=4, chunk=16, s0=False),
    "groups-s0": dict(bt=2, s=64, h=4, p=8, n=4, g=2, chunk=16, s0=True),
    "one-group-ragged": dict(bt=1, s=45, h=4, p=16, n=8, g=1, chunk=16,
                             s0=False),
    "ragged-s0": dict(bt=2, s=37, h=2, p=4, n=8, g=1, chunk=32, s0=True),
    "short-prompt": dict(bt=1, s=5, h=2, p=8, n=4, g=1, chunk=32, s0=True),
}


@pytest.mark.parametrize("case", list(SSD_CHUNKED), ids=list(SSD_CHUNKED))
def test_ssd_ref_matches_chunked(jx, case):
    c = SSD_CHUNKED[case]
    jnp = jx["jnp"]
    rng = np.random.default_rng(9)
    x, dt, a, b, cm = _ssd_inputs(rng, c["bt"], c["s"], c["h"], c["p"],
                                  c["n"], c["g"])
    s0 = (rng.standard_normal((c["bt"], c["h"], c["n"], c["p"]))
          .astype(np.float32) if c["s0"] else None)
    rep = c["h"] // c["g"]
    y_j, last_j = jx["layers"]._ssd_chunked(
        jnp.asarray(x), jnp.asarray(dt), jnp.asarray(a),
        jnp.repeat(jnp.asarray(b), rep, axis=2),
        jnp.repeat(jnp.asarray(cm), rep, axis=2), c["chunk"],
        s0=None if s0 is None else jnp.asarray(s0))
    y, last = ref.ssd_scan_ref(
        *(torch.as_tensor(t) for t in (x, dt, a, b, cm)), chunk=c["chunk"],
        s0=None if s0 is None else torch.as_tensor(s0))
    assert y.dtype == last.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=SSD_RTOL,
                               atol=SSD_ATOL)
    np.testing.assert_allclose(last.numpy(), np.asarray(last_j),
                               rtol=SSD_RTOL, atol=SSD_ATOL)


def test_ssd_prefill_then_decode_continues_scan(jx):
    """The scan over 48 steps, then 16 plain decode steps from its state,
    equals the scan over all 64 (test_kernels.py:322), and the decode step
    equals the JAX package's."""
    jnp = jx["jnp"]
    rng = np.random.default_rng(13)
    bt, s, h, p, n = 1, 64, 2, 8, 4
    x, dt, a, b, c = (torch.as_tensor(t) for t in
                      _ssd_inputs(rng, bt, s, h, p, n, h))
    y_full, last_full = ref.ssd_scan_ref(x, dt, a, b, c, chunk=16)
    _, state = ref.ssd_scan_ref(x[:, :48], dt[:, :48], a, b[:, :48],
                                c[:, :48], chunk=16)
    ys = []
    for t in range(48, 64):
        y_t, new = ref.ssd_decode_ref(state, x[:, t], dt[:, t], a, b[:, t],
                                      c[:, t])
        y_j, new_j = jx["ref"].ssd_decode_ref(
            *(jnp.asarray(v.numpy()) for v in (state, x[:, t], dt[:, t], a,
                                                b[:, t], c[:, t])))
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j),
                                   rtol=SSD_RTOL, atol=SSD_ATOL)
        np.testing.assert_allclose(new.numpy(), np.asarray(new_j),
                                   rtol=SSD_RTOL, atol=SSD_ATOL)
        ys.append(y_t)
        state = new
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(),
                               y_full[:, 48:].numpy(), atol=2e-5, rtol=2e-4)
    np.testing.assert_allclose(state.numpy(), last_full.numpy(), atol=2e-5,
                               rtol=2e-4)


# ---------------------------------------------------------------------------
# the SSD kernel's plan and its bf16 arithmetic (no card needed)
# ---------------------------------------------------------------------------

#: a block's shared memory on the H100: an SM's 228 KB, 1 KB reserved a block
SM_SMEM, BLOCK_RESERVED = 233472, 1024


@pytest.mark.parametrize("n,p", [(64, 64), (128, 64)])
def test_ssd_plan_runs_the_models_chunk_in_bf16(n, p):
    """zamba2-2.7b (N = P = 64) and mamba2-370m (N = 128) keep their chunk
    of 128 on the tensor cores; at N = P = 64 two blocks fit an SM."""
    plan = ss.ssd_plan(n, p, 128, 512, torch.bfloat16)
    assert (plan.lc, plan.n_pad, plan.p_pad) == (128, n, p)
    assert plan.smem_bytes <= ss.MAX_SMEM
    blocks = SM_SMEM // (plan.smem_bytes + BLOCK_RESERVED)
    assert blocks == (2 if n == 64 else 1)


@pytest.mark.parametrize("n,p,chunk,s,want", [
    (64, 64, 128, 512, 128), (128, 64, 128, 300, 64), (16, 16, 32, 77, 32),
    (64, 64, 5, 512, 8), (64, 64, 128, 5, 8)])
def test_ssd_plan_float32_keeps_the_fma_kernels_chunk(n, p, chunk, s, want):
    """float32: the chunk cut to S, rounded up to a multiple of 4 and halved
    while the FMA kernel's block exceeds 227 KB (N = 128 halves)."""
    plan = ss.ssd_plan(n, p, chunk, s, torch.float32)
    assert plan.lc == want
    assert plan.smem_bytes == 4 * (2 * n * want + want * p + want * want
                                   + n * p + 3 * want) <= ss.MAX_SMEM


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,p,chunk,s", [
    (4, 8, 32, 96), (8, 16, 32, 128), (16, 32, 64, 256), (20, 12, 128, 40),
    (64, 64, 128, 9), (64, 64, 256, 1024), (128, 64, 128, 5), (100, 60, 64, 1),
    (128, 64, 512, 2048), (64, 64, 1, 7)])
def test_ssd_plan_blocks_the_same_function(n, p, chunk, s, dtype):
    """Any plan is a blocking the kernel takes: a chunk of the kernel's
    step (4; bf16: 16, at most 128), no longer than needed, halved only
    while the block does not fit; bf16 pads N and P to a power of two."""
    dt = getattr(torch, dtype)
    plan = ss.ssd_plan(n, p, chunk, s, dt)
    step = 16 if dt == torch.bfloat16 else 4
    want = max(1, min(chunk, s))
    assert plan.lc % step == 0 and plan.lc < want + step
    assert plan.smem_bytes <= ss.MAX_SMEM
    if dt == torch.bfloat16:
        assert plan.lc <= 128
        for v, pad in ((n, plan.n_pad), (p, plan.p_pad)):
            assert max(v, 16) <= pad < 2 * max(v, 16)
            assert pad & (pad - 1) == 0
        assert plan.smem_bytes == 2 * max(
            2 * plan.lc * (2 * plan.n_pad + plan.p_pad),
            6 * plan.n_pad * plan.p_pad) + 2048
    if plan.lc < -(-want // step) * step:        # halved: twice would not fit
        assert ss.ssd_plan(n, p, 2 * plan.lc, 2 * plan.lc, dt).lc < 2 * plan.lc


@pytest.mark.parametrize("n,p", [(256, 64), (64, 128)])
def test_ssd_plan_refuses_bf16_beyond_its_tiles(n, p):
    with pytest.raises(ValueError, match="bfloat16 kernel takes"):
        ss.ssd_plan(n, p, 128, 512, torch.bfloat16)
    assert ss.ssd_plan(n, p, 128, 512, torch.float32).lc >= 4


def _bf16_terms(t, terms):
    """``t`` (float32) as the sum of ``terms`` bf16 values: hi, then the
    rest's hi, ... — in float64."""
    out, rest = torch.zeros_like(t, dtype=torch.float64), t.float()
    for _ in range(terms):
        hi = rest.to(torch.bfloat16).float()
        out, rest = out + hi.double(), rest - hi
    return out


def _ssd_bf16_emulation(x, dt, a, b, c, chunk, s0, terms):
    """The bf16 kernel's arithmetic around its roundings, in float64
    elsewhere: the prefix sums and decays in float32 (powers of 2 of
    dt A log2 e), M, w B and the state as ``terms`` = (M, w B, S) bf16
    terms each, x, B and C exact."""
    bt, s, h, p = x.shape
    rep = h // b.shape[2]
    bh, ch, xd = (t.double() for t in (b.repeat_interleave(rep, 2),
                                       c.repeat_interleave(rep, 2), x))
    state = s0.double()
    y = torch.empty((bt, s, h, p), dtype=torch.float64)
    for c0 in range(0, s, chunk):
        sl = slice(c0, min(c0 + chunk, s))
        dtc = dt[:, sl].float()
        cum = torch.cumsum(dtc * (a.float() * 1.4426950408889634), 1)
        total = cum[:, -1]
        li = torch.arange(cum.shape[1])
        keep = (li[:, None] >= li[None, :])[None, :, :, None]
        diff = (cum[:, :, None] - cum[:, None, :]).masked_fill(~keep, 0.0)
        decay = torch.exp2(diff).masked_fill(~keep, 0.0)
        g = torch.einsum("bihn,bjhn->bijh", ch[:, sl], bh[:, sl]).float()
        m = _bf16_terms(g * decay * dtc[:, None], terms[0])
        y_intra = torch.einsum("bijh,bjhp->bihp", m, xd[:, sl])
        y_inter = torch.einsum("bihn,bhnp->bihp", ch[:, sl],
                               _bf16_terms(state.float(), terms[2]))
        y[:, sl] = y_intra + y_inter * torch.exp2(cum).double()[..., None]
        w = torch.exp2(total[:, None] - cum) * dtc
        wb = _bf16_terms(bh[:, sl].float() * w[..., None], terms[1])
        state = state * torch.exp2(total).double()[..., None, None] \
            + torch.einsum("bjhn,bjhp->bhnp", wb, xd[:, sl])
    return y, state


SSD_SPLIT = {
    "from-zero": dict(s=256, n=64, kind=""),
    "s0": dict(s=256, n=64, kind="s0"),
    "s0x100": dict(s=256, n=64, kind="s0x100"),
    "s0x100-n128": dict(s=256, n=128, kind="s0x100"),
    "dt0-ragged": dict(s=200, n=64, kind="dt0"),
}


def _split_case(case):
    c = SSD_SPLIT[case]
    rng = np.random.default_rng(21)
    x, dt, a, b, cm = _ssd_inputs(rng, 1, c["s"], 2, 64, c["n"], 1)
    s0 = rng.standard_normal((1, 2, c["n"], 64)).astype(np.float32)
    s0 = _ssd_kind(c["kind"], dt, s0) if c["kind"] else np.zeros_like(s0)
    x, b, cm = (torch.as_tensor(t).to(torch.bfloat16) for t in (x, b, cm))
    return (x, torch.as_tensor(dt), torch.as_tensor(a), b, cm,
            torch.as_tensor(s0))


@pytest.mark.parametrize("case", list(SSD_SPLIT), ids=list(SSD_SPLIT))
def test_ssd_bf16_split_holds_the_float32_bar(case):
    """M and w B in two bf16 terms and the state in three keep the bf16
    kernel's arithmetic within 1e-4 + 1e-4 of the plain version (the bar
    the card holds the kernel to) at zamba2's per-head widths, the state at
    100x included."""
    x, dt, a, b, c, s0 = _split_case(case)
    y, last = _ssd_bf16_emulation(x, dt, a, b, c, 128, s0, terms=(2, 2, 3))
    y_r, last_r = ref.ssd_scan_ref(x, dt, a, b, c, chunk=128, s0=s0)
    np.testing.assert_allclose(y.numpy(), y_r.double().numpy(),
                               atol=CARD_ATOL, rtol=CARD_RTOL)
    np.testing.assert_allclose(last.numpy(), last_r.double().numpy(),
                               atol=CARD_ATOL, rtol=CARD_RTOL)


@pytest.mark.parametrize("terms", [(1, 1, 1), (2, 2, 2)],
                         ids=["one-rounding", "state-in-two"])
def test_ssd_bf16_fewer_terms_miss_the_bar(terms):
    """Why the split: one bf16 rounding of each float operand misses the
    bar from a unit state, and a two-term state misses it at 100x."""
    x, dt, a, b, c, s0 = _split_case("s0" if terms[0] == 1 else "s0x100")
    y, _ = _ssd_bf16_emulation(x, dt, a, b, c, 128, s0, terms=terms)
    y_r, _ = ref.ssd_scan_ref(x, dt, a, b, c, chunk=128, s0=s0)
    excess = (y - y_r.double()).abs() - CARD_RTOL * y_r.double().abs()
    assert float(excess.max()) > CARD_ATOL


# ---------------------------------------------------------------------------
# dispatch and the wrappers' refusals (no card needed)
# ---------------------------------------------------------------------------

def test_ops_take_the_plain_versions_on_the_cpu():
    rng = np.random.default_rng(2)
    q, k, v = (torch.as_tensor(t) for t in _qkv(rng, 2, 5, 9, 4, 2, 16))
    kw = dict(causal=True, window=4, q_offset=4, kv_offset=0)
    assert torch.equal(ops.flash_attention(q, k, v, **kw),
                       ref.flash_attention_ref(q, k, v, **kw))
    args = [torch.as_tensor(t) for t in _ssd_inputs(rng, 1, 20, 4, 8, 4, 2)]
    y, st = ops.ssd_scan(*args, chunk=8)
    y_r, st_r = ref.ssd_scan_ref(*args, chunk=8)
    assert torch.equal(y, y_r) and torch.equal(st, st_r)


def test_ops_refuse_inputs_that_require_grad():
    """Inference only, on either device: an input that requires grad
    raises rather than returning a result with no history."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.as_tensor(t) for t in _qkv(rng, 1, 4, 4, 2, 2, 8))
    with pytest.raises(RuntimeError, match="inference only"):
        ops.flash_attention(q.requires_grad_(), k, v, causal=True)
    args = [torch.as_tensor(t) for t in _ssd_inputs(rng, 1, 8, 2, 4, 4, 1)]
    args[0].requires_grad_()
    with pytest.raises(RuntimeError, match="inference only"):
        ops.ssd_scan(*args, chunk=4)
    with torch.no_grad():
        ops.ssd_scan(*args, chunk=4)


def test_wrappers_take_cuda_tensors_only():
    rng = np.random.default_rng(6)
    q, k, v = (torch.as_tensor(t) for t in _qkv(rng, 1, 4, 4, 2, 2, 8))
    before = (fa.flash_attention_cuda.launches, ss.ssd_scan_cuda.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_cuda(q, k, v, causal=True)
    args = [torch.as_tensor(t) for t in _ssd_inputs(rng, 1, 8, 2, 4, 4, 1)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        ss.ssd_scan_cuda(*args, chunk=4)
    assert (fa.flash_attention_cuda.launches,
            ss.ssd_scan_cuda.launches) == before


# ---------------------------------------------------------------------------
# on a card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    from repro_torch.core.gnn import resolve_device
    return resolve_device("cuda")


def _card_close(got, want, dtype):
    tol = CARD_BF16 if dtype == torch.bfloat16 else CARD_ATOL
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol,
                               rtol=tol if dtype == torch.bfloat16
                               else CARD_RTOL)


CARD_FLASH = [
    dict(b=1, sq=128, skv=128, h=2, hkv=2, d=64, causal=True),
    dict(b=2, sq=33, skv=70, h=8, hkv=2, d=16, causal=True, window=16,
         qoff=40, kvoff=-3),
    dict(b=2, sq=1, skv=576, h=4, hkv=4, d=80, causal=True, qoff=500),
    dict(b=1, sq=5, skv=20, h=2, hkv=1, d=120, causal=True, window=4,
         kvoff=-12),
    dict(b=1, sq=6, skv=8, h=2, hkv=1, d=128, causal=True, kvoff=3),
    dict(b=2, sq=70, skv=70, h=4, hkv=4, d=64, causal=False),
    # query tiles around the 64-row warpgroup and the 128-row CTA, every
    # padded head dim of the tensor-core path (16, 64, 80, 120 -> 128, 128)
    dict(b=1, sq=63, skv=63, h=2, hkv=2, d=64, causal=True),
    dict(b=1, sq=64, skv=64, h=2, hkv=1, d=80, causal=True),
    dict(b=1, sq=65, skv=65, h=2, hkv=2, d=120, causal=True),
    dict(b=1, sq=200, skv=260, h=4, hkv=2, d=128, causal=True, qoff=60),
    dict(b=1, sq=512, skv=576, h=2, hkv=2, d=80, causal=True),
    dict(b=1, sq=40, skv=96, h=4, hkv=1, d=16, causal=True, window=24,
         qoff=70, kvoff=-10),
    dict(b=1, sq=3, skv=24, h=2, hkv=2, d=16, causal=False),  # < one tile
    # head dims 24 and 32, padded to 64 like every D <= 64 but 16
    dict(b=2, sq=70, skv=90, h=4, hkv=2, d=32, causal=True, qoff=20),
    dict(b=1, sq=130, skv=130, h=2, hkv=1, d=24, causal=True, window=48),
    # more work items than SMs, so each persistent CTA takes several, some
    # with no kept key (rows 0-149 sit before every key)
    dict(b=4, sq=300, skv=300, h=40, hkv=8, d=64, causal=True, kvoff=150),
    # decode: grouped heads 4 and 8 over several splits, a window over the
    # ring's negative offset, fewer keys than a tile, no kept key at all
    dict(b=1, sq=1, skv=576, h=16, hkv=4, d=64, causal=True, qoff=575),
    dict(b=1, sq=1, skv=576, h=16, hkv=2, d=128, causal=True, qoff=575),
    dict(b=1, sq=1, skv=300, h=8, hkv=2, d=120, causal=True, window=40,
         qoff=250, kvoff=-30),
    dict(b=1, sq=1, skv=24, h=4, hkv=1, d=64, causal=True, qoff=23),
    dict(b=2, sq=1, skv=20, h=4, hkv=1, d=80, causal=True, qoff=5, kvoff=10),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(CARD_FLASH)))
def test_flash_kernel_matches_plain(card, case, dtype):
    c = {"window": 0, "qoff": 0, "kvoff": 0, **CARD_FLASH[case]}
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(case)
    q, k, v = (torch.as_tensor(t, device=card).to(dt) for t in
               _qkv(rng, c["b"], c["sq"], c["skv"], c["h"], c["hkv"], c["d"]))
    kw = dict(causal=c["causal"], window=c["window"], q_offset=c["qoff"],
              kv_offset=c["kvoff"])
    n0 = fa.flash_attention_cuda.launches
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == n0 + 1
    _card_close(got, ref.flash_attention_ref(q, k, v, **kw), dt)


#: (Bt, S, H, P, N, G, chunk, kind): kind "s0x100" scales the initial
#: state by 100, "dt0" sets dt to 0 on rows 10-39 and 130
CARD_SSD = [
    (2, 128, 2, 16, 8, 1, 32, ""), (1, 77, 4, 16, 16, 2, 32, ""),
    (2, 300, 8, 64, 64, 1, 128, ""), (1, 130, 4, 64, 128, 1, 128, ""),
    # the bf16 tensor-core kernel's edges: S < 16; a last chunk of 72 rows
    # (not a multiple of 16); N = 128 at chunk 128; G = 2 with 4 heads; the
    # state at 100x (its three-term split); steps with dt = 0; N and P not
    # multiples of 8
    (2, 9, 4, 64, 64, 1, 128, ""), (1, 200, 4, 64, 64, 1, 128, ""),
    (2, 256, 4, 64, 128, 1, 128, ""), (2, 160, 4, 64, 64, 2, 128, ""),
    (1, 256, 4, 64, 64, 1, 128, "s0x100"), (2, 256, 4, 64, 64, 1, 128, "dt0"),
    (1, 40, 2, 12, 20, 1, 128, ""),
]


def _ssd_kind(kind, dt, s0):
    """dt and s0 as SSD case ``kind`` asks (numpy, in place for dt)."""
    if kind == "dt0":
        dt[:, 10:40] = 0.0
        dt[:, 130:131] = 0.0
    return s0 * 100.0 if kind == "s0x100" else s0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", CARD_SSD)
def test_ssd_kernel_matches_plain(card, shape, dtype):
    """Both dtypes at the float32 bar: the bf16 kernel splits its float
    operands into bf16 terms (csrc/ssd_scan.cu)."""
    bt, s, h, p, n, g, chunk, kind = shape
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(s)
    x, dtt, a, b, c = _ssd_inputs(rng, bt, s, h, p, n, g)
    s0 = _ssd_kind(kind, dtt, rng.standard_normal((bt, h, n, p))
                   .astype(np.float32))
    x, b, c = (torch.as_tensor(t, device=card).to(dt) for t in (x, b, c))
    dtt, a = torch.as_tensor(dtt, device=card), torch.as_tensor(a, device=card)
    s0 = torch.as_tensor(s0, device=card)
    for init in (None, s0):
        n0 = ss.ssd_scan_cuda.launches
        y, last = ops.ssd_scan(x, dtt, a, b, c, chunk=chunk, s0=init)
        torch.cuda.synchronize()
        assert ss.ssd_scan_cuda.launches == n0 + 1
        y_r, last_r = ref.ssd_scan_ref(x, dtt, a, b, c, chunk=chunk, s0=init)
        _card_close(y, y_r, torch.float32)
        _card_close(last, last_r, torch.float32)
