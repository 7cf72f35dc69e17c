"""Mixture-of-experts and MLA in the PyTorch port against the JAX package.

On the CPU, at the two smoke configs in float32 (deepseek-v2: MLA, a dense
layer 0, eight experts top-2 with a shared one; grok-1: GQA, four experts
top-2), seeded numpy inputs go through ``repro.models`` and the port:

* ``_route`` and ``moe_apply_local`` at 1e-5 (float32 products in
  another order): expert ids, keep masks and slots exactly equal; drops
  forced by a ``capacity_factor`` of 0.5 and by decode's capacity of 1 at
  B = 2; tied router columns (the lower expert first, as ``lax.top_k``);
  the Switch aux loss; a bfloat16 block at 2e-2 with the same ids; the
  trees' shapes, the float32 router and ``wg == wu`` at init;
* ``mla_apply`` in both forms (the materialised heads of a full sequence,
  the weight-absorbed form over a cache) at 1e-5;
* ``forward``, ``loss_fn``'s value, a one-shot ``decode_step``, 12
  incremental steps and 12 greedy tokens of ``make_prefill_step`` +
  ``make_serve_step`` against ``repro.models.lm`` at the LM bar of 1e-4
  (``tests/test_torch_lm.py``), with the tokens equal;
* the flash twin (``flash_attention_ref``) at a value head dim Dv != D
  against ``blockwise_attention`` at small chunks, at D = Dv = 192
  against ``flash_attention_pallas`` in interpret mode, and the
  split-decode twin at Dv != D;
* the trace path takes an MoE or MLA config (their graph forms, held to
  the reference by ``tests/test_torch_lm_trace.py``) and training
  refuses it (ROADMAP A14b-3).

On a card (marked ``cuda``): B8's kernel at MLA's head dims (D 24 to 576,
Dv below D) against its twin, in float32 (1e-4) and bfloat16 (2e-2).
JAX is imported only inside the fixtures that compare with it; the card's
test runs where JAX is not installed:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_lm_moe_mla.py``.
"""
import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import layers, lm  # noqa: E402

ARCHS = ["deepseek-v2-236b", "grok-1-314b"]
#: float32 sums in another order through 2–3 layers and the head
ATOL = RTOL = 1e-4
#: one block: float32 products in another order
BLOCK_ATOL = BLOCK_RTOL = 1e-5
PROMPT, MAX_LEN, STEPS = 40, 64, 12
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}    # test_kernels.py's bars
CARD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}     # kernel vs plain


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the file's float32 sums in one order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.flash_attention import flash_attention_pallas
    from repro.models import layers as jlayers
    from repro.models import lm as jlm
    return dict(jax=jax, jnp=jnp, lm=jlm, layers=jlayers,
                flash=flash_attention_pallas)


def _np_tree(tree):
    import jax
    import jax.numpy as jnp
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else np.asarray(a), tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree))


@functools.lru_cache(maxsize=None)
def _jax_tree(arch: str):
    """The JAX package's smoke-config tree (PRNGKey 0) and its numpy copy."""
    import jax
    from repro.configs import get_smoke_config as jget
    from repro.models import lm as jlm
    cfg = jget(arch)
    # jitted: the same values as the eager call, in a tenth of the time
    tree = jax.jit(lambda key: jlm.init_params(key, cfg))(
        jax.random.PRNGKey(0))
    return tree, _np_tree(tree)


def _port_params(arch):
    return lm.params_from_numpy(_jax_tree(arch)[1], get_smoke_config(arch),
                                device="cpu")


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)) \
        .astype(np.int32)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


# ---------------------------------------------------------------------------
# B8's twin at MLA's head dims against the JAX package
# ---------------------------------------------------------------------------

def _qkv(rng, b, sq, skv, h, hkv, d, dv):
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, dv)).astype(np.float32))


#: the twin against ``blockwise_attention`` at Dv != D: the smoke MLA's two
#: forms (24 / 16, 40 / 32 over one latent kv head), the full model's
BLOCKWISE_DV = {
    "full-sequence-24-16": dict(b=2, sq=37, skv=37, h=4, hkv=4, d=24, dv=16,
                                causal=True),
    "absorbed-40-32": dict(b=2, sq=9, skv=64, h=4, hkv=1, d=40, dv=32,
                           causal=True, qoff=30),
    "absorbed-decode-row": dict(b=2, sq=1, skv=50, h=4, hkv=1, d=40, dv=32,
                                causal=True, qoff=41),
    "full-sequence-192-128": dict(b=1, sq=20, skv=20, h=2, hkv=2, d=192,
                                  dv=128, causal=True),
    "absorbed-576-512-mqa": dict(b=1, sq=5, skv=40, h=8, hkv=1, d=576,
                                 dv=512, causal=True, qoff=20),
    "ring-window": dict(b=1, sq=6, skv=21, h=4, hkv=2, d=48, dv=24,
                        causal=True, window=9, qoff=4, kvoff=-12),
    "bidirectional": dict(b=1, sq=17, skv=33, h=2, hkv=1, d=32, dv=8,
                          causal=False),
}


@pytest.mark.parametrize("case", list(BLOCKWISE_DV), ids=list(BLOCKWISE_DV))
def test_flash_ref_at_dv_matches_blockwise(jx, case):
    c = {"window": 0, "qoff": 0, "kvoff": 0, **BLOCKWISE_DV[case]}
    jnp = jx["jnp"]
    rng = np.random.default_rng(31)
    q, k, v = _qkv(rng, c["b"], c["sq"], c["skv"], c["h"], c["hkv"], c["d"],
                   c["dv"])
    # MLA's scale, 1 / sqrt(nope + rope), where the call gives one
    kw = dict(causal=c["causal"], window=c["window"], q_offset=c["qoff"],
              kv_offset=c["kvoff"], scale=1.0 / math.sqrt(c["d"] * 0.75))
    want = jx["layers"].blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_chunk=8,
        kv_chunk=16, **kw)
    got = ref.flash_attention_ref(torch.as_tensor(q), torch.as_tensor(k),
                                  torch.as_tensor(v), **kw)
    assert got.shape == (c["b"], c["sq"], c["h"], c["dv"])
    _close(got, want, BLOCK_ATOL, BLOCK_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,qoff", [(True, 0), (False, 0), (True, 24)])
def test_flash_ref_at_192_matches_pallas(jx, causal, qoff, dtype):
    """D = Dv = 192, which the Pallas kernel pads to 256."""
    jnp = jx["jnp"]
    rng = np.random.default_rng(37)
    sq, skv, d = 40, 64, 192
    q, k, v = (rng.standard_normal((1, 2, s, d)).astype(np.float32)
               for s in (sq, skv, skv))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = jx["flash"](jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                       jnp.asarray(v, jdt), causal=causal, q_offset=qoff,
                       bq=32, bk=32)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.as_tensor(a).to(tdt).transpose(1, 2).contiguous()
                  for a in (q, k, v))
    got = ref.flash_attention_ref(tq, tk, tv, causal=causal, q_offset=qoff)
    assert got.dtype == tdt
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(got.float().transpose(1, 2).numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


#: the split decode at Dv != D: (b, skv, h, hkv, d, dv, qoff, kvoff, window)
SPLIT_DV = {
    "mla-576-512": (2, 300, 16, 1, 576, 512, 290, 0, 0),
    "smoke-40-32": (2, 400, 4, 1, 40, 32, 390, 0, 0),
    "gqa-192-128-window": (1, 200, 8, 2, 192, 128, 150, -20, 150),
}


@pytest.mark.parametrize("case", list(SPLIT_DV), ids=list(SPLIT_DV))
def test_decode_split_ref_at_dv(case):
    b, skv, h, hkv, d, dv, qoff, kvoff, window = SPLIT_DV[case]
    rng = np.random.default_rng(41)
    q, k, v = (torch.as_tensor(a) for a in _qkv(rng, b, 1, skv, h, hkv, d,
                                                 dv))
    kw = dict(causal=True, window=window, q_offset=qoff, kv_offset=kvoff,
              scale=0.07)
    tile = fa.decode_tile(torch.bfloat16, d)
    assert tile == (32 if d > 128 else 64)
    plan = fa.decode_split_plan(skv, ctas=b * hkv * -(-(h // hkv) // 8),
                                sm_count=132, tile=tile, **{
                                    k_: v_ for k_, v_ in kw.items()
                                    if k_ != "scale"})
    assert plan.n_splits > 1
    got = ref.flash_decode_split_ref(q, k, v, plan=tuple(plan), **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    assert got.shape == (b, 1, h, dv)
    _close(got, want, BLOCK_ATOL, BLOCK_ATOL)


def test_wrapper_refuses_head_dims_it_does_not_take(monkeypatch):
    """Checked before the card is touched: Dv > D, Dv not a multiple of 8,
    D past 576; the log-sum-exp and the backward past D = 192, and the
    backward at Dv > D or Dv not a multiple of 8 (until MLA trained, both
    stayed at D <= 128 with Dv == D)."""
    monkeypatch.setattr(fa, "_cuda_device",
                        lambda t: torch.device("cuda", 0))
    meta = lambda *s: torch.zeros(s, device="meta")  # noqa: E731
    q = k = meta(1, 4, 2, 64)
    for v in (meta(1, 4, 2, 72), meta(1, 4, 2, 20)):
        with pytest.raises(ValueError, match="v's head dim"):
            fa.flash_attention_cuda(q, k, v, causal=True)
    big = meta(1, 4, 2, 584)
    with pytest.raises(ValueError, match="head dim 584"):
        fa.flash_attention_cuda(big, big, big, causal=True)
    wide = meta(1, 4, 2, 200)
    with pytest.raises(ValueError, match="with_lse takes D <= 192"):
        fa.flash_attention_cuda(wide, wide, meta(1, 4, 2, 128), causal=True,
                                with_lse=True)
    lse = meta(1, 2, 4)
    with pytest.raises(ValueError, match=r"head dim 200 .*\[8, 192\]"):
        fa.flash_attention_bwd_cuda(wide, wide, wide, wide, lse, wide,
                                    causal=True)
    q = k = meta(1, 4, 2, 192)
    v = meta(1, 4, 2, 128)
    with pytest.raises(ValueError, match="v's head dim 200"):
        fa.flash_attention_bwd_cuda(q, k, wide, wide, lse, wide, causal=True)
    with pytest.raises(ValueError, match="v's head dim 20 "):
        fa.flash_attention_bwd_cuda(q, k, meta(1, 4, 2, 20), v, lse, v,
                                    causal=True)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _flat(tree, path=""):
    out = {}
    for k, v in tree.items():
        key = f"{path}['{k}']"
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_jax_tree_shape(jx, arch):
    """Keys, shapes, dtypes and stacked axes: ``pre`` (deepseek's dense
    layer 0) and ``blocks``, the nested ``experts``, the float32 router."""
    tu = jx["jax"].tree_util
    port = lm.init_params(get_smoke_config(arch), seed=0, device="cpu")
    tree = _jax_tree(arch)[0]
    flat_j = {tu.keystr(k): v for k, v in tu.tree_flatten_with_path(tree)[0]}
    flat_p = _flat(port)
    assert flat_p.keys() == flat_j.keys()
    for k, v in flat_p.items():
        assert tuple(v.shape) == flat_j[k].shape, k
        assert str(v.dtype).removeprefix("torch.") == str(flat_j[k].dtype), k
    assert ("pre" in port) == (arch == "deepseek-v2-236b")


@pytest.mark.parametrize("arch", ARCHS)
def test_params_cross_and_come_back(arch):
    tree = _flat(_jax_tree(arch)[1])
    back = _flat(lm.params_to_numpy(_port_params(arch)))
    assert back.keys() == tree.keys()
    for k, v in tree.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_tree_keeps_the_router_float32_and_wg_equal_wu(arch):
    """In a bfloat16 config the router stays float32, from ``init_params``
    and from a JAX tree; ``wg`` and ``wu`` start equal, as the JAX
    package's ``moe_init`` draws both from one key (ROADMAP §C)."""
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="bfloat16")
    for tree in (lm.init_params(cfg, seed=2, device="cpu"),
                 lm.params_from_numpy(_jax_tree(arch)[1], cfg,
                                      device="cpu")):
        ffn = tree["blocks"]["ffn"]
        assert ffn["router"].dtype == torch.float32
        assert ffn["experts"]["wg"].dtype == torch.bfloat16
        assert tree["blocks"]["attn"]["wo"].dtype == torch.bfloat16
        assert torch.equal(ffn["experts"]["wg"], ffn["experts"]["wu"])
    jt = _jax_tree(arch)[1]["blocks"]["ffn"]["experts"]
    np.testing.assert_array_equal(jt["wg"], jt["wu"])


# ---------------------------------------------------------------------------
# the MoE block against the JAX package
# ---------------------------------------------------------------------------

def _moe_params(arch, layer=0):
    """Layer ``layer`` of the smoke tree's MoE stack: (JAX, port)."""
    jt = _jax_tree(arch)[0]["blocks"]["ffn"]
    import jax
    j = jax.tree_util.tree_map(lambda a: a[layer], jt)
    return j, _to_torch(_np_tree(j))


def _ref_slots(jnp, jax, ids, mo, t):
    """The reference's dispatch lines (``moe_apply_local``,
    ``repro/models/layers.py:530-537``) on its ids."""
    cap = int(math.ceil(t * mo.top_k / mo.n_experts * mo.capacity_factor))
    flat = ids.reshape(-1)
    pos = jnp.cumsum(jax.nn.one_hot(flat, mo.n_experts, dtype=jnp.int32),
                     axis=0) - 1
    pos = jnp.take_along_axis(pos, flat[:, None], axis=1)[:, 0]
    keep = pos < cap
    return (np.asarray(keep), np.asarray(jnp.where(keep, flat * cap + pos,
                                                   mo.n_experts * cap)), cap)


def _moe_x(cfg, case, rng):
    """The case's tokens: "prefill" 80 random ones, "drops" the same at a
    capacity factor of 0.5, "decode" B = 2 identical tokens (capacity 1:
    the second token's replicas drop), "ties" a zero router, so that every
    expert ties and the lower indices win."""
    t = 2 if case == "decode" else 80
    x = rng.standard_normal((t, cfg.d_model)).astype(np.float32)
    if case == "decode":
        x[1] = x[0]
    return x


MOE_CASES = ["prefill", "drops", "decode", "ties"]


@pytest.mark.parametrize("case", MOE_CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_local_matches_jax(jx, arch, case):
    jnp, jax = jx["jnp"], jx["jax"]
    cfg = get_smoke_config(arch)
    if case == "drops":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=0.5))
    mo = cfg.moe
    jp, tp = _moe_params(arch)
    if case == "ties":
        jp = dict(jp, router=jnp.zeros_like(jp["router"]))
        tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = _moe_x(cfg, case, np.random.default_rng(43))
    t = x.shape[0]

    wp, wids, waux = jx["layers"]._route(jp["router"], jnp.asarray(x), mo)
    gp, gids, gaux = layers._route(tp["router"], torch.as_tensor(x), mo)
    np.testing.assert_array_equal(gids.numpy(), np.asarray(wids))
    _close(gp, wp, BLOCK_ATOL, BLOCK_RTOL)
    _close(gaux, waux, BLOCK_ATOL, BLOCK_RTOL)
    wkeep, wslot, wcap = _ref_slots(jnp, jax, wids, mo, t)
    keep, slot, cap = layers.moe_slots(gids, mo, t)
    assert cap == wcap
    np.testing.assert_array_equal(keep.numpy(), wkeep)
    np.testing.assert_array_equal(slot.numpy(), wslot)
    dropped = int((~keep).sum())
    if case in ("drops", "ties") or cap == 1:
        assert dropped > 0, "the case must drop replicas"
    if case == "decode":    # deepseek: ceil(2·2 / 8 · 1.25) = 1
        assert cap == (1 if mo.n_experts == 8 else 2)
    if case == "ties":
        want_ids = np.broadcast_to(np.arange(mo.top_k), (t, mo.top_k))
        np.testing.assert_array_equal(gids.numpy(), want_ids)

    want, want_aux = jx["layers"].moe_apply_local(jp, cfg, jnp.asarray(x))
    got, got_aux = layers.moe_apply_local(tp, cfg, torch.as_tensor(x))
    _close(got, want, BLOCK_ATOL, BLOCK_RTOL)
    _close(got_aux, want_aux, BLOCK_ATOL, BLOCK_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_local_in_bf16_matches_jax(jx, arch):
    """A bfloat16 block (the router float32): the same ids and keep masks,
    the output at the bf16 bar (the probabilities and the buffers round
    where the reference rounds them, the products' sums in another
    order)."""
    import jax
    jnp = jx["jnp"]
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="bfloat16")
    mo = cfg.moe
    jp, _ = _moe_params(arch)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    jp["router"] = jp["router"].astype(jnp.float32)
    tp = {k: v for k, v in _to_torch(_np_tree(jp)).items()}
    tp = {"router": tp["router"],
          **{k: _cast(v, torch.bfloat16) for k, v in tp.items()
             if k != "router"}}
    x = _moe_x(cfg, "prefill", np.random.default_rng(61))
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.as_tensor(x).to(torch.bfloat16)
    _, wids, _ = jx["layers"]._route(jp["router"], xj, mo)
    _, gids, _ = layers._route(tp["router"], xt, mo)
    np.testing.assert_array_equal(gids.numpy(), np.asarray(wids))
    want, want_aux = jx["layers"].moe_apply_local(jp, cfg, xj)
    got, got_aux = layers.moe_apply_local(tp, cfg, xt)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want, np.float32), FLASH_TOL["bfloat16"],
           FLASH_TOL["bfloat16"])
    _close(got_aux, want_aux, BLOCK_ATOL, BLOCK_RTOL)


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def test_route_ties_take_the_lower_expert_first(jx):
    """Exactly tied probabilities (dyadic inputs, so every product and sum
    is exact in any order): the lower expert index first, as
    ``lax.top_k``; the renormalised probabilities and the aux loss."""
    jnp = jx["jnp"]
    mo = get_smoke_config("deepseek-v2-236b").moe
    rng = np.random.default_rng(47)
    d = 16
    x = rng.integers(-4, 5, (12, d)).astype(np.float32) / 4
    w = rng.integers(-4, 5, (d, mo.n_experts)).astype(np.float32) / 8
    w[:, 5] = w[:, 2]                          # experts 2 and 5 tie
    w[:, 7] = w[:, 2]                          # and 7
    x[::3] = 0.0                               # every expert ties
    wp, wids, waux = jx["layers"]._route(jnp.asarray(w), jnp.asarray(x), mo)
    gp, gids, gaux = layers._route(torch.as_tensor(w), torch.as_tensor(x), mo)
    np.testing.assert_array_equal(gids.numpy(), np.asarray(wids))
    np.testing.assert_array_equal(gids[::3].numpy(),
                                  np.broadcast_to(np.arange(mo.top_k),
                                                  (4, mo.top_k)))
    _close(gp, wp, BLOCK_ATOL, BLOCK_RTOL)
    _close(gaux, waux, BLOCK_ATOL, BLOCK_RTOL)


# ---------------------------------------------------------------------------
# MLA against the JAX package
# ---------------------------------------------------------------------------

def _mla_params(stack="pre"):
    import jax
    jt = _jax_tree("deepseek-v2-236b")[0][stack]["attn"]
    j = jax.tree_util.tree_map(lambda a: a[0], jt)
    return j, _to_torch(_np_tree(j))


def test_mla_full_sequence_form_matches_jax(jx):
    jnp = jx["jnp"]
    cfg = get_smoke_config("deepseek-v2-236b")
    jp, tp = _mla_params()
    b, s = 2, 21
    x = np.random.default_rng(53).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    want, (wc, wr) = jx["jax"].jit(lambda p, x, pos: jx["layers"].mla_apply(
        p, cfg, x, positions=pos))(jp, jnp.asarray(x), jnp.asarray(pos))
    got, (gc, gr) = layers.mla_apply(tp, cfg, torch.as_tensor(x),
                                     positions=torch.as_tensor(pos))
    for g, w in ((got, want), (gc, wc), (gr, wr)):
        _close(g, w, BLOCK_ATOL, BLOCK_RTOL)


@pytest.mark.parametrize("new", [1, 5])
def test_mla_absorbed_form_matches_jax(jx, new):
    """A prompt of 14 tokens into an empty cache, then ``new`` tokens at
    index 14: the outputs and the caches, written in place."""
    jnp = jx["jnp"]
    cfg = get_smoke_config("deepseek-v2-236b")
    m = cfg.mla
    jp, tp = _mla_params("blocks")
    b, s0, smax = 2, 14, 24
    rng = np.random.default_rng(59)
    xs = [rng.standard_normal((b, n, cfg.d_model)).astype(np.float32)
          for n in (s0, new)]
    jc = (jnp.zeros((b, smax, m.kv_lora_rank)),
          jnp.zeros((b, smax, 1, m.qk_rope_dim)))
    tc = (torch.zeros((b, smax, m.kv_lora_rank)),
          torch.zeros((b, smax, 1, m.qk_rope_dim)))
    ref_step = jx["jax"].jit(lambda p, x, pos, c, i: jx["layers"].mla_apply(
        p, cfg, x, positions=pos, cache=c, cache_index=i))
    for x, idx in zip(xs, (0, s0)):
        pos = idx + np.broadcast_to(np.arange(x.shape[1], dtype=np.int32),
                                    x.shape[:2])
        want, jc = ref_step(jp, jnp.asarray(x), jnp.asarray(pos), jc,
                            jnp.asarray(idx, jnp.int32))
        got, out_c = layers.mla_apply(
            tp, cfg, torch.as_tensor(x), positions=torch.as_tensor(pos),
            cache=tc, cache_index=idx)
        assert out_c[0] is tc[0] and out_c[1] is tc[1]
        _close(got, want, BLOCK_ATOL, BLOCK_RTOL)
    for g, w in zip(tc, jc):
        _close(g, w, BLOCK_ATOL, BLOCK_RTOL)


def test_mla_absorbed_scale_is_the_heads_not_the_latents(monkeypatch):
    """The weight-absorbed attention scales by 1/sqrt(nope + rope), not by
    1/sqrt of the 576-wide (here 40-wide) latent it runs over."""
    cfg = get_smoke_config("deepseek-v2-236b")
    m = cfg.mla
    seen = []
    real = layers.blockwise_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[-1], v.shape[-1], kw["scale"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(layers, "blockwise_attention", spy)
    _, tp = _mla_params()
    x = torch.zeros((1, 3, cfg.d_model))
    pos = torch.arange(3)[None]
    cache = (torch.zeros((1, 8, m.kv_lora_rank)),
             torch.zeros((1, 8, 1, m.qk_rope_dim)))
    layers.mla_apply(tp, cfg, x, positions=pos)
    layers.mla_apply(tp, cfg, x, positions=pos, cache=cache, cache_index=0)
    qk = m.qk_nope_dim + m.qk_rope_dim
    assert seen == [(qk, m.v_head_dim, 1 / math.sqrt(qk)),
                    (m.kv_lora_rank + m.qk_rope_dim, m.kv_lora_rank,
                     1 / math.sqrt(qk))]
    with pytest.raises(ValueError, match="past the cache"):
        layers.mla_apply(tp, cfg, x, positions=pos + 6, cache=cache,
                         cache_index=6)


# ---------------------------------------------------------------------------
# the LM stack against the JAX package
# ---------------------------------------------------------------------------

#: "base" the smoke config; "drops" its capacity factor at 0.5; "ties" a
#: zero router in every MoE layer (every expert ties: the lowest k win, and
#: the rest of each token's replicas past capacity drop)
VARIANTS = ["base", "drops", "ties"]


@functools.lru_cache(maxsize=None)
def _variant(arch, variant):
    """(cfg, JAX tree, port tree) of a variant."""
    cfg = get_smoke_config(arch)
    tree, as_np = _jax_tree(arch)
    if variant == "drops":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=0.5))
    if variant == "ties":
        import jax.numpy as jnp
        ffn = tree["blocks"]["ffn"]
        tree = dict(tree, blocks=dict(tree["blocks"], ffn=dict(
            ffn, router=jnp.zeros_like(ffn["router"]))))
        as_np = _np_tree(tree)
    return cfg, tree, lm.params_from_numpy(as_np, cfg, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_decode(arch, variant):
    """The reference's ``decode_step`` of a variant, jitted with a traced
    cache index (as ``make_serve_step`` runs it): one compile a token
    count instead of a trace of every scan at every step."""
    import jax
    from repro.models import lm as jlm
    cfg = _variant(arch, variant)[0]
    return jax.jit(lambda p, c, x, i: jlm.decode_step(p, cfg, c,
                                                      {"tokens": x}, i))


LM_CASES = [(a, v) for a in ARCHS for v in VARIANTS]
LM_IDS = [f"{a}-{v}" for a, v in LM_CASES]


@pytest.mark.parametrize("arch,variant", LM_CASES, ids=LM_IDS)
def test_forward_and_loss_match_jax(jx, arch, variant):
    cfg, jt, tp = _variant(arch, variant)
    toks = _tokens(cfg, 2, PROMPT, 1)
    labels = _tokens(cfg, 2, PROMPT, 2)
    mask = (np.random.default_rng(3).random((2, PROMPT)) > 0.3) \
        .astype(np.float32)
    jnp, jlm = jx["jnp"], jx["lm"]
    batch = {"tokens": toks, "labels": labels, "loss_mask": mask}
    # one compile for both (eager JAX traces every scan at every call)
    (want, want_aux), (wl, wm) = jx["jax"].jit(
        lambda p, bt: (jlm.forward(p, cfg, {"tokens": bt["tokens"]}),
                       jlm.loss_fn(p, cfg, bt)))(
        jt, {k: jnp.asarray(v) for k, v in batch.items()})
    got, aux = lm.forward(tp, cfg, {"tokens": torch.as_tensor(toks)})
    assert got.dtype == torch.float32 and float(aux) > 0.0
    _close(got, want)
    _close(aux, want_aux)
    gl, gm = lm.loss_fn(tp, cfg, {k: torch.as_tensor(v)
                                  for k, v in batch.items()})
    for g, w in ((gl, wl), (gm["ce"], wm["ce"]), (gm["aux"], wm["aux"])):
        _close(g, w)


@pytest.mark.parametrize("arch,variant", LM_CASES, ids=LM_IDS)
def test_incremental_decode_matches_jax(jx, arch, variant):
    """A prompt through a one-shot ``decode_step``, then 12 one-token
    steps (decode's capacity at B = 2): every step's logits and, at the
    end, every cache leaf (MLA's c and r, grok-1's K/V)."""
    cfg, jp, tp = _variant(arch, variant)
    jnp, jlm = jx["jnp"], jx["lm"]
    toks = _tokens(cfg, 2, PROMPT + STEPS, 3)
    jc = jlm.init_cache(cfg, 2, MAX_LEN)
    tc = lm.init_cache(cfg, 2, MAX_LEN, device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == {
        k: v.shape for k, v in jc.items()}
    step = _jax_decode(arch, variant)
    want, jc = step(jp, jc, jnp.asarray(toks[:, :PROMPT]),
                    jnp.asarray(0, jnp.int32))
    got, out = lm.decode_step(tp, cfg, tc, {"tokens": torch.as_tensor(
        toks[:, :PROMPT])}, 0)
    assert out is tc
    _close(got, want)
    for t in range(PROMPT, PROMPT + STEPS):
        want, jc = step(jp, jc, jnp.asarray(toks[:, t:t + 1]),
                        jnp.asarray(t, jnp.int32))
        got, tc = lm.decode_step(tp, cfg, tc, {"tokens": torch.as_tensor(
            toks[:, t:t + 1])}, t)
        _close(got, want)
    for k in jc:
        _close(tc[k], np.asarray(jc[k], np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_serving_matches_jax(jx, arch):
    """The port's ``make_prefill_step`` then ``make_serve_step``: 12 greedy
    tokens, the same as the JAX package's prefill (a decode step over the
    prompt from a fresh cache) and greedy decode steps."""
    cfg, jp, tp = _variant(arch, "base")
    jnp, jlm = jx["jnp"], jx["lm"]
    toks = _tokens(cfg, 3, 24, 4)
    step = _jax_decode(arch, "base")
    logits, jc = step(jp, jlm.init_cache(cfg, 3, 24 + STEPS),
                      jnp.asarray(toks), jnp.asarray(0, jnp.int32))
    want = []
    for i in range(STEPS):
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        want.append(np.asarray(tok))
        if i + 1 < STEPS:
            logits, jc = step(jp, jc, tok[:, None],
                              jnp.asarray(24 + i, jnp.int32))

    logits, tc = steps.make_prefill_step(cfg, 24 + STEPS)(
        tp, {"tokens": torch.as_tensor(toks)})
    assert logits.shape == (3, 1, cfg.vocab)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    serve = steps.make_serve_step(cfg)
    idx, got = 24, [tok.numpy()]
    for _ in range(STEPS - 1):
        tok, tc, idx = serve(tp, tc, {"tokens": tok[:, None]}, idx)
        got.append(tok.numpy())
    np.testing.assert_array_equal(np.stack(got, 1), np.stack(want, 1))


@pytest.mark.parametrize("arch", ARCHS)
def test_traces_and_training_refuse_moe_and_mla(arch):
    """The serving entry points, a trace and training take both archs
    (the trace refused them, naming A14c-2, until their graph forms were
    ported, and training, naming A14b-3, until it was), at the smoke and
    the full config."""
    for cfg in (get_smoke_config(arch), get_config(arch)):
        lm.check_supported(cfg)
        lm.param_specs(cfg)
        assert callable(steps.make_train_step(cfg))
    steps.make_prefill_step(cfg, 8)
    steps.make_serve_step(cfg)


#: B8 on the card at MLA's shapes: the smoke forms, deepseek's 192 / 128
#: and its absorbed 576 / 512 over one latent kv head under 128 query heads
#: (16 CTAs of 8 rows a batch row at decode), GQA, Dv == D past 128 (the
#: decode's column groups), Dv = 576 (a second column piece), windows,
#: offsets, a bidirectional call, Dv at or under 64 where D takes two of
#: the tensor-core route's 64-column chunks, and part-filled decode groups
CARD_MLA = [
    dict(b=2, sq=40, skv=40, h=4, hkv=4, d=24, dv=16, causal=True),
    dict(b=2, sq=1, skv=64, h=4, hkv=1, d=40, dv=32, causal=True, qoff=41),
    dict(b=2, sq=40, skv=64, h=4, hkv=1, d=40, dv=32, causal=True),
    dict(b=1, sq=77, skv=77, h=8, hkv=8, d=192, dv=128, causal=True),
    dict(b=1, sq=130, skv=130, h=4, hkv=4, d=192, dv=128, causal=False),
    dict(b=2, sq=1, skv=300, h=128, hkv=1, d=576, dv=512, causal=True,
         qoff=290),
    dict(b=1, sq=70, skv=96, h=128, hkv=1, d=576, dv=512, causal=True,
         qoff=20),
    dict(b=1, sq=33, skv=50, h=8, hkv=2, d=192, dv=192, causal=True,
         qoff=10),
    dict(b=1, sq=1, skv=200, h=16, hkv=4, d=256, dv=200, causal=True,
         qoff=199),
    dict(b=1, sq=1, skv=150, h=8, hkv=2, d=384, dv=320, causal=True,
         qoff=120, window=50),
    dict(b=1, sq=1, skv=100, h=8, hkv=2, d=576, dv=576, causal=True,
         qoff=99),
    dict(b=1, sq=20, skv=40, h=2, hkv=1, d=576, dv=576, causal=True,
         qoff=20, kvoff=-4, window=12),
    dict(b=1, sq=17, skv=33, h=2, hkv=1, d=32, dv=8, causal=False),
    # the tensor-core route loads only V's 64-column chunks below Dv
    dict(b=1, sq=150, skv=150, h=4, hkv=2, d=128, dv=64, causal=True),
    dict(b=2, sq=70, skv=90, h=4, hkv=1, d=80, dv=16, causal=True, qoff=20),
    # decode groups that do not fill the 8-row group: grok-1's 6 query
    # heads a kv head at its last decode row, and 5 at MLA's full sequence
    dict(b=4, sq=1, skv=528, h=48, hkv=8, d=128, dv=128, causal=True,
         qoff=527),
    dict(b=2, sq=1, skv=200, h=10, hkv=2, d=192, dv=128, causal=True,
         qoff=150),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    from repro_torch.core.gnn import resolve_device
    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(CARD_MLA)))
def test_flash_kernel_at_mla_dims_matches_plain(card, case, dtype):
    c = {"window": 0, "qoff": 0, "kvoff": 0, **CARD_MLA[case]}
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(100 + case)
    q, k, v = (torch.as_tensor(t, device=card).to(dt) for t in
               _qkv(rng, c["b"], c["sq"], c["skv"], c["h"], c["hkv"], c["d"],
                    c["dv"]))
    kw = dict(causal=c["causal"], window=c["window"], q_offset=c["qoff"],
              kv_offset=c["kvoff"], scale=1.0 / math.sqrt(c["d"] / 3))
    n0 = fa.flash_attention_cuda.launches
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == n0 + 1
    assert got.shape == (c["b"], c["sq"], c["h"], c["dv"])
    tol = CARD_TOL[dtype]
    np.testing.assert_allclose(
        got.float().cpu().numpy(),
        ref.flash_attention_ref(q, k, v, **kw).float().cpu().numpy(),
        atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_card_serving_matches_cpu(card, arch):
    """The smoke model on the card against the same weights on the CPU:
    prefill logits within 1e-3 + 1e-3 and a flash launch a layer."""
    cfg = get_smoke_config(arch)
    cpu = lm.init_params(cfg, seed=0, device="cpu")
    on_card = lm.params_from_numpy(lm.params_to_numpy(cpu), cfg)
    toks = torch.as_tensor(_tokens(cfg, 2, PROMPT, 5))
    n0 = fa.flash_attention_cuda.launches
    got, _ = lm.prefill(on_card, cfg, {"tokens": toks.to(card)}, MAX_LEN)
    want, _ = lm.prefill(cpu, cfg, {"tokens": toks}, MAX_LEN)
    assert fa.flash_attention_cuda.launches == n0 + cfg.n_layers
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-3,
                               rtol=1e-3)
