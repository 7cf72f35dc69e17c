"""Training the MoE, MLA, cross-attention and audio archs in the PyTorch
port against the JAX package, on the CPU.

At the smoke configs of deepseek-v2 (MLA, a dense layer 0, MoE with a
shared expert), grok-1 (GQA, MoE), llama-3.2-vision (groups of a self
layer and a cross layer over a vision memory) and hubert-xlarge (audio
frames, bidirectional), float32, one torch thread, seeded numpy inputs
through both packages:

* the flash backward's plain twin (``ref.flash_attention_bwd_ref``) and
  ``autograd.FlashAttention``'s CPU path (``ops.flash_attention_train``)
  against ``jax.vjp`` of the reference's ``blockwise_attention`` (its
  custom VJP) at MLA's head dims, D 24 over Dv 16 and D 192 over Dv 128,
  causal and not, with GQA, chunks smaller than the lengths and rows with
  no kept key (their dq exactly 0): 1e-5 of each gradient's largest;
* one MLA layer (the full-sequence form) and one MoE block, with dropped
  replicas and with a zero router that ties every expert, against
  ``jax.grad`` of the reference's: every parameter's and the input's
  gradient within 1e-5 of its largest (float32 products in another
  order); under ties the experts past the first k get exactly 0;
* ``lm.loss_fn`` (remat on) and every leaf's gradient against
  ``jax.value_and_grad(repro.models.lm.loss_fn)``, with and without
  ``loss_mask``: 1e-4 of each leaf's largest (float32 through 2–4 layers
  and the head);
* two ``make_train_step`` steps (AdamW, float32 states) against the
  reference's jitted ``make_train_step(cfg, ParallelCtx())``, llama and
  hubert in two microbatches (``vision_embeds`` and ``features`` split on
  their leading axis): every metric and parameter within 1e-4 + 1e-3
  relative, with ROADMAP §C's Adam-noise rule (an element whose
  first-step gradient is below 1e-4 of its leaf's largest may leave the
  bar by 5e-4 more), the leaves that needed it asserted;
* AdamW's sliced update of a large leaf is the whole leaf's, bit for bit.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import layers, lm  # noqa: E402
from repro_torch.optim import adamw, constant  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402

ARCHS = ["deepseek-v2-236b", "grok-1-314b", "llama-3.2-vision-11b",
         "hubert-xlarge"]
#: one layer, or the twin against the custom VJP: float32 sums in another
#: order
GRAD_RTOL = 1e-5
#: the loss and its gradients through 2–4 layers and the head
LOSS_RTOL = 1e-4
#: two optimizer steps: the trainer's bar, and ROADMAP §C's noise rule
STEP_ATOL, STEP_RTOL = 1e-4, 1e-3
NOISE_FLOOR, NOISE_ATOL = 1e-4, 5e-4
LR = 1e-3
B, S = 2, 16
#: arch → microbatches of its two train steps
MICROBATCHES = {"deepseek-v2-236b": 1, "grok-1-314b": 1,
                "llama-3.2-vision-11b": 2, "hubert-xlarge": 2}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the smoke shapes are tiny, and test workers
    that share the host's cores otherwise oversubscribe it many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro import optim as joptim
    from repro.launch import steps as jsteps
    from repro.models import layers as jlayers
    from repro.models import lm as jlm
    from repro.models.parallel import ParallelCtx
    return dict(jax=jax, jnp=jnp, configs=jconfigs, optim=joptim,
                steps=jsteps, layers=jlayers, lm=jlm, ctx=ParallelCtx)


@functools.lru_cache(maxsize=None)
def _jax_tree(arch: str):
    """The reference's smoke-config tree (PRNGKey 0, jitted init) and its
    float32 numpy copy."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jget
    from repro.models import lm as jlm
    cfg = jget(arch)
    tree = jax.jit(lambda key: jlm.init_params(key, cfg))(
        jax.random.PRNGKey(0))
    return tree, jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else np.asarray(a), tree)


def _leaves_np(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_np(tree[k])]
    return [np.asarray(tree, np.float32)]


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree, np.float32))


def _close_scaled(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


def _batch(cfg, seed, mask: bool, b: int = B, s: int = S):
    """Labels and the model inputs (tokens, with a vision memory for a
    cross config, or audio frames), and a 70 % loss mask with ``mask``."""
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend == "audio_frames":
        out["features"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    if cfg.cross_attn_every:
        out["vision_embeds"] = rng.standard_normal(
            (b, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)
    if mask:
        out["loss_mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# the flash backward at MLA's head dims
# ---------------------------------------------------------------------------

#: (B, Sq, Skv, H, Hkv, D, Dv, causal, q_offset, kv_offset, q_chunk,
#: kv_chunk); chunks smaller than the lengths run the reference's loop
FLASH_CASES = [
    (2, 19, 19, 4, 4, 24, 16, True, 0, 0, 8, 8),       # MLA, smoke width
    (1, 13, 21, 4, 2, 24, 16, False, 0, 0, 8, 8),      # not causal, GQA 2
    (1, 17, 17, 2, 2, 192, 128, True, 0, 0, 8, 8),     # MLA, full width
    (1, 11, 14, 4, 1, 192, 128, False, 0, 0, 8, 8),    # not causal, GQA 4
    (1, 10, 12, 2, 1, 192, 128, True, 0, 4, 4, 4),     # rows 0-3: no key
]


def _flash_inputs(case, seed):
    b, sq, skv, h, hkv, d, dv = case[:7]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, dv),
             (b, sq, h, dv))]


@functools.lru_cache(maxsize=None)
def _jax_flash_grads(case):
    """``jax.vjp`` of the reference's ``blockwise_attention`` on the
    case's inputs, once a case."""
    import jax
    import jax.numpy as jnp
    from repro.models import layers as jlayers
    q, k, v, g = _flash_inputs(case, 21)
    kw = dict(causal=case[7], q_offset=case[8], kv_offset=case[9])
    _, vjp = jax.vjp(
        lambda q, k, v: jlayers.blockwise_attention(
            q, k, v, q_chunk=case[10], kv_chunk=case[11], **kw),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("path", ["twin", "function"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_backward_at_mla_dims_matches_jax_vjp(jx, case, path):
    q, k, v, g = _flash_inputs(case, 21)
    kw = dict(causal=case[7], q_offset=case[8], kv_offset=case[9])
    qc, kc = case[10], case[11]
    want = _jax_flash_grads(case)
    tq, tk, tv, tg = (torch.as_tensor(a) for a in (q, k, v, g))
    if path == "twin":
        out, lse = ref.flash_attention_ref(tq, tk, tv, with_lse=True, **kw)
        got = ref.flash_attention_bwd_ref(tq, tk, tv, out, lse, tg,
                                          q_chunk=qc, kv_chunk=kc, **kw)
    else:
        leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
        out = ops.flash_attention_train(*leaves, **kw)
        assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
        got = torch.autograd.grad(out, leaves, tg)
    for name, a, w, t in zip("qkv", got, want, (tq, tk, tv)):
        assert a.shape == t.shape
        _close_scaled(a.numpy(), w, GRAD_RTOL, f"d{name}")
    if case[9] > 0 and case[7]:       # rows that keep no key
        dead = got[0][:, :case[9]]
        assert torch.equal(dead, torch.zeros_like(dead))


# ---------------------------------------------------------------------------
# one MLA layer and one MoE block under autograd
# ---------------------------------------------------------------------------

def _grads_vs_jax(jx, jfn, tfn, jp, x, cot):
    """``jax.grad`` of ``sum(jfn(p, x) · cot)`` against autograd of the
    port's, every parameter's and x's gradient within GRAD_RTOL of its
    largest; returns the port's gradients."""
    jax, jnp = jx["jax"], jx["jnp"]
    jg = jax.jit(jax.grad(lambda p, x: jnp.sum(jfn(p, x) * cot),
                          argnums=(0, 1)))(jp, jnp.asarray(x))
    tp = _to_torch(jax.tree_util.tree_map(np.asarray, jp))
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_()
    tx = torch.as_tensor(x).requires_grad_()
    out = torch.sum(tfn(tp, tx) * torch.as_tensor(cot))
    got = torch.autograd.grad(out, leaves + [tx])
    want = _leaves_np(jg[0]) + [np.asarray(jg[1])]
    for path, a, w in zip(_paths(tp) + ["x"], got, want):
        _close_scaled(a.numpy(), w, GRAD_RTOL, path)
    return dict(zip(_paths(tp) + ["x"], got))


def test_mla_layer_gradients_match_jax(jx):
    """The full-sequence form: q / k at nope + rope = 24 over v at 16 on
    the flash twin, the split q_nope / q_rope and v's contiguous copy
    carrying their gradients."""
    import jax
    cfg = get_smoke_config("deepseek-v2-236b")
    jcfg = jx["configs"].get_smoke_config("deepseek-v2-236b")
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                _jax_tree("deepseek-v2-236b")[0]["pre"]["attn"])
    b, s = 2, 13
    rng = np.random.default_rng(23)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    cot = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    _grads_vs_jax(
        jx, lambda p, x: jx["layers"].mla_apply(p, jcfg, x,
                                                positions=pos)[0],
        lambda p, x: layers.mla_apply(p, cfg, x,
                                      positions=torch.as_tensor(pos))[0],
        jp, x, cot)


@pytest.mark.parametrize("case", ["drops", "ties"])
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "grok-1-314b"])
def test_moe_block_gradients_match_jax(jx, arch, case):
    """y · cot + 0.3 · aux through the router's softmax (the combine
    weights and the aux loss's mean probability; the replica shares carry
    none), the slot copy, the experts' batched products and the shared
    experts: at a capacity factor of 0.5 (replicas dropped), or with a
    zero router (every expert ties, the lowest k win, replicas past
    capacity drop)."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    cfg = get_smoke_config(arch)
    cf = 0.5 if case == "drops" else cfg.moe.capacity_factor
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))
    jcfg = dataclasses.replace(
        jx["configs"].get_smoke_config(arch),
        moe=dataclasses.replace(jx["configs"].get_smoke_config(arch).moe,
                                capacity_factor=cf))
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                _jax_tree(arch)[0]["blocks"]["ffn"])
    if case == "ties":
        jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    rng = np.random.default_rng(29)
    x = rng.standard_normal((40, cfg.d_model)).astype(np.float32)
    cot = rng.standard_normal((40, cfg.d_model)).astype(np.float32)

    def jfn(p, x):
        y, aux = jx["layers"].moe_apply_local(p, jcfg, x)
        return y + 0.3 * aux / (40 * cfg.d_model) / cot

    def tfn(p, x):
        y, aux = layers.moe_apply_local(p, cfg, x)
        return y + 0.3 * aux / (40 * cfg.d_model) / torch.as_tensor(cot)
    got = _grads_vs_jax(jx, jfn, tfn, jp, x, cot)
    _, ids, _ = layers._route(_to_torch(np.asarray(jp["router"])),
                              torch.as_tensor(x), cfg.moe)
    keep, _, _ = layers.moe_slots(ids, cfg.moe, 40)
    assert int((~keep).sum()) > 0, "the case must drop replicas"
    if case == "ties":
        # every token routes to experts 0..k-1; the others get no
        # gradient at all
        k = cfg.moe.top_k
        for name in ("wg", "wu", "wd"):
            g = got[f"experts/{name}"]
            assert torch.equal(g[k:], torch.zeros_like(g[k:]))


# ---------------------------------------------------------------------------
# loss_fn and every gradient, then two train steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mask", [False, True], ids=["mean", "loss_mask"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_grads_match_jax(jx, arch, mask):
    jax, jnp = jx["jax"], jx["jnp"]
    jtree, np_tree = _jax_tree(arch)
    cfg = get_smoke_config(arch)
    batch = _batch(cfg, 31, mask)
    jcfg = jx["configs"].get_smoke_config(arch)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jx["lm"].loss_fn(p, jcfg, b), has_aux=True))(
        jtree, {k: jnp.asarray(v) for k, v in batch.items()})
    params = lm.params_from_numpy(np_tree, cfg, device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_()
    loss, aux = lm.loss_fn(params, cfg, {k: torch.as_tensor(v)
                                         for k, v in batch.items()},
                           remat=True)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    for key in ("ce", "aux"):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    assert (float(jaux["aux"]) > 0) == (cfg.moe is not None)
    want = _leaves_np(jg)
    assert len(want) == len(grads)
    for path, g, w in zip(_paths(np_tree), grads, want):
        _close_scaled(g.numpy(), w, LOSS_RTOL, path)


def _quiet(cfg, np_tree, batch):
    """Per leaf, the elements whose first-step gradient is below
    NOISE_FLOOR of the leaf's largest: Adam turns their float noise into
    steps of either sign."""
    params = lm.params_from_numpy(np_tree, cfg, device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_()
    loss, _ = lm.loss_fn(params, cfg, {k: torch.as_tensor(v)
                                       for k, v in batch.items()})
    return [(g.abs() < NOISE_FLOOR * max(float(g.abs().max()), 1e-30))
            .numpy() for g in torch.autograd.grad(loss, leaves)]


#: arch → the leaves in which an element outside the bar is admitted by
#: the noise rule; every other arch needs it nowhere
NOISE_LEAVES = {}


@pytest.mark.parametrize("arch", ARCHS)
def test_two_train_steps_match_jax(jx, arch):
    jax, jnp = jx["jax"], jx["jnp"]
    jtree, np_tree = _jax_tree(arch)
    cfg = get_smoke_config(arch)
    mb = MICROBATCHES[arch]
    kw = dict(b1=0.9, b2=0.95, weight_decay=0.1, grad_clip_norm=1.0)
    port_opt = adamw(constant(LR), state_dtype=torch.float32, **kw)
    jax_opt = jx["optim"].adamw(jx["optim"].constant(LR),
                                state_dtype=jnp.float32, **kw)
    jstep = jax.jit(jx["steps"].make_train_step(
        jx["configs"].get_smoke_config(arch), jx["ctx"](),
        optimizer=jax_opt, microbatches=mb))
    step_fn = steps.make_train_step(cfg, port_opt, microbatches=mb)
    batches = [_batch(cfg, 40 + i, mask=True) for i in range(2)]
    jp, jstate, jstep_i = jtree, jax_opt.init(jtree), jnp.asarray(0,
                                                                 jnp.int32)
    params = lm.params_from_numpy(np_tree, cfg, device="cpu")
    state, step_i = port_opt.init(params), 0
    for i, batch in enumerate(batches):
        jp, jstate, jstep_i, jm = jstep(
            jp, jstate, jstep_i, {k: jnp.asarray(v) for k, v in batch.items()})
        params, state, step_i, m = step_fn(
            params, state, step_i, {k: torch.as_tensor(v)
                                    for k, v in batch.items()})
        for key in ("loss", "ce", "aux"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       atol=STEP_ATOL, rtol=STEP_RTOL,
                                       err_msg=f"step {i} {key}")
    assert step_i == int(jstep_i) == 2
    admitted = {}
    quiet = _quiet(cfg, np_tree, batches[0] if mb == 1 else {
        k: v[:B // mb] for k, v in batches[0].items()})
    for path, g, w, q in zip(_paths(np_tree), _leaves_np(params),
                             _leaves_np(jp), quiet):
        assert np.isfinite(g).all(), path
        bar = STEP_ATOL + STEP_RTOL * np.abs(w) + NOISE_ATOL * q
        out = np.abs(g - w) > bar
        assert not (out & ~q).any(), \
            f"{path}: max excess {float((np.abs(g - w) - bar)[~q].max())}"
        if out.any():
            admitted[path] = int(out.sum())
    assert set(admitted) == NOISE_LEAVES.get(arch, set()), admitted


def test_adamw_slices_a_large_leaf_to_the_same_bits(monkeypatch):
    """A leaf past ``_SLICE_ELEMS`` is updated a flat slice at a time
    (deepseek-v2's and grok-1's expert stacks at full width, behind a
    stack's leading axis of 1): the update is elementwise, so the new
    parameters and states are the whole leaf's bit for bit, in their
    dtypes."""
    gen = torch.Generator().manual_seed(5)
    p = {"experts": torch.randn(1, 9, 6, 5,
                                generator=gen).to(torch.bfloat16),
         "router": torch.randn(6, 4, generator=gen)}
    g = {k: torch.randn(v.shape, generator=gen).to(v.dtype)
         for k, v in p.items()}
    opt = steps.default_optimizer()
    state = opt.init(p)
    state = {"m": {k: torch.randn(v.shape, generator=gen).to(v.dtype)
                   for k, v in state["m"].items()},
             "v": {k: torch.rand(v.shape, generator=gen).to(v.dtype)
                   for k, v in state["v"].items()}}
    whole = opt.update(3, state, p, g)
    monkeypatch.setattr(optimizers, "_SLICE_ELEMS", 64)   # 5 slices, ragged
    sliced = opt.update(3, state, p, g)
    leaves = lambda r: tree_leaves(r[0]) + tree_leaves(r[1])  # noqa: E731
    assert len(leaves(whole)) == 6
    for a, b in zip(leaves(whole), leaves(sliced)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-v2-236b"])
def test_train_step_leaves_no_tensor_in_a_cycle(arch):
    """A step's gradients die with the step. ``tree_unflatten`` once built
    its result through a nested function that called itself through its
    closure: a reference cycle that kept the leaves it was given (a step's
    gradients, 10.7 GB at deepseek-v2's full width) alive until the
    garbage collector next ran."""
    import gc
    cfg = get_smoke_config(arch)
    params = lm.init_params(cfg, seed=0, device="cpu")
    opt = steps.default_optimizer()
    step_fn = steps.make_train_step(cfg, opt)
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg, 51, False).items()}
    params, state, i, _ = step_fn(params, opt.init(params), 0, batch)
    gc.collect()             # what the first call's lazy imports left
    enabled = gc.isenabled()
    gc.disable()
    try:
        params, state, i, _ = step_fn(params, state, i, batch)
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        cycled = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        if enabled:
            gc.enable()
    assert not cycled, f"{len(cycled)} tensors left in reference cycles"
