"""Cross-attention and the audio frontend in the PyTorch port against the
JAX package.

On the CPU, at the two smoke configs in float32 (llama-3.2-vision: four
layers in two groups of a self layer and a cross layer over a 16-row
vision memory of width 32, GQA 4 / 2; hubert-xlarge: two bidirectional
layers over audio frames, ``frontend_proj`` and no embedding table),
seeded numpy inputs go through ``repro.models`` and the port:

* ``param_specs`` and ``init_cache`` (``cross_k`` / ``cross_v`` among
  them) equal the reference's in keys, shapes and dtypes, and the trees
  cross between the packages and come back;
* ``forward`` logits at the LM bar of 1e-4 (``tests/test_torch_lm.py``),
  the aux loss 0;
* llama-3.2-vision's ``prefill`` and six greedy ``decode_step`` calls
  (the cross layers reading the K / V the prefill seeded from the vision
  memory): every step's logits at 1e-4, the tokens and the final caches
  equal to the reference's; ``make_prefill_step`` + ``make_serve_step``
  give the reference steps' greedy tokens;
* hubert's ``make_encode_step`` against the reference's
  ``make_encode_step(cfg, ParallelCtx())``;
* one cross ``attention_apply`` alone at 1e-5 (float32 products in
  another order), and its independence of the positions (no RoPE);
* each arch's meta-device trace of ``lm.forward`` against the
  reference's ``from_jax`` graph, node for node, at the factory's
  smallest and largest (batch, seq), with llama's float32
  ``vision_embeds`` spec and hubert's ``features`` spec;
* the dataset factory's shards of a plan with llama-3.2-vision LM
  entries, byte for byte the JAX factory's;
* the entry points: training both archs is taken (a train step's loss
  against the reference's ``loss_fn``; the full comparison is
  ``tests/test_torch_lm_train_wide.py``'s), a prefill or serve step of
  the encoder-only hubert stays refused.

On a card (marked ``cuda``): B8 against its twin at the three shapes the
two archs give it (a non-causal prefill of text rows over vision keys,
its one-row decode, a self-attention of frames whose key count is not a
multiple of 64), and the smoke llama-3.2-vision served on the card
against the CPU. JAX is imported only inside the fixtures that compare
with it: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_lm_vision_audio.py``.
"""
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

VISION, AUDIO = "llama-3.2-vision-11b", "hubert-xlarge"
ARCHS = [VISION, AUDIO]
#: float32 sums in another order through 2–4 layers and the head
ATOL = RTOL = 1e-4
#: one layer: float32 products in another order
LAYER_TOL = 1e-5
PROMPT, MAX_LEN, STEPS = 40, 64, 6
#: the factory's smallest and largest (batch, seq)
SHAPES = [(1, 64), (8, 256)]


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
    from repro.configs import get_smoke_config as jget
    from repro.launch import steps as jsteps
    from repro.models import layers as jlayers
    from repro.models import lm as jlm
    from repro.models.parallel import ParallelCtx
    return dict(jax=jax, jnp=jnp, lm=jlm, layers=jlayers, steps=jsteps,
                get=jget, ctx=ParallelCtx)


@functools.lru_cache(maxsize=None)
def _jax_tree(arch: str):
    """The JAX package's smoke-config tree (PRNGKey 0) and its numpy copy."""
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


def _port_params(arch):
    return lm.params_from_numpy(_jax_tree(arch)[1], get_smoke_config(arch),
                                device="cpu")


def _inputs(cfg, b, s, seed):
    """Seeded numpy model inputs: tokens and a vision memory, or frames."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_frames":
        return {"features": rng.standard_normal((b, s, cfg.d_model))
                .astype(np.float32)}
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.cross_attn_every:
        out["vision_embeds"] = rng.standard_normal(
            (b, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)
    return out


def _j(jx, inputs):
    return {k: jx["jnp"].asarray(v) for k, v in inputs.items()}


def _t(inputs):
    return {k: torch.as_tensor(v) for k, v in inputs.items()}


def _close(got, want, tol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _paths(tree, prefix=()):
    """path → (shape, dtype name) of every leaf of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, prefix + (k,)))
        return out
    shape, dt = tree if isinstance(tree, tuple) else (tree.shape, tree.dtype)
    return {prefix: (tuple(shape), str(dt).replace("torch.", ""))}


# ---------------------------------------------------------------------------
# trees and caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_specs_and_caches_are_the_reference_trees(jx, arch):
    """``param_specs``, ``init_params`` and ``init_cache`` (the self K/V
    [G, per - 1, B, Smax, Hkv, hd] and ``cross_k`` / ``cross_v`` [G, B,
    vision_tokens, Hkv, hd] of the vision config) match the reference's
    keys, shapes and dtypes; the full config's specs too."""
    cfg, jcfg = get_smoke_config(arch), jx["get"](arch)
    want = _paths(jx["lm"].param_specs(jcfg))
    assert _paths(lm.param_specs(cfg)) == want
    assert _paths(lm.init_params(cfg, seed=0, device="cpu")) == want
    assert _paths(lm.init_cache(cfg, 2, MAX_LEN, device="cpu")) == _paths(
        jx["lm"].init_cache(jcfg, 2, MAX_LEN, abstract=True))
    from repro.configs import get_config as jget_full
    assert _paths(lm.param_specs(get_config(arch))) == _paths(
        jx["lm"].param_specs(jget_full(arch)))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_cross_and_come_back(arch):
    tree = _paths(_jax_tree(arch)[1])
    back = lm.params_to_numpy(_port_params(arch))
    assert _paths(back) == tree
    want = _jax_tree(arch)[1]

    def walk(a, b):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k])
        else:
            np.testing.assert_array_equal(a, b)
    walk(back, want)


# ---------------------------------------------------------------------------
# forward, prefill and decode against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(jx, arch):
    cfg = get_smoke_config(arch)
    inputs = _inputs(cfg, 2, PROMPT, 1)
    want, _ = jx["lm"].forward(_jax_tree(arch)[0], jx["get"](arch),
                               _j(jx, inputs))
    got, aux = lm.forward(_port_params(arch), cfg, _t(inputs))
    assert got.shape == (2, PROMPT, cfg.vocab) and got.dtype == torch.float32
    assert float(aux) == 0.0
    _close(got, want)


def test_vision_prefill_and_decode_match_jax(jx):
    """The prefill seeds every group's cross K / V from the vision memory;
    six greedy steps then read them: logits at 1e-4, the same tokens, and
    every cache leaf at the end."""
    cfg = get_smoke_config(VISION)
    jnp, jlm = jx["jnp"], jx["lm"]
    jp, tp = _jax_tree(VISION)[0], _port_params(VISION)
    inputs = _inputs(cfg, 2, PROMPT, 2)
    want, jc = jlm.prefill(jp, cfg, _j(jx, inputs), MAX_LEN)
    got, tc = lm.prefill(tp, cfg, _t(inputs), MAX_LEN)
    assert got.shape == (2, 1, cfg.vocab)
    _close(got, want)
    _close(tc["cross_k"], jc["cross_k"], LAYER_TOL)
    for t in range(PROMPT, PROMPT + STEPS):
        jtok = jnp.argmax(want[:, -1], axis=-1).astype(jnp.int32)
        ttok = torch.argmax(got[:, -1], dim=-1).to(torch.int32)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        want, jc = jlm.decode_step(jp, cfg, jc, {"tokens": jtok[:, None]},
                                   jnp.asarray(t, jnp.int32))
        got, out = lm.decode_step(tp, cfg, tc, {"tokens": ttok[:, None]}, t)
        assert out is tc                      # updated in place
        _close(got, want)
    for k in jc:
        _close(tc[k], jc[k])


def test_vision_greedy_serving_matches_jax(jx):
    """``make_prefill_step`` then ``make_serve_step``, the vision memory
    given to the prefill only: the reference steps' greedy tokens."""
    cfg = get_smoke_config(VISION)
    jnp, js = jx["jnp"], jx["steps"]
    inputs = _inputs(cfg, 3, 24, 4)
    ctx = js.make_ctx(None, cfg)
    jp = _jax_tree(VISION)[0]
    logits, jc = js.make_prefill_step(cfg, ctx, 24 + STEPS)(
        jp, _j(jx, inputs))
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    serve, idx, want = js.make_serve_step(cfg, ctx), jnp.asarray(24), [tok]
    for _ in range(STEPS - 1):
        tok, jc, idx = serve(jp, jc, {"tokens": tok[:, None]}, idx)
        want.append(tok)

    tp = _port_params(VISION)
    logits, tc = steps.make_prefill_step(cfg, 24 + STEPS)(tp, _t(inputs))
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    serve, idx, got = steps.make_serve_step(cfg), 24, [tok]
    for _ in range(STEPS - 1):
        tok, tc, idx = serve(tp, tc, {"tokens": tok[:, None]}, idx)
        got.append(tok)
    np.testing.assert_array_equal(torch.stack(got, 1).numpy(),
                                  np.stack([np.asarray(w) for w in want], 1))


def test_encode_step_matches_jax(jx):
    cfg = get_smoke_config(AUDIO)
    inputs = _inputs(cfg, 2, PROMPT, 5)
    want = jx["steps"].make_encode_step(cfg, jx["ctx"]())(
        _jax_tree(AUDIO)[0], _j(jx, inputs))
    got = steps.make_encode_step(cfg)(_port_params(AUDIO), _t(inputs))
    assert got.shape == (2, PROMPT, cfg.vocab)
    _close(got, want)


def _cross_layer(jx, cfg, seed):
    """A cross layer's weights from the JAX init, x and a memory."""
    jax = jx["jax"]
    p = jx["layers"].attention_init(jax.random.PRNGKey(seed), cfg,
                                    cross=True)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, cfg.vision_tokens, cfg.vision_dim)) \
        .astype(np.float32)
    return p, x, mem


def test_cross_attention_apply_matches_jax(jx):
    """One cross layer's attention alone: ``wk`` / ``wv`` of [vision_dim,
    Hkv·hd], K / V from the memory, no cache returned."""
    cfg = get_smoke_config(VISION)
    jp, x, mem = _cross_layer(jx, cfg, 7)
    jnp = jx["jnp"]
    pos = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    want, wcache = jx["layers"].attention_apply(
        jp, cfg, jnp.asarray(x), positions=jnp.asarray(pos),
        memory=jnp.asarray(mem))
    tp = {k: torch.as_tensor(np.array(v)) for k, v in jp.items()}
    got, cache = layers.attention_apply(
        tp, cfg, torch.as_tensor(x), positions=torch.as_tensor(pos),
        memory=torch.as_tensor(mem))
    assert cache is None and wcache is None
    assert tp["wk"].shape == (cfg.vision_dim, cfg.n_kv_heads * 16)
    _close(got, want, LAYER_TOL)


def test_cross_attention_takes_no_rope():
    """Keys from the memory carry no position, and neither does q: the
    output is the same at any positions (a port that ropes q in the cross
    layer fails here)."""
    cfg = get_smoke_config(VISION)
    gen = torch.Generator().manual_seed(0)
    p = layers.attention_init(gen, cfg, cross=True)
    assert p["wk"].shape == p["wv"].shape == (
        cfg.vision_dim, cfg.n_kv_heads * cfg.resolved_head_dim)
    x = torch.randn((2, 5, cfg.d_model), generator=gen)
    mem = torch.randn((2, cfg.vision_tokens, cfg.vision_dim), generator=gen)
    a, b = (layers.attention_apply(
        p, cfg, x, memory=mem,
        positions=torch.full((2, 5), pos, dtype=torch.int32))[0]
        for pos in (0, 1000))
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# graphs and the dataset factory
# ---------------------------------------------------------------------------

def _nodes(g):
    return [(nd.op, nd.out_shape, nd.dtype, nd.attrs, nd.flops, nd.macs,
             nd.bytes_accessed, nd.param_bytes) for nd in g.nodes]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"b{s[0]}s{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_trace_matches_reference(jx, arch, shape):
    """The meta-device trace of ``lm.forward`` against ``from_jax`` of the
    reference's: llama-3.2-vision with the factory's specs (int32 tokens,
    float32 ``vision_embeds`` [B, vision_tokens, vision_dim]), hubert with
    float32 ``features`` [B, S, d_model]; every node, the edges, the meta
    and the fingerprint."""
    from repro.core.frontends import from_jax
    from repro_torch.core.frontends import from_torch
    jax, jnp, jlm = jx["jax"], jx["jnp"], jx["lm"]
    b, s = shape
    cfg, jcfg = get_smoke_config(arch), jx["get"](arch)
    meta = {"family": arch, "batch": b, "seq": s}
    if arch == VISION:
        vis = (b, cfg.vision_tokens, cfg.vision_dim)
        gj = from_jax(lambda p, t, v: jlm.forward(
            p, jcfg, {"tokens": t, "vision_embeds": v})[0],
            jlm.param_specs(jcfg), jax.ShapeDtypeStruct((b, s), jnp.int32),
            jax.ShapeDtypeStruct(vis, jnp.float32), meta=meta)
        gt = from_torch(lambda p, t, v: lm.forward(
            p, cfg, {"tokens": t, "vision_embeds": v})[0],
            lm.param_specs(cfg), ((b, s), torch.int32),
            (vis, torch.float32), meta=meta)
    else:
        feats = (b, s, cfg.d_model)
        gj = from_jax(lambda p, f: jlm.forward(p, jcfg, {"features": f})[0],
                      jlm.param_specs(jcfg),
                      jax.ShapeDtypeStruct(feats, jnp.float32), meta=meta)
        gt = from_torch(lambda p, f: lm.forward(p, cfg, {"features": f})[0],
                        lm.param_specs(cfg), (feats, torch.float32),
                        meta=meta)
    assert _nodes(gt) == _nodes(gj)
    assert gt.edges == gj.edges
    assert gt.meta == gj.meta and gt.meta["n_raw_nodes"] > gt.num_nodes
    assert gt.fingerprint() == gj.fingerprint()


def _shas(path):
    import hashlib
    import os
    shard_dir = os.path.join(path, "shards")
    return {f: hashlib.sha256(open(os.path.join(shard_dir, f), "rb")
                              .read()).hexdigest()
            for f in sorted(os.listdir(shard_dir)) if f.endswith(".npz")}


def test_factory_shards_with_vision_entries_match_reference(tmp_path):
    """A plan with two llama-3.2-vision LM entries beside a vgg record,
    built by each package: the same shard bytes."""
    from repro.dataset import factory as jf
    from repro_torch.dataset import factory as tf
    kw = dict(n_graphs=2, seed=1, shard_size=2, fractions={"vgg": 1.0},
              lm_archs=(VISION,), lm_fraction=1.0)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    a = jf.build(ref_dir, jf.FactoryConfig(**kw))
    b = tf.build(port_dir, tf.FactoryConfig(**kw))
    plan = tf.make_plan(tf.FactoryConfig(**kw))
    assert sum(e["kind"] == "lm" for e in plan.entries) >= 2
    assert b.n_skipped == a.n_skipped == 0 and b.n_built == a.n_built
    assert _shas(port_dir) == _shas(ref_dir)


# ---------------------------------------------------------------------------
# what stays refused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_training_refuses_naming_a14b3(jx, arch):
    """Training both archs was refused naming A14b-3 until it was ported:
    the full and smoke configs build a train step, and the smoke one's
    first loss is the reference's ``loss_fn`` on the same batch."""
    jnp = jx["jnp"]
    assert callable(steps.make_train_step(get_config(arch)))
    cfg = get_smoke_config(arch)
    batch = _inputs(cfg, 2, 12, 71)
    batch["labels"] = np.random.default_rng(72).integers(
        0, cfg.vocab, (2, 12)).astype(np.int32)
    want, _ = jx["lm"].loss_fn(_jax_tree(arch)[0], jx["get"](arch),
                               {k: jnp.asarray(v) for k, v in batch.items()})
    params = _port_params(arch)
    opt = steps.default_optimizer()
    _, _, _, m = steps.make_train_step(cfg, opt)(
        params, opt.init(params), 0,
        {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), float(want), rtol=ATOL)


def test_encoder_has_no_prefill_or_serve_step():
    """hubert is encoder-only: the reference never lowers a decode for it
    and its encode step plays the prefill's role."""
    for cfg in (get_smoke_config(AUDIO), get_config(AUDIO)):
        assert cfg.is_encoder_only
        with pytest.raises(ValueError, match="make_encode_step"):
            steps.make_prefill_step(cfg, 8)
        with pytest.raises(ValueError, match="make_encode_step"):
            steps.make_serve_step(cfg)
        steps.make_encode_step(cfg)
    steps.make_prefill_step(get_config(VISION), 8)
    steps.make_serve_step(get_config(VISION))


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

#: B8 at the two archs' shapes, cut in batch: (B, Sq, Skv, H, Hkv, D,
#: q_offset), none causal — llama-3.2-vision's cross prefill (text rows
#: over 1,600 vision keys, GQA 4) and its one-row decode over them,
#: hubert's self-attention of 1,500 frames at D 80
CARD_CASES = [(1, 512, 1600, 32, 8, 128, 0), (2, 1, 1600, 32, 8, 128, 530),
              (1, 1500, 1500, 16, 16, 80, 0)]
CARD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    from repro_torch.core.gnn import resolve_device
    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(CARD_CASES)))
def test_flash_kernel_at_cross_and_encoder_shapes(card, case, dtype):
    b, sq, skv, h, hkv, d, qo = CARD_CASES[case]
    rng = np.random.default_rng(300 + case)
    dt = getattr(torch, dtype)
    q, k, v = (torch.as_tensor(rng.standard_normal(s).astype(np.float32),
                               device=card).to(dt)
               for s in ((b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, d)))
    n0 = fa.flash_attention_cuda.launches
    got = ops.flash_attention(q, k, v, causal=False, q_offset=qo)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == n0 + 1
    want = ref.flash_attention_ref(q, k, v, causal=False, q_offset=qo)
    tol = CARD_TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol,
                               rtol=tol)


@pytest.mark.cuda
def test_card_serving_matches_cpu(card):
    """The smoke llama-3.2-vision on the card against the same weights on
    the CPU: prefill logits within 1e-3 + 1e-3, a flash launch a layer."""
    cfg = get_smoke_config(VISION)
    cpu = lm.init_params(cfg, seed=0, device="cpu")
    on_card = lm.params_from_numpy(lm.params_to_numpy(cpu), cfg)
    inputs = _t(_inputs(cfg, 2, PROMPT, 6))
    n0 = fa.flash_attention_cuda.launches
    got, _ = lm.prefill(on_card, cfg, {k: v.to(card) for k, v in
                                       inputs.items()}, MAX_LEN)
    want, _ = lm.prefill(cpu, cfg, inputs, MAX_LEN)
    assert fa.flash_attention_cuda.launches == n0 + cfg.n_layers
    assert math.isfinite(float(got.abs().max()))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-3,
                               rtol=1e-3)
