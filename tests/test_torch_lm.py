"""The LM serving path of the PyTorch port against the JAX package.

For every architecture whose blocks the port runs (dense attention with
and without a sliding window and with partial RoPE, Mamba2, the zamba2
hybrid), at its smoke config in float32: the JAX ``init_params`` tree is
carried to the port with ``params_from_numpy``, and the port's
``forward``, one-shot ``decode_step`` from an empty cache and 12
incremental decode steps are held against ``repro.models.lm`` at 1e-4
absolute + 1e-4 relative — float32 sums in another order (XLA's CPU
products against torch's) through 2–4 layers and a vocabulary-wide head
— and the greedy tokens of ``make_prefill_step`` + ``make_serve_step``
must equal JAX's. Also: every config and its ``param_count()`` equal the
JAX package's, the cross-attention and audio archs build, cache and run
forward and take a train step, the cross
layer takes its keys from the vision memory, and ``init_params`` wants a
card unless asked for the CPU. The MoE and MLA archs (deepseek-v2,
grok-1) are held to the JAX package in ``tests/test_torch_lm_moe_mla.py``,
the cross-attention and audio archs (llama-3.2-vision, hubert) in
``tests/test_torch_lm_vision_audio.py``.

JAX is imported only inside the fixtures that compare with it; the card's
test runs where JAX is not installed:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_lm.py``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import nn as tnn  # noqa: E402
from repro_torch.configs import (ALIASES, all_arch_names, get_config,  # noqa: E402
                                 get_smoke_config)
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import lm  # noqa: E402

PORTED = ["qwen2.5-3b", "h2o-danube-3-4b", "chatglm3-6b", "yi-34b",
          "mamba2-370m", "zamba2-2.7b"]
#: the cross-attention and audio archs, whose training is not ported
VISION_AUDIO = ["hubert-xlarge", "llama-3.2-vision-11b"]
#: float32 sums in another order through 2–4 layers and the head
ATOL = RTOL = 1e-4
PROMPT, MAX_LEN, STEPS = 40, 64, 12


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.launch import steps as jsteps
    from repro.models import lm as jlm
    return dict(jax=jax, jnp=jnp, configs=jconfigs, lm=jlm, steps=jsteps)


@functools.lru_cache(maxsize=None)
def _jax_tree(arch: str):
    """The JAX package's smoke-config tree (PRNGKey 0) and its numpy copy."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as jget
    from repro.models import lm as jlm
    tree = jlm.init_params(jax.random.PRNGKey(0), jget(arch))
    as_np = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else np.asarray(a), tree)
    return tree, as_np


def _port_params(arch):
    return lm.params_from_numpy(_jax_tree(arch)[1], get_smoke_config(arch),
                                device="cpu")


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)) \
        .astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ALIASES))
def test_configs_equal_the_jax_packages(jx, arch):
    for port, ref in ((get_config(arch), jx["configs"].get_config(arch)),
                      (get_smoke_config(arch),
                       jx["configs"].get_smoke_config(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()


def test_registry_matches(jx):
    assert all_arch_names() == jx["configs"].all_arch_names()
    assert ALIASES == jx["configs"].ALIASES


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _flat(tree, path=""):
    """{"['a']['b']": leaf} over a nested dict, as ``jax.tree_util.keystr``
    spells paths."""
    out = {}
    for k, v in tree.items():
        key = f"{path}['{k}']"
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


@pytest.mark.parametrize("arch", PORTED)
def test_init_params_has_the_jax_tree_shape(jx, arch):
    """Keys, shapes, dtypes and the stacked leading axes of the JAX tree;
    ``tree_size`` / ``tree_bytes`` agree with ``repro.nn``'s."""
    from repro import nn as jnn
    tu = jx["jax"].tree_util
    port = lm.init_params(get_smoke_config(arch), seed=0, device="cpu")
    tree = _jax_tree(arch)[0]
    flat_j = {tu.keystr(k): v for k, v in tu.tree_flatten_with_path(tree)[0]}
    flat_p = _flat(port)
    assert flat_p.keys() == flat_j.keys()
    for k, v in flat_p.items():
        assert tuple(v.shape) == flat_j[k].shape, k
        assert str(v.dtype).removeprefix("torch.") == str(flat_j[k].dtype), k
    assert tnn.tree_size(port) == jnn.tree_size(tree)
    assert tnn.tree_bytes(port) == jnn.tree_bytes(tree)


@pytest.mark.parametrize("arch", PORTED)
def test_params_cross_and_come_back(arch):
    tree = _flat(_jax_tree(arch)[1])
    back = _flat(lm.params_to_numpy(_port_params(arch)))
    assert back.keys() == tree.keys()
    for k, v in tree.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_params_from_numpy_casts_to_the_param_dtype():
    """A bfloat16 config's leaves arrive as float32 and are cast, but
    ``dt_bias``, ``A_log`` and ``D`` stay float32 as in the JAX tree."""
    cfg = dataclasses.replace(get_smoke_config("zamba2-2.7b"),
                              param_dtype="bfloat16")
    port = lm.params_from_numpy(_jax_tree("zamba2-2.7b")[1], cfg,
                                device="cpu")
    mix = port["groups"]["mix"]
    assert port["embed"].dtype == mix["wz"].dtype == torch.bfloat16
    assert port["shared_attn"]["attn"]["wq"].dtype == torch.bfloat16
    assert {mix[k].dtype for k in ("dt_bias", "A_log", "D")} == {
        torch.float32}


def test_init_params_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("zamba2-2.7b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm.init_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm.init_cache(cfg, 1, 8)
    a = lm.init_params(cfg, seed=3, device="cpu")
    b = lm.init_params(cfg, seed=3, device="cpu")
    assert torch.equal(a["embed"], b["embed"])


@pytest.mark.parametrize("arch", VISION_AUDIO)
def test_unported_blocks_raise(arch):
    """Nothing of the cross-attention and audio archs stays unported:
    their parameters, caches and forward run (they raised naming A14c-3
    until it was ported), and so does a train step (it raised naming
    A14b-3 until training was ported), whose batch carries the vision
    memory or the frames beside the labels."""
    cfg = get_smoke_config(arch)
    params = lm.init_params(cfg, seed=0, device="cpu")
    assert ("frontend_proj" in params) == (cfg.frontend == "audio_frames")
    assert ("embed" in params) != ("frontend_proj" in params)
    cache = lm.init_cache(cfg, 1, 8, device="cpu")
    assert ("cross_k" in cache) == bool(cfg.cross_attn_every)
    rng = np.random.default_rng(0)
    if cfg.frontend == "audio_frames":
        inputs = {"features": torch.as_tensor(rng.standard_normal(
            (1, 8, cfg.d_model)), dtype=torch.float32)}
    else:
        inputs = {"tokens": torch.as_tensor(_tokens(cfg, 1, 8, 0)),
                  "vision_embeds": torch.as_tensor(rng.standard_normal(
                      (1, cfg.vision_tokens, cfg.vision_dim)),
                      dtype=torch.float32)}
    logits, aux = lm.forward(params, cfg, inputs)
    assert logits.shape == (1, 8, cfg.vocab) and float(aux) == 0.0
    assert bool(torch.isfinite(logits).all())
    opt = steps.default_optimizer()
    batch = dict(inputs, labels=torch.as_tensor(_tokens(cfg, 1, 8, 1)))
    new, _, step, m = steps.make_train_step(cfg, opt)(
        params, opt.init(params), 0, batch)
    assert step == 1 and bool(torch.isfinite(m["loss"]))
    assert not torch.equal(new["final_norm"]["scale"],
                           params["final_norm"]["scale"])


# ---------------------------------------------------------------------------
# forward and decode against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", PORTED)
def test_forward_matches_jax(jx, arch):
    cfg = get_smoke_config(arch)
    toks = _tokens(cfg, 2, PROMPT, 1)
    want, _ = jx["lm"].forward(_jax_tree(arch)[0], cfg,
                               {"tokens": jx["jnp"].asarray(toks)})
    got, aux = lm.forward(_port_params(arch), cfg,
                          {"tokens": torch.as_tensor(toks)})
    assert got.dtype == torch.float32 and float(aux) == 0.0
    _close(got, want)


@pytest.mark.parametrize("arch", PORTED)
def test_one_shot_decode_matches_jax(jx, arch):
    cfg = get_smoke_config(arch)
    jnp = jx["jnp"]
    toks = _tokens(cfg, 2, PROMPT, 2)
    want, _ = jx["lm"].decode_step(
        _jax_tree(arch)[0], cfg, jx["lm"].init_cache(cfg, 2, MAX_LEN),
        {"tokens": jnp.asarray(toks)}, jnp.asarray(0, jnp.int32))
    cache = lm.init_cache(cfg, 2, MAX_LEN, device="cpu")
    got, out = lm.decode_step(_port_params(arch), cfg, cache,
                              {"tokens": torch.as_tensor(toks)}, 0)
    assert out is cache                      # updated in place
    _close(got, want)


@pytest.mark.parametrize("arch", PORTED)
def test_incremental_decode_matches_jax(jx, arch):
    """A prompt, then 12 one-token steps: every step's logits and, at the
    end, every cache leaf (the sliding window's ring, conv and SSD
    states)."""
    cfg = get_smoke_config(arch)
    jnp, jlm = jx["jnp"], jx["lm"]
    toks = _tokens(cfg, 2, PROMPT + STEPS, 3)
    jp, tp = _jax_tree(arch)[0], _port_params(arch)
    jc = jlm.init_cache(cfg, 2, MAX_LEN)
    tc = lm.init_cache(cfg, 2, MAX_LEN, device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == {
        k: v.shape for k, v in jc.items()}
    _, jc = jlm.decode_step(jp, cfg, jc, {"tokens": jnp.asarray(
        toks[:, :PROMPT])}, jnp.asarray(0, jnp.int32))
    _, tc = lm.decode_step(tp, cfg, tc, {"tokens": torch.as_tensor(
        toks[:, :PROMPT])}, 0)
    for t in range(PROMPT, PROMPT + STEPS):
        want, jc = jlm.decode_step(jp, cfg, jc, {"tokens": jnp.asarray(
            toks[:, t:t + 1])}, jnp.asarray(t, jnp.int32))
        got, tc = lm.decode_step(tp, cfg, tc, {"tokens": torch.as_tensor(
            toks[:, t:t + 1])}, t)
        _close(got, want)
    for k in jc:
        _close(tc[k].float(), np.asarray(jc[k], np.float32))


@pytest.mark.parametrize("arch", PORTED)
def test_greedy_serving_matches_jax(jx, arch):
    """``make_prefill_step`` then ``make_serve_step``, as
    ``examples/serve_lm.py`` drives them: the same greedy tokens."""
    cfg = get_smoke_config(arch)
    jnp, js = jx["jnp"], jx["steps"]
    toks = _tokens(cfg, 3, 24, 4)
    new = 10
    ctx = js.make_ctx(None, cfg)
    j_prefill = js.make_prefill_step(cfg, ctx, 24 + new)
    j_serve = js.make_serve_step(cfg, ctx)
    logits, jc = j_prefill(_jax_tree(arch)[0], {"tokens": jnp.asarray(toks)})
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    idx = jnp.asarray(24, jnp.int32)
    want = [np.asarray(tok)]
    for _ in range(new - 1):
        tok, jc, idx = j_serve(_jax_tree(arch)[0], jc,
                               {"tokens": tok[:, None]}, idx)
        want.append(np.asarray(tok))

    params = _port_params(arch)
    logits, tc = steps.make_prefill_step(cfg, 24 + new)(
        params, {"tokens": torch.as_tensor(toks)})
    assert logits.shape == (3, 1, cfg.vocab)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    serve = steps.make_serve_step(cfg)
    idx, got = 24, [tok.numpy()]
    for _ in range(new - 1):
        tok, tc, idx = serve(params, tc, {"tokens": tok[:, None]}, idx)
        assert tok.dtype == torch.int32
        got.append(tok.numpy())
    assert idx == 24 + new - 1
    np.testing.assert_array_equal(np.stack(got, 1), np.stack(want, 1))


def test_unported_layers_raise():
    """The cross layer, which raised naming A14c-3 until it was ported:
    ``attention_init(cross=True)`` draws ``wk`` / ``wv`` from the memory's
    width, and ``attention_apply(memory=)`` attends over every memory row
    and returns no cache; a memory of the wrong width still raises."""
    from repro_torch.models import layers
    cfg = get_smoke_config("llama-3.2-vision-11b")
    gen = torch.Generator().manual_seed(0)
    p = layers.attention_init(gen, cfg, cross=True)
    kv = cfg.n_kv_heads * cfg.resolved_head_dim
    assert p["wk"].shape == p["wv"].shape == (cfg.vision_dim, kv)
    assert p["wq"].shape == (cfg.d_model, cfg.n_heads * cfg.resolved_head_dim)
    x = torch.randn((1, 2, cfg.d_model), generator=gen)
    mem = torch.randn((1, 5, cfg.vision_dim), generator=gen)
    out, cache = layers.attention_apply(p, cfg, x, memory=mem,
                                        positions=torch.zeros((1, 2)))
    assert out.shape == x.shape and cache is None
    with pytest.raises(RuntimeError):
        layers.attention_apply(p, cfg, x, positions=torch.zeros((1, 2)),
                               memory=x)


def test_decode_past_the_cache_raises():
    cfg = get_smoke_config("qwen2.5-3b")
    params = lm.init_params(cfg, seed=0, device="cpu")
    cache = lm.init_cache(cfg, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="past the cache"):
        lm.decode_step(params, cfg, cache,
                       {"tokens": torch.zeros((1, 5), dtype=torch.int32)}, 0)


# ---------------------------------------------------------------------------
# on a card: the smoke zamba2 against the same weights on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "h2o-danube-3-4b"])
def test_card_serving_matches_cpu(arch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    cfg = get_smoke_config(arch)
    cpu = lm.init_params(cfg, seed=0, device="cpu")
    card = lm.params_from_numpy(lm.params_to_numpy(cpu), cfg)
    toks = torch.as_tensor(_tokens(cfg, 2, PROMPT, 5))
    n_flash, n_ssd = flash_attention_cuda.launches, ssd_scan_cuda.launches
    got, _ = lm.prefill(card, cfg, {"tokens": toks.cuda()}, MAX_LEN)
    want, _ = lm.prefill(cpu, cfg, {"tokens": toks}, MAX_LEN)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-3,
                               rtol=1e-3)
    assert flash_attention_cuda.launches > n_flash
    if cfg.ssm is not None:
        assert ssd_scan_cuda.launches > n_ssd
