"""LM training in the PyTorch port against the JAX package, on the CPU.

* The flash backward's plain twin (``ref.flash_attention_bwd_ref``, what
  the CPU runs and the card's ``flash_attention_bwd`` kernel is held to)
  against ``jax.vjp`` of the reference's ``blockwise_attention`` (its
  custom VJP) in float32, within 1e-5 of each gradient's largest
  magnitude: causal, non-causal, a window, GQA 2 and 4, a query offset,
  D = 120, lengths that pad the reference's chunks, and rows with no kept
  key (their gradient exactly 0). ``gradcheck`` of
  ``autograd.FlashAttention`` in float64, and the forward's log-sum-exp
  against ``_flash_fwd_chunks``'.
* A Mamba2 block takes ``ops.ssd_scan_train`` under grad and
  ``ops.ssd_scan`` under ``no_grad``; ``compress_grads`` names A14d
  and every arch takes a train step;
  ``remat`` changes no gradient. The SSD scan's backward itself is
  ``tests/test_torch_ssd_train.py``'s.

``lm.loss_fn`` against the reference's is in
``tests/test_torch_lm_train_loss.py``, the train steps in
``tests/test_torch_lm_train_steps.py`` and
``tests/test_torch_lm_train_steps_swa_rope.py``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import layers, lm  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402

ATTN_ARCHS = ["qwen2.5-3b", "yi-34b", "h2o-danube-3-4b", "chatglm3-6b"]
SSD_ARCHS = ["mamba2-370m", "zamba2-2.7b"]
#: the twin against jax.vjp of the custom VJP: float32, sums in another order
FLASH_RTOL = 1e-5
B, S = 4, 16

#: (B, Sq, Skv, H, Hkv, D, causal, window, q_offset, kv_offset, q_chunk,
#: kv_chunk); chunks smaller than the lengths run the reference's loop
FLASH_CASES = [
    (2, 24, 24, 4, 4, 16, True, 0, 0, 0, 8, 8),
    (1, 20, 28, 2, 2, 16, False, 0, 0, 0, 8, 16),
    (2, 32, 32, 4, 2, 16, True, 6, 0, 0, 16, 8),        # window, GQA 2
    (1, 19, 19, 8, 2, 24, True, 0, 0, 0, 8, 8),         # GQA 4, padding
    (1, 12, 30, 4, 2, 16, True, 0, 18, 0, 8, 16),       # q_offset
    (1, 17, 17, 4, 2, 120, True, 0, 0, 0, 16, 16),      # D = 120, padding
    (2, 10, 12, 2, 1, 8, True, 0, 0, 5, 4, 4),          # rows 0-4: no key
    (1, 21, 21, 4, 1, 16, True, 4, 0, 0, 8, 8),         # window, GQA 4
]


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
def jax_tree(arch: str):
    """The reference's ``init_params`` tree of ``arch``'s smoke config at
    key 0, and the same as float32 numpy; made once a process, since the
    reference builds it op by op (seconds for an SSD arch)."""
    import jax
    from repro.configs import get_smoke_config as jget
    from repro.models import lm as jlm
    tree = jlm.init_params(jax.random.PRNGKey(0), jget(arch))
    return tree, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                        tree)


def _qkvg(case, seed):
    b, sq, skv, h, hkv, d = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, d),
             (b, sq, h, d))]


def _kw(case):
    return dict(causal=case[6], window=case[7], q_offset=case[8],
                kv_offset=case[9])


def _close_scaled(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


# ---------------------------------------------------------------------------
# the flash backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_backward_twin_matches_jax_vjp(jx, case):
    jnp = jx["jnp"]
    q, k, v, g = _qkvg(case, 11)
    kw = _kw(case)
    qc, kc = case[10], case[11]

    def attn(q, k, v):
        return jx["layers"].blockwise_attention(
            q, k, v, q_chunk=qc, kv_chunk=kc, **kw)

    _, vjp = jx["jax"].vjp(attn, jnp.asarray(q), jnp.asarray(k),
                           jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    tq, tk, tv, tg = (torch.as_tensor(a) for a in (q, k, v, g))
    out, lse = ref.flash_attention_ref(tq, tk, tv, with_lse=True, **kw)
    got = ref.flash_attention_bwd_ref(tq, tk, tv, out, lse, tg, q_chunk=qc,
                                      kv_chunk=kc, **kw)
    for name, a, b in zip("qkv", got, want):
        _close_scaled(a.numpy(), b, FLASH_RTOL, f"d{name}")
    if case[9] > 0 and case[6]:
        # causal with the keys after the first rows: those rows keep no key
        dead = case[9]
        assert torch.equal(got[0][:, :dead], torch.zeros_like(got[0][:, :dead]))


#: (B, Sq, Skv, H, Hkv, causal, window, q_offset, kv_offset) at D = 8
GRADCHECK_CASES = [
    (1, 6, 6, 2, 2, True, 0, 0, 0),
    (1, 5, 7, 2, 1, False, 0, 0, 0),
    (1, 8, 8, 4, 2, True, 3, 0, 0),      # window, GQA 2
    (1, 6, 8, 2, 1, True, 0, 0, 3),      # rows 0-2 keep no key
    (1, 4, 9, 2, 2, True, 0, 5, 0),      # q_offset
]


@pytest.mark.parametrize("case", GRADCHECK_CASES, ids=str)
def test_flash_attention_function_gradcheck(case):
    b, sq, skv, h, hkv = case[:5]
    d = 8
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(s, generator=gen, dtype=torch.float64,
                           requires_grad=True)
               for s in ((b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, d)))
    kw = dict(causal=case[5], window=case[6], q_offset=case[7],
              kv_offset=case[8])
    assert torch.autograd.gradcheck(
        lambda q, k, v: ops.flash_attention_train(q, k, v, **kw), (q, k, v))


@pytest.mark.parametrize("case", [FLASH_CASES[i] for i in (2, 4, 5)],
                         ids=str)
def test_flash_lse_matches_reference(jx, case):
    jnp = jx["jnp"]
    q, k, v, _ = _qkvg(case, 12)
    b, sq, skv, h, hkv, d = case[:6]
    kw = _kw(case)
    qs = jnp.asarray(q).reshape(b, 1, sq, hkv, h // hkv, d) \
        .transpose(1, 0, 2, 3, 4, 5)
    ks = jnp.asarray(k).reshape(b, 1, skv, hkv, d).transpose(1, 0, 2, 3, 4)
    vs = jnp.asarray(v).reshape(b, 1, skv, hkv, d).transpose(1, 0, 2, 3, 4)
    _, want = jx["layers"]._flash_fwd_chunks(
        qs, ks, vs, kw["q_offset"], kw["kv_offset"], skv, kw["causal"],
        kw["window"], 1.0 / np.sqrt(d), True)
    want = np.asarray(want)[0].reshape(b, h, sq)     # [B, g, r, qc]
    _, got = ref.flash_attention_ref(*(torch.as_tensor(a) for a in (q, k, v)),
                                     with_lse=True, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


def test_blockwise_attention_records_the_flash_backward():
    """Grad mode with an input that requires grad takes the Function; no
    grad, or no input that requires it, the inference call."""
    q, k, v, _ = (torch.as_tensor(a) for a in _qkvg(FLASH_CASES[0], 13))
    out = layers.blockwise_attention(q.requires_grad_(), k, v, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    with torch.no_grad():
        assert layers.blockwise_attention(q, k, v, causal=True).grad_fn is None
    with pytest.raises(RuntimeError, match="inference only"):
        ops.flash_attention(q, k, v, causal=True)


# ---------------------------------------------------------------------------
# the LM training stack
# ---------------------------------------------------------------------------

def _batch(cfg, seed, mask: bool):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if mask:
        batch["loss_mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
    return batch


def test_remat_changes_no_gradient():
    cfg = get_smoke_config("h2o-danube-3-4b")
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg, 40, True).items()}
    out = []
    for remat in (False, True):
        params = lm.init_params(cfg, seed=0, device="cpu")
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_()
        loss, _ = lm.loss_fn(params, cfg, batch, remat=remat)
        out.append((loss, torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


@pytest.mark.parametrize("arch", SSD_ARCHS)
def test_mamba2_block_takes_the_train_call_under_grad(arch, monkeypatch):
    """Under grad the block takes ``ops.ssd_scan_train``; under
    ``no_grad`` the inference call ``ops.ssd_scan``, as before."""
    cfg = get_smoke_config(arch)
    params = lm.init_params(cfg, seed=0, device="cpu")
    lp = (lm._at(params["blocks"], 0) if cfg.block == "mamba2"
          else lm._at(params["groups"], 0, 0))
    calls = []
    for name in ("ssd_scan", "ssd_scan_train"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    x = torch.randn(2, 12, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    with torch.no_grad():
        out, _ = layers.mamba2_apply(lp["mix"], cfg, x)
    assert calls == ["ssd_scan"] and out.grad_fn is None
    calls.clear()
    out2, _ = layers.mamba2_apply(lp["mix"], cfg, x.requires_grad_())
    assert calls == ["ssd_scan_train"] and out2.grad_fn is not None
    torch.testing.assert_close(out2.detach(), out, rtol=0, atol=0)


def test_compress_grads_and_unported_archs_refused():
    cfg = get_smoke_config("qwen2.5-3b")
    with pytest.raises(NotImplementedError, match="A14d"):
        steps.make_train_step(cfg, compress_grads=True)
    from repro_torch.configs import get_config
    # every arch trains now (MoE, MLA, cross and audio raised naming
    # A14b-3 until their training was ported); A14d's refusal stays
    for arch in ("deepseek-v2-236b", "grok-1-314b", "llama-3.2-vision-11b",
                 "hubert-xlarge"):
        assert callable(steps.make_train_step(get_config(arch)))
        with pytest.raises(NotImplementedError, match="A14d"):
            steps.make_train_step(get_config(arch), compress_grads=True)


def test_default_optimizer_matches_reference(jx):
    opt = steps.default_optimizer()
    params = {"w": torch.ones(3, 2), "b": torch.zeros(2)}
    state = opt.init(params)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(state))
    jopt = jx["steps"].default_optimizer()
    jstate = jopt.init({"w": np.ones((3, 2), np.float32),
                        "b": np.zeros(2, np.float32)})
    assert all(str(x.dtype) == "bfloat16"
               for x in jx["jax"].tree_util.tree_leaves(jstate))
    assert dataclasses.is_dataclass(opt)


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
#: largest magnitude: float32 sums in another order; bf16 gradients round
#: to 8 bits and the forward's bf16 output enters delta
CARD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_backward_kernel_matches_plain_on_card(card, case, dtype):
    from repro_torch.kernels import flash_attention as fa
    q, k, v, g = (torch.as_tensor(a, device=card).to(dtype)
                  for a in _qkvg(case, 14))
    kw = _kw(case)
    out, lse = fa.flash_attention_cuda(q, k, v, with_lse=True, **kw)
    n = fa.flash_attention_bwd_cuda.launches
    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, **kw)
    again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, g, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, g, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd_cuda.launches == n + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for a, b in zip(got, want):
        _close_scaled(a.float().cpu().numpy(), b.float().cpu().numpy(),
                      CARD_TOL[dtype])
