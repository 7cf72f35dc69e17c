"""Three LM train steps of the PyTorch port against the JAX package's
``make_train_step``, on the CPU.

For each of the four attention archs' smoke configs (qwen2.5-3b, yi-34b,
h2o-danube-3-4b, chatglm3-6b) and the two SSD archs' (mamba2-370m,
zamba2-2.7b), from the JAX ``init_params`` tree, three
steps of ``repro_torch.launch.steps.make_train_step`` (``remat=True``)
under each optimizer — ``adamw`` with float32 states,
``default_optimizer``'s bfloat16 states and ``adafactor`` — against the
reference's jitted step on the same batches (the second with a
``loss_mask``): every metric and every parameter within 1e-4 absolute +
1e-3 relative, the trainer's bar (``tests/test_trainer.py``). Each
optimizer runs with one microbatch on three archs and with two on the
other three, so every (optimizer, microbatches) pair is held three times.
This file holds qwen2.5-3b, yi-34b and the SSD archs;
``test_torch_lm_train_steps_swa_rope.py`` the sliding window (h2o-danube)
and partial RoPE (chatglm3).

Adam and Adafactor normalize a gradient's size away, so an element whose
gradient is zero in exact arithmetic takes steps whose signs float32 noise
decides: chatglm3 rotates half of each head, and a key bias in the
unrotated half only shifts every score of a row, so its gradient is 0 in
the port and about ±1e-11 in the reference. As ROADMAP §C's bar for the
trainer, an element whose first-step gradient (the port's, within 1e-4 of
the reference's by ``tests/test_torch_lm_train_loss.py``) is below 1e-4 of
its leaf's largest is *quiet*. Under Adam a quiet element may leave the
bar by at most 5e-4 more. Adafactor's step for an element is its gradient
over its factored row's and column's second moments: where a whole row or
column of a leaf of rank ≥ 2 is quiet (a rank-1 leaf: an element), that
factor is noise, and so are the steps, which are held to being finite;
every other element of the leaf, live rows and columns, is held to the
bar. Which leaves need the rule is asserted: none for qwen2.5-3b and
yi-34b, chatglm3's key bias under Adafactor only.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adafactor, adamw, constant  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402
from test_torch_lm_train import jax_tree, one_thread  # noqa: E402,F401

#: three optimizer steps: the trainer's bar (tests/test_trainer.py)
STEP_ATOL, STEP_RTOL = 1e-4, 1e-3
#: ROADMAP §C: elements whose first-step gradient is float noise
NOISE_FLOOR, NOISE_ATOL = 1e-4, 5e-4
#: adamw's and adafactor's rate: three steps move a weight (init scale
#: 0.02) by up to 3e-3, thirty times the bar, while a normalized step
#: turns float32 noise in a small gradient into a few percent of the rate
LR = 1e-3
B, S = 4, 16
#: (arch, microbatches): each optimizer runs on every arch; this file
#: runs the first two and the SSD archs (the last two),
#: ``test_torch_lm_train_steps_swa_rope.py`` the sliding window and RoPE
RUNS = [("qwen2.5-3b", 2), ("yi-34b", 1), ("h2o-danube-3-4b", 2),
        ("chatglm3-6b", 1), ("mamba2-370m", 1), ("zamba2-2.7b", 2)]
OPTIMIZERS = ["adamw_f32", "default_bf16", "adafactor"]


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro import optim as joptim
    from repro.launch import steps as jsteps
    from repro.models import lm as jlm
    from repro.models.parallel import ParallelCtx
    return dict(jax=jax, jnp=jnp, configs=jconfigs, optim=joptim,
                steps=jsteps, lm=jlm, ctx=ParallelCtx)


def _batch(cfg, seed, mask: bool):
    """Tokens, labels and a loss mask: 70 % kept with ``mask``, else all
    ones (one batch structure, so the reference's step compiles once)."""
    rng = np.random.default_rng(seed)
    keep = rng.random((B, S)) < (0.7 if mask else 2.0)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "loss_mask": keep.astype(np.float32)}


def _leaves_np(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_np(tree[k])]
    return [np.asarray(tree, np.float32)]


def _optimizers(jx, name):
    jnp, jo = jx["jnp"], jx["optim"]
    if name == "adamw_f32":
        kw = dict(b1=0.9, b2=0.95, weight_decay=0.1, grad_clip_norm=1.0)
        return (adamw(constant(LR), state_dtype=torch.float32, **kw),
                jo.adamw(jo.constant(LR), state_dtype=jnp.float32, **kw))
    if name == "default_bf16":
        return (steps.default_optimizer(),
                jx["steps"].default_optimizer())
    return adafactor(LR), jo.adafactor(LR)


#: (arch, optimizer) → the leaves in which an element outside the bar is
#: admitted by the noise rule; every other run needs it nowhere
NOISE_LEAVES = {("chatglm3-6b", "adafactor"): {"blocks/attn/bk"}}


@pytest.mark.parametrize("opt", OPTIMIZERS)
@pytest.mark.parametrize("arch,microbatches", RUNS[:2] + RUNS[4:])
def test_three_train_steps_match_jax(jx, arch, microbatches, opt):
    three_steps(jx, arch, microbatches, opt)


def three_steps(jx, arch, microbatches, opt):
    """Three steps of each package from the JAX tree; the bar above, and
    the leaves that needed the noise rule are ``NOISE_LEAVES``'."""
    jax, jnp = jx["jax"], jx["jnp"]
    jtree, np_tree = jax_tree(arch)
    cfg = get_smoke_config(arch)
    port_opt, jax_opt = _optimizers(jx, opt)
    jstep = jax.jit(jx["steps"].make_train_step(
        jx["configs"].get_smoke_config(arch), jx["ctx"](),
        optimizer=jax_opt, microbatches=microbatches))
    step_fn = steps.make_train_step(cfg, port_opt, microbatches=microbatches)
    jp, jstate, jstep_i = jtree, jax_opt.init(jtree), jnp.asarray(0,
                                                                 jnp.int32)
    params = lm.params_from_numpy(np_tree, cfg, device="cpu")
    state, step_i = port_opt.init(params), 0
    for i in range(3):
        batch = _batch(cfg, 30 + i, mask=(i == 1))
        jp, jstate, jstep_i, jm = jstep(
            jp, jstate, jstep_i, {k: jnp.asarray(v) for k, v in batch.items()})
        params, state, step_i, m = step_fn(
            params, state, step_i, {k: torch.as_tensor(v)
                                    for k, v in batch.items()})
        for key in ("loss", "ce", "aux"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       atol=STEP_ATOL, rtol=STEP_RTOL,
                                       err_msg=f"step {i} {key}")
    assert step_i == int(jstep_i) == 3
    admitted = {}
    for path, g, w, noise in zip(_paths(np_tree), _leaves_np(params),
                                 _leaves_np(jp),
                                 _noise_elements(cfg, np_tree, opt)):
        assert np.isfinite(g).all(), path
        bar = STEP_ATOL + STEP_RTOL * np.abs(w)
        if opt != "adafactor":
            bar = bar + NOISE_ATOL * noise
        out = np.abs(g - w) > bar
        assert not (out & ~noise).any(), \
            f"{path}: max excess {float((np.abs(g - w) - bar)[~noise].max())}"
        if out.any():
            admitted[path] = int(out.sum())
    assert set(admitted) == NOISE_LEAVES.get((arch, opt), set()), admitted
    assert all(a.dtype == b.dtype for a, b in
               zip(tree_leaves(state), tree_leaves(port_opt.init(params))))


def _paths(tree, prefix=""):
    """The leaves' paths, in ``_leaves_np``'s order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def _noise_elements(cfg, np_tree, opt):
    """Per leaf, the elements whose steps float noise decides: under Adam
    those whose first-step gradient (on the first step's batch) is below
    NOISE_FLOOR of the leaf's largest (quiet); under Adafactor, in a leaf
    of rank ≥ 2, every element of a row or column (the last two axes)
    that is quiet throughout, in a rank-1 leaf the quiet elements."""
    params = lm.params_from_numpy(np_tree, cfg, device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_()
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg, 30, False).items()}
    loss, _ = lm.loss_fn(params, cfg, batch)
    out = []
    for g in torch.autograd.grad(loss, leaves):
        a = g.abs().numpy()
        quiet = a < NOISE_FLOOR * max(float(a.max()), 1e-30)
        if opt == "adafactor" and quiet.ndim >= 2:
            quiet = np.broadcast_to(quiet.all(axis=-1, keepdims=True)
                                    | quiet.all(axis=-2, keepdims=True),
                                    quiet.shape)
        out.append(quiet)
    return out
