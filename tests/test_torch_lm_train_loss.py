"""``lm.loss_fn`` of the PyTorch port against the JAX package's, on the
CPU: the loss, its cross-entropy and aux terms, and the gradient of every
parameter against ``jax.value_and_grad`` of ``repro.models.lm.loss_fn``
on the smoke configs of the four attention archs (qwen2.5-3b, yi-34b,
h2o-danube-3-4b, chatglm3-6b) and the two SSD archs (mamba2-370m, zamba2-2.7b,
through the SSD scan's backward), with and without ``loss_mask``, within
1e-4 (each gradient within 1e-4 of its leaf's largest): float32 sums in
another order through the layers and the head.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402
from test_torch_lm_train import (ATTN_ARCHS, SSD_ARCHS,  # noqa: E402,F401
                                 _batch, _close_scaled, jax_tree, jx,
                                 one_thread)

#: loss and gradients: float32 through two layers and a vocabulary head
LOSS_RTOL = 1e-4


def _leaves_np(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_np(tree[k])]
    return [np.asarray(tree, np.float32)]


@pytest.mark.parametrize("mask", [False, True], ids=["mean", "loss_mask"])
@pytest.mark.parametrize("arch", ATTN_ARCHS + SSD_ARCHS)
def test_loss_fn_and_grads_match_jax(jx, arch, mask):
    jax, jnp = jx["jax"], jx["jnp"]
    jtree, np_tree = jax_tree(arch)
    cfg = get_smoke_config(arch)
    batch = _batch(cfg, 21, mask)
    (jl, jaux), jg = jax.value_and_grad(jx["lm"].loss_fn, has_aux=True)(
        jtree, jx["configs"].get_smoke_config(arch),
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = lm.params_from_numpy(np_tree, cfg, device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_()
    loss, aux = lm.loss_fn(params, cfg, {k: torch.as_tensor(v)
                                         for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux["ce"]), float(jaux["ce"]),
                               rtol=LOSS_RTOL)
    assert float(aux["aux"]) == float(jaux["aux"]) == 0.0
    want = _leaves_np(jg)
    assert len(want) == len(grads)
    for i, (g, w) in enumerate(zip(grads, want)):
        _close_scaled(g.numpy(), w, LOSS_RTOL, f"grad leaf {i}")
