"""The last public names of the JAX package's ported files, each held to
its JAX counterpart on the CPU.

* ``core.gnn``'s ``{sage,gcn,gat,gin,mlp}_layer_init``: the reference's
  tree, shapes and dtypes (numpy draws its values, not ``jax.random``).
* ``kernels.ops.ssd_decode``: the alias of the plain decode step, against
  the reference's ``ssd_decode_ref`` over a few steps.
* ``kernels.ref.attention_ref``: naive attention over [B, H, S, D] with
  ``causal``, ``scale``, ``window`` and ``q_offset``, at 1e-5 relative.
* ``nn.layernorm`` / ``layernorm_init``: the tree and the function.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import nn as jnn  # noqa: E402
from repro.core import gnn as jgnn  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import nn as tnn  # noqa: E402
from repro_torch.core import gnn as tgnn  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

RTOL = 1e-5


def _tree(tree, prefix=()):
    """path → (shape, dtype name) of every leaf."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tree(v, prefix + (k,)))
        return out
    dt = tree.dtype
    return {prefix: (tuple(tree.shape),
                     str(dt).replace("torch.", "") if isinstance(
                         dt, torch.dtype) else np.dtype(dt).name)}


@pytest.mark.parametrize("name", ["sage", "gcn", "gat", "gin", "mlp"])
def test_layer_init_is_the_reference_tree(name):
    fn = f"{name}_layer_init"
    got = getattr(tgnn, fn)(np.random.default_rng(0), 12, 8)
    want = getattr(jgnn, fn)(jax.random.PRNGKey(0), 12, 8)
    assert _tree(got) == _tree(want)
    assert all(isinstance(v, np.ndarray)
               for v in jax.tree_util.tree_leaves(got))
    # a seed draws as its Generator does
    again = getattr(tgnn, fn)(3, 12, 8)
    same = getattr(tgnn, fn)(np.random.default_rng(3), 12, 8)
    for a, b in zip(jax.tree_util.tree_leaves(again),
                    jax.tree_util.tree_leaves(same)):
        np.testing.assert_array_equal(a, b)


def test_gat_layer_init_takes_the_head_count():
    got = tgnn.gat_layer_init(np.random.default_rng(0), 12, 8, heads=2)
    want = jgnn.gat_layer_init(jax.random.PRNGKey(0), 12, 8, heads=2)
    assert _tree(got) == _tree(want)
    assert got["att_src"].shape == (2, 4)


def test_ssd_decode_is_the_reference_step():
    rng = np.random.default_rng(0)
    b, h, n, p = 2, 3, 4, 5
    a = -np.exp(0.1 * rng.standard_normal(h)).astype(np.float32)
    state = rng.standard_normal((b, h, n, p)).astype(np.float32)
    want_state, got_state = state, torch.tensor(state)
    assert tops.ssd_decode is tref.ssd_decode_ref
    for _ in range(3):
        x = rng.standard_normal((b, h, p)).astype(np.float32)
        dt = (0.05 + 0.1 * rng.random((b, h))).astype(np.float32)
        bm = rng.standard_normal((b, h, n)).astype(np.float32)
        cm = rng.standard_normal((b, h, n)).astype(np.float32)
        wy, want_state = jops.ssd_decode(want_state, x, dt, a, bm, cm)
        y, got_state = tops.ssd_decode(got_state, torch.tensor(x),
                                       torch.tensor(dt), torch.tensor(a),
                                       torch.tensor(bm), torch.tensor(cm))
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), rtol=RTOL,
                                   atol=1e-6)
        np.testing.assert_allclose(got_state.numpy(),
                                   np.asarray(want_state), rtol=RTOL,
                                   atol=1e-6)


ATTN_CASES = {
    # name: (B, H, Sq, Skv, D, kwargs)
    "plain": (2, 3, 7, 7, 8, {}),
    "causal": (1, 2, 9, 9, 8, {"causal": True}),
    "scaled_window": (1, 2, 12, 12, 4, {"causal": True, "window": 4,
                                        "scale": 0.3}),
    "offset_decode": (2, 2, 1, 10, 8, {"causal": True, "q_offset": 9}),
    "offset_chunk": (1, 2, 4, 10, 8, {"causal": True, "q_offset": 6,
                                      "window": 5}),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_ref_is_the_reference(case):
    b, h, sq, skv, d, kw = ATTN_CASES[case]
    rng = np.random.default_rng(1)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, h, skv, d)).astype(np.float32)
    got = tref.attention_ref(torch.tensor(q), torch.tensor(k),
                             torch.tensor(v), **kw)
    want = np.asarray(jref.attention_ref(q, k, v, **kw))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6)


def test_attention_ref_keeps_bf16_and_a_keyless_row_is_nan():
    rng = np.random.default_rng(2)
    q = torch.tensor(rng.standard_normal((1, 1, 3, 4)).astype(np.float32))
    k = torch.tensor(rng.standard_normal((1, 1, 3, 4)).astype(np.float32))
    assert tref.attention_ref(q.bfloat16(), k.bfloat16(),
                              k.bfloat16()).dtype == torch.bfloat16
    # a query before every key (q_offset -1, causal) has no key
    got = tref.attention_ref(q, k, k, causal=True, q_offset=-1).numpy()
    want = np.asarray(jref.attention_ref(q.numpy(), k.numpy(), k.numpy(),
                                         causal=True, q_offset=-1))
    assert np.isnan(got[0, 0, 0]).all() and np.isnan(want[0, 0, 0]).all()
    np.testing.assert_allclose(got[0, 0, 1:], want[0, 0, 1:], rtol=RTOL,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_is_the_reference(dtype):
    p = tnn.layernorm_init(6, getattr(torch, dtype))
    jp = jnn.layernorm_init(6, jnp.dtype(dtype))
    assert _tree(p) == _tree(jp)
    assert tnn.layernorm_init(6, lead=(3,))["bias"].shape == (3, 6)
    rng = np.random.default_rng(4)
    x = (3.0 + rng.standard_normal((2, 5, 6))).astype(np.float32)
    scale = rng.standard_normal(6).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    got = tnn.layernorm({"scale": torch.tensor(scale),
                         "bias": torch.tensor(bias)}, torch.tensor(x))
    want = np.asarray(jnn.layernorm({"scale": scale, "bias": bias}, x))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-5)
    got = tnn.layernorm({"scale": torch.tensor(scale),
                         "bias": torch.tensor(bias)}, torch.tensor(x),
                        eps=0.5)
    want = np.asarray(jnn.layernorm({"scale": scale, "bias": bias}, x,
                                    eps=0.5))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-5)
