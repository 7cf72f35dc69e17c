"""Optimizers and schedules of the PyTorch port against the JAX package.

``adamw`` / ``adam`` and ``clip_by_global_norm`` run five steps on the
same numpy parameter tree and gradients as ``repro.optim``'s and must
agree to 1e-6, state included; the schedules agree at every step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.optim import (adam, adamw, clip_by_global_norm,  # noqa: E402
                               constant, cosine_warmup, linear_warmup)

TOL = 1e-6


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"gnn": {"b0": {"w": rng.standard_normal((5, 4)),
                           "b": rng.standard_normal(4)}},
            "fc": {"b0": {"w": rng.standard_normal((4, 3))},
                   "eps": np.asarray(rng.standard_normal())}}


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    return fn(tree)


def _assert_trees_close(got, want, tol=TOL):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_trees_close(got[k], want[k], tol)
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("kw", [
    dict(), dict(weight_decay=0.01), dict(grad_clip_norm=0.5),
    dict(b1=0.8, b2=0.99, eps=1e-6),
], ids=["adam", "weight_decay", "clip", "betas"])
def test_adamw_matches_jax_over_five_steps(kw):
    import jax.numpy as jnp
    from repro.optim import adamw as jadamw
    from repro.optim import constant as jconstant
    params = _f32(_tree(0))
    jopt = jadamw(jconstant(3e-3), **kw)
    topt = adamw(constant(3e-3), **kw)
    jp = _to(params, jnp.asarray)
    tp = _to(params, torch.as_tensor)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(5):
        grads = _f32(_tree(10 + step))
        jp, js = jopt.update(jnp.asarray(step, jnp.int32), js, jp,
                             _to(grads, jnp.asarray))
        tp, ts = topt.update(torch.tensor(step, dtype=torch.int32), ts, tp,
                             _to(grads, torch.as_tensor))
        _assert_trees_close(tp, jp)
        _assert_trees_close(ts["m"], js["m"])
        _assert_trees_close(ts["v"], js["v"])


def test_adam_is_adamw_without_decay():
    params = _to(_f32(_tree(1)), torch.as_tensor)
    grads = _to(_f32(_tree(2)), torch.as_tensor)
    a, b = adam(1e-2), adamw(1e-2, weight_decay=0.0)
    pa, _ = a.update(0, a.init(params), params, grads)
    pb, _ = b.update(0, b.init(params), params, grads)
    _assert_trees_close(pa, pb, 0.0)


@pytest.mark.parametrize("max_norm", [1e-3, 1.0, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    import jax.numpy as jnp
    from repro.optim import clip_by_global_norm as jclip
    grads = _f32(_tree(3))
    jg, jn = jclip(_to(grads, jnp.asarray), max_norm)
    tg, tn = clip_by_global_norm(_to(grads, torch.as_tensor), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=TOL)
    _assert_trees_close(tg, jg)


def test_update_writes_nothing_into_its_inputs():
    params = _to(_f32(_tree(4)), torch.as_tensor)
    before = _to(params, lambda t: t.clone())
    opt = adamw(1e-2)
    state = opt.init(params)
    opt.update(0, state, params, _to(_f32(_tree(5)), torch.as_tensor))
    _assert_trees_close(params, before, 0.0)
    _assert_trees_close(state["m"], _to(before, torch.zeros_like), 0.0)


@pytest.mark.parametrize("name", ["constant", "linear_warmup",
                                  "cosine_warmup"])
def test_schedules_match_jax(name):
    import jax.numpy as jnp
    from repro.optim import schedules as js
    args = {"constant": (3e-4,), "linear_warmup": (3e-4, 5),
            "cosine_warmup": (3e-4, 5, 40)}[name]
    mine = {"constant": constant, "linear_warmup": linear_warmup,
            "cosine_warmup": cosine_warmup}[name](*args)
    theirs = getattr(js, name)(*args)
    for step in (0, 1, 4, 5, 17, 39, 60):
        np.testing.assert_allclose(
            float(mine(torch.tensor(step, dtype=torch.int32))),
            float(theirs(jnp.asarray(step, jnp.int32))), rtol=TOL)
