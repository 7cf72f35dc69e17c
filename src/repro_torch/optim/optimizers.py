"""Optimizers as pure ``(init, update)`` pairs over parameter trees.

The port of ``repro.optim.optimizers``: Adam/AdamW, SGD with momentum,
Adafactor and global-norm clipping, formula for formula: the bias
correction from ``step + 1``, ``eps`` outside the square root, float32
update math whatever the parameters' and states' dtypes. A tree is a
nested dict of tensors, flattened in sorted-key order as ``jax.tree_util``
does, so the global norm sums its leaves in the same order.
``torch.optim`` is not used: its Adam puts ``eps`` inside its own bias
correction and differs in the last bits. The state is ``{"m": tree, "v":
tree}``, as in the JAX package, so one checkpoint format serves both;
``sgd``'s is ``{"mu": tree}``, ``adafactor``'s ``{"f": tree}`` of
``{"vr", "vc"}`` (factored, rank ≥ 2) or ``{"v"}`` per leaf, in float32.
``state_dtype`` (``adamw``, ``adam``, ``sgd``) stores the states in that
dtype (``torch.bfloat16`` halves their memory); the update still computes
in float32 and rounds the new states once.

``update`` returns new trees and never writes into its inputs; call it
under ``torch.no_grad()``. AdamW updates a leaf of more than
``_SLICE_ELEMS`` elements a flat slice at a time, into new tensors
allocated once: the update is elementwise, so the values are the same
bits, and its float32 temporaries stay at 256 MiB each where a whole
expert stack's would be 5–6 GB (deepseek-v2's [160, 5120, 1536],
grok-1's [8, 6144, 32768], each behind a stack's leading axis of 1). It
also drops each gradient once its leaf is updated: a caller that hands
over the only reference to the gradients (``launch.steps``' train step
does) holds at most the old and the new parameters and states and the
gradients not yet used, which is what lets deepseek-v2's full width
train in 80 GB.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

Params = Any
OptState = Dict[str, Any]
#: AdamW's largest slice of a leaf, in elements (float32 temporaries of
#: 256 MiB)
_SLICE_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], OptState]
    update: Callable[[Any, OptState, Params, Params],
                     Tuple[Params, OptState]]
    # update(step, state, params, grads) -> (new_params, new_state)


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves in ``jax.tree_util.tree_leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree, leaves):
    """``leaves`` (an iterable, in :func:`tree_leaves` order) placed in the
    structure of ``tree``."""
    return _build(tree, iter(leaves))


def _build(t, it):
    # a plain recursion: a nested function that calls itself through its
    # own closure is a reference cycle, which kept ``leaves`` (a train
    # step's gradients, 10.7 GB for deepseek-v2 at full width) alive until
    # the garbage collector ran
    if isinstance(t, dict):
        return {k: _build(t[k], it) for k in sorted(t)}
    return next(it)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def _clip_scale(grads, max_norm: float):
    """``(min(1, max_norm / max(‖grads‖, 1e-12)), ‖grads‖)``, the float32
    norm over every leaf."""
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                           for g in leaves))
    return torch.clamp_max(max_norm / torch.clamp_min(gnorm, 1e-12),
                           1.0), gnorm


def clip_by_global_norm(grads, max_norm: float):
    """``(grads · min(1, max_norm / max(‖grads‖, 1e-12)), ‖grads‖)`` with
    the float32 norm over every leaf."""
    scale, gnorm = _clip_scale(grads, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gnorm


def adamw(lr: Union[Callable, float], b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0,
          state_dtype: Optional[torch.dtype] = None,
          grad_clip_norm: Optional[float] = None) -> Optimizer:
    """AdamW with float32 update math (Loshchilov & Hutter); the moments
    are kept in ``state_dtype`` (default: each parameter's own)."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        zeros = lambda p: torch.zeros_like(  # noqa: E731
            p, dtype=state_dtype or p.dtype)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def update(step, state, params, grads):
        scale = None
        if grad_clip_norm is not None:
            # clip_by_global_norm's product, a leaf at a time
            scale, _ = _clip_scale(grads, grad_clip_norm)
        step = torch.as_tensor(step)
        t = step.to(torch.float32) + 1.0
        lr_t = lr_fn(step)
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t

        def upd(p, g, m, v):
            n = _SLICE_ELEMS
            if p.numel() <= n:
                return upd_slice(p, g, m, v)
            outs = tuple(torch.empty(p.shape, dtype=dt, device=p.device)
                         for dt in (p.dtype, state_dtype or m.dtype,
                                    state_dtype or v.dtype))
            flat = [t.reshape(-1) for t in (p, g, m, v)]
            for i in range(0, p.numel(), n):
                part = upd_slice(*(t[i:i + n] for t in flat))
                for o, x in zip(outs, part):
                    o.view(-1)[i:i + n] = x
            return outs

        def upd_slice(p, g, m, v):
            # the reference's expressions, in place on float32 temporaries
            # (a [36, 2048, 11008] stack's would be 3.2 GB each)
            if scale is not None:
                g = g * scale.to(g.dtype)
            gf = g.to(torch.float32)
            mf = m.to(torch.float32) * b1 + (1 - b1) * gf
            vf = (v.to(torch.float32) * b2).add_((1 - b2) * gf * gf)
            del gf
            new_m = mf.to(state_dtype or m.dtype, copy=True)
            new_v = vf.to(state_dtype or v.dtype, copy=True)
            # lr_t · m̂ / (√v̂ + eps)
            step_ = mf.div_(bc1).mul_(lr_t).div_(vf.div_(bc2).sqrt_()
                                                 .add_(eps))
            del vf
            if weight_decay:
                step_.add_(lr_t * weight_decay * p.to(torch.float32))
            newp = (p.to(torch.float32) - step_).to(p.dtype)
            return newp, new_m, new_v

        # a leaf at a time; each gradient is dropped once its leaf is
        # updated, so a tree handed over as the only reference (as
        # make_train_step hands it) is freed leaf by leaf
        gl = tree_leaves(grads)
        del grads
        out = []
        for i, (p, m, v) in enumerate(zip(tree_leaves(params),
                                          tree_leaves(state["m"]),
                                          tree_leaves(state["v"]))):
            g, gl[i] = gl[i], None
            out.append(upd(p, g, m, v))
            del g

        def pick(i):
            return tree_unflatten(params, [o[i] for o in out])
        return pick(0), {"m": pick(1), "v": pick(2)}

    return Optimizer(init=init, update=update)


def adam(lr, **kw) -> Optimizer:
    return adamw(lr, weight_decay=0.0, **kw)


def sgd(lr: Union[Callable, float], momentum: float = 0.9,
        state_dtype: Optional[torch.dtype] = None) -> Optimizer:
    """SGD with heavy-ball momentum, float32 update math; the momentum is
    kept in ``state_dtype`` (default: each parameter's own)."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        return {"mu": tree_map(
            lambda p: torch.zeros_like(p, dtype=state_dtype or p.dtype),
            params)}

    def update(step, state, params, grads):
        lr_t = lr_fn(step)

        def upd(p, g, mu):
            muf = mu.to(torch.float32) * momentum + g.to(torch.float32)
            newp = (p.to(torch.float32) - lr_t * muf).to(p.dtype)
            return newp, muf.to(state_dtype or mu.dtype)

        out = tree_map(upd, params, grads, state["mu"])
        return (tree_map(lambda o: o[0], out),
                {"mu": tree_map(lambda o: o[1], out)})

    return Optimizer(init=init, update=update)


def adafactor(lr: Union[Callable, float], decay: float = 0.8,
              eps: float = 1e-30, clip_threshold: float = 1.0) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern) — O(n + m)
    state for an n × m matrix: a leaf of rank ≥ 2 keeps row and column
    means of g² over its last two axes, a smaller one the full second
    moment; β₂ = 1 − t^(−decay); updates clipped to RMS
    ``clip_threshold``. States in float32, update math in float32."""
    lr_fn = lr if callable(lr) else (lambda _: lr)
    f32 = torch.float32

    def init(params):
        def st(p):
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], dtype=f32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=f32, device=p.device)}
            return {"v": torch.zeros_like(p, dtype=f32)}
        return {"f": tree_map(st, params)}

    def update(step, state, params, grads):
        step = torch.as_tensor(step)
        t = step.to(f32) + 1.0
        beta2 = 1.0 - t ** (-decay)
        lr_t = lr_fn(step)

        def upd(p, g, s):
            gf = g.to(f32)
            g2 = gf * gf + eps
            if p.dim() >= 2:
                vr = beta2 * s["vr"] + (1 - beta2) * g2.mean(dim=-1)
                vc = beta2 * s["vc"] + (1 - beta2) * g2.mean(dim=-2)
                denom = (vr[..., None] * vc[..., None, :]) / torch.clamp_min(
                    vr.mean(dim=-1, keepdim=True)[..., None], eps)
                u = gf * torch.rsqrt(torch.clamp_min(denom, eps))
                new_s = {"vr": vr, "vc": vc}
            else:
                v = beta2 * s["v"] + (1 - beta2) * g2
                u = gf * torch.rsqrt(torch.clamp_min(v, eps))
                new_s = {"v": v}
            rms = torch.sqrt(torch.mean(u * u) + eps)     # update clipping
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            newp = (p.to(f32) - lr_t * u).to(p.dtype)
            return newp, new_s

        out = tree_map(upd, params, grads, state["f"])
        return (tree_map(lambda o: o[0], out),
                {"f": tree_map(lambda o: o[1], out)})

    return Optimizer(init=init, update=update)
