"""Optimizers as pure ``(init, update)`` pairs over parameter trees.

The port of ``repro.optim.optimizers``' Adam/AdamW and global-norm
clipping, formula for formula: the bias correction from ``step + 1``,
``eps`` outside the square root, float32 update math. A tree is a nested
dict of tensors, flattened in sorted-key order as ``jax.tree_util`` does,
so the global norm sums its leaves in the same order. ``torch.optim`` is
not used: its Adam puts ``eps`` inside its own bias correction and
differs in the last bits. The state is ``{"m": tree, "v": tree}``, as in
the JAX package, so one checkpoint format serves both; ``sgd``'s is
``{"mu": tree}``. ``adafactor`` comes with the LM stack (ROADMAP A14b).

``update`` returns new trees and never writes into its inputs; call it
under ``torch.no_grad()``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

Params = Any
OptState = Dict[str, Any]


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


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def clip_by_global_norm(grads, max_norm: float):
    """``(grads · min(1, max_norm / max(‖grads‖, 1e-12)), ‖grads‖)`` with
    the float32 norm over every leaf."""
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                           for g in leaves))
    scale = torch.clamp_max(max_norm / torch.clamp_min(gnorm, 1e-12), 1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gnorm


def adamw(lr: Union[Callable, float], b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.0,
          grad_clip_norm: Optional[float] = None) -> Optimizer:
    """AdamW with float32 update math (Loshchilov & Hutter)."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        return {"m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params)}

    def update(step, state, params, grads):
        if grad_clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, grad_clip_norm)
        step = torch.as_tensor(step)
        t = step.to(torch.float32) + 1.0
        lr_t = lr_fn(step)
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t

        def upd(p, g, m, v):
            gf = g.to(torch.float32)
            mf = m.to(torch.float32) * b1 + (1 - b1) * gf
            vf = v.to(torch.float32) * b2 + (1 - b2) * gf * gf
            mhat = mf / bc1
            vhat = vf / bc2
            step_ = lr_t * mhat / (torch.sqrt(vhat) + eps)
            if weight_decay:
                step_ = step_ + lr_t * weight_decay * p.to(torch.float32)
            newp = (p.to(torch.float32) - step_).to(p.dtype)
            return newp, mf.to(m.dtype), vf.to(v.dtype)

        out = tree_map(upd, params, grads, state["m"], state["v"])

        def pick(i):
            return tree_map(lambda o: o[i], out)
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
