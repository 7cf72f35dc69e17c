"""Minimal NN primitives of the port, in the JAX package's layout.

Parameters are nested dicts of arrays (numpy at init, tensors at run
time), as in ``repro.nn``. A weight is ``w [d_in, d_out]`` and the
product is ``x @ w`` — the JAX layout, not ``nn.Linear``'s
``[out, in]`` — so one artifact loads into both packages unchanged.
Initialization draws from an explicit ``numpy.random.Generator``, and
dropout from an explicit ``torch.Generator``. The LM stack's leaves are
tensors from the start (``repro_torch.models.lm.init_params`` draws them
on the device).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

Params = Dict[str, Any]


def glorot(rng: np.random.Generator, shape: Tuple[int, ...]) -> np.ndarray:
    """Glorot-uniform float32 array of ``shape`` (fans from the last two
    axes)."""
    fan_in, fan_out = shape[-2], shape[-1]
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    return rng.uniform(-lim, lim, size=shape).astype(np.float32)


def normal_init(rng: np.random.Generator,
                shape: Tuple[int, ...]) -> np.ndarray:
    """Normal float32 array of ``shape`` with standard deviation 0.02
    (``repro.nn.normal_init``'s default)."""
    return (rng.standard_normal(shape) * 0.02).astype(np.float32)


def zeros(shape: Tuple[int, ...], dtype: torch.dtype = torch.float32,
          device: Optional[torch.device] = None) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def ones(shape: Tuple[int, ...], dtype: torch.dtype = torch.float32,
         device: Optional[torch.device] = None) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=device)


def linear_init(rng: np.random.Generator, d_in: int, d_out: int,
                bias: bool = True) -> Params:
    p = {"w": glorot(rng, (d_in, d_out))}
    if bias:
        p["b"] = np.zeros((d_out,), np.float32)
    return p


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def mlp_init(rng: np.random.Generator, dims: Sequence[int],
             bias: bool = True) -> Params:
    """``{"l0": linear, "l1": linear, ...}`` for layer widths ``dims``."""
    return {f"l{i}": linear_init(rng, dims[i], dims[i + 1], bias)
            for i in range(len(dims) - 1)}


def mlp(p: Params, x: torch.Tensor,
        act: Callable[[torch.Tensor], torch.Tensor] = torch.relu
        ) -> torch.Tensor:
    """Linear layers ``l0, l1, ...`` with ``act`` between them (not after
    the last)."""
    n = len(p)
    for i in range(n):
        x = linear(p[f"l{i}"], x)
        if i < n - 1:
            x = act(x)
    return x


def dropout(gen: Optional[torch.Generator], x: torch.Tensor, rate: float,
            train: bool) -> torch.Tensor:
    """Inverted dropout, ``repro.nn.dropout``'s semantics: keep each element
    with probability ``1 - rate`` and scale it by ``1 / (1 - rate)``, exact
    0 elsewhere; the identity unless training with ``rate > 0`` and a
    generator. ``gen`` lives on ``x``'s device. The bits are torch's, not
    ``jax.random``'s."""
    if not train or rate <= 0.0 or gen is None:
        return x
    keep = 1.0 - rate
    kept = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(kept, x / keep, 0.0)


def layernorm_init(d: int, dtype: torch.dtype = torch.float32,
                   device: Optional[torch.device] = None,
                   lead: Tuple[int, ...] = ()) -> Params:
    """``repro.nn.layernorm_init``: unit scale, zero bias; ``lead``
    prepends stacked layer axes."""
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device),
            "bias": torch.zeros(lead + (d,), dtype=dtype, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``repro.nn.layernorm``: the mean and the biased variance over the
    last axis, in x's dtype."""
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def rmsnorm_init(d: int, dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None,
                 lead: Tuple[int, ...] = ()) -> Params:
    """``repro.nn.rmsnorm_init``; ``lead`` prepends stacked layer axes."""
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``repro.nn.rmsnorm`` step for step: the square in x's dtype, the mean
    in float32, the reciprocal root cast back to x's dtype, eps 1e-6 (the
    JAX model never reads ``ArchConfig.norm_eps``)."""
    ms = torch.mean(torch.square(x).float(), dim=-1, keepdim=True)
    inv = torch.rsqrt(ms + eps).to(x.dtype)
    return x * inv * p["scale"]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def tree_size(tree) -> int:
    """Elements over every tensor or array leaf of a nested dict/list."""
    return sum(int(x.numel()) if isinstance(x, torch.Tensor) else int(x.size)
               for x in _leaves(tree) if hasattr(x, "shape"))


def tree_bytes(tree) -> int:
    """Bytes over every tensor or array leaf of a nested dict/list."""
    return sum(int(x.numel()) * x.element_size()
               if isinstance(x, torch.Tensor) else int(x.nbytes)
               for x in _leaves(tree) if hasattr(x, "shape"))


def tree_cast(tree, dtype: torch.dtype):
    """The same nested dict/list with every floating tensor leaf cast to
    ``dtype``; integer tensors and other leaves are left as they are."""
    if isinstance(tree, dict):
        return {k: tree_cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_cast(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree
