"""Minimal NN primitives of the port, in the JAX package's layout.

Parameters are nested dicts of arrays (numpy at init, tensors at run
time), as in ``repro.nn``. A weight is ``w [d_in, d_out]`` and the
product is ``x @ w`` — the JAX layout, not ``nn.Linear``'s
``[out, in]`` — so one artifact loads into both packages unchanged.
Initialization draws from an explicit ``numpy.random.Generator``, and
dropout from an explicit ``torch.Generator``.
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
