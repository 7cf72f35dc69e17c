"""Minimal NN primitives of the port, in the JAX package's layout.

Parameters are nested dicts of arrays (numpy at init, tensors at run
time), as in ``repro.nn``. A weight is ``w [d_in, d_out]`` and the
product is ``x @ w`` — the JAX layout, not ``nn.Linear``'s
``[out, in]`` — so one artifact loads into both packages unchanged.
Initialization draws from an explicit ``numpy.random.Generator``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

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
