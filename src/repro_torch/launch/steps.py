"""Serve steps of the LM stack: prefill and greedy decode.

The port of ``make_prefill_step`` and ``make_serve_step``
(``repro/launch/steps.py``). The JAX package jits these with sharding
trees over a mesh; the port runs eagerly on one device, which is what the
JAX package does with ``mesh=None``, so there is no ``ParallelCtx``.
``make_train_step`` waits for LM training (ROADMAP A14b).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..models import lm
from ..models.config import ArchConfig


def make_prefill_step(cfg: ArchConfig, max_len: int) -> Callable:
    """→ ``prefill_step(params, inputs) → (logits [B, 1, V], cache)``: the
    prompt through :func:`repro_torch.models.lm.prefill` into a fresh cache
    of ``max_len`` positions."""
    def prefill_step(params, inputs):
        return lm.prefill(params, cfg, inputs, max_len)
    return prefill_step


def make_serve_step(cfg: ArchConfig) -> Callable:
    """→ ``serve_step(params, cache, inputs, cache_index) → (next token
    [B] int32, cache, cache_index + 1)``: one decode step and its greedy
    token. The cache is updated in place and returned."""
    def serve_step(params, cache, inputs, cache_index):
        logits, cache = lm.decode_step(params, cfg, cache, inputs,
                                       cache_index)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, cache, cache_index + 1
    return serve_step
