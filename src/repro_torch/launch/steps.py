"""Train and serve steps of the LM stack.

The port of ``make_train_step``, ``default_optimizer``,
``make_prefill_step``, ``make_encode_step`` and ``make_serve_step``
(``repro/launch/steps.py``).
The JAX package jits these with sharding trees over a mesh; the port runs
eagerly on one device, which is what the JAX package does with
``mesh=None``, so there is no ``ParallelCtx``: the train step takes its
``remat`` flag directly. Gradient compression over a ``pod`` mesh axis
(``compress_grads``) waits for sharding (ROADMAP A14d).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models import lm
from ..models.config import ArchConfig
from ..optim import Optimizer, adamw, cosine_warmup
from ..optim.optimizers import tree_leaves, tree_map, tree_unflatten


def default_optimizer(state_dtype: Optional[torch.dtype] = torch.bfloat16
                      ) -> Optimizer:
    """Production default: AdamW, bf16 states, cosine schedule, clip 1.0."""
    return adamw(cosine_warmup(3e-4, 2000, 100_000), b1=0.9, b2=0.95,
                 weight_decay=0.1, state_dtype=state_dtype,
                 grad_clip_norm=1.0)


def make_train_step(cfg: ArchConfig, optimizer: Optional[Optimizer] = None,
                    microbatches: int = 1, remat: bool = True, *,
                    compress_grads: bool = False) -> Callable:
    """→ ``train_step(params, opt_state, step, batch) → (params', opt',
    step + 1, metrics)``: :func:`repro_torch.models.lm.loss_fn`, its
    gradients, and ``optimizer.update`` (default :func:`default_optimizer`).

    ``batch`` holds ``tokens`` and ``labels`` [B, S] (and optionally
    ``loss_mask``), with ``vision_embeds`` [B, vision_tokens,
    vision_dim] for a cross-attention config; an audio-frame encoder
    takes ``features`` [B, S, d_model] in place of ``tokens``.
    ``microbatches > 1`` splits every key's leading axis, sums the
    microbatches' gradients in float32 and divides by their number; the
    metrics are then the last microbatch's and ``loss`` the mean. With one
    microbatch the gradients come in the parameters' dtype, as
    ``jax.value_and_grad`` gives them. ``metrics["loss"]`` is the loss.
    The parameters and optimizer state are returned as new trees; the
    inputs are not written. Every config trains: attention (dense, MLA,
    cross) through the flash backward, MoE through autograd of its
    dispatch, Mamba2 and hybrid through the SSD scan's backward;
    ``compress_grads=True`` raises naming A14d.
    """
    if compress_grads:
        raise NotImplementedError(
            "compress_grads sums int8 gradients over a 'pod' mesh axis; "
            "sharding and launch are not ported yet (ROADMAP A14d)")
    lm.check_supported(cfg)
    optimizer = optimizer or default_optimizer()

    def value_and_grad(params, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        tracked = tree_unflatten(params, leaves)
        with torch.enable_grad():
            loss, metrics = lm.loss_fn(tracked, cfg, batch, remat=remat)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree_unflatten(params, grads))

    def compute_grads(params, batch):
        if microbatches <= 1:
            return value_and_grad(params, batch)
        split = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                              + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params)
        lsum = 0.0
        for i in range(microbatches):
            loss, metrics, g = value_and_grad(
                params, {k: v[i] for k, v in split.items()})
            tree_map(lambda a, x: a.add_(x), acc, g)
            lsum = lsum + loss
        grads = tree_map(lambda a: a / microbatches, acc)
        return lsum / microbatches, metrics, grads

    def train_step(params, opt_state, step, batch):
        out = list(compute_grads(params, batch))
        loss, metrics = out[0], out[1]
        with torch.no_grad():
            # the gradients' one reference goes to the update, which drops
            # each once its leaf is updated
            new_params, new_opt = optimizer.update(step, opt_state, params,
                                                   out.pop())
        metrics = dict(metrics)
        metrics["loss"] = loss
        return new_params, new_opt, step + 1, metrics

    return train_step


def _refuse_encoder(cfg: ArchConfig) -> None:
    """An encoder-only config has no decode cache: the JAX package never
    lowers a decode for one, and its encode step plays the prefill's
    role (``repro/launch/input_specs.py:cell_for``)."""
    if cfg.is_encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: it has no prefill or "
                         f"decode step; use make_encode_step")


def make_prefill_step(cfg: ArchConfig, max_len: int) -> Callable:
    """→ ``prefill_step(params, inputs) → (logits [B, 1, V], cache)``: the
    prompt (``tokens``, with ``vision_embeds`` for a cross-attention
    config) through :func:`repro_torch.models.lm.prefill` into a fresh
    cache of ``max_len`` positions. An encoder-only config raises."""
    _refuse_encoder(cfg)

    def prefill_step(params, inputs):
        return lm.prefill(params, cfg, inputs, max_len)
    return prefill_step


def make_encode_step(cfg: ArchConfig) -> Callable:
    """→ ``encode_step(params, inputs) → logits [B, S, V]``: the
    encoder-only forward (hubert: audio ``features`` [B, S, d_model] →
    per-frame logits), :func:`repro_torch.models.lm.forward`."""
    def encode_step(params, inputs):
        logits, _ = lm.forward(params, cfg, inputs)
        return logits
    return encode_step


def make_serve_step(cfg: ArchConfig) -> Callable:
    """→ ``serve_step(params, cache, inputs, cache_index) → (next token
    [B] int32, cache, cache_index + 1)``: one decode step and its greedy
    token. The cache is updated in place and returned; a cross layer reads
    the vision memory's K / V the prefill seeded there. An encoder-only
    config raises."""
    _refuse_encoder(cfg)

    def serve_step(params, cache, inputs, cache_index):
        logits, cache = lm.decode_step(params, cfg, cache, inputs,
                                       cache_index)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, cache, cache_index + 1
    return serve_step
