"""Transformer and SSM building blocks of the LM stack, in PyTorch.

The port of ``repro/models/layers.py`` for the blocks that serve dense
decoders, MLA, the capacity-dropping mixture-of-experts (local dispatch),
Mamba2 and the zamba2 hybrid. Parameters are nested dicts of
tensors under the JAX tree's keys, with ``w [d_in, d_out]`` and ``x @ w``;
a stacked tree (``blocks``, ``groups``) keeps its leading axes, and the
model code indexes one layer out of it. Activations run in
``cfg.param_dtype``, softmax, norms and the SSD scan in float32.

The two contractions that the JAX package wrote as jnp twins of its
Pallas kernels go through the port's kernels: ``blockwise_attention``
through :func:`repro_torch.kernels.ops.flash_attention` and
``_ssd_chunked`` through :func:`repro_torch.kernels.ops.ssd_scan`, which
launch ``csrc/flash_attention.cu`` and ``csrc/ssd_scan.cu`` on a CUDA
tensor and take their plain versions on a CPU one. The one-token SSD
decode step stays plain on every device (the JAX package has no kernel
for it either). Attention trains through the flash kernel's backward
(``ops.flash_attention_train``), the SSD scan through its own
(``ops.ssd_scan_train``); a decode step and a prefill from a cache stay
inference only. MLA runs both of its forms on the flash kernel (a value
head dim below the query's). The mixture-of-experts block routes,
dispatches and combines with torch ops, as the JAX package does outside
any Pallas kernel; its expert products are batched matrix products.
Cross-attention (llama-3.2-vision's every fifth layer) takes its keys
and values from a vision memory, with no RoPE and no causal mask, on the
same flash kernel. All of them train: MLA's full-sequence form through
the flash backward at its D 192 over Dv 128, the MoE block through
autograd of its torch ops (the router's softmax carries the combine
weights' and the load-balance loss's gradients; dropped replicas get
exactly 0), the cross layer's ``wk`` / ``wv`` through the memory's K and
V. The expert- and tensor-parallel MoE forms are ROADMAP A14d.

On the meta device (a trace by ``repro_torch.core.tracer``, which the
dataset factory's LM entries take) the steps run as the JAX package's
jnp equations instead, so that the trace is the reference's graph; the
decision and those steps are :mod:`repro_torch.models.graph_form`'s.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import nn
from ..kernels import ops
from ..kernels.ref import ssd_decode_ref
from . import graph_form as G
from .config import ArchConfig

Params = Dict[str, Any]


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` → ``torch.bfloat16`` (a config's dtype names)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def gen_device(gen: Optional[torch.Generator]) -> torch.device:
    """The device a generator draws on; ``None`` draws nothing, on the
    meta device (a tree of shapes, ``lm.param_specs``)."""
    return gen.device if gen is not None else torch.device("meta")


def normal(gen: Optional[torch.Generator], shape: Tuple[int, ...],
           std: float, dtype: torch.dtype) -> torch.Tensor:
    """``repro.nn.normal_init``: a float32 normal draw times ``std``, cast
    to ``dtype``, on the generator's device. Not JAX's bits."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    t = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return t.mul_(std).to(dtype)


def _full(gen: Optional[torch.Generator], shape, value: float, dtype
          ) -> torch.Tensor:
    return torch.full(shape, value, dtype=dtype, device=gen_device(gen))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_cos_sin(positions: torch.Tensor, dim: int, theta: float,
                 dtype: torch.dtype = torch.float32
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [..., S] → cos, sin [..., S, dim / 2]."""
    # jnp's float arange is a constant of the jaxpr, 1.0 / · a division
    base = G.constant(lambda dev: torch.arange(
        0, dim, 2, dtype=torch.float32, device=dev), positions)
    inv_freq = torch.div(torch.full((), 1.0, device=positions.device),
                         theta ** (base / dim))
    ang = positions[..., None].float() * inv_freq
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               fraction: float = 1.0) -> torch.Tensor:
    """Rotate the first ``fraction`` of the head dim (interleaved pairs).
    x: [B, S, H, D]."""
    d = x.shape[-1]
    rd = int(d * fraction)
    rd -= rd % 2
    if rd == 0:
        return x
    if G.is_trace(x):
        # gathers of an iota where the card takes strided views
        return G.apply_rope(x, cos, sin, rd)
    xr, xp = x[..., :rd], x[..., rd:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    c = cos[..., :rd // 2][:, :, None, :]
    s = sin[..., :rd // 2][:, :, None, :]
    y1 = (x1 * c - x2 * s).to(x.dtype)
    y2 = (x2 * c + x1 * s).to(x.dtype)
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr, xp], dim=-1) if rd < d else yr


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, window: int = 0, q_offset: int = 0,
                        kv_offset: int = 0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q [B, Sq, H, D] over k [B, Skv, Hkv, D] and v [B, Skv, Hkv, Dv] →
    [B, Sq, H, Dv] (``Dv <= D``: MLA's 192 / 128 over a full sequence,
    576 / 512 weight-absorbed over its cache): the function of the JAX
    package's ``blockwise_attention``, on the flash kernel; ``scale``
    defaults to ``1 / sqrt(D)``. Offsets are Python ints (a decode step's
    cache index). With
    grad mode on and an input that requires grad it is the differentiable
    call (``ops.flash_attention_train``: the kernel's forward with its
    log-sum-exp, the backward kernel — the reference's custom VJP);
    otherwise the inference call. On a trace it is the JAX package's jnp
    form instead (the card launches B8)."""
    if G.is_trace(q):
        return G.blockwise_attention(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, kv_offset=kv_offset,
                                     scale=scale)
    kw = dict(causal=causal, window=window, q_offset=int(q_offset),
              kv_offset=int(kv_offset), scale=scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return ops.flash_attention_train(q, k, v, **kw)
    return ops.flash_attention(q, k, v, **kw)


def attention_init(gen: torch.Generator, cfg: ArchConfig,
                   lead: Tuple[int, ...] = (), *, cross: bool = False
                   ) -> Params:
    """GQA attention weights; ``cross`` draws ``wk`` / ``wv`` from the
    vision memory's width, ``[vision_dim, Hkv·hd]``."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    kd = cfg.vision_dim if cross else d
    dt = torch_dtype(cfg.param_dtype)
    p = {
        "wq": normal(gen, lead + (d, cfg.n_heads * hd), 0.02, dt),
        "wk": normal(gen, lead + (kd, cfg.n_kv_heads * hd), 0.02, dt),
        "wv": normal(gen, lead + (kd, cfg.n_kv_heads * hd), 0.02, dt),
        "wo": normal(gen, lead + (cfg.n_heads * hd, d), 0.02, dt),
    }
    if cfg.qkv_bias:
        p["bq"] = _full(gen, lead + (cfg.n_heads * hd,), 0.0, dt)
        p["bk"] = _full(gen, lead + (cfg.n_kv_heads * hd,), 0.0, dt)
        p["bv"] = _full(gen, lead + (cfg.n_kv_heads * hd,), 0.0, dt)
    return p


def attention_apply(p: Params, cfg: ArchConfig, x: torch.Tensor, *,
                    positions: torch.Tensor,
                    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    cache_index: Optional[int] = None,
                    memory: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor,
                               Tuple[torch.Tensor, torch.Tensor]]:
    """Self- or cross-attention → (output, cache).

    * ``cache=None`` (a full-sequence forward): attention over x, and the
      fresh (k, v) returned.
    * a sliding-window config with ``cache`` (the ring [B, W, Hkv, hd] of
      the last W positions): attention over ring ++ new tokens with
      ``kv_offset = cache_index − W`` (negative early in a sequence, where
      the ring's slots are empty), returning the last W positions as new
      tensors.
    * otherwise ``cache`` = (k, v) of shape [B, Smax, Hkv, hd]: the new
      tokens' k and v are written IN PLACE at ``cache_index`` (the JAX
      package's functional ``dynamic_update_slice``), and the same two
      tensors are returned. A write past Smax raises, where JAX would
      clamp the start.

    * ``memory`` [B, M, vision_dim] (a cross layer): k and v from
      ``memory @ wk`` / ``@ wv``, no RoPE on q or k, attention over all M
      rows (not causal); the cache is None.
    """
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    kv_src = x if memory is None else memory
    q, k, v = x @ p["wq"], kv_src @ p["wk"], kv_src @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, kv_src.shape[1], hkv, hd)
    v = v.reshape(b, kv_src.shape[1], hkv, hd)
    if memory is not None:
        out = blockwise_attention(q, k, v, causal=False)
        return out.reshape(b, s, h * hd) @ p["wo"], None
    if cfg.rope_fraction > 0:
        rd = int(hd * cfg.rope_fraction)
        cos, sin = rope_cos_sin(positions, rd, cfg.rope_theta)
        frac = 1.0 if hd == rd else cfg.rope_fraction
        q = apply_rope(q, cos, sin, frac)
        k = apply_rope(k, cos, sin, frac)

    if cache is None:
        out = blockwise_attention(q, k, v, causal=cfg.causal,
                                  window=cfg.window)
        new_cache = (k, v)
    elif cfg.window > 0:
        ck, cv = cache
        w = ck.shape[1]
        full_k = torch.cat([ck, k.to(ck.dtype)], dim=1)
        full_v = torch.cat([cv, v.to(cv.dtype)], dim=1)
        out = blockwise_attention(q, full_k, full_v, causal=True,
                                  window=cfg.window, q_offset=cache_index,
                                  kv_offset=cache_index - w)
        new_cache = (full_k[:, -w:], full_v[:, -w:])
    else:
        ck, cv = cache
        end = cache_index + s
        if end > ck.shape[1]:
            raise ValueError(f"decode past the cache: positions up to {end} "
                             f"in a cache of {ck.shape[1]}")
        ck[:, cache_index:end] = k.to(ck.dtype)
        cv[:, cache_index:end] = v.to(cv.dtype)
        out = blockwise_attention(q, ck, cv, causal=True, window=cfg.window,
                                  q_offset=cache_index)
        new_cache = (ck, cv)
    return out.reshape(b, s, h * hd) @ p["wo"], new_cache


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (deepseek-v2)
# ---------------------------------------------------------------------------

def mla_init(gen: Optional[torch.Generator], cfg: ArchConfig,
             lead: Tuple[int, ...] = ()) -> Params:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    dt = torch_dtype(cfg.param_dtype)
    dev = gen_device(gen)
    return {
        "wq_a": normal(gen, lead + (d, m.q_lora_rank), 0.02, dt),
        "wq_b": normal(gen, lead + (m.q_lora_rank, h * qk), 0.02, dt),
        "wkv_a": normal(gen, lead + (d, m.kv_lora_rank + m.qk_rope_dim),
                        0.02, dt),
        "wkv_b": normal(gen, lead + (m.kv_lora_rank,
                                     h * (m.qk_nope_dim + m.v_head_dim)),
                        0.02, dt),
        "wo": normal(gen, lead + (h * m.v_head_dim, d), 0.02, dt),
        "q_norm": nn.rmsnorm_init(m.q_lora_rank, dt, dev, lead),
        "kv_norm": nn.rmsnorm_init(m.kv_lora_rank, dt, dev, lead),
    }


def mla_apply(p: Params, cfg: ArchConfig, x: torch.Tensor, *,
              positions: torch.Tensor,
              cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              cache_index: Optional[int] = None
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """MLA attention → (output, cache), the JAX package's two forms.

    * ``cache=None`` (a full-sequence forward): the heads materialised, k
      = [c_kv @ wkv_b's nope part ‖ k_rope on every head], v its value
      part, scale ``1 / sqrt(nope + rope)``; returns (c_kv, k_rope).
    * ``cache`` = (c [B, Smax, rank], r [B, Smax, 1, rope]): the new
      tokens' compressed pair written IN PLACE at ``cache_index`` (a write
      past Smax raises), then the weight-absorbed form: q_nope folded
      into the latent through wkv_b's ``w_uk``, attention over k = [c ‖ r]
      and v = c on ONE kv head shared by every query head (D = rank +
      rope over Dv = rank on the flash kernel), the same scale, and the
      result mapped back through ``w_uv``; returns the same two tensors.
    """
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    qk_n, qk_r, dv, rank = (m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim,
                            m.kv_lora_rank)
    scale = 1.0 / math.sqrt(qk_n + qk_r)

    q = G.rmsnorm(p["q_norm"], x @ p["wq_a"]) @ p["wq_b"]
    q = q.reshape(b, s, h, qk_n + qk_r)
    q_nope, q_rope = q[..., :qk_n], q[..., qk_n:]
    kv_a = x @ p["wkv_a"]                             # [B, S, rank + rope]
    c_kv = G.rmsnorm(p["kv_norm"], kv_a[..., :rank])
    k_rope = kv_a[..., rank:].reshape(b, s, 1, qk_r)
    cos, sin = rope_cos_sin(positions, qk_r, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope, cos, sin)

    if cache is not None:
        cc, cr = cache
        end = cache_index + s
        if end > cc.shape[1]:
            raise ValueError(f"decode past the cache: positions up to {end} "
                             f"in a cache of {cc.shape[1]}")
        cc[:, cache_index:end] = c_kv.to(cc.dtype)
        cr[:, cache_index:end] = k_rope.to(cr.dtype)
        w = p["wkv_b"].reshape(rank, h, qk_n + dv)
        w_uk, w_uv = w[..., :qk_n], w[..., qk_n:]
        q_lat = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)
        qf = torch.cat([q_lat, q_rope], dim=-1)
        k_lat = torch.cat([cc[:, :, None, :], cr.to(cc.dtype)], dim=-1)
        out_lat = blockwise_attention(qf, k_lat, cc[:, :, None, :],
                                      causal=cfg.causal,
                                      q_offset=cache_index, scale=scale)
        out = torch.einsum("bshr,rhd->bshd", out_lat, w_uv)
        return out.reshape(b, s, h * dv) @ p["wo"], (cc, cr)

    kv = (c_kv @ p["wkv_b"]).reshape(b, s, h, qk_n + dv)
    k_nope, v = kv[..., :qk_n], kv[..., qk_n:]
    k = torch.cat([k_nope, k_rope.expand(b, s, h, qk_r)], dim=-1)
    qf = torch.cat([q_nope, q_rope], dim=-1)
    out = blockwise_attention(qf, k, v.contiguous(), causal=cfg.causal,
                              scale=scale)
    return out.reshape(b, s, h * dv) @ p["wo"], (c_kv, k_rope)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, cfg: ArchConfig,
             lead: Tuple[int, ...] = (), d_ff: Optional[int] = None
             ) -> Params:
    """SwiGLU of hidden width ``d_ff`` (default ``cfg.d_ff``): the dense
    layers before the first MoE layer (``moe.dense_d_ff``) and the shared
    experts (``n_shared × d_expert``) take their own."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = torch_dtype(cfg.param_dtype)
    return {"wg": normal(gen, lead + (d, f), 0.02, dt),
            "wu": normal(gen, lead + (d, f), 0.02, dt),
            "wd": normal(gen, lead + (f, d), 0.02, dt)}


def mlp_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    return G.swiglu(p, x)


# ---------------------------------------------------------------------------
# Mixture of Experts (local dispatch)
# ---------------------------------------------------------------------------

def moe_init(gen: Optional[torch.Generator], cfg: ArchConfig,
             lead: Tuple[int, ...] = ()) -> Params:
    """Router (float32 whatever ``param_dtype`` is), the experts' stacked
    SwiGLU weights and, with ``n_shared``, the shared experts' MLP. As in
    the JAX package, ``wg`` and ``wu`` start equal (its ``moe_init`` draws
    both from one key): one draw, copied."""
    mo = cfg.moe
    d = cfg.d_model
    dt = torch_dtype(cfg.param_dtype)
    wg = normal(gen, lead + (mo.n_experts, d, mo.d_expert), 0.02, dt)
    p = {
        "router": normal(gen, lead + (d, mo.n_experts), 0.006,
                         torch.float32),
        "experts": {
            "wg": wg,
            "wu": wg.clone(),
            "wd": normal(gen, lead + (mo.n_experts, mo.d_expert, d), 0.02,
                         dt),
        },
    }
    if mo.n_shared:
        p["shared"] = mlp_init(gen, cfg, lead, d_ff=mo.n_shared * mo.d_expert)
    return p


def _top_k(probs: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest in descending order,
    the lower index first among equals (a stable sort; ``torch.topk``
    promises no order of ties)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _route(router_w: torch.Tensor, x_flat: torch.Tensor, mo
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (probs [T, k], ids [T, k], aux loss): float32 router logits,
    softmax, top-k renormalised by ``max(Σ, 1e-9)``, and the Switch
    load-balance loss ``E · Σ_e mean_prob_e · share_of_replicas_e``."""
    logits = x_flat.float() @ router_w
    probs_all = torch.softmax(logits, dim=-1)
    probs, ids = _top_k(probs_all, mo.top_k)
    probs = probs / torch.clamp_min(probs.sum(-1, keepdim=True), 1e-9)
    me = probs_all.mean(dim=0)
    # replicas an expert, as integer counts (no float atomic, no host sync)
    ce = F.one_hot(ids.reshape(-1), mo.n_experts).sum(0).float() \
        / ids.numel()
    aux = mo.n_experts * torch.sum(me * ce)
    return probs, ids, aux


def moe_slots(ids: torch.Tensor, mo, n_tokens: int
              ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The capacity dispatch of ``ids`` [T, k] → (keep [T·k], slot [T·k],
    cap): ``cap = ceil(T·k / E · capacity_factor)``; a replica's position
    in its expert is the count of earlier replicas routed there in
    token-major order (a cumulative count), those at ``cap`` or past it are
    dropped, and a kept one's slot is ``expert · cap + position`` (a
    dropped one's ``E · cap``, one past the buffer)."""
    cap = int(math.ceil(n_tokens * mo.top_k / mo.n_experts
                        * mo.capacity_factor))
    flat_ids = ids.reshape(-1)
    onehot = F.one_hot(flat_ids, mo.n_experts)
    pos = torch.cumsum(onehot, dim=0) - 1
    pos = pos.gather(1, flat_ids[:, None])[:, 0]
    keep = pos < cap
    slot = torch.where(keep, flat_ids * cap + pos,
                       torch.full_like(pos, mo.n_experts * cap))
    return keep, slot, cap


def moe_apply_local(p: Params, cfg: ArchConfig, x_flat: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The capacity-dropping MoE on one device: x_flat [T, D] → ([T, D],
    aux loss), the JAX package's ``moe_apply_local`` step for step.

    Each token's k replicas go to their experts' buffers [E, cap, D] by
    :func:`moe_slots` (kept slots are unique, so the dispatch is a copy,
    the same bits every run; the dropped ones land in a row past the
    buffer that is thrown away), the experts run as batched products
    ``silu(buf @ wg) · (buf @ wu) @ wd``, each kept replica's output comes
    back from its slot (a dropped one's is 0), weighted by its probability
    cast to x's dtype and summed over the k replicas; the shared experts'
    MLP is added."""
    mo = cfg.moe
    if G.is_trace(x_flat):
        # the JAX package's steps (the card sorts and copies instead)
        return G.moe_apply_local(p, mo, x_flat)
    t, d = x_flat.shape
    probs, ids, aux = _route(p["router"], x_flat, mo)
    keep, slot, cap = moe_slots(ids, mo, t)
    rows = mo.n_experts * cap
    x_rep = x_flat.repeat_interleave(mo.top_k, dim=0)
    buf = x_flat.new_zeros((rows + 1, d)).index_copy_(0, slot, x_rep)
    buf = buf[:-1].reshape(mo.n_experts, cap, d)
    e = p["experts"]
    hid = G.silu(torch.bmm(buf, e["wg"])) * torch.bmm(buf, e["wu"])
    y_buf = torch.bmm(hid, e["wd"])
    y_rep = y_buf.reshape(rows, d)[torch.clamp_max(slot, rows - 1)]
    y_rep = y_rep * keep[:, None].to(y_rep.dtype)
    w = probs.reshape(-1)[:, None].to(x_flat.dtype)
    y = (y_rep.to(x_flat.dtype) * w).reshape(t, mo.top_k, d).sum(dim=1)
    if mo.n_shared:
        y = y + mlp_apply(p["shared"], x_flat)
    return y.to(x_flat.dtype), aux


# ---------------------------------------------------------------------------
# Mamba2 block (SSD)
# ---------------------------------------------------------------------------

def mamba2_init(gen: torch.Generator, cfg: ArchConfig,
                lead: Tuple[int, ...] = ()) -> Params:
    """The JAX tree's separate projections (z / x / B / C / dt) and
    per-stream convolutions; ``dt_bias``, ``A_log`` and ``D`` in float32."""
    s = cfg.ssm
    d = cfg.d_model
    di, nh = s.d_inner(d), s.n_heads(d)
    gn = s.n_groups * s.d_state
    dt = torch_dtype(cfg.param_dtype)
    f32 = torch.float32
    return {
        "wz": normal(gen, lead + (d, di), 0.02, dt),
        "wx": normal(gen, lead + (d, di), 0.02, dt),
        "wb": normal(gen, lead + (d, gn), 0.02, dt),
        "wc": normal(gen, lead + (d, gn), 0.02, dt),
        "wdt": normal(gen, lead + (d, nh), 0.02, dt),
        "conv_x": normal(gen, lead + (s.d_conv, di), 0.02, dt),
        "conv_xb": _full(gen, lead + (di,), 0.0, dt),
        "conv_bw": normal(gen, lead + (s.d_conv, gn), 0.02, dt),
        "conv_bb": _full(gen, lead + (gn,), 0.0, dt),
        "conv_cw": normal(gen, lead + (s.d_conv, gn), 0.02, dt),
        "conv_cb": _full(gen, lead + (gn,), 0.0, dt),
        "dt_bias": _full(gen, lead + (nh,), 0.0, f32),
        "A_log": normal(gen, lead + (nh,), 0.1, f32),
        "D": _full(gen, lead + (nh,), 1.0, f32),
        "norm": nn.rmsnorm_init(di, dt, gen_device(gen), lead),
        "out_proj": normal(gen, lead + (di, d), 0.02, dt),
    }


def _causal_dwconv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Depthwise causal conv1d: x [B, S, C], w [K, C] → ([B, S, C], the last
    K − 1 inputs). ``state`` carries the K − 1 inputs before x."""
    k, s = w.shape[0], x.shape[1]
    if state is None:
        padded = G.pad(x, 1, k - 1)
    else:
        padded = torch.cat([state.to(x.dtype), x], dim=1)
    new_state = padded[:, -(k - 1):] if k > 1 else None
    y = None
    for i in range(k):
        t = padded[:, i:i + s] * w[i]
        y = t if y is None else y + t
    return y + b, new_state


def mamba2_apply(p: Params, cfg: ArchConfig, x: torch.Tensor, *,
                 cache=None):
    """Mamba2 block → (output, cache). ``cache`` = ((conv_x, conv_b,
    conv_c) [B, d_conv − 1, ·], ssd state [B, H, N, P] float32) for decode,
    None for a full-sequence forward. No cache: the SSD scan from a zero
    state; one token with a cache: the plain decode step; several tokens
    with a cache: the scan from the cached state."""
    s = cfg.ssm
    b, sl, d = x.shape
    di, nh = s.d_inner(d), s.n_heads(d)
    g, n = s.n_groups, s.d_state

    z = x @ p["wz"]
    xs = x @ p["wx"]
    bs = x @ p["wb"]
    cs = x @ p["wc"]
    dt_raw = x @ p["wdt"]

    st_x = st_b = st_c = None
    if cache is not None:
        st_x, st_b, st_c = cache[0]
    xs, ns_x = _causal_dwconv(xs, p["conv_x"], p["conv_xb"], st_x)
    bs, ns_b = _causal_dwconv(bs, p["conv_bw"], p["conv_bb"], st_b)
    cs, ns_c = _causal_dwconv(cs, p["conv_cw"], p["conv_cb"], st_c)
    xs, bs, cs = G.silu(xs), G.silu(bs), G.silu(cs)

    x_ssd = xs.reshape(b, sl, nh, s.head_dim)
    bmat = bs.reshape(b, sl, g, n)
    cmat = cs.reshape(b, sl, g, n)
    if G.is_trace(x) and cache is None:
        # the JAX package's steps (the card launches B9)
        y, last_state = G.mamba2_scan(p, x_ssd, dt_raw, bmat, cmat, s.chunk)
    else:
        dt = F.softplus(dt_raw.float() + p["dt_bias"])
        a = -torch.exp(p["A_log"])
        if cache is None:
            # under grad the differentiable call (ops.ssd_scan_train: the
            # scan, then its backward kernel), else the inference call
            scan = ops.ssd_scan_train if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x_ssd, dt, a, bmat, cmat)) \
                else ops.ssd_scan
            y, last_state = scan(x_ssd, dt, a, bmat, cmat, chunk=s.chunk)
        elif sl == 1:
            hpg = nh // g
            bh = bmat[:, 0].repeat_interleave(hpg, dim=1)
            ch = cmat[:, 0].repeat_interleave(hpg, dim=1)
            y_t, last_state = ssd_decode_ref(cache[1], x_ssd[:, 0].float(),
                                             dt[:, 0], a, bh.float(),
                                             ch.float())
            y = y_t[:, None]
        else:
            y, last_state = ops.ssd_scan(x_ssd, dt, a, bmat, cmat,
                                         chunk=s.chunk, s0=cache[1])

    y = y + x_ssd.float() * p["D"].view(1, 1, nh, 1)
    y = y.reshape(b, sl, di).to(x.dtype)
    y = y * G.silu(z)
    y = G.rmsnorm(p["norm"], y)
    out = y @ p["out_proj"]
    new_cache = ((ns_x, ns_b, ns_c), last_state) if s.d_conv > 1 else None
    return out, new_cache

