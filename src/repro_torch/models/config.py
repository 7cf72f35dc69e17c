"""Unified architecture configuration for all assigned model families.

One ``ArchConfig`` describes dense / MoE / SSM / hybrid / encoder-only /
VLM transformers; the block pattern decides how ``repro_torch.models.lm``
assembles layers. Exact per-arch instantiations live in
``repro_torch/configs/<id>.py``. A copy of ``repro.models.config``, which
the port may not import; the two must stay equal field for field
(``tests/test_torch_lm.py`` holds ``param_count`` of every config).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden dim
    n_shared: int = 0             # always-on shared experts (deepseek-v2)
    capacity_factor: float = 1.25
    #: "ep" shards experts over the model axis; "tp" shards d_expert.
    sharding: str = "ep"
    #: index of first MoE layer (earlier layers use a dense FFN)
    first_moe_layer: int = 0
    #: dense-FFN hidden dim for pre-MoE layers (deepseek layer 0)
    dense_d_ff: int = 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128            # N
    head_dim: int = 64            # P
    expand: int = 2               # d_inner = expand * d_model
    n_groups: int = 1             # B/C groups
    d_conv: int = 4               # causal depthwise conv width
    chunk: int = 128              # SSD chunk length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (deepseek-v2)."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                  # 0 → d_model // n_heads

    # --- block pattern -----------------------------------------------------
    #: "attn" | "mamba2" | "hybrid" (mamba + shared attn every k layers)
    block: str = "attn"
    #: hybrid: one shared (weight-tied) attention block every k mamba layers
    hybrid_attn_every: int = 6
    #: decoder (causal) vs encoder-only (bidirectional, no decode path)
    causal: bool = True

    # --- attention flavour ---------------------------------------------------
    #: sliding-window size; 0 = full attention
    window: int = 0
    #: fraction of head_dim that gets RoPE (chatglm-style 2D/partial rope)
    rope_fraction: float = 1.0
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    #: cross-attention interval for VLM (0 = none); every k-th layer is a
    #: cross-attn layer attending to the vision-embedding memory
    cross_attn_every: int = 0
    #: MLA config (deepseek) — replaces GQA when set
    mla: Optional[MLAConfig] = None

    # --- mixture of experts ---------------------------------------------------
    moe: Optional[MoEConfig] = None

    # --- state-space ---------------------------------------------------------
    ssm: Optional[SSMConfig] = None

    # --- frontend -------------------------------------------------------------
    #: "tokens" | "audio_frames" (precomputed [B,S,d] frame embeddings)
    #: | "tokens+vision" (tokens + [B, n_img_tokens, vision_dim] memory)
    frontend: str = "tokens"
    vision_tokens: int = 1600
    vision_dim: int = 4096

    # --- numerics / training -----------------------------------------------
    param_dtype: str = "bfloat16"
    #: storage dtype for attention KV caches (None → param_dtype;
    #: "float8_e4m3fn" halves decode-cache HBM — the difference between
    #: grok-1's decode_32k×128 fitting one v5e pod or not, §Perf C1)
    kv_cache_dtype: Optional[str] = None

    @property
    def resolved_kv_cache_dtype(self) -> str:
        return self.kv_cache_dtype or self.param_dtype
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def subquadratic(self) -> bool:
        """Can this arch run the 500k-token long-context shape?"""
        return self.block in ("mamba2", "hybrid") or self.window > 0

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D MODEL_FLOPS checks)."""
        d, v = self.d_model, self.vocab
        total = v * d                       # embedding
        if not self.tie_embeddings and self.frontend != "audio_frames":
            total += v * d                  # lm head
        hd = self.resolved_head_dim
        for layer in range(self.n_layers):
            if self.block == "mamba2" or (
                    self.block == "hybrid"):
                s = self.ssm or SSMConfig()
                di = s.d_inner(d)
                nh = s.n_heads(d)
                g = s.n_groups
                # in_proj: x(di) + z(di) + B,C (g*N each) + dt (nh)
                total += d * (2 * di + 2 * g * s.d_state + nh)
                total += s.d_conv * (di + 2 * g * s.d_state)  # conv
                total += nh * 2 + di                          # A, D, norm
                total += di * d                               # out_proj
            if self.block == "attn" or (
                    self.block == "hybrid" and
                    (layer + 1) % self.hybrid_attn_every == 0):
                if self.mla is not None:
                    m = self.mla
                    qk = m.qk_nope_dim + m.qk_rope_dim
                    total += d * m.q_lora_rank
                    total += m.q_lora_rank * self.n_heads * qk
                    total += d * (m.kv_lora_rank + m.qk_rope_dim)
                    total += m.kv_lora_rank * self.n_heads * (
                        m.qk_nope_dim + m.v_head_dim)
                    total += self.n_heads * m.v_head_dim * d
                else:
                    total += d * self.n_heads * hd            # q
                    total += 2 * d * self.n_kv_heads * hd     # k, v
                    total += self.n_heads * hd * d            # o
            if self.block == "attn":
                if self.moe is not None and layer >= self.moe.first_moe_layer:
                    mo = self.moe
                    total += d * mo.n_experts                 # router
                    total += mo.n_experts * 3 * d * mo.d_expert
                    total += mo.n_shared * 3 * d * mo.d_expert
                elif self.moe is not None:
                    total += 3 * d * self.moe.dense_d_ff
                else:
                    total += 3 * d * self.d_ff                # swiglu
            elif self.block == "hybrid" and (
                    layer + 1) % self.hybrid_attn_every == 0:
                total += 3 * d * self.d_ff
            if self.cross_attn_every and (
                    layer + 1) % self.cross_attn_every == 0:
                total += d * self.n_heads * hd
                total += 2 * self.vision_dim * self.n_kv_heads * hd
                total += self.n_heads * hd * d
        return total
