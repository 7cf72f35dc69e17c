"""Model assembly of the LM stack: embeddings, layer stacks, head, decode
caches, and the training loss.

The port of ``repro/models/lm.py`` for three block patterns:

* ``block="attn"`` — dense decoders (qwen2.5, h2o-danube with its sliding
  window, chatglm3 with partial RoPE, yi), mixture-of-experts decoders
  (deepseek-v2: MLA, shared experts and a dense layer 0 in a ``pre``
  stack; grok-1: GQA, 8 experts top-2), the MoE layers on one device
  (the reference's local dispatch, flattened to ``[B·S, D]``), the
  vision-language decoder llama-3.2-vision (``groups`` of
  ``cross_attn_every - 1`` self layers and one cross-attention layer
  over the ``vision_embeds`` memory) and the encoder hubert (the
  ``audio_frames`` frontend: ``features @ frontend_proj``, no
  embedding table, bidirectional attention);
* ``block="mamba2"`` — pure Mamba2 / SSD (mamba2-370m);
* ``block="hybrid"`` — zamba2: groups of Mamba2 layers, each followed by
  ONE weight-tied attention + MLP block.

The parameter tree has the JAX tree's keys and its stacked leading axes
(``blocks`` [L, ...], ``groups`` [G, per, ...]), so a tree crosses between
the packages as a plain map over leaves (:func:`params_from_numpy`,
:func:`params_to_numpy`); the JAX package's ``lax.scan`` over a stack is
a Python loop over its index here. Every function runs on one device, as
the JAX package does with no mesh.

Training: :func:`loss_fn` is the reference's mean token cross-entropy;
its gradient runs the flash kernel's backward (``ops.flash_attention_train``)
and, with ``remat=True``, recomputes each layer in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``). A stack
is read with ``unbind`` (:func:`_unstack`) on that path too, so its
backward stacks the layers' gradients once. Mamba2 and hybrid configs
train through the SSD scan's backward kernel (``ops.ssd_scan_train``).
:func:`forward` sums each layer's MoE load-balance loss as the reference
does, and :func:`loss_fn` adds ``aux_weight`` times it. Every config
trains: MoE and MLA decoders, the cross-attention groups (the memory
``vision_embeds`` is an input: its gradient is not taken) and the audio
encoder, whose batch is ``features`` [B, S, d_model] with ``labels``
[B, S], as the reference's ``input_specs`` give an encoder's train
cell.

:func:`decode_step` updates the cache that :func:`init_cache` made IN
PLACE (the JAX package's update is functional) and returns it. A cross
layer reads the ``cross_k`` / ``cross_v`` that :func:`prefill` seeded
from the vision memory.

:func:`param_specs` gives the tree's ``(shape, dtype)`` pairs without
allocating. On meta tensors (a trace by ``repro_torch.core.tracer``, as
the dataset factory's LM entries take it) :func:`forward` runs the
graph forms of :mod:`repro_torch.models.graph_form`, so that the traced
graph is the reference's.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import nn
from ..core.gnn import resolve_device
from . import graph_form as G
from . import layers as L
from .config import ArchConfig

Params = Dict[str, Any]
Device = Union[None, str, torch.device]
#: leaves the JAX tree keeps in float32 whatever ``param_dtype`` is
_F32_LEAVES = frozenset({"dt_bias", "A_log", "D", "router"})


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` for a block pattern that no config of the JAX
    package has. Every config the port runs also traces to the
    reference's graph (each layer has its graph form)."""
    if cfg.block not in ("attn", "mamba2", "hybrid"):
        raise ValueError(f"unknown block {cfg.block!r}")


# ---------------------------------------------------------------------------
# per-layer init / apply
# ---------------------------------------------------------------------------

def _ffn_init(gen: Optional[torch.Generator], cfg: ArchConfig,
              layer_kind: str, lead: Tuple[int, ...]) -> Params:
    if layer_kind == "moe":
        return L.moe_init(gen, cfg, lead)
    if layer_kind == "dense_pre_moe":
        return L.mlp_init(gen, cfg, lead, d_ff=cfg.moe.dense_d_ff)
    return L.mlp_init(gen, cfg, lead)


def _ffn_apply(p: Params, cfg: ArchConfig, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] → (y, aux loss): an MoE layer over the flattened
    ``[B·S, D]`` tokens (its capacity counts them all), else the MLP and
    a zero aux loss."""
    if "experts" in p:
        b, s, d = x.shape
        y, aux = L.moe_apply_local(p, cfg, x.reshape(b * s, d))
        return y.reshape(b, s, d), aux
    return L.mlp_apply(p, x), torch.zeros((), dtype=torch.float32,
                                          device=x.device)


def decoder_layer_init(gen: Optional[torch.Generator], cfg: ArchConfig,
                       lead: Tuple[int, ...] = (),
                       layer_kind: str = "dense", cross: bool = False
                       ) -> Params:
    """``layer_kind``: "dense", "dense_pre_moe" (``moe.dense_d_ff``) or
    "moe"; the attention is MLA when the config has it, but a ``cross``
    layer's is GQA attention over the vision memory."""
    dt = L.torch_dtype(cfg.param_dtype)
    dev = L.gen_device(gen)
    attn = (L.mla_init(gen, cfg, lead) if cfg.mla is not None and not cross
            else L.attention_init(gen, cfg, lead, cross=cross))
    return {"ln1": nn.rmsnorm_init(cfg.d_model, dt, dev, lead),
            "ln2": nn.rmsnorm_init(cfg.d_model, dt, dev, lead),
            "ffn": _ffn_init(gen, cfg, layer_kind, lead),
            "attn": attn}


def decoder_layer_apply(p: Params, cfg: ArchConfig, x: torch.Tensor, *,
                        positions: torch.Tensor, cache=None,
                        cache_index: Optional[int] = None,
                        memory: Optional[torch.Tensor] = None):
    """→ (x, attention cache, aux loss); with ``memory`` a cross layer."""
    h = G.rmsnorm(p["ln1"], x)
    if cfg.mla is not None and memory is None:
        a, new_cache = L.mla_apply(p["attn"], cfg, h, positions=positions,
                                   cache=cache, cache_index=cache_index)
    else:
        a, new_cache = L.attention_apply(p["attn"], cfg, h,
                                         positions=positions, cache=cache,
                                         cache_index=cache_index,
                                         memory=memory)
    x = x + a
    f, aux = _ffn_apply(p["ffn"], cfg, G.rmsnorm(p["ln2"], x))
    return x + f, new_cache, aux


def mamba_layer_init(gen: Optional[torch.Generator], cfg: ArchConfig,
                     lead: Tuple[int, ...] = ()) -> Params:
    return {"ln": nn.rmsnorm_init(cfg.d_model, L.torch_dtype(cfg.param_dtype),
                                  L.gen_device(gen), lead),
            "mix": L.mamba2_init(gen, cfg, lead)}


def mamba_layer_apply(p: Params, cfg: ArchConfig, x: torch.Tensor, *,
                      cache=None):
    """→ (x, ((conv states), ssd state))."""
    y, new_cache = L.mamba2_apply(p["mix"], cfg, G.rmsnorm(p["ln"], x),
                                  cache=cache)
    return x + y, new_cache


def _at(tree, *idx):
    """Layer ``idx`` of a stacked tree: every leaf indexed (views)."""
    if isinstance(tree, dict):
        return {k: _at(v, *idx) for k, v in tree.items()}
    return tree[idx]


def _unstack(tree) -> List[Params]:
    """The layers of a stacked tree as ``lax.scan`` hands them to its
    body: every leaf unbound along its leading axis (views)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(tree.unbind(0))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, *, seed: int, device: Device = None
                ) -> Params:
    """A random parameter tree with the JAX tree's keys, shapes and dtypes,
    drawn on ``device`` (the card unless the caller asks for the CPU) from
    a ``torch.Generator`` seeded with ``seed``: at full width the host
    never holds the weights. Not the JAX package's numbers — carry a JAX
    tree across with :func:`params_from_numpy` to compare the two."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return _init_tree(cfg, gen)


def param_specs(cfg: ArchConfig) -> Params:
    """The parameter tree as ``(shape, dtype)`` pairs, nothing allocated:
    ``repro.models.lm.param_specs`` (the same keys, stacked leading axes
    and dtypes, the MoE router in float32), the spec
    ``core.tracer.trace_graph`` takes."""
    check_supported(cfg)

    def spec(tree):
        if isinstance(tree, dict):
            return {k: spec(v) for k, v in tree.items()}
        return tuple(tree.shape), tree.dtype

    return spec(_init_tree(cfg, None))


def _init_tree(cfg: ArchConfig, gen: Optional[torch.Generator]) -> Params:
    """The tree drawn from ``gen``, or on the meta device for None."""
    dev = L.gen_device(gen)
    dt = L.torch_dtype(cfg.param_dtype)
    d = cfg.d_model
    p: Params = {}
    if cfg.frontend == "audio_frames":
        p["frontend_proj"] = L.normal(gen, (d, d), 0.02, dt)
    else:
        p["embed"] = L.normal(gen, (cfg.vocab, d), 0.02, dt)
    if cfg.block == "attn" and cfg.cross_attn_every:
        per = cfg.cross_attn_every
        ng = cfg.n_layers // per
        p["groups"] = {"self": decoder_layer_init(gen, cfg, (ng, per - 1)),
                       "cross": decoder_layer_init(gen, cfg, (ng,),
                                                   cross=True)}
    elif cfg.block == "attn":
        n_pre = cfg.moe.first_moe_layer if cfg.moe is not None else 0
        if n_pre:
            p["pre"] = decoder_layer_init(gen, cfg, (n_pre,),
                                          "dense_pre_moe")
        p["blocks"] = decoder_layer_init(
            gen, cfg, (cfg.n_layers - n_pre,),
            "moe" if cfg.moe is not None else "dense")
    elif cfg.block == "mamba2":
        p["blocks"] = mamba_layer_init(gen, cfg, (cfg.n_layers,))
    else:
        per = cfg.hybrid_attn_every
        p["groups"] = mamba_layer_init(gen, cfg, (cfg.n_layers // per, per))
        p["shared_attn"] = decoder_layer_init(gen, cfg)
    p["final_norm"] = nn.rmsnorm_init(cfg.d_model, dt, dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = L.normal(gen, (cfg.d_model, cfg.vocab), 0.02, dt)
    return p


def params_from_numpy(tree: Params, cfg: ArchConfig,
                      device: Device = None) -> Params:
    """A JAX parameter tree (numpy leaves; a bfloat16 leaf arrives as
    float32) as the port's tree on ``device``: every float leaf cast to
    ``cfg.param_dtype``, but those the JAX tree keeps in float32 (the SSD
    leaves, the MoE router)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = L.torch_dtype(cfg.param_dtype)

    def conv(key, v):
        if isinstance(v, dict):
            return {k: conv(k, x) for k, x in v.items()}
        t = torch.tensor(np.asarray(v), device=dev)
        if t.is_floating_point():
            t = t.to(torch.float32 if key in _F32_LEAVES else dt)
        return t.contiguous()

    return conv(None, tree)


def params_to_numpy(params: Params) -> Params:
    """The tree as numpy, float leaves in float32 (numpy has no bfloat16)."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    t = params.detach()
    return (t.float() if t.is_floating_point() else t).cpu().numpy()


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _embed(p: Params, cfg: ArchConfig, inputs: Dict[str, torch.Tensor]
           ) -> torch.Tensor:
    """The token embeddings, or ``features @ frontend_proj`` (audio)."""
    if cfg.frontend == "audio_frames":
        x = inputs["features"].to(L.torch_dtype(cfg.param_dtype))
        return x @ p["frontend_proj"]
    return G.take_rows(p["embed"], inputs["tokens"])


def _head(p: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = G.rmsnorm(p["final_norm"], x)
    w = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    return (x @ w).float()


def forward(params: Params, cfg: ArchConfig,
            inputs: Dict[str, torch.Tensor], *, remat: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward → (logits [B, S, V] float32, aux loss), in
    the JAX package's steps: int32 positions, each stack read as
    ``lax.scan`` reads it (:func:`_unstack`), the MoE layers' load-balance
    losses summed a stack at a time (0 without MoE), and on a trace
    ``jnp.take`` of the tokens and the aux loss of every attention stack,
    which the jaxpr keeps though it is zero, and an MoE stack's as the
    scan's ys (:func:`graph_form.stack_aux`). A cross-attention config
    runs its ``groups``: each group's self layers, then its cross layer
    over ``inputs["vision_embeds"]`` (cast to the activations' dtype);
    a group's aux loss is its self layers' sum plus the cross layer's.
    ``remat`` recomputes each layer in the backward instead of keeping
    its activations (the reference's ``ParallelCtx(remat=True)``); it
    changes no value."""
    check_supported(cfg)
    x = _embed(params, cfg, inputs)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def layer(apply, lp, x, with_aux=False, **kw):
        """The layer's x, and with ``with_aux`` (a decoder layer's
        (x, cache, aux)) its aux loss."""
        def run(h):
            out = apply(lp, cfg, h, **kw)
            return (out[0], out[2]) if with_aux else out[0]
        return run(x) if not remat else checkpoint(run, x,
                                                   use_reentrant=False)

    if cfg.block == "attn" and cfg.cross_attn_every:
        memory = inputs["vision_embeds"].to(x.dtype)
        group_auxs = []
        for gp in _unstack(params["groups"]):
            auxs = []
            for lp in _unstack(gp["self"]):
                x, a = layer(decoder_layer_apply, lp, x, with_aux=True,
                             positions=positions)
                auxs.append(a)
            x, a = layer(decoder_layer_apply, gp["cross"], x, with_aux=True,
                         positions=positions, memory=memory)
            group_auxs.append(G.group_aux(auxs, a))
        aux = G.stack_aux(aux, group_auxs)
    elif cfg.block == "attn":
        for stack in ("pre", "blocks"):
            if stack not in params:
                continue
            auxs = []
            for lp in _unstack(params[stack]):
                x, a = layer(decoder_layer_apply, lp, x, with_aux=True,
                             positions=positions)
                auxs.append(a)
            aux = G.stack_aux(aux, auxs) if cfg.moe is not None \
                else G.scan_aux(aux, len(auxs))
    elif cfg.block == "mamba2":
        for lp in _unstack(params["blocks"]):
            x = layer(mamba_layer_apply, lp, x)
    else:
        groups = _unstack(params["groups"])
        for gp in groups:
            for lp in _unstack(gp):
                x = layer(mamba_layer_apply, lp, x)
            x = layer(decoder_layer_apply, params["shared_attn"], x,
                      positions=positions)
        aux = G.scan_aux(aux, len(groups))
    return _head(params, cfg, x), aux


def loss_fn(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            aux_weight: float = 0.01, *, remat: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean token cross-entropy (+ ``aux_weight`` × the aux loss) →
    ``(total, {"ce", "aux"})``, the reference's ``loss_fn``: float32
    logits, ``logsumexp`` minus the gold logit of ``batch["labels"]``, and
    with ``batch["loss_mask"]`` the masked sum over ``max(Σ mask, 1)``."""
    logits, aux = forward(params, cfg, batch, remat=remat)
    logits = logits.float()
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = logz - gold
    mask = batch.get("loss_mask")
    if mask is None:
        loss = nll.mean()
    else:
        mask = mask.to(nll.dtype)
        loss = (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    total = loss + aux_weight * aux
    return total, {"ce": loss, "aux": aux}


# ---------------------------------------------------------------------------
# decode caches + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device: Device = None) -> Params:
    """Zeroed decode caches with the JAX package's keys, shapes and dtypes
    (attention K/V in ``resolved_kv_cache_dtype``, MLA's compressed pair
    ``c`` [n, B, Smax, rank] and ``r`` [n, B, Smax, 1, rope] in the same,
    a cross-attention config's self K/V [G, per - 1, B, Smax, Hkv, hd]
    and cross K/V [G, B, vision_tokens, Hkv, hd], conv states in
    ``param_dtype``, SSD states in float32); a sliding-window config
    keeps a ring of ``min(max_len, window)`` positions."""
    check_supported(cfg)
    dev = resolve_device(device)
    kv_dt = L.torch_dtype(cfg.resolved_kv_cache_dtype)
    pdt = L.torch_dtype(cfg.param_dtype)
    hd = cfg.resolved_head_dim

    def mk(shape, dtype=kv_dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if cfg.block == "attn":
        n = cfg.n_layers
        if cfg.window > 0:
            max_len = min(max_len, cfg.window)
        if cfg.mla is not None:
            m = cfg.mla
            return {"c": mk((n, batch, max_len, m.kv_lora_rank)),
                    "r": mk((n, batch, max_len, 1, m.qk_rope_dim))}
        if cfg.cross_attn_every:
            per = cfg.cross_attn_every
            ng = n // per
            cross = (ng, batch, cfg.vision_tokens, cfg.n_kv_heads, hd)
            return {"k": mk((ng, per - 1, batch, max_len, cfg.n_kv_heads, hd)),
                    "v": mk((ng, per - 1, batch, max_len, cfg.n_kv_heads, hd)),
                    "cross_k": mk(cross), "cross_v": mk(cross)}
        return {"k": mk((n, batch, max_len, cfg.n_kv_heads, hd)),
                "v": mk((n, batch, max_len, cfg.n_kv_heads, hd))}
    s = cfg.ssm
    di, gn = s.d_inner(cfg.d_model), s.n_groups * s.d_state
    nh = s.n_heads(cfg.d_model)
    lead: Tuple[int, ...] = (cfg.n_layers,) if cfg.block == "mamba2" else (
        cfg.n_layers // cfg.hybrid_attn_every, cfg.hybrid_attn_every)
    cache = {
        "conv_x": mk(lead + (batch, s.d_conv - 1, di), pdt),
        "conv_b": mk(lead + (batch, s.d_conv - 1, gn), pdt),
        "conv_c": mk(lead + (batch, s.d_conv - 1, gn), pdt),
        "ssd": mk(lead + (batch, nh, s.d_state, s.head_dim), torch.float32),
    }
    if cfg.block == "hybrid":
        cache["k"] = mk((lead[0], batch, max_len, cfg.n_kv_heads, hd))
        cache["v"] = mk((lead[0], batch, max_len, cfg.n_kv_heads, hd))
    return cache


def _store(slot: torch.Tensor, value: torch.Tensor) -> None:
    if value.data_ptr() != slot.data_ptr():
        slot.copy_(value)


def _mamba_cached(p: Params, cfg: ArchConfig, x: torch.Tensor,
                  cache: Params, idx: tuple) -> torch.Tensor:
    conv = tuple(cache[k][idx] for k in ("conv_x", "conv_b", "conv_c"))
    x, ((nx, nb, nc), sd) = mamba_layer_apply(p, cfg, x,
                                              cache=(conv, cache["ssd"][idx]))
    for slot, new in zip(conv, (nx, nb, nc)):
        _store(slot, new)
    _store(cache["ssd"][idx], sd)
    return x


def _attn_cached(p: Params, cfg: ArchConfig, x: torch.Tensor, cache: Params,
                 idx, positions: torch.Tensor, cache_index: int
                 ) -> torch.Tensor:
    """Decoder layer ``idx`` (an int, or a (group, layer) tuple) over its
    cache: K/V, or MLA's (c, r)."""
    slots = tuple(cache[k][idx] for k in (("c", "r") if cfg.mla is not None
                                          else ("k", "v")))
    x, new, _ = decoder_layer_apply(p, cfg, x, positions=positions,
                                    cache=slots, cache_index=cache_index)
    for slot, value in zip(slots, new):
        _store(slot, value)
    return x


def _cross_cached(p: Params, cfg: ArchConfig, x: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A cross layer over the K / V that :func:`prefill` seeded from the
    vision memory: q only, attention over every memory row (not causal),
    ``wo``, then the FFN."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (G.rmsnorm(p["ln1"], x) @ p["attn"]["wq"]).reshape(
        b, s, cfg.n_heads, hd)
    out = L.blockwise_attention(q, k, v, causal=False)
    x = x + out.reshape(b, s, cfg.n_heads * hd) @ p["attn"]["wo"]
    f, _ = _ffn_apply(p["ffn"], cfg, G.rmsnorm(p["ln2"], x))
    return x + f


def decode_step(params: Params, cfg: ArchConfig, cache: Params,
                inputs: Dict[str, torch.Tensor], cache_index: int,
                logits_mode: str = "all") -> Tuple[torch.Tensor, Params]:
    """New token(s) at positions ``cache_index, ...`` → (logits [B, S, V]
    float32, cache). The cache is updated IN PLACE and returned.
    ``logits_mode="last"`` applies the head to the last position only."""
    check_supported(cfg)
    ci = int(cache_index)
    x = _embed(params, cfg, inputs)
    b, s, _ = x.shape
    positions = ci + torch.arange(s, device=x.device).expand(b, s)
    if cfg.block == "attn" and cfg.cross_attn_every:
        ng, n_self = cache["k"].shape[:2]
        for g in range(ng):
            gp = _at(params["groups"], g)
            for i in range(n_self):
                x = _attn_cached(_at(gp["self"], i), cfg, x, cache, (g, i),
                                 positions, ci)
            x = _cross_cached(gp["cross"], cfg, x, cache["cross_k"][g],
                              cache["cross_v"][g])
    elif cfg.block == "attn":
        # the pre-MoE layers take the cache's first entries, then the blocks
        layers = [lp for stack in ("pre", "blocks") if stack in params
                  for lp in _unstack(params[stack])]
        for i, lp in enumerate(layers):
            x = _attn_cached(lp, cfg, x, cache, i, positions, ci)
    elif cfg.block == "mamba2":
        for i in range(cfg.n_layers):
            x = _mamba_cached(_at(params["blocks"], i), cfg, x, cache, (i,))
    else:
        ng, per = cache["ssd"].shape[:2]
        for g in range(ng):
            for i in range(per):
                x = _mamba_cached(_at(params["groups"], g, i), cfg, x, cache,
                                  (g, i))
            x = _attn_cached(params["shared_attn"], cfg, x, cache, g,
                             positions, ci)
    if logits_mode == "last":
        x = x[:, -1:]
    return _head(params, cfg, x), cache


def prefill(params: Params, cfg: ArchConfig, inputs: Dict[str, torch.Tensor],
            max_len: int) -> Tuple[torch.Tensor, Params]:
    """A prompt (``tokens``, or audio ``features``) through
    :func:`decode_step` from a fresh cache of ``max_len`` positions →
    (logits of the last position [B, 1, V], cache). A cross-attention
    config first seeds every group's ``cross_k`` / ``cross_v`` from
    ``inputs["vision_embeds"]`` (cast to ``param_dtype``) through the
    cross layer's ``wk`` / ``wv``."""
    b = (inputs["tokens"] if "tokens" in inputs
         else inputs["features"]).shape[0]
    cache = init_cache(cfg, b, max_len,
                       device=params["final_norm"]["scale"].device)
    if cfg.block == "attn" and cfg.cross_attn_every:
        mem = inputs["vision_embeds"].to(L.torch_dtype(cfg.param_dtype))
        shape = (b, cfg.vision_tokens, cfg.n_kv_heads, cfg.resolved_head_dim)
        attn = params["groups"]["cross"]["attn"]
        for g in range(cache["cross_k"].shape[0]):
            cache["cross_k"][g] = (mem @ attn["wk"][g]).reshape(shape)
            cache["cross_v"][g] = (mem @ attn["wv"][g]).reshape(shape)
    return decode_step(params, cfg, cache, inputs, 0, logits_mode="last")
