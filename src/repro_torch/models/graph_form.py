"""The graph forms of the LM stack's steps: what a trace records.

``repro_torch.core.tracer`` records one raw node per jaxpr equation of
the JAX package's model, so a trace of ``lm.forward`` is the reference's
graph only if each step runs the jnp step's equations. This module holds
the one decision, :func:`is_trace` (the tensors lie on the meta device,
as make_fx's fake tensors do), and every jnp step the layers take.

Where the jnp step and the serving op compute the same values and launch
the same work on the card, the layers run one form on every device
(RoPE's ``inv_freq`` through :func:`constant`; the stacks read with
``unbind``; int32 positions). Where they do not, the step forks here or
in the layer, and the serving op runs on the card and the CPU:

* attention (:func:`blockwise_attention`, MLA's full-sequence call at
  Dv != D among them) and the full-sequence SSD scan
  (:func:`mamba2_scan`): the card launches kernels B8 and B9;
* the mixture-of-experts block (:func:`moe_apply_local`: the router's
  softmax, ``lax.top_k`` as :func:`prims.top_k`, the aux loss's and the
  dispatch's scatter-adds, ``one_hot``, ``take_along_axis``, the experts
  as ``dot_general``): the card sorts, counts with a one-hot sum and
  copies to unique slots, with int64 ids;
* :func:`silu`, :func:`rmsnorm`, :func:`take_rows`, :func:`pad`,
  :func:`scan_aux`, :func:`stack_aux`, :func:`group_aux` and RoPE's lanes
  (:func:`apply_rope`): the jnp step launches more kernels (x · sigmoid(x)
  against ``F.silu``, a sum and a division against a mean, the index
  wrapped, a dead conversion of the pad value, the zero aux loss of every
  attention stack, gathers against strided views).

The graph forms compute the serving function on any device (the tests
hold them against the JAX package and the kernels' plain versions, and
``chip_smoke.py`` holds B8 and B9 against them, and the MoE block's
graph form against its serving form, on the card); a meta tensor that
reaches a kernel entry still raises. MLA's full-sequence layer needs no
function here: its norms, slices, broadcast and concatenations are one
form on every device, and its attention forks in
:func:`blockwise_attention`. A decode step and a prefill from a cache
have no graph form (nothing traces them).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import nn
from ..core import prims

Params = Dict[str, Any]


def is_trace(x: torch.Tensor) -> bool:
    """Whether ``x`` is being traced into a graph (a meta tensor)."""
    return x.is_meta


# ---------------------------------------------------------------------------
# small jnp steps
# ---------------------------------------------------------------------------

def trace_internals():
    """torch's private context managers that step outside a make_fx trace
    (:func:`constant`). They are not public API: a torch release that
    moves them breaks every LM trace, so the failure names them."""
    try:
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        from torch.fx.experimental.proxy_tensor import \
            disable_proxy_modes_tracing
    except ImportError as e:
        raise ImportError(
            f"tracing an LM needs torch._subclasses.fake_tensor."
            f"unset_fake_temporarily and torch.fx.experimental.proxy_tensor."
            f"disable_proxy_modes_tracing, which torch {torch.__version__} "
            f"does not have: {e}") from e
    return unset_fake_temporarily, disable_proxy_modes_tracing


def constant(make: Callable[[torch.device], torch.Tensor],
             like: torch.Tensor) -> torch.Tensor:
    """A value jnp computes from Python numbers at trace time, which the
    jaxpr holds as a constant (a weight of the graph). On a trace it is
    made outside the trace and moved to the meta device, so that the
    trace records a tensor constant; otherwise ``make(like.device)``."""
    if not is_trace(like):
        return make(like.device)
    unset_fake, no_proxy = trace_internals()
    with unset_fake(), no_proxy():
        return make(torch.device("cpu")).to("meta")


def scalar(value, dtype: torch.dtype, device) -> torch.Tensor:
    """A Python number bound to a jitted jnp function's argument and
    converted there (``convert_element_type``)."""
    return torch.ops.aten._to_copy(
        torch.full((), value, dtype=dtype, device=device), dtype=dtype)


def where(mask: torch.Tensor, x: torch.Tensor, value) -> torch.Tensor:
    """``jnp.where(mask, x, value)`` for a Python number: the number
    converted, mask and number broadcast to x's shape, a select."""
    c = scalar(value, x.dtype, x.device)
    return torch.where(mask.expand(x.shape), x, c.expand(x.shape))


def pad(x: torch.Tensor, dim: int, before: int, after: int = 0
        ) -> torch.Tensor:
    """Zeros before and after ``dim``; on a trace ``jnp.pad``'s steps, the
    pad value converted, then the pad."""
    if is_trace(x):
        scalar(0.0, x.dtype, x.device)
    widths = [0, 0] * (x.dim() - 1 - dim) + [before, after]
    return F.pad(x, widths)


def index(i: int, n: int, device) -> torch.Tensor:
    """A static index as jnp's dynamic indexing wraps it: ``i + n`` where
    ``i < 0`` (an int32 scalar tensor)."""
    lit = torch.full((), i, dtype=torch.int32, device=device)
    return torch.where(lit < 0, lit + n, lit)


def lanes(x: torch.Tensor, start: int, step: int) -> torch.Tensor:
    """``x[..., start::step]``, which jnp writes as a gather of an iota."""
    n = (x.shape[-1] - start + step - 1) // step
    idx = torch.arange(n, dtype=torch.int32, device=x.device) * step + start
    return x.index_select(x.dim() - 1, idx)


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at integer ``idx``; on a trace ``jnp.take(table,
    idx, axis=0)``'s steps, negative indices wrapped, then a gather."""
    if is_trace(table):
        idx = torch.where(idx < 0, idx + table.shape[0], idx)
        return F.embedding(idx, table)
    return F.embedding(idx.long(), table)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = ``jnp.logaddexp(x, 0)`` step for step."""
    zero = torch.ops.aten.alias(torch.zeros((), dtype=x.dtype,
                                            device=x.device))
    amax = torch.maximum(x, zero)
    delta = x - zero
    nan = delta != delta
    both = x + zero
    soft = amax + torch.log1p(torch.exp(-torch.abs(delta)))
    return torch.where(nan, both, soft)


def tril_ones(n: int, device) -> torch.Tensor:
    """``jnp.tril(jnp.ones((n, n), bool))``: ones, ``jnp.tri``'s mask from
    two iotas, zeros, a select."""
    ones = torch.ones((n, n), dtype=torch.bool, device=device)
    rows = prims.iota([n, n], 0, torch.int32, device) + 0
    mask = rows >= prims.iota([n, n], 1, torch.int32, device)
    return torch.where(mask, ones,
                       torch.zeros((n, n), dtype=torch.bool, device=device))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x · sigmoid(x) on a trace, ``F.silu`` otherwise."""
    return x * torch.sigmoid(x) if is_trace(x) else F.silu(x)


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """:func:`repro_torch.nn.rmsnorm`; on a trace ``repro.nn.rmsnorm``'s
    steps, the float32 mean as jnp writes it (a sum, then a division)."""
    if not is_trace(x):
        return nn.rmsnorm(p, x, eps)
    sq = torch.square(x).float()
    ms = sq.sum(-1, keepdim=True) / sq.shape[-1]
    inv = torch.rsqrt(ms + eps).to(x.dtype)
    return x * inv * p["scale"]


def scan_aux(aux: torch.Tensor, n: int) -> torch.Tensor:
    """The aux loss of a ``lax.scan`` over ``n`` MLP layers, added to
    ``aux`` (a zero literal): zero. On a trace the jaxpr's equations,
    which it keeps though ``lm.forward``'s caller drops them: the scan's
    ys of the literal, a sum, an add."""
    if not is_trace(aux):
        return aux
    return aux + prims.scan_ys([aux] * n).sum()


def stack_aux(aux: torch.Tensor, auxs) -> torch.Tensor:
    """The aux losses ``auxs`` of an MoE config's stack, one a layer, summed
    and added to ``aux``: the jaxpr's ``aux_total += auxs.sum()`` of the
    scan's ys on a trace (``torch.stack`` is an elementwise node there),
    a stack and a sum otherwise."""
    ys = prims.scan_ys(auxs) if is_trace(aux) else torch.stack(auxs)
    return aux + ys.sum()


def group_aux(auxs, aux_c: torch.Tensor) -> torch.Tensor:
    """A cross-attention group's aux loss: its self layers' ``auxs``
    summed (the inner scan's ys on a trace), plus its cross layer's
    ``aux_c``, as the jaxpr's ``auxs.sum() + aux_c``."""
    ys = prims.scan_ys(auxs) if is_trace(aux_c) else torch.stack(auxs)
    return ys.sum() + aux_c


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rd: int) -> torch.Tensor:
    """``layers.apply_rope``'s jnp steps for ``rd`` rotated lanes: a full
    slice is no step, a strided one a gather, the stack two broadcasts and
    a concatenate."""
    d = x.shape[-1]
    xr = x if rd == d else x[..., :rd]
    xp = x[..., rd:]
    x1, x2 = lanes(xr, 0, 2), lanes(xr, 1, 2)
    c = (cos if cos.shape[-1] == rd // 2 else cos[..., :rd // 2])[:, :, None]
    s = (sin if sin.shape[-1] == rd // 2 else sin[..., :rd // 2])[:, :, None]
    y1 = (x1 * c - x2 * s).to(x.dtype)
    y2 = (x2 * c + x1 * s).to(x.dtype)
    yr = torch.cat([y1[..., None], y2[..., None]], dim=-1).reshape(xr.shape)
    return torch.cat([yr, xp], dim=-1) if rd < d else yr


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _mask_for(rows: torch.Tensor, cols: torch.Tensor, kv_valid: int,
              causal: bool, window: int) -> torch.Tensor:
    m = (cols[None, :] >= 0) & (cols[None, :] < kv_valid)
    if causal:
        m = m & (cols[None, :] <= rows[:, None])
    if window > 0:
        m = m & (cols[None, :] >= rows[:, None] - window + 1)
    return m


def _flash_fwd_chunks(qs: torch.Tensor, ks: torch.Tensor, vs: torch.Tensor,
                      q_off: int, kv_off: int, skv: int, causal: bool,
                      window: int, scale: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's jnp twin of the flash kernel, equation for
    equation: qs [nq, B, qc, g, r, D], ks / vs [nk, B, kc, g, D] → (out
    [nq, B, qc, g, r, Dv], lse [nq, B, g, r, qc]). A streaming softmax
    over kv chunks in float32, each product one ``dot_general``. The lse
    is computed whether or not the caller keeps it, as the jaxpr keeps
    the dead equations."""
    nq, b, qc, g, r, _ = qs.shape
    nk, _, kc, _, dv = vs.shape
    kv_valid = kv_off + skv
    dev = qs.device
    f32 = torch.float32

    def q_block(qi, qblk):
        qblk = qblk.float()
        rows = q_off + qi * qc + torch.arange(qc, dtype=torch.int32,
                                              device=dev)
        m = torch.full((b, g, r, qc), -1e30, dtype=f32, device=dev)
        l = torch.zeros((b, g, r, qc), dtype=f32, device=dev)
        acc = torch.zeros((b, g, r, qc, dv), dtype=f32, device=dev)
        kjs = torch.arange(nk, dtype=torch.int32, device=dev)
        for kj, kblk, vblk in zip(kjs.unbind(0), ks.unbind(0), vs.unbind(0)):
            cols = kv_off + kj * kc + torch.arange(kc, dtype=torch.int32,
                                                   device=dev)
            # "bqgrd,bkgd->bgrqk": dot_general(k, q) → [b, g, k, q, r]
            s = prims.dot_general(kblk.float(), qblk, [3], [4], [0, 2],
                                  [0, 2]).permute(0, 1, 4, 3, 2) * scale
            mask = _mask_for(rows, cols, kv_valid, causal, window)
            s = where(mask.view(1, 1, 1, *mask.shape), s, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            p = where(mask.view(1, 1, 1, *mask.shape), p, 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            # "bgrqk,bkgd->bgrqd"
            acc = acc * alpha[..., None] + prims.dot_general(
                p, vblk.float(), [4], [1], [0, 1], [0, 2])
            m = m_new
        lsafe = torch.clamp_min(l, 1e-20)
        out = acc / lsafe[..., None]
        lse = m + torch.log(lsafe)
        return out.permute(0, 3, 1, 2, 4), lse

    if nq == 1:
        o, s = q_block(torch.zeros((), dtype=torch.int32, device=dev), qs[0])
        return o[None], s[None]
    blocks = [q_block(qi, qblk) for qi, qblk in zip(
        torch.arange(nq, dtype=torch.int32, device=dev).unbind(0),
        qs.unbind(0))]
    return (prims.scan_ys([o for o, _ in blocks]),
            prims.scan_ys([s for _, s in blocks]))


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, window: int = 0, q_offset: int = 0,
                        kv_offset: int = 0, q_chunk: int = 2048,
                        kv_chunk: int = 1024,
                        scale: Optional[float] = None) -> torch.Tensor:
    """The JAX package's ``blockwise_attention`` with static offsets: pad
    to the chunks, chunk, :func:`_flash_fwd_chunks`, unchunk."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    rep = h // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    q_chunk, kv_chunk = min(q_chunk, sq), min(kv_chunk, skv)
    pq, pk = (-sq) % q_chunk, (-skv) % kv_chunk
    qp = pad(q, 1, 0, pq) if pq else q
    kp = pad(k, 1, 0, pk) if pk else k
    vp = pad(v, 1, 0, pk) if pk else v
    nq, nk = (sq + pq) // q_chunk, (skv + pk) // kv_chunk
    qs = qp.reshape(b, nq, q_chunk, hkv, rep, d).permute(1, 0, 2, 3, 4, 5)
    ks = kp.reshape(b, nk, kv_chunk, hkv, d).permute(1, 0, 2, 3, 4)
    vs = vp.reshape(b, nk, kv_chunk, hkv, dv).permute(1, 0, 2, 3, 4)
    out, _ = _flash_fwd_chunks(qs, ks, vs, int(q_offset), int(kv_offset),
                               skv, causal, window, scale)
    out = out.permute(1, 0, 2, 3, 4, 5).reshape(b, sq + pq, h, dv)
    if pq:
        out = out[:, :sq]
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------

def _ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 bm: torch.Tensor, cm: torch.Tensor, chunk: int,
                 s0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's chunked SSD in jnp, equation for equation: x
    [Bt, S, H, P], dt [Bt, S, H], a [H], B and C [Bt, S, H, N] (per head)
    → (y [Bt, S, H, P] float32, last state [Bt, H, N, P]). The intra-chunk
    products are ``dot_general``s in their own output order, then a
    transpose; the scan over the S / chunk chunks is a loop."""
    bt, sl, h, p = x.shape
    n = bm.shape[-1]
    dev = x.device
    chunk = min(chunk, sl)
    padding = (-sl) % chunk
    if padding:
        x, dt = pad(x, 1, 0, padding), pad(dt, 1, 0, padding)
        bm, cm = pad(bm, 1, 0, padding), pad(cm, 1, 0, padding)
    nc = (sl + padding) // chunk
    xc = x.reshape(bt, nc, chunk, h, p).float()
    dtc = dt.reshape(bt, nc, chunk, h).float()
    bc = bm.reshape(bt, nc, chunk, h, n).float()
    cc = cm.reshape(bt, nc, chunk, h, n).float()

    cum = torch.cumsum(dtc * a.view(1, 1, 1, h), 2)         # [Bt,nc,Lc,H]
    L = torch.exp(cum.view(bt, nc, chunk, 1, h)
                  - cum.view(bt, nc, 1, chunk, h))
    tri = tril_ones(chunk, dev)
    L = where(tri.view(1, 1, chunk, chunk, 1), L, 0.0)

    # "bnihd,bnjhd->bnijh" (C_i · B_j)
    cb = prims.dot_general(cc, bc, [4], [4], [0, 1, 3], [0, 1, 3]) \
        .permute(0, 1, 3, 4, 2)
    m = cb * L * dtc.view(bt, nc, 1, chunk, h)
    # "bnijh,bnjhp->bnihp": dot_general(x, M) → [b, n, h, p, i]
    y_intra = prims.dot_general(xc, m, [2], [3], [0, 1, 3], [0, 1, 4]) \
        .permute(0, 1, 4, 2, 3)

    # cum[:, :, -1]: a dynamic index, [Bt, nc, H]
    total = torch.ops.aten.index(cum, [None, None, index(-1, chunk, dev)])
    w = torch.exp(total.view(bt, nc, 1, h) - cum) * dtc
    # "bnlh,bnlhd,bnlhp->bnhdp" in two products
    chunk_state = prims.dot_general(
        prims.dot_general(w, bc, [], [], [0, 1, 2, 3], [0, 1, 2, 3]),
        xc, [2], [2], [0, 1, 3], [0, 1, 3])

    if s0 is None:
        s0 = torch.zeros((bt, h, n, p), dtype=torch.float32, device=dev)
    states, s_prev = [], s0
    for tot, cst in zip(total.permute(1, 0, 2).unbind(0),
                        chunk_state.permute(1, 0, 2, 3, 4).unbind(0)):
        states.append(s_prev)
        s_prev = s_prev * torch.exp(tot).view(bt, h, 1, 1) + cst
    states_in = prims.scan_ys(states).permute(1, 0, 2, 3, 4)  # [Bt,nc,H,N,P]

    # "bnlhd,bnhdp->bnlhp": dot_general(states, C) → [b, n, h, p, l]
    y_inter = prims.dot_general(states_in, cc, [3], [4], [0, 1, 2],
                                [0, 1, 3]).permute(0, 1, 4, 2, 3) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(bt, sl + padding, h, p)
    if padding:
        y = y[:, :sl]
    return y, s_prev


def mamba2_scan(p: Params, x_ssd: torch.Tensor, dt_raw: torch.Tensor,
                bmat: torch.Tensor, cmat: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``mamba2_apply``'s full-sequence scan in the JAX package's steps:
    B and C [B, S, G, N] repeated to the heads, jnp's softplus of dt, A,
    :func:`_ssd_chunked` from a zero state → (y, last state)."""
    b, sl, nh, _ = x_ssd.shape
    g, n = bmat.shape[2], bmat.shape[3]
    hpg = nh // g
    bh = bmat.repeat(1, 1, 1, hpg).view(b, sl, nh, n)
    ch = cmat.repeat(1, 1, 1, hpg).view(b, sl, nh, n)
    dt = softplus(dt_raw.float() + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    return _ssd_chunked(x_ssd, dt, a, bh, ch, chunk)


# ---------------------------------------------------------------------------
# mixture of experts
# ---------------------------------------------------------------------------

def wrap_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """A traced index as jnp wraps it before a gather or a scatter:
    ``idx + n`` where ``idx < 0``."""
    return torch.where(idx < 0, idx + n, idx)


def softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis step for step: the max with
    ``initial=-inf``, kept and stopped from the gradient, the shifted
    exponentials over their kept sum."""
    m = torch.clamp_min(x.amax(-1), -math.inf)[..., None].detach()
    e = torch.exp(x - m)
    return e / e.sum(-1, keepdim=True)


def swiglu(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``layers.mlp_apply``: ``(silu(x @ wg) · (x @ wu)) @ wd``."""
    return (silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]


def moe_route(router_w: torch.Tensor, x_flat: torch.Tensor, n_experts: int,
              top_k: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX package's ``_route``: x_flat [T, D] → (probs [T, k], int32
    ids [T, k], aux loss). The float32 router product, jnp's softmax,
    ``lax.top_k`` (:func:`prims.top_k`), the renormalisation by
    ``max(Σ, 1e-9)``, and the Switch loss from the mean probability and
    the replicas an expert counted by a scatter-add of ones."""
    logits = x_flat.float() @ router_w
    probs_all = softmax(logits)
    probs, ids = prims.top_k(probs_all, top_k)
    probs = probs / torch.clamp_min(probs.sum(-1, keepdim=True), 1e-9)
    me = probs_all.sum(0) / probs_all.shape[0]
    counts = torch.zeros((n_experts,), dtype=torch.float32,
                         device=x_flat.device)
    flat = ids.reshape(-1)
    idx = wrap_index(flat, n_experts)
    ones = torch.ones(flat.shape, dtype=torch.float32, device=x_flat.device)
    ce = counts.index_add(0, idx, ones) / flat.numel()
    return probs, ids, torch.sum(me * ce) * n_experts


def moe_slots(ids: torch.Tensor, n_experts: int, cap: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_apply_local``'s dispatch in jnp's steps: ids [T, k] → (keep
    [T·k], slot [T·k]). ``one_hot`` as an iota compared and converted to
    int32, an int32 ``cumsum``, ``take_along_axis`` (the index wrapped,
    then a gather), the kept slot ``expert · cap + position`` and the
    dropped one ``E · cap``."""
    flat = ids.reshape(-1)
    onehot = torch.eq(flat[:, None], prims.iota(
        [1, n_experts], 1, torch.int32, ids.device)).to(torch.int32)
    pos = torch.cumsum(onehot, 0, dtype=torch.int32) - 1
    pos = torch.gather(pos, 1, wrap_index(flat[:, None], n_experts))[:, 0]
    keep = pos < cap
    return keep, where(keep, flat * cap + pos, n_experts * cap)


def moe_apply_local(p: Params, mo, x_flat: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``moe_apply_local`` equation for equation: x_flat
    [T, D] → ([T, D], aux loss). ``mo`` is the config's ``MoEConfig``;
    ``cap`` a Python int of T. The replicas (``jnp.repeat``: a tile and a
    reshape), masked by ``keep``, are scatter-added into ``E · cap + 1``
    rows; the experts are three ``dot_general``s; each replica's output
    comes back by a gather of its slot clamped into the buffer, masked,
    weighted by its probability and summed over k; the shared experts'
    MLP is added."""
    t, d = x_flat.shape
    e_n, k = mo.n_experts, mo.top_k
    dt = x_flat.dtype
    probs, ids, aux = moe_route(p["router"], x_flat, e_n, k)
    cap = int(math.ceil(t * k / e_n * mo.capacity_factor))
    keep, slot = moe_slots(ids, e_n, cap)
    rows = e_n * cap
    x_rep = x_flat.repeat(1, k).view(t * k, d)
    buf = torch.zeros((rows + 1, d), dtype=dt, device=x_flat.device)
    x_rep = x_rep * keep[:, None].to(dt)
    buf = buf.index_add(0, wrap_index(slot, rows + 1), x_rep)
    buf = buf[:-1].view(e_n, cap, d)
    e = p["experts"]
    hid = silu(prims.dot_general(buf, e["wg"], [2], [1], [0], [0])) \
        * prims.dot_general(buf, e["wu"], [2], [1], [0], [0])
    y_buf = prims.dot_general(hid, e["wd"], [2], [1], [0], [0])
    y_rep = take_rows(y_buf.view(rows, d), torch.clamp_max(slot, rows - 1))
    y_rep = y_rep * keep[:, None].to(y_rep.dtype)
    w = probs.reshape(-1)[:, None].to(dt)
    y = (y_rep.to(dt) * w).view(t, k, d).sum(1)
    if mo.n_shared:
        y = y + swiglu(p["shared"], x_flat)
    return y.to(dt), aux
