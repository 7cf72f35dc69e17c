"""Gradients of the kernels on the training path.

A kernel launched through ``ctypes`` writes into a fresh tensor, which
has no ``grad_fn``. Each kernel that training differentiates through
therefore gets a ``torch.autograd.Function`` here:

* :class:`SegmentAggregate` (``segment_aggregate``, B5) — ``dh`` is the
  same aggregation over the swapped edges (src ↔ dst), in sum mode, with
  weight ``em`` (sum) or ``em / max(deg[dst], 1)`` (mean); ``deg`` is
  saved from the forward.
* :class:`SegmentScatter` (``segment_scatter``, B6) — ``dmsgs`` is the
  gather of ``g[dst]`` times ``em``.
* :class:`SegmentGather` (``segment_gather``) — ``dh`` is the scatter of
  ``g`` into ``idx``.
* :class:`DenseAggregate` (``dense_aggregate``, B7) — ``dh`` is the same
  kernel with the transpose flag and the input scale ``1 / max(deg, 1)``
  (``Aᵀ @ (g / deg)``).
* :class:`SegmentReadout` (``segment_readout``, B2) — the mean part
  ``w·g_mean[gid] / max(cnt, 1)``; the max part ``g_max[gid]`` split
  evenly among tied real nodes (``w > 0``), JAX's ``segment_max`` rule,
  and nothing for empty graphs: ``segment_readout_backward``, one kernel
  launch on the card.
* :class:`EdgeSoftmax` (``edge_softmax``, B3) —
  ``ds = att ⊙ (g − gather(scatter(att ⊙ g)))`` on real edges, 0 on
  masked ones.
* :class:`FlashAttention` (``flash_attention``, B8) — the forward keeps
  each row's log-sum-exp, and the backward (``flash_attention_bwd``, a
  kernel of its own) recomputes p from it: the JAX package's custom VJP
  of ``_make_flash``, so residuals stay O(S), not O(S²).
* :class:`SsdScan` (``ssd_scan``, B9) — the backward (``ssd_scan_bwd``, a
  kernel of its own) is the closed form of autodiff through the chunked
  scan: it recomputes the chunks' entry states from the saved inputs, so
  nothing but the inputs is kept.

Every formula is written once, over :func:`repro_torch.kernels.ops.kernel`:
the CUDA kernels for a CUDA tensor and their plain versions for a CPU
tensor, so the CPU tests run the very backward the card runs. The JAX
package differentiates its plain compositions instead (its Pallas calls
have no ``custom_vjp``; its attention has one, over jnp); the tests hold
these gradients against ``jax.grad`` of them.

There is no gradient for ``edges``, ``edge_mask``, ``adj``, ``graph_ids``
or ``node_mask``: they depend only on the data (GCN's normalization
weights included). Asking for one raises.
"""
from __future__ import annotations

import torch

from . import ops


def _refuse(ctx, names: dict) -> None:
    """Raise for an input whose gradient this Function does not compute."""
    for i, name in names.items():
        if ctx.needs_input_grad[i]:
            raise RuntimeError(f"{name} has no gradient here: it depends on "
                               f"the data only")


def _c(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous()


class SegmentAggregate(torch.autograd.Function):
    """``out[b, i] = agg_{e: dst_e=i} em_e · h[b, src_e]`` (sum | mean)."""

    @staticmethod
    def forward(ctx, edges, edge_mask, h, mode):
        _refuse(ctx, {1: "edge_mask"})
        run = ops.kernel("segment_aggregate", h)
        deg = None
        if mode == "mean":
            out, deg = run(edges, edge_mask, h, mode, return_degree=True)
        else:
            out = run(edges, edge_mask, h, mode)
        ctx.mode = mode
        ctx.save_for_backward(edges, edge_mask, deg)
        return out

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[2]:
            return None, None, None, None
        edges, em, deg = ctx.saved_tensors
        w = em
        if ctx.mode == "mean":
            w = em / torch.gather(deg, 1, edges[..., 1].long()).clamp_min(1.0)
        swapped = _c(edges.flip(-1))
        dh = ops.kernel("segment_aggregate", g)(swapped, _c(w), _c(g), "sum")
        return None, None, dh, None


class SegmentScatter(torch.autograd.Function):
    """``out[b, i] = Σ_{e: dst_e=i} em_e · msgs[b, e]``."""

    @staticmethod
    def forward(ctx, dst, edge_mask, msgs, n_nodes):
        _refuse(ctx, {1: "edge_mask"})
        ctx.save_for_backward(dst, edge_mask)
        return ops.kernel("segment_scatter", msgs)(dst, edge_mask, msgs,
                                                   n_nodes)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[2]:
            return None, None, None, None
        dst, em = ctx.saved_tensors
        return None, None, ops.kernel("segment_gather", g)(_c(g), dst, em), \
            None


class SegmentGather(torch.autograd.Function):
    """``out[b, e] = h[b, idx[b, e]]``."""

    @staticmethod
    def forward(ctx, h, idx):
        ctx.n = h.shape[1]
        ctx.save_for_backward(idx)
        return ops.kernel("segment_gather", h)(h, idx)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        idx, = ctx.saved_tensors
        ones = torch.ones(idx.shape, dtype=g.dtype, device=g.device)
        return ops.kernel("segment_scatter", g)(idx, ones, _c(g), ctx.n), None


class DenseAggregate(torch.autograd.Function):
    """``out[b] = adj_b @ h_b`` (sum | mean)."""

    @staticmethod
    def forward(ctx, adj, h, mode):
        _refuse(ctx, {0: "adj"})
        run = ops.kernel("dense_aggregate", h)
        deg = None
        if mode == "mean":
            out, deg = run(adj, h, mode, return_degree=True)
        else:
            out = run(adj, h, mode)
        ctx.save_for_backward(adj, deg)
        return out

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[1]:
            return None, None, None
        adj, deg = ctx.saved_tensors
        inv = None if deg is None else _c(1.0 / deg.clamp_min(1.0))
        return None, ops.kernel("dense_aggregate", g)(
            adj, _c(g), "sum", scale=inv, transpose=True), None


class SegmentReadout(torch.autograd.Function):
    """Per-graph mean (⊕ max) over the packed flat node axis."""

    @staticmethod
    def forward(ctx, h, graph_ids, node_mask, n_graphs, kind):
        _refuse(ctx, {2: "node_mask"})
        z = ops.kernel("segment_readout", h)(h, graph_ids, node_mask,
                                             n_graphs, kind=kind)
        ctx.kind = kind
        ctx.save_for_backward(h, graph_ids, node_mask, z)
        return z

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None
        h, gid, w, z = ctx.saved_tensors
        dh = ops.kernel("segment_readout_backward", h)(h, gid, w, z, _c(g),
                                                      kind=ctx.kind)
        return dh, None, None, None, None


class EdgeSoftmax(torch.autograd.Function):
    """Per-destination softmax of ``[B, E, H]`` edge scores."""

    @staticmethod
    def forward(ctx, scores, dst, edge_mask, n_nodes, csr=None):
        _refuse(ctx, {2: "edge_mask"})
        att = ops.kernel("edge_softmax", scores)(scores, dst, edge_mask,
                                                 n_nodes, csr=csr)
        ctx.n = n_nodes
        ctx.save_for_backward(att, dst, edge_mask)
        return att

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None
        att, dst, em = ctx.saved_tensors
        live = (em > 0).to(att.dtype)
        ag = _c(att * g)
        per_dst = ops.kernel("segment_scatter", ag)(dst, live, ag, ctx.n)
        back = ops.kernel("segment_gather", ag)(per_dst, dst, live)
        ds = torch.where(live[..., None] > 0, att * (g - back), 0.0)
        return ds, None, None, None, None


class FlashAttention(torch.autograd.Function):
    """Masked softmax attention of q [B, Sq, H, D] over k [B, Skv, Hkv, D]
    and v [B, Skv, Hkv, Dv] (``flash_attention``; Dv < D is MLA's); the
    offsets and window are Python ints."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, kv_offset, scale):
        kw = dict(causal=causal, window=window, q_offset=q_offset,
                  kv_offset=kv_offset, scale=scale)
        q, k, v = _c(q), _c(k), _c(v)
        out, lse = ops.kernel("flash_attention", q)(q, k, v, with_lse=True,
                                                    **kw)
        ctx.kw = kw
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ops.kernel("flash_attention_bwd", q)(
            q, k, v, out, lse, _c(g.to(q.dtype)), **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


class SsdScan(torch.autograd.Function):
    """The chunked SSD scan of x [Bt, S, H, P], dt [Bt, S, H], A [H] and
    B, C [Bt, S, G, N] from s0 [Bt, H, N, P] or zero (``ssd_scan``) → (y,
    last state); the chunk is a Python int."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, s0, chunk):
        x, dt, A, B, C = (_c(t) for t in (x, dt, A, B, C))
        s0 = None if s0 is None else _c(s0)
        y, last = ops.kernel("ssd_scan", x)(x, dt, A, B, C, chunk=chunk,
                                             s0=s0)
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, A, B, C, s0)
        return y, last

    @staticmethod
    def backward(ctx, gy, glast):
        x, dt, A, B, C, s0 = ctx.saved_tensors
        if gy is None:
            gy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dx, ddt, da, db, dc, ds0 = ops.kernel("ssd_scan_bwd", x)(
            x, dt, A, B, C, _c(gy.float()), chunk=ctx.chunk, s0=s0,
            d_last=None if glast is None else _c(glast.float()))
        return dx, ddt, da, db, dc, ds0, None
