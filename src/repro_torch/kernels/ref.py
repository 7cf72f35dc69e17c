"""Plain PyTorch versions of the port's kernels.

Each function is the mathematically direct form of one kernel, written
with ``index_select`` / ``index_add_`` / ``scatter_reduce_`` / ``bmm``.
They are the oracles the CUDA kernels are held against on the card, and
the path a CPU tensor takes (:mod:`repro_torch.kernels.ops`). Semantics
follow ``repro.kernels.ref`` function for function. Every function works
in the dtype of its float inputs, float64 included, so that
``torch.autograd.gradcheck`` can run the backward passes of
:mod:`repro_torch.kernels.autograd` on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def segment_degree_ref(edges: torch.Tensor, edge_mask: torch.Tensor,
                       n_nodes: int) -> torch.Tensor:
    """In-degree per destination node: [B, E, 2] → [B, N].

    The degree is the sum of edge-mask *values*, so weighted or padded
    edges count by their weight.
    """
    b = edges.shape[0]
    dst = edges[..., 1].long() + n_nodes * torch.arange(
        b, device=edges.device)[:, None]
    out = torch.zeros((b * n_nodes,), dtype=edge_mask.dtype,
                      device=edge_mask.device)
    out.index_add_(0, dst.reshape(-1), edge_mask.reshape(-1))
    return out.reshape(b, n_nodes)


def _flat_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``idx [B, E]`` local node indices → flat ``b·n + idx`` (long)."""
    b = idx.shape[0]
    return (idx.long() + n * torch.arange(b, device=idx.device)[:, None]
            ).reshape(-1)


def segment_gather_ref(h: torch.Tensor, idx: torch.Tensor,
                       w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted row gather: ``out[b, e] = w[b, e] · h[b, idx[b, e]]``.

    h: [B, N, F]; idx: [B, E] int32; w: [B, E] or None (weight 1).
    Returns [B, E, F]. The primitive the backward passes share.
    """
    b, n, f = h.shape
    out = h.reshape(b * n, f).index_select(0, _flat_index(idx, n))
    out = out.reshape(b, idx.shape[1], f)
    return out if w is None else out * w[..., None]


def segment_scatter_ref(dst: torch.Tensor, edge_mask: torch.Tensor,
                        msgs: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Scatter per-edge messages into per-node sums.

    dst: [B, E] int32; edge_mask: [B, E]; msgs: [B, E, F]. Returns
    [B, N, F] with ``out[b, i] = Σ_{e: dst_e=i} edge_mask_e · msgs_e``.
    """
    b, _, f = msgs.shape
    m = (msgs * edge_mask[..., None]).reshape(-1, f)
    out = torch.zeros((b * n_nodes, f), dtype=msgs.dtype, device=msgs.device)
    out.index_add_(0, _flat_index(dst, n_nodes), m)
    return out.reshape(b, n_nodes, f)


def segment_aggregate_ref(edges: torch.Tensor, edge_mask: torch.Tensor,
                          h: torch.Tensor, mode: str = "mean", *,
                          return_degree: bool = False):
    """Edge-list aggregation: ``out[b, i] = agg_{e: dst_e=i} em_e·h[b, src_e]``.

    edges: [B, E, 2] int32 (src, dst), padded rows (0, 0) with mask 0;
    edge_mask: [B, E], which may carry weights (GCN); h: [B, N, F].
    ``mode="mean"`` divides by the weighted in-degree
    ``max(Σ edge_mask, 1)``. Returns [B, N, F], or ``(out, deg [B, N])``
    with ``return_degree``.
    """
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    n = h.shape[1]
    msgs = segment_gather_ref(h, edges[..., 0], edge_mask)
    out = segment_scatter_ref(edges[..., 1], torch.ones_like(edge_mask),
                              msgs, n)
    deg = None
    if mode == "mean" or return_degree:
        deg = segment_degree_ref(edges, edge_mask.to(h.dtype), n)
    if mode == "mean":
        out = out / deg.clamp_min(1.0)[..., None]
    return (out, deg) if return_degree else out


def dense_aggregate_ref(adj: torch.Tensor, h: torch.Tensor,
                        mode: str = "mean", *,
                        scale: Optional[torch.Tensor] = None,
                        transpose: bool = False,
                        return_degree: bool = False):
    """Dense aggregation ``out[b] = A'_b @ (scale ⊙ h_b)``.

    adj: [B, N, N] with ``adj[b, dst, src]`` (weights allowed: GCN's
    normalized adjacency); h: [B, N, F]; ``A' = adj`` or ``adjᵀ``
    (``transpose``); scale: [B, N] per source row or None. ``mode="mean"``
    divides row i by ``max(Σ_k A'[i, k], 1)``. Returns [B, N, F], or
    ``(out, deg [B, N])`` with ``return_degree`` (the row sums of A').
    ``transpose`` and ``scale`` make the backward pass the same function.
    """
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    a = adj.transpose(1, 2) if transpose else adj
    if scale is not None:
        h = h * scale[..., None]
    deg = a.sum(dim=-1) if (mode == "mean" or return_degree) else None
    if mode == "mean":
        out = torch.bmm(a / deg.clamp_min(1.0)[..., None], h)
    else:
        out = torch.bmm(a, h)
    return (out, deg) if return_degree else out


def sage_aggregate_ref(adj: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``mean_{j∈N(i)} h_j`` — adj: [B, N, N] (``adj[b, dst, src]``),
    h: [B, N, F]."""
    return dense_aggregate_ref(adj, h, mode="mean")


def segment_readout_ref(h: torch.Tensor, graph_ids: torch.Tensor,
                        node_mask: torch.Tensor, n_graphs: int,
                        kind: str = "mean_max") -> torch.Tensor:
    """Per-graph pooled readout over a packed flat node axis.

    ``h [P, F]`` holds every graph's nodes on one axis, ``graph_ids [P]``
    maps each node to its graph, ``node_mask [P]`` zeroes tail padding.
    Returns ``[G, F]`` (``kind="mean"``) or ``[G, 2F]`` (``"mean_max"``:
    mean ⊕ max). Graph slots with no real nodes pool to exact zeros.
    """
    if kind not in ("mean", "mean_max"):
        raise ValueError(f"kind must be 'mean' or 'mean_max', got {kind!r}")
    ids = graph_ids.long()
    w = node_mask.to(h.dtype)
    f = h.shape[1]
    sums = torch.zeros((n_graphs, f), dtype=h.dtype, device=h.device)
    sums.index_add_(0, ids, h * w[:, None])
    cnt = torch.zeros((n_graphs,), dtype=h.dtype, device=h.device)
    cnt.index_add_(0, ids, w)
    mean = sums / cnt.clamp_min(1.0)[:, None]
    if kind == "mean":
        return mean
    neg = torch.finfo(h.dtype).min
    mx = torch.full((n_graphs, f), neg, dtype=h.dtype, device=h.device)
    mx.scatter_reduce_(0, ids[:, None].expand(-1, f),
                       torch.where(w[:, None] > 0, h, neg), reduce="amax")
    mx = torch.where(cnt[:, None] > 0, mx, 0.0)
    return torch.cat([mean, mx], dim=-1)


def edge_softmax_ref(scores: torch.Tensor, dst: torch.Tensor,
                     edge_mask: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Per-destination softmax over incoming edges, NaN-safe.

    scores: [B, E, H] per-edge (multi-head) attention logits; dst: [B, E]
    int32; edge_mask: [B, E]. Returns [B, E, H] weights that sum to 1 over
    each destination's real incoming edges. Padded edges' scores are
    masked to ``finfo.min`` before the exp, an empty destination's max is
    zeroed and the denominator floored at ``finfo.tiny``, so a destination
    with no real incoming edge gives exact zeros, never NaN.
    """
    b, e, h = scores.shape
    neg = torch.finfo(scores.dtype).min
    live = (edge_mask > 0)[..., None]
    s = torch.where(live, scores, neg)
    # flat (b, dst) segment ids, so one scatter covers the whole batch
    seg = (dst.long() + n_nodes * torch.arange(
        b, device=dst.device)[:, None]).reshape(-1)
    m = torch.full((b * n_nodes, h), neg, dtype=scores.dtype,
                   device=scores.device)
    m.scatter_reduce_(0, seg[:, None].expand(-1, h), s.reshape(-1, h),
                      reduce="amax")
    m = torch.where(m > neg, m, 0.0)
    p = torch.exp(s.reshape(-1, h) - m[seg]) * edge_mask.reshape(-1, 1)
    denom = torch.zeros_like(m).index_add_(0, seg, p)
    denom = denom.clamp_min(torch.finfo(scores.dtype).tiny)
    return (p / denom[seg]).reshape(b, e, h)


def fused_gat_aggregate_ref(z: torch.Tensor, edges: torch.Tensor,
                            edge_mask: torch.Tensor, att: torch.Tensor,
                            node_mask: torch.Tensor) -> torch.Tensor:
    """Fused GAT post-softmax stage: gather ⊙ per-head attention → scatter.

    z: [P, D] projected node features (D = H·dh, heads concatenated);
    edges: [Q, 2] int32; edge_mask: [Q]; att: [Q, H] per-edge attention
    (softmax-normalized per destination); node_mask: [P]. Returns [P, D],
    ``out[i] = Σ_{e: dst_e=i} m_e · α_e[h] ⊙ z[src_e]`` with each head's
    weight broadcast over its dh slice, times ``node_mask``.
    """
    p, d = z.shape
    h = att.shape[1]
    if d % h:
        raise ValueError(f"head count {h} must divide feature dim {d}")
    src, dst = edges[:, 0].long(), edges[:, 1].long()
    zs = z.index_select(0, src)
    msgs = (zs.reshape(-1, h, d // h) * att[:, :, None]).reshape(-1, d)
    out = torch.zeros_like(z).index_add_(0, dst, msgs * edge_mask[:, None])
    return out * node_mask[:, None]


def fused_mp_layer_ref(x: torch.Tensor, edges: torch.Tensor,
                       edge_mask: torch.Tensor,
                       node_mask: Optional[torch.Tensor] = None, *,
                       w_neigh: torch.Tensor,
                       w_self: Optional[torch.Tensor] = None,
                       bias: Optional[torch.Tensor] = None,
                       mode: str = "mean", combine: str = "split",
                       self_scale: Union[None, float, torch.Tensor] = None,
                       act: str = "relu") -> torch.Tensor:
    """One full message-passing layer over the packed flat node axis.

    gather → mask → segment-scatter(+mean) → combine-with-self → bias →
    activation → node-mask. x: [P, F]; edges: [Q, 2] int32 globally
    offset (src, dst); edge_mask: [Q] — may carry real-valued edge
    weights (GCN normalization); node_mask: [P] or None.

    ``combine="split"`` computes ``x @ w_self + agg @ w_neigh``
    (GraphSAGE). ``combine="pre"`` computes
    ``(self_scale * x + agg) @ w_neigh`` where ``self_scale`` is a
    scalar (GIN's ``1 + eps``) or a [P] vector (GCN's ``d̂⁻¹·d̂⁻¹``);
    ``w_self`` is ignored. Returns [P, H].
    """
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    if combine not in ("split", "pre"):
        raise ValueError(f"combine must be 'split' or 'pre', got {combine!r}")
    if act not in ("relu", "none"):
        raise ValueError(f"act must be 'relu' or 'none', got {act!r}")
    p = x.shape[0]
    src, dst = edges[:, 0].long(), edges[:, 1].long()
    msgs = x.index_select(0, src) * edge_mask[:, None]
    agg = torch.zeros_like(x).index_add_(0, dst, msgs)
    if mode == "mean":
        deg = torch.zeros((p,), dtype=x.dtype, device=x.device)
        deg.index_add_(0, dst, edge_mask.to(x.dtype))
        agg = agg / deg.clamp_min(1.0)[:, None]
    if combine == "split":
        if w_self is None:
            raise ValueError("combine='split' requires w_self")
        y = x @ w_self + agg @ w_neigh
    else:
        s = torch.as_tensor(1.0 if self_scale is None else self_scale,
                            dtype=x.dtype, device=x.device)
        if s.dim() == 1:
            s = s[:, None]
        y = (s * x + agg) @ w_neigh
    if bias is not None:
        y = y + bias
    if act == "relu":
        y = torch.relu(y)
    if node_mask is not None:
        y = y * node_mask[:, None]
    return y
