"""Plain PyTorch versions of the port's kernels.

Each function is the mathematically direct form of one kernel, written
with ``index_select`` / ``index_add_`` / ``scatter_reduce_`` / ``bmm``.
They are the oracles the CUDA kernels are held against on the card, and
the path a CPU tensor takes (:mod:`repro_torch.kernels.ops`). Semantics
follow ``repro.kernels.ref`` function for function. Every function works
in the dtype of its float inputs, float64 included, so that
``torch.autograd.gradcheck`` can run the backward passes of
:mod:`repro_torch.kernels.autograd` on the CPU. The LM kernels'
versions (:func:`flash_attention_ref`, :func:`ssd_scan_ref`) compute in
float32 whatever their inputs, as the JAX package's model code does.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

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


def dst_csr_ref(dst: torch.Tensor, n_nodes: int,
                src: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Destination-sorted CSR of a batched edge list: for each batch row a
    stable sort of the edge indices by destination.

    dst: [B, E] int32; src: [B, E] int32 or None. Returns ``rowptr``
    [B, N + 1] and ``perm`` [B, E] (int32): row b's edges into d are
    ``perm[b, rowptr[b, d]:rowptr[b, d + 1]]`` in ascending order, and
    ``perm[b, k] = -1`` for ``k ≥ rowptr[b, N]``. An edge whose
    destination, or source where ``src`` is given, falls outside [0, N) is
    in no segment; every other edge is, whatever its weight. The order the
    segmented sums of ``csrc/segment_aggregate.cu`` add in.
    """
    b, e = dst.shape
    n = int(n_nodes)
    d = dst.long()
    live = (d >= 0) & (d < n)
    if src is not None:
        live &= (src >= 0) & (src < n)
    key = torch.where(live, d, n)             # out of every segment: last
    perm = torch.argsort(key, dim=1, stable=True)
    rows = torch.arange(b, device=dst.device)[:, None] * (n + 1)
    counts = torch.bincount((rows + key).reshape(-1),
                            minlength=b * (n + 1)).reshape(b, n + 1)
    rowptr = torch.zeros((b, n + 1), dtype=torch.long, device=dst.device)
    rowptr[:, 1:] = torch.cumsum(counts[:, :n], dim=1)
    tail = torch.arange(e, device=dst.device)[None] >= rowptr[:, n:]
    return rowptr.int(), torch.where(tail, -1, perm).int()


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


def segment_readout_backward_ref(h: torch.Tensor, graph_ids: torch.Tensor,
                                 node_mask: torch.Tensor, z: torch.Tensor,
                                 g: torch.Tensor,
                                 kind: str = "mean_max") -> torch.Tensor:
    """The gradient in ``h`` of :func:`segment_readout_ref`.

    h, graph_ids, node_mask: the forward's inputs; z: its output and g the
    incoming gradient, both ``[G, F]`` (``kind="mean"``) or ``[G, 2F]``.
    Returns ``dh [P, F]``: the mean part ``w · g_mean / max(cnt, 1)``;
    with ``mean_max`` also ``g_max / max(ties, 1)`` on each real node
    (``w > 0``) that holds its graph's max, column by column — JAX's
    ``segment_max`` rule of an even split among ties. An empty graph
    passes nothing back, and a NaN max has no ties.
    """
    if kind not in ("mean", "mean_max"):
        raise ValueError(f"kind must be 'mean' or 'mean_max', got {kind!r}")
    ids = graph_ids.long()
    w = node_mask.to(h.dtype)
    f, n = h.shape[1], g.shape[0]
    cnt = torch.zeros((n,), dtype=h.dtype, device=h.device).index_add_(
        0, ids, w)
    dh = w[:, None] * (g[:, :f] / cnt.clamp_min(1.0)[:, None]).index_select(
        0, ids)
    if kind == "mean":
        return dh
    eq = ((h == z[:, f:].index_select(0, ids)) & (w[:, None] > 0)).to(h.dtype)
    ties = torch.zeros((n, f), dtype=h.dtype, device=h.device).index_add_(
        0, ids, eq)
    return dh + eq * (g[:, f:] / ties.clamp_min(1.0)).index_select(0, ids)


def _check_csr(csr, b: int, n: int, e: int) -> None:
    """The shapes of a CSR handed to a plain version, which computes as
    without it: rowptr [B, N + 1] and perm [B, E] (:func:`dst_csr_ref`)."""
    if csr is None:
        return
    rowptr, perm = csr[0], csr[1]
    if tuple(rowptr.shape) != (b, n + 1) or tuple(perm.shape) != (b, e):
        raise ValueError(f"csr has rowptr {tuple(rowptr.shape)} and perm "
                         f"{tuple(perm.shape)}, expected {(b, n + 1)} and "
                         f"{(b, e)}")


def edge_softmax_ref(scores: torch.Tensor, dst: torch.Tensor,
                     edge_mask: torch.Tensor, n_nodes: int,
                     csr=None) -> torch.Tensor:
    """Per-destination softmax over incoming edges, NaN-safe.

    scores: [B, E, H] per-edge (multi-head) attention logits; dst: [B, E]
    int32; edge_mask: [B, E]. Returns [B, E, H] weights that sum to 1 over
    each destination's real incoming edges. Padded edges' scores are
    masked to ``finfo.min`` before the exp, an empty destination's max is
    zeroed and the denominator floored at ``finfo.tiny``, so a destination
    with no real incoming edge gives exact zeros, never NaN. ``csr`` (the
    kernel's CSR of ``dst``) is checked for its shapes and not used.
    """
    b, e, h = scores.shape
    _check_csr(csr, b, n_nodes, e)
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
                            node_mask: torch.Tensor,
                            csr=None) -> torch.Tensor:
    """Fused GAT post-softmax stage: gather ⊙ per-head attention → scatter.

    z: [P, D] projected node features (D = H·dh, heads concatenated);
    edges: [Q, 2] int32; edge_mask: [Q]; att: [Q, H] per-edge attention
    (softmax-normalized per destination); node_mask: [P]. Returns [P, D],
    ``out[i] = Σ_{e: dst_e=i} m_e · α_e[h] ⊙ z[src_e]`` with each head's
    weight broadcast over its dh slice, times ``node_mask``. ``csr`` (the
    kernel's CSR of the destinations) is checked for its shapes and not
    used.
    """
    p, d = z.shape
    h = att.shape[1]
    if d % h:
        raise ValueError(f"head count {h} must divide feature dim {d}")
    _check_csr(csr, 1, p, edges.shape[0])
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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, window: int = 0, q_offset: int = 0,
                        kv_offset: int = 0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Masked softmax attention, the function of ``blockwise_attention``
    (``repro/models/layers.py``) in one piece.

    q: [B, Sq, H, D]; k, v: [B, Skv, Hkv, D] with ``H % Hkv == 0`` (query
    head h reads kv head ``h // (H / Hkv)``). Query row i sits at position
    ``q_offset + i`` and key j at ``kv_offset + j``; a pair is kept when the
    key position is ``≥ 0`` and, if ``causal``, not after the query's, and,
    with ``window > 0``, within ``window`` of it (``_mask_for``). Scores
    and sums in float32, the masked maximum starting at -1e30 and the sum
    divided by ``max(l, 1e-20)``, so a row with no kept key reads 0 (not
    NaN, as a softmax over -inf would). Returns [B, Sq, H, D] in q's dtype.
    """
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qf, kf, vf = q.float(), k.float(), v.float()
    if rep > 1:
        kf = kf.repeat_interleave(rep, dim=2)
        vf = vf.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    rows = q_offset + torch.arange(sq, device=q.device)[:, None]
    cols = kv_offset + torch.arange(skv, device=q.device)[None, :]
    mask = cols >= 0
    if causal:
        mask = mask & (cols <= rows)
    if window > 0:
        mask = mask & (cols >= rows - window + 1)
    s = s.masked_fill(~mask, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1).clamp_min(1e-20)                 # [B, H, Sq]
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf) / l.transpose(1, 2)[..., None]
    return out.to(q.dtype)


def flash_decode_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, plan: Tuple[int, int, int, int], causal: bool,
                           window: int = 0, q_offset: int = 0,
                           kv_offset: int = 0,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The split-KV decode of ``csrc/flash_attention.cu``, step by step:
    one query row (q [B, 1, H, D]) over the keys of ``plan = (key_lo,
    key_hi, split_len, n_splits)`` (``decode_split_plan`` in
    :mod:`repro_torch.kernels.flash_attention`).

    Split s takes keys ``[key_lo + s·split_len, min(key_hi, … + split_len))``
    and holds ``m`` (its masked maximum, never below -1e30), ``l`` (the sum
    of ``exp(score − m)`` over its kept keys) and ``acc`` (the same weights
    times V, unnormalised); a split with no kept key holds (-1e30, 0, 0).
    The merge weighs each split by ``exp(m − max m)`` and divides by
    ``max(Σ w·l, 1e-20)``, so a row with no kept key anywhere reads 0.
    Masks are those of :func:`flash_attention_ref`. Float32 inside; used by
    the tests only. Returns [B, 1, H, D] in q's dtype.
    """
    b, sq, h, d = q.shape
    if sq != 1:
        raise ValueError(f"a decode step has one query row, got {sq}")
    hkv = k.shape[2]
    rep = h // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qf = q[:, 0].float()                                   # [B, H, D]
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    key_lo, key_hi, split_len, n_splits = plan
    ms, ls, accs = [], [], []
    for s in range(n_splits):
        j0 = key_lo + s * split_len
        j = torch.arange(j0, max(j0, min(key_hi, j0 + split_len)),
                         device=q.device)
        cols = kv_offset + j
        mask = cols >= 0
        if causal:
            mask = mask & (cols <= q_offset)
        if window > 0:
            mask = mask & (cols >= q_offset - window + 1)
        sc = torch.einsum("bhd,bkhd->bhk", qf, kf[:, j]) * scale
        sc = sc.masked_fill(~mask, -math.inf)
        m = torch.full((b, h), -1e30, device=q.device)
        if j.numel():
            m = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m[..., None])                   # masked: 0
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bhk,bkhd->bhd", p, vf[:, j]))
    m_all = torch.stack(ms)                                # [splits, B, H]
    w = torch.exp(m_all - m_all.amax(dim=0))
    l = (w * torch.stack(ls)).sum(dim=0).clamp_min(1e-20)
    out = (w[..., None] * torch.stack(accs)).sum(dim=0) / l[..., None]
    return out[:, None].to(q.dtype)


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, *, chunk: int,
                 s0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan of ``_ssd_chunked`` (``repro/models/layers.py``).

    x: [Bt, S, H, P]; dt: [Bt, S, H]; A: [H]; B, C: [Bt, S, G, N] with
    ``H % G == 0`` (head h reads group ``h // (H / G)``; G = H is the
    per-head form); s0: the [Bt, H, N, P] state before the first step, or
    None for zeros. Returns (y [Bt, S, H, P], last state [Bt, H, N, P]),
    both float32. The sequence is padded to a chunk multiple with zeros
    (dt = 0 is the identity decay and adds nothing); inside a chunk the
    decay ``exp(cum_i − cum_j)`` is masked to ``i ≥ j`` before the exp.
    """
    bt, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if g != h:
        B = B.repeat_interleave(h // g, dim=2)
        C = C.repeat_interleave(h // g, dim=2)
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, 0, 0, pad))
    nc = (s + pad) // chunk
    xc = x.reshape(bt, nc, chunk, h, p).float()
    dtc = dt.reshape(bt, nc, chunk, h).float()
    bc = B.reshape(bt, nc, chunk, h, n).float()
    cc = C.reshape(bt, nc, chunk, h, n).float()

    cum = torch.cumsum(dtc * A.float(), dim=2)                # [Bt,nc,Lc,H]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))[None, None, :, :, None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # [.., i, j, H]
    decay = torch.exp(diff.masked_fill(~tri, 0.0)).masked_fill(~tri, 0.0)
    cb = torch.einsum("bnihd,bnjhd->bnijh", cc, bc)
    m = cb * decay * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", m, xc)

    total = cum[:, :, -1, :]                                  # [Bt,nc,H]
    w = torch.exp(total[:, :, None, :] - cum) * dtc
    chunk_state = torch.einsum("bnlh,bnlhd,bnlhp->bnhdp", w, bc, xc)
    state = (torch.zeros((bt, h, n, p), dtype=torch.float32, device=x.device)
             if s0 is None else s0.float())
    states_in = []
    for c in range(nc):
        states_in.append(state)
        state = state * torch.exp(total[:, c])[..., None, None] \
            + chunk_state[:, c]
    states = torch.stack(states_in, dim=1)                    # [Bt,nc,H,N,P]
    y_inter = torch.einsum("bnlhd,bnhdp->bnlhp", cc, states) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(bt, s + pad, h, p)[:, :s]
    return y, state


def ssd_decode_ref(state: torch.Tensor, x_t: torch.Tensor, dt_t: torch.Tensor,
                   A: torch.Tensor, B_t: torch.Tensor, C_t: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One SSD decode step (``repro.kernels.ref.ssd_decode_ref``).

    state: [Bt, H, N, P] float32; x_t: [Bt, H, P]; dt_t: [Bt, H]; A: [H];
    B_t, C_t: [Bt, H, N]. Returns (y_t [Bt, H, P] in x_t's dtype, state').
    The JAX package has no kernel for it, so it is plain on every device.
    """
    a_t = torch.exp(dt_t.float() * A[None, :])
    upd = torch.einsum("bh,bhn,bhp->bhnp", dt_t.float(), B_t.float(),
                       x_t.float())
    state = state * a_t[..., None, None] + upd
    y_t = torch.einsum("bhn,bhnp->bhp", C_t.float(), state)
    return y_t.to(x_t.dtype), state
