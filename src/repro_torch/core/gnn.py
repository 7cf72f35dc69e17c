"""Performance Model Graph Network Structure (paper §3.4) + GNN baselines.

The PMGNS is: 3 × GraphSAGE blocks → graph readout → ``z ⊕ F_s`` →
3 × FC blocks → 3-way multi-regression head (latency ms, energy J,
memory MB). Table 4 baselines — GCN, GAT, GIN, and a no-GNN MLP — share
the same skeleton with the message-passing layer swapped.

This is the port of ``repro.core.gnn``. Batches come in the three layouts
of ``repro_torch.core.batching``:

    x     [B, N, F]     node features            (dense, sparse)
    mask  [B, N]        node validity
    adj   [B, N, N]     A[dst, src]              (dense)
    edges [B, E, 2]     (src, dst) int32         (sparse)
    edge_mask [B, E]    1.0 real edge / 0.0 padding

    x     [P, F]        packed: ONE flat node axis for many graphs
    graph_ids [P]       segment id of each node's graph
    edges [Q, 2]        globally-offset block-diagonal edge list
    static/y [G, ·]     per-graph rows

Packed inference (``cfg.resolved_fused``, the prediction path) runs each
SAGE/GCN/GIN layer as one call of
:func:`repro_torch.kernels.ops.fused_mp_layer`, each GAT layer as one
call each of :func:`~repro_torch.kernels.ops.edge_softmax` and
:func:`~repro_torch.kernels.ops.fused_gat_aggregate`. Training, and
inference with ``fused_mp="off"`` or a dense or sparse layout, runs the
composed layers (:func:`sage_layer` … :func:`mlp_layer`), whose
aggregations go through the differentiable entries of
:mod:`repro_torch.kernels.ops` (:mod:`repro_torch.kernels.autograd`):
``dense_aggregate`` on the dense layout, ``segment_aggregate`` /
``segment_gather`` / ``segment_scatter`` / ``edge_softmax`` on the
edge-list layouts (the packed axis rides as a batch of one), and
``segment_readout`` for the packed pooling. A CUDA tensor runs the
hand-written kernels, a CPU tensor their plain versions. The dense GAT
attention is plain torch, as it is plain ``jnp`` in the JAX package.

Parameters keep the JAX package's pytree and layout: nested dicts with
``w [d_in, d_out]`` and ``x @ w`` products. :class:`PMGNS` holds them as
an ``nn.Module`` whose parameter names are the pytree paths
(``gnn.b0.self.w``); :func:`params_from_numpy` and
:func:`params_to_numpy` convert to and from the numpy pytree that
artifacts, checkpoints and the JAX package use.

Targets are trained in ``log1p`` space; :func:`decode_targets` maps
predictions back to physical units.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from .. import nn
from ..kernels import ops
from ..kernels.ref import segment_degree_ref

Params = Dict[str, Any]

TARGET_NAMES = ("latency_ms", "energy_j", "memory_mb")
N_TARGETS = 3

#: Variants the port runs: all of the JAX package's.
PORTED_VARIANTS = ("graphsage", "gcn", "gat", "gin", "mlp")
#: attention heads of a GAT layer (``repro.core.gnn.gat_layer_init``)
GAT_HEADS = 4


@dataclasses.dataclass(frozen=True)
class PMGNSConfig:
    """Paper Table 3 settings — the same fields, defaults and validation as
    ``repro.core.gnn.PMGNSConfig``, so ``dataclasses.asdict`` round-trips
    through artifacts written by either package."""

    variant: str = "graphsage"       # graphsage | gcn | gat | gin | mlp
    node_feat_dim: int = 32
    static_dim: int = 5
    hidden: int = 512                # "Nr hidden layers 512"
    n_gnn_blocks: int = 3            # Fig. 2: three graphSAGE blocks
    n_fc_blocks: int = 3             # Fig. 2: three FC blocks
    dropout: float = 0.05
    n_targets: int = N_TARGETS
    readout: str = "mean_max"        # graph-level pooling
    #: Kept so artifacts round-trip; the port ignores it. Kernel choice
    #: follows the tensor's device (``repro_torch.kernels.ops``): a CUDA
    #: tensor always runs the hand-written kernels.
    use_pallas: bool = False
    #: Legacy alias for ``layout="sparse"``.
    sparse_mp: bool = False
    #: Batch layout: ``"auto"`` (dense, or sparse when ``sparse_mp``),
    #: ``"dense"``, ``"sparse"``, or ``"packed"`` (the prediction
    #: engine's layout).
    layout: str = "auto"
    #: Inference precision policy: ``"f32"``, ``"bf16"`` (the packed
    #: engine stages its float buffer in bfloat16 and the device upcasts
    #: it; parameters and compute stay float32) or ``"int8-weights"``
    #: (artifact-level int8 weights, dequantized at load, so float32 at
    #: run time).
    precision: str = "f32"
    #: Fused message-passing policy (packed layout only): ``"auto"`` and
    #: ``"on"`` run each inference layer as one fused kernel call;
    #: ``"off"`` keeps the composed per-op layers. Training always runs
    #: the composed layers (dropout sits between their stages).
    fused_mp: str = "auto"

    @property
    def resolved_layout(self) -> str:
        """The effective batch layout: explicit ``layout`` wins; ``auto``
        follows the legacy ``sparse_mp`` flag."""
        if self.layout == "auto":
            return "sparse" if self.sparse_mp else "dense"
        if self.layout not in ("dense", "sparse", "packed"):
            raise ValueError(
                f"layout must be auto|dense|sparse|packed, "
                f"got {self.layout!r}")
        return self.layout

    @property
    def resolved_precision(self) -> str:
        """Validated inference precision policy."""
        if self.precision not in ("f32", "bf16", "int8-weights"):
            raise ValueError(
                f"precision must be f32|bf16|int8-weights, "
                f"got {self.precision!r}")
        return self.precision

    @property
    def resolved_fused(self) -> bool:
        """Whether inference runs the fused message-passing stack."""
        if self.fused_mp == "off":
            return False
        if self.fused_mp == "auto":
            return self.resolved_layout == "packed"
        if self.fused_mp == "on":
            if self.resolved_layout != "packed":
                raise ValueError(
                    "fused_mp='on' requires layout='packed' — the fused "
                    "megakernel operates on the flat packed node axis")
            return True
        raise ValueError(
            f"fused_mp must be auto|on|off, got {self.fused_mp!r}")


def check_supported(cfg: PMGNSConfig) -> None:
    """Validate ``cfg``: a known variant, layout, fused policy and
    precision (each property raises ``ValueError`` if invalid)."""
    if cfg.variant not in PORTED_VARIANTS:
        raise ValueError(f"unknown variant {cfg.variant!r}")
    _ = (cfg.resolved_layout, cfg.resolved_fused, cfg.resolved_precision)


def resolve_device(device: Union[None, str, torch.device] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller
    asks for another. Raises if CUDA is asked for and missing — the port
    never falls back to the CPU by itself.

    On the card, float32 matrix products must not round to TF32 (the FC
    head's products go to cuBLAS), so this turns TF32 off, process-wide.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "port's plain versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _layer_init(rng: np.random.Generator, variant: str, d_in: int,
                d_out: int, heads: int = GAT_HEADS) -> Params:
    if variant == "graphsage":
        return {"self": nn.linear_init(rng, d_in, d_out),
                "neigh": nn.linear_init(rng, d_in, d_out, bias=False)}
    if variant in ("gcn", "mlp"):
        return {"lin": nn.linear_init(rng, d_in, d_out)}
    if variant == "gin":
        return {"mlp": {"l0": nn.linear_init(rng, d_in, d_out),
                        "l1": nn.linear_init(rng, d_out, d_out)},
                "eps": np.zeros((), np.float32)}
    if variant == "gat":
        dh = d_out // heads
        return {"proj": nn.linear_init(rng, d_in, d_out, bias=False),
                "att_src": nn.normal_init(rng, (heads, dh)),
                "att_dst": nn.normal_init(rng, (heads, dh))}
    raise ValueError(f"unknown variant {variant!r}")


# One layer's parameters, ``repro.core.gnn``'s ``*_layer_init``: the same
# tree, shapes and dtypes, drawn by numpy from ``rng`` (a Generator or a
# seed), not by ``jax.random``.

def sage_layer_init(rng, d_in: int, d_out: int) -> Params:
    return _layer_init(np.random.default_rng(rng), "graphsage", d_in, d_out)


def gcn_layer_init(rng, d_in: int, d_out: int) -> Params:
    return _layer_init(np.random.default_rng(rng), "gcn", d_in, d_out)


def gat_layer_init(rng, d_in: int, d_out: int,
                   heads: int = GAT_HEADS) -> Params:
    return _layer_init(np.random.default_rng(rng), "gat", d_in, d_out,
                       heads)


def gin_layer_init(rng, d_in: int, d_out: int) -> Params:
    return _layer_init(np.random.default_rng(rng), "gin", d_in, d_out)


def mlp_layer_init(rng, d_in: int, d_out: int) -> Params:
    return _layer_init(np.random.default_rng(rng), "mlp", d_in, d_out)


def pmgns_init(seed: Union[int, np.random.Generator],
               cfg: PMGNSConfig) -> Params:
    """Random PMGNS parameters as a numpy pytree, drawn from ``seed``.

    The tree has the JAX package's structure and shapes; the values are
    numpy's, not ``jax.random``'s.
    """
    rng = np.random.default_rng(seed)
    p: Params = {"gnn": {}, "fc": {}}
    d = cfg.node_feat_dim
    for i in range(cfg.n_gnn_blocks):
        p["gnn"][f"b{i}"] = _layer_init(rng, cfg.variant, d, cfg.hidden)
        d = cfg.hidden
    pool_mult = 2 if cfg.readout == "mean_max" else 1
    d_in = cfg.hidden * pool_mult + cfg.static_dim
    for i in range(cfg.n_fc_blocks):
        last = i == cfg.n_fc_blocks - 1
        d_out = cfg.n_targets if last else cfg.hidden
        p["fc"][f"b{i}"] = nn.linear_init(rng, d_in, d_out)
        d_in = d_out
    return p


def _shapes(tree) -> Any:
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(np.shape(tree))


class _Tree(torch.nn.Module):
    """One level of the parameter pytree: dict keys become submodule and
    parameter names, so paths read ``gnn.b0.self.w``."""

    def __init__(self, tree: Params, device: torch.device,
                 requires_grad: bool):
        super().__init__()
        for key in sorted(tree):
            value = tree[key]
            if isinstance(value, dict):
                self.add_module(key, _Tree(value, device, requires_grad))
            else:
                t = torch.as_tensor(np.array(value, np.float32),
                                    device=device)
                self.register_parameter(
                    key, torch.nn.Parameter(t.contiguous(),
                                            requires_grad=requires_grad))

    def tree(self) -> Params:
        out: Params = dict(self._parameters)
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


class PMGNS(torch.nn.Module):
    """The PMGNS parameters on one device, with the JAX pytree's paths as
    parameter names. Build it with :func:`params_from_numpy`; with
    ``requires_grad=True`` its leaves are trainable (the trainer's), else
    frozen (inference, which also runs under ``torch.no_grad()``)."""

    def __init__(self, cfg: PMGNSConfig, params: Params,
                 device: Union[str, torch.device],
                 requires_grad: bool = False):
        super().__init__()
        check_supported(cfg)
        want = _shapes(pmgns_init(0, cfg))
        got = _shapes(params)
        if got != want:
            raise ValueError(
                f"parameter tree does not match {cfg}: expected shapes "
                f"{want}, got {got}")
        self.cfg = cfg
        dev = torch.device(device)
        self.gnn = _Tree(params["gnn"], dev, requires_grad)
        self.fc = _Tree(params["fc"], dev, requires_grad)

    def tree(self) -> Params:
        """The parameters as a nested dict of tensors (the pytree view)."""
        return {"gnn": self.gnn.tree(), "fc": self.fc.tree()}


def params_from_numpy(tree: Params, cfg: PMGNSConfig,
                      device: Union[None, str, torch.device] = None, *,
                      requires_grad: bool = False) -> PMGNS:
    """The JAX pytree (numpy leaves) → :class:`PMGNS` on ``device``
    (default ``"cuda"``; raises if CUDA is missing and ``device`` is not
    ``"cpu"``), with trainable leaves when ``requires_grad``."""
    return PMGNS(cfg, tree, resolve_device(device), requires_grad)


def params_to_numpy(model: PMGNS) -> Params:
    """:class:`PMGNS` → the JAX pytree with numpy leaves (the inverse of
    :func:`params_from_numpy`)."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return t.detach().cpu().numpy()
    return conv(model.tree())


# ---------------------------------------------------------------------------
# composed layers (training; inference off the fused path)
# ---------------------------------------------------------------------------

def _aggregate(h: torch.Tensor, mode: str, adj=None, edges=None,
               edge_mask=None) -> torch.Tensor:
    """Neighbourhood sum / mean behind SAGE, GCN and GIN: the edge-list
    kernel when ``edges`` is given, else the dense one. ``edge_mask`` may
    carry per-edge weights (GCN's normalization)."""
    if edges is not None:
        return ops.segment_aggregate(edges, edge_mask, h.contiguous(), mode)
    return ops.dense_aggregate(adj, h.contiguous(), mode)


def _gcn_norm_adj(adj: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``D^-1/2 (A + I) D^-1/2`` with masked self-loops (data only)."""
    eye = torch.eye(adj.shape[-1], dtype=adj.dtype, device=adj.device)[None]
    a = adj + eye * mask[:, :, None]
    dinv = torch.rsqrt(a.sum(dim=-1).clamp_min(1.0))
    return (a * dinv[:, :, None] * dinv[:, None, :]).contiguous()


def _in_degree(edges: torch.Tensor, edge_mask: torch.Tensor,
               n: int) -> torch.Tensor:
    """Weighted in-degree ``[B, N]`` of an edge list, through the scatter
    kernel."""
    ones = torch.ones(edge_mask.shape + (1,), dtype=edge_mask.dtype,
                      device=edge_mask.device)
    return ops.segment_scatter(edges[..., 1], edge_mask, ones, n)[..., 0]


def sage_layer(p: Params, x: torch.Tensor, adj, mask: torch.Tensor, *,
               edges=None, edge_mask=None) -> torch.Tensor:
    agg = _aggregate(x, "mean", adj=adj, edges=edges, edge_mask=edge_mask)
    y = nn.linear(p["self"], x) + nn.linear(p["neigh"], agg)
    return y * mask[..., None]


def gcn_layer(p: Params, x: torch.Tensor, adj, mask: torch.Tensor, *,
              edges=None, edge_mask=None) -> torch.Tensor:
    if edges is None:
        agg = _aggregate(x, "sum", adj=_gcn_norm_adj(adj, mask))
    else:
        # D^-1/2 (A + I) D^-1/2 @ x without forming A: the edge weight
        # dinv[dst]·dinv[src] rides in through edge_mask, and the masked
        # self-loop adds dinv²·x
        src, dst = edges[..., 0].long(), edges[..., 1].long()
        deg = _in_degree(edges, edge_mask, x.shape[1]) + mask
        dinv = torch.rsqrt(deg.clamp_min(1.0))
        w = edge_mask * torch.gather(dinv, 1, dst) * torch.gather(dinv, 1, src)
        agg = _aggregate(x, "sum", edges=edges, edge_mask=w.contiguous())
        agg = agg + (dinv * dinv * mask)[..., None] * x
    return nn.linear(p["lin"], agg) * mask[..., None]


def gat_layer(p: Params, x: torch.Tensor, adj, mask: torch.Tensor, *,
              edges=None, edge_mask=None) -> torch.Tensor:
    heads = p["att_src"].shape[0]
    z = nn.linear(p["proj"], x)                          # [B, N, D]
    b, n, d = z.shape
    zh = z.reshape(b, n, heads, d // heads)
    es = torch.einsum("bnhd,hd->bnh", zh, p["att_src"])   # source score
    ed = torch.einsum("bnhd,hd->bnh", zh, p["att_dst"])   # dest score
    if edges is not None:
        # per-edge attention [B, E, heads], not [B, N, N, heads]
        src, dst = edges[..., 0], edges[..., 1]
        s = torch.nn.functional.leaky_relu(
            ops.segment_gather(ed.contiguous(), dst)
            + ops.segment_gather(es.contiguous(), src), 0.2)
        att = ops.edge_softmax(s.contiguous(), dst.contiguous(), edge_mask, n)
        zs = ops.segment_gather(z, src)                   # [B, E, D]
        msgs = (zs.reshape(b, -1, heads, d // heads)
                * att[..., None]).reshape(b, -1, d)
        out = ops.segment_scatter(dst, edge_mask, msgs.contiguous(), n)
        return out * mask[..., None]
    # dense: e[b, i, j, h], the attention of destination i over j, with a
    # guarded denominator so an empty neighbourhood gives exact zeros
    e = torch.nn.functional.leaky_relu(ed[:, :, None, :] + es[:, None, :, :],
                                       0.2)
    neg = torch.finfo(z.dtype).min
    live = (adj > 0)[..., None]
    e = torch.where(live, e, neg)
    p_e = torch.where(live, torch.exp(e - torch.amax(e, dim=2, keepdim=True)),
                      0.0)
    denom = p_e.sum(dim=2, keepdim=True)
    att = p_e / denom.clamp_min(torch.finfo(z.dtype).tiny)
    out = torch.einsum("bijh,bjhd->bihd", att, zh).reshape(b, n, d)
    return out * mask[..., None]


def gin_layer(p: Params, x: torch.Tensor, adj, mask: torch.Tensor, *,
              edges=None, edge_mask=None) -> torch.Tensor:
    agg = _aggregate(x, "sum", adj=adj, edges=edges, edge_mask=edge_mask)
    return nn.mlp(p["mlp"], (1.0 + p["eps"]) * x + agg) * mask[..., None]


def mlp_layer(p: Params, x: torch.Tensor, adj, mask: torch.Tensor, *,
              edges=None, edge_mask=None) -> torch.Tensor:
    """No message passing — the paper's plain-MLP baseline."""
    return nn.linear(p["lin"], x) * mask[..., None]


_LAYERS = {"graphsage": sage_layer, "gcn": gcn_layer, "gat": gat_layer,
           "gin": gin_layer, "mlp": mlp_layer}


def _readout(h: torch.Tensor, mask: torch.Tensor, kind: str) -> torch.Tensor:
    """Per-graph masked mean (⊕ max) over the padded node axis:
    ``h [B, N, F]`` → ``[B, F or 2F]``. ``amax`` splits the gradient
    evenly among tied maxima, as ``jnp.max`` does."""
    m = mask[..., None]
    denom = mask.sum(dim=1, keepdim=True).clamp_min(1.0)[..., None]
    mean = ((h * m).sum(dim=1, keepdim=True) / denom)[:, 0]
    if kind == "mean":
        return mean
    mx = torch.amax(torch.where(m > 0, h, torch.finfo(h.dtype).min), dim=1)
    mx = torch.where(mask.sum(dim=1, keepdim=True) > 0, mx, 0.0)
    return torch.cat([mean, mx], dim=-1)


# ---------------------------------------------------------------------------
# packed forward
# ---------------------------------------------------------------------------

def _readout_packed(h: torch.Tensor, graph_ids: torch.Tensor,
                    node_mask: torch.Tensor, n_graphs: int,
                    kind: str) -> torch.Tensor:
    """Segment-pooled graph readout over the packed flat node axis:
    ``h [P, F]`` → ``[G, F or 2F]``."""
    return ops.segment_readout(h.contiguous(), graph_ids, node_mask,
                               n_graphs, kind=kind)


def _fused_mp_stack(p: Params, cfg: PMGNSConfig, x: torch.Tensor,
                    mask: torch.Tensor, edges: torch.Tensor,
                    edge_mask: torch.Tensor) -> torch.Tensor:
    """All GNN blocks as one fused layer call each (packed layout).

    GraphSAGE runs as ``mean``/``split``; GCN as ``sum``/``pre`` with the
    ``d̂⁻¹·d̂⁻¹`` self-loop scale and the normalization weights riding in
    through ``edge_mask`` (both depend only on the graph, so they are
    computed once, outside the loop); GIN's first MLP linear as
    ``sum``/``pre`` with scale ``1 + ε`` — its second linear stays
    outside, because its bias comes before the node mask. GAT projects
    and scores with plain products and gathers (as XLA ran them), then
    runs the edge softmax and the fused gather ⊙ attention → scatter as
    kernels over one destination-sorted CSR that the bin's layers share
    (their edges are the same); it has no self term. The MLP baseline has no message
    passing.
    """
    h = x
    blocks = [p["gnn"][f"b{i}"] for i in range(cfg.n_gnn_blocks)]
    if cfg.variant == "graphsage":
        for lp in blocks:
            h = ops.fused_mp_layer(
                h, edges, edge_mask, mask, w_neigh=lp["neigh"]["w"],
                w_self=lp["self"]["w"], bias=lp["self"].get("b"),
                mode="mean", combine="split", act="relu")
    elif cfg.variant == "gcn":
        n = x.shape[0]
        src, dst = edges[:, 0].long(), edges[:, 1].long()
        deg = segment_degree_ref(edges[None], edge_mask[None], n)[0] + mask
        dinv = torch.rsqrt(deg.clamp_min(1.0))
        w = (edge_mask * dinv[dst] * dinv[src]).contiguous()
        ss = (dinv * dinv * mask).contiguous()
        for lp in blocks:
            h = ops.fused_mp_layer(
                h, edges, w, mask, w_neigh=lp["lin"]["w"],
                bias=lp["lin"].get("b"), mode="sum", combine="pre",
                self_scale=ss, act="relu")
    elif cfg.variant == "gin":
        for lp in blocks:
            m0, m1 = lp["mlp"]["l0"], lp["mlp"]["l1"]
            r = ops.fused_mp_layer(
                h, edges, edge_mask, None, w_neigh=m0["w"], bias=m0.get("b"),
                mode="sum", combine="pre", self_scale=1.0 + lp["eps"],
                act="relu")
            h = torch.relu((r @ m1["w"] + m1["b"]) * mask[:, None])
    elif cfg.variant == "gat":
        n = x.shape[0]
        src, dst = edges[:, 0].long(), edges[:, 1].long()
        dst32 = edges[:, 1].contiguous()[None]
        csr = ops.dst_csr(dst32, n)                  # once a bin
        for lp in blocks:
            heads = lp["att_src"].shape[0]
            z = nn.linear(lp["proj"], h)                 # [P, D]
            zh = z.reshape(n, heads, -1)
            es = torch.einsum("phd,hd->ph", zh, lp["att_src"])
            ed = torch.einsum("phd,hd->ph", zh, lp["att_dst"])
            s = torch.nn.functional.leaky_relu(ed[dst] + es[src], 0.2)
            att = ops.edge_softmax(s[None], dst32, edge_mask[None], n,
                                   csr=csr)[0]
            h = torch.relu(ops.fused_gat_aggregate(z, edges, edge_mask, att,
                                                   mask, csr=csr))
    elif cfg.variant == "mlp":
        for lp in blocks:
            h = torch.relu(nn.linear(lp["lin"], h) * mask[:, None])
    else:
        check_supported(cfg)
    return h


def _tree_of(p: Union[PMGNS, Params]) -> Params:
    return p.tree() if isinstance(p, PMGNS) else p


def _leaf_device(p: Params) -> torch.device:
    while isinstance(p, dict):
        p = next(iter(p.values()))
    return p.device


def pmgns_apply(p: Union[PMGNS, Params], cfg: PMGNSConfig,
                batch: Dict[str, torch.Tensor], *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Forward pass → ``[B or G, n_targets]`` predictions in log1p space.

    ``batch`` holds tensors on the parameters' device, in the layout of
    ``cfg.resolved_layout``: dense batches carry ``adj``, sparse batches
    ``edges`` + ``edge_mask`` (``collate``), packed batches the flat
    ``x [P, F]`` / ``graph_ids`` / globally-offset ``edges [Q, 2]``
    (``collate_packed``) and return one row per graph slot. Packed
    inference with ``cfg.resolved_fused`` runs the fused layers; every
    other case runs the composed ones, the packed axis as a batch of one.
    With ``train`` and a ``generator`` (on the parameters' device),
    dropout follows each GNN block and each hidden FC block.
    """
    check_supported(cfg)
    p = _tree_of(p)
    layout = cfg.resolved_layout
    x, mask = batch["x"], batch["mask"]
    packed = layout == "packed"
    need = {"packed": ("graph_ids", "edges", "edge_mask"),
            "sparse": ("edges", "edge_mask"), "dense": ("adj",)}[layout]
    missing = [k for k in need + ("static",) if k not in batch]
    if missing:
        build = {"packed": "collate_packed(samples)",
                 "sparse": "collate(samples, sparse=True)",
                 "dense": "collate(samples)"}[layout]
        raise ValueError(f"PMGNSConfig(layout={layout!r}) needs a batch "
                         f"with {missing} — build it via {build}")
    drop = train and generator is not None
    if packed and cfg.resolved_fused and not train:
        h = _fused_mp_stack(p, cfg, x, mask, batch["edges"],
                            batch["edge_mask"])
        z = _readout_packed(h, batch["graph_ids"], mask,
                            batch["static"].shape[0], cfg.readout)
    else:
        adj = batch.get("adj") if layout == "dense" else None
        edges = batch.get("edges")
        edge_mask = batch.get("edge_mask")
        mask_mp = mask
        if packed:
            x, mask_mp = x[None], mask[None]
            edges, edge_mask = edges[None], edge_mask[None]
        layer = _LAYERS[cfg.variant]
        h = x
        for i in range(cfg.n_gnn_blocks):
            h = torch.relu(layer(p["gnn"][f"b{i}"], h, adj, mask_mp,
                                 edges=edges, edge_mask=edge_mask))
            if drop:
                h = nn.dropout(generator, h, cfg.dropout, train)
        if packed:
            z = _readout_packed(h[0], batch["graph_ids"], mask,
                                batch["static"].shape[0], cfg.readout)
        else:
            z = _readout(h, mask, cfg.readout)
    y = torch.cat([z, batch["static"]], dim=-1)          # z ⊕ F_s
    for i in range(cfg.n_fc_blocks):
        y = nn.linear(p["fc"][f"b{i}"], y)
        if i < cfg.n_fc_blocks - 1:
            y = torch.relu(y)
            if drop:
                y = nn.dropout(generator, y, cfg.dropout, train)
    return y


@torch.no_grad()
def pmgns_infer(p: Union[PMGNS, Params], cfg: PMGNSConfig,
                batch: Dict[str, Any]) -> torch.Tensor:
    """Inference: ``[B or G, n_targets]`` in physical units, on a batch
    of ``cfg.resolved_layout``.

    Runs on the parameters' device. Batch entries may be numpy arrays
    (for example ``collate_packed``'s output); they are moved there.
    """
    tree = _tree_of(p)
    dev = _leaf_device(tree)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    return decode_targets(pmgns_apply(tree, cfg, batch))


def make_infer_fn(cfg: PMGNSConfig) -> Callable[..., torch.Tensor]:
    """``(params, batch) → [B, n_targets]`` over :func:`pmgns_infer`: the
    bucketed engine's function for every dense or sparse chunk shape
    (PyTorch runs eagerly, so one closure serves them all)."""
    check_supported(cfg)

    def infer(params: Union[PMGNS, Params],
              batch: Dict[str, Any]) -> torch.Tensor:
        return pmgns_infer(params, cfg, batch)
    return infer


def packed_staging_layout(cfg: PMGNSConfig, p: int, q: int,
                          g: int) -> Tuple[int, int, int, int, int]:
    """Offsets of the flat staged packed buffers — shared by the producer
    (``PredictionEngine._stage_packed``) and the consumer
    (:func:`make_staged_packed_infer_fn`).

    Float32 buffer: ``x [P·F] ⊕ mask [P] ⊕ edge_mask [Q] ⊕
    static [G·D]``; int32 buffer: ``edges [Q·2] ⊕ graph_ids [P]``.
    Returns ``(o1, o2, o3, f_len, i_len)``.
    """
    o1 = p * cfg.node_feat_dim
    o2 = o1 + p
    o3 = o2 + q
    return o1, o2, o3, o3 + g * cfg.static_dim, 2 * q + p


def make_staged_packed_infer_fn(cfg: PMGNSConfig, p: int, q: int, g: int
                                ) -> Callable[..., torch.Tensor]:
    """Packed infer over the two flat staging buffers of one ``(P, Q, G)``
    shape: ``(params, fbuf, ibuf) → [G, n_targets]``. The buffers are
    sliced into the batch as views, with no copy.

    Under ``precision="bf16"`` the engine stages ``fbuf`` in bfloat16;
    it is upcast to float32 on its device before slicing, so compute is
    float32 and the drift is the staging's rounding alone. The
    parameters are float32 and never rounded."""
    check_supported(cfg)
    feat, sdim = cfg.node_feat_dim, cfg.static_dim
    o1, o2, o3, _, _ = packed_staging_layout(cfg, p, q, g)

    def infer(params: Union[PMGNS, Params], fbuf: torch.Tensor,
              ibuf: torch.Tensor) -> torch.Tensor:
        fbuf = fbuf.to(torch.float32)
        batch = {
            "x": fbuf[:o1].view(p, feat),
            "mask": fbuf[o1:o2],
            "edge_mask": fbuf[o2:o3],
            "static": fbuf[o3:].view(g, sdim),
            "edges": ibuf[:2 * q].view(q, 2),
            "graph_ids": ibuf[2 * q:],
        }
        return pmgns_infer(params, cfg, batch)
    return infer


# ---------------------------------------------------------------------------
# target transforms & metrics
# ---------------------------------------------------------------------------

def encode_targets(y: torch.Tensor) -> torch.Tensor:
    """physical units → log1p training space."""
    return torch.log1p(torch.clamp_min(y, 0.0))


def decode_targets(yhat: torch.Tensor) -> torch.Tensor:
    """log1p space → physical units (latency ms, energy J, memory MB)."""
    return torch.expm1(yhat)


def huber(pred: torch.Tensor, target: torch.Tensor,
          delta: float = 1.0) -> torch.Tensor:
    """Huber loss (paper Table 3) — elementwise."""
    abs_err = torch.abs(pred - target)
    quad = torch.clamp_max(abs_err, delta)
    return 0.5 * quad * quad + delta * (abs_err - quad)


def mape(pred_phys: torch.Tensor, target_phys: torch.Tensor) -> torch.Tensor:
    """Mean Absolute Percentage Error (the paper's metric), in [0, ...]."""
    denom = torch.abs(target_phys).clamp_min(1e-6)
    return torch.mean(torch.abs(pred_phys - target_phys) / denom)
