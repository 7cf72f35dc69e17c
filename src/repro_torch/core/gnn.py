"""Performance Model Graph Network Structure (paper §3.4), packed inference.

The PMGNS is: 3 × GraphSAGE blocks → graph readout → ``z ⊕ F_s`` →
3 × FC blocks → 3-way multi-regression head (latency ms, energy J,
memory MB). Table 4 baselines — GCN, GAT, GIN, and a no-GNN MLP — share
the same skeleton with the message-passing layer swapped.

This is the port of the packed inference path of ``repro.core.gnn``.
A batch is the packed layout of ``repro_torch.core.batching``:

    x     [P, F]        ONE flat node axis for many graphs
    mask  [P]           node validity
    graph_ids [P]       segment id of each node's graph
    edges [Q, 2]        globally-offset block-diagonal edge list (int32)
    edge_mask [Q]       1.0 real edge / 0.0 padding
    static [G, D]       per-graph rows

Every SAGE/GCN/GIN layer is one call of
:func:`repro_torch.kernels.ops.fused_mp_layer`, every GAT layer one call
each of :func:`~repro_torch.kernels.ops.edge_softmax` and
:func:`~repro_torch.kernels.ops.fused_gat_aggregate`, and the pooling one
call of :func:`repro_torch.kernels.ops.segment_readout`: the hand-written
CUDA kernels for a CUDA tensor, their plain versions for a CPU tensor.

Parameters keep the JAX package's pytree and layout: nested dicts with
``w [d_in, d_out]`` and ``x @ w`` products. :class:`PMGNS` holds them as
an ``nn.Module`` whose parameter names are the pytree paths
(``gnn.b0.self.w``); :func:`params_from_numpy` and
:func:`params_to_numpy` convert to and from the numpy pytree that
artifacts and the JAX package use.

Targets are trained in ``log1p`` space; :func:`decode_targets` maps
predictions back to physical units.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple, Union

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
_NOT_PORTED_LAYOUT = ("repro_torch runs the packed layout only; the dense and "
                      "sparse layouts come with training (ROADMAP.md A11)")
_NOT_PORTED_COMPOSED = ("fused_mp='off' selects the composed per-op layers, "
                        "which come with training (ROADMAP.md A11)")
_NOT_PORTED_BF16 = ("precision='bf16' staging is not ported yet (ROADMAP.md "
                    "A10); use 'f32' or 'int8-weights'")


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
    #: Legacy alias for ``layout="sparse"`` (not run by this slice).
    sparse_mp: bool = False
    #: Batch layout: ``"auto"`` (dense, or sparse when ``sparse_mp``),
    #: ``"dense"``, ``"sparse"``, or ``"packed"``. The port runs
    #: ``"packed"`` only.
    layout: str = "auto"
    #: Inference precision policy: ``"f32"``, ``"bf16"`` (staging in
    #: bfloat16; not ported yet) or ``"int8-weights"`` (artifact-level
    #: int8 weights, dequantized at load, so float32 at run time).
    precision: str = "f32"
    #: Fused message-passing policy (packed layout only): ``"auto"`` and
    #: ``"on"`` run each layer as one fused kernel call; ``"off"`` keeps
    #: the composed per-op path (not ported yet).
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
    """Raise ``NotImplementedError`` for a configuration this slice does
    not run, naming the ROADMAP item that ports it."""
    if cfg.variant not in PORTED_VARIANTS:
        raise ValueError(f"unknown variant {cfg.variant!r}")
    if cfg.resolved_layout != "packed":
        raise NotImplementedError(_NOT_PORTED_LAYOUT)
    if not cfg.resolved_fused:
        raise NotImplementedError(_NOT_PORTED_COMPOSED)
    if cfg.resolved_precision == "bf16":
        raise NotImplementedError(_NOT_PORTED_BF16)


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
                d_out: int) -> Params:
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
        dh = d_out // GAT_HEADS
        return {"proj": nn.linear_init(rng, d_in, d_out, bias=False),
                "att_src": nn.normal_init(rng, (GAT_HEADS, dh)),
                "att_dst": nn.normal_init(rng, (GAT_HEADS, dh))}
    raise ValueError(f"unknown variant {variant!r}")


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

    def __init__(self, tree: Params, device: torch.device):
        super().__init__()
        for key in sorted(tree):
            value = tree[key]
            if isinstance(value, dict):
                self.add_module(key, _Tree(value, device))
            else:
                t = torch.as_tensor(np.array(value, np.float32),
                                    device=device)
                self.register_parameter(
                    key, torch.nn.Parameter(t.contiguous(),
                                            requires_grad=False))

    def tree(self) -> Params:
        out: Params = dict(self._parameters)
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


class PMGNS(torch.nn.Module):
    """The PMGNS parameters on one device, with the JAX pytree's paths as
    parameter names. Build it with :func:`params_from_numpy`."""

    def __init__(self, cfg: PMGNSConfig, params: Params,
                 device: Union[str, torch.device]):
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
        self.gnn = _Tree(params["gnn"], dev)
        self.fc = _Tree(params["fc"], dev)

    def tree(self) -> Params:
        """The parameters as a nested dict of tensors (the pytree view)."""
        return {"gnn": self.gnn.tree(), "fc": self.fc.tree()}


def params_from_numpy(tree: Params, cfg: PMGNSConfig,
                      device: Union[None, str, torch.device] = None) -> PMGNS:
    """The JAX pytree (numpy leaves) → :class:`PMGNS` on ``device``
    (default ``"cuda"``; raises if CUDA is missing and ``device`` is not
    ``"cpu"``)."""
    return PMGNS(cfg, tree, resolve_device(device))


def params_to_numpy(model: PMGNS) -> Params:
    """:class:`PMGNS` → the JAX pytree with numpy leaves (the inverse of
    :func:`params_from_numpy`)."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return t.detach().cpu().numpy()
    return conv(model.tree())


# ---------------------------------------------------------------------------
# packed forward
# ---------------------------------------------------------------------------

def _readout_packed(h: torch.Tensor, graph_ids: torch.Tensor,
                    node_mask: torch.Tensor, n_graphs: int,
                    kind: str) -> torch.Tensor:
    """Segment-pooled graph readout over the packed flat node axis:
    ``h [P, F]`` → ``[G, F or 2F]``."""
    return ops.segment_readout(h, graph_ids, node_mask, n_graphs, kind=kind)


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
    kernels; it has no self term. The MLP baseline has no message
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
        for lp in blocks:
            heads = lp["att_src"].shape[0]
            z = nn.linear(lp["proj"], h)                 # [P, D]
            zh = z.reshape(n, heads, -1)
            es = torch.einsum("phd,hd->ph", zh, lp["att_src"])
            ed = torch.einsum("phd,hd->ph", zh, lp["att_dst"])
            s = torch.nn.functional.leaky_relu(ed[dst] + es[src], 0.2)
            att = ops.edge_softmax(s[None], dst32, edge_mask[None], n)[0]
            h = torch.relu(ops.fused_gat_aggregate(z, edges, edge_mask, att,
                                                   mask))
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
                batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Packed forward pass → ``[G, n_targets]`` predictions in log1p space.

    ``batch`` is a packed batch (``collate_packed`` keys ``x``, ``mask``,
    ``graph_ids``, ``edges``, ``edge_mask``, ``static``) as tensors on the
    parameters' device.
    """
    check_supported(cfg)
    missing = [k for k in ("x", "mask", "graph_ids", "edges", "edge_mask",
                           "static") if k not in batch]
    if missing:
        raise ValueError(
            f"a packed batch needs {missing} — build it via "
            f"collate_packed(samples)")
    p = _tree_of(p)
    mask = batch["mask"]
    h = _fused_mp_stack(p, cfg, batch["x"], mask, batch["edges"],
                        batch["edge_mask"])
    z = _readout_packed(h, batch["graph_ids"], mask,
                        batch["static"].shape[0], cfg.readout)
    y = torch.cat([z, batch["static"]], dim=-1)          # z ⊕ F_s
    for i in range(cfg.n_fc_blocks):
        y = nn.linear(p["fc"][f"b{i}"], y)
        if i < cfg.n_fc_blocks - 1:
            y = torch.relu(y)
    return y


@torch.no_grad()
def pmgns_infer(p: Union[PMGNS, Params], cfg: PMGNSConfig,
                batch: Dict[str, Any]) -> torch.Tensor:
    """Packed inference: ``[G, n_targets]`` in physical units.

    Runs on the parameters' device. Batch entries may be numpy arrays
    (for example ``collate_packed``'s output); they are moved there.
    """
    tree = _tree_of(p)
    dev = _leaf_device(tree)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    return decode_targets(pmgns_apply(tree, cfg, batch))


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
    sliced into the batch as views, with no copy."""
    check_supported(cfg)
    feat, sdim = cfg.node_feat_dim, cfg.static_dim
    o1, o2, o3, _, _ = packed_staging_layout(cfg, p, q, g)

    def infer(params: Union[PMGNS, Params], fbuf: torch.Tensor,
              ibuf: torch.Tensor) -> torch.Tensor:
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
# target transforms
# ---------------------------------------------------------------------------

def encode_targets(y: torch.Tensor) -> torch.Tensor:
    """physical units → log1p training space."""
    return torch.log1p(torch.clamp_min(y, 0.0))


def decode_targets(yhat: torch.Tensor) -> torch.Tensor:
    """log1p space → physical units (latency ms, energy J, memory MB)."""
    return torch.expm1(yhat)
