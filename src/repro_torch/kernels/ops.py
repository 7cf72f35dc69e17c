"""Kernel dispatch by the device of the tensor.

A CUDA tensor always goes to the hand-written kernel
(:mod:`repro_torch.kernels.segment_spmm`, :mod:`~repro_torch.kernels.sage_spmm`):
if the kernel cannot build or launch, the call raises, and nothing falls
back to the plain version. A CPU tensor goes to the plain version
(:mod:`repro_torch.kernels.ref`), which is how the CPU tests run the
port. There is no switch between the two other than the device, and no
size limit.

The entries that training differentiates through — ``segment_aggregate``,
``segment_scatter``, ``segment_gather``, ``dense_aggregate``,
``segment_readout`` and ``edge_softmax`` — record their gradients through
:mod:`repro_torch.kernels.autograd`, whose backward passes run on
:func:`kernel` again (the readout's on ``segment_readout_backward``, a
kernel of its own). ``fused_mp_layer`` and ``fused_gat_aggregate`` are
inference only: training runs the composed layers. So are the LM stack's
``flash_attention`` and ``ssd_scan``: on either device they refuse an
input that requires grad. LM training takes :func:`flash_attention_train`
(``autograd.FlashAttention``: the forward with its log-sum-exp and the
backward kernel ``flash_attention_bwd``) and :func:`ssd_scan_train`
(``autograd.SsdScan``: the scan, then the backward kernel
``ssd_scan_bwd``).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch

from . import autograd as _ag
from . import flash_attention as _flash
from . import ref as _ref
from . import sage_spmm as _dense
from . import segment_spmm as _cuda
from . import ssd_scan as _ssd

_KERNELS = {
    "fused_mp_layer": (_cuda, _ref),
    "segment_readout": (_cuda, _ref),
    "segment_readout_backward": (_cuda, _ref),
    "edge_softmax": (_cuda, _ref),
    "fused_gat_aggregate": (_cuda, _ref),
    "segment_aggregate": (_cuda, _ref),
    "segment_scatter": (_cuda, _ref),
    "segment_gather": (_cuda, _ref),
    "dst_csr": (_cuda, _ref),
    "dense_aggregate": (_dense, _ref),
    "flash_attention": (_flash, _ref),
    "flash_attention_bwd": (_flash, _ref),
    "ssd_scan": (_ssd, _ref),
    "ssd_scan_bwd": (_ssd, _ref),
}


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cuda", "cpu"):
        return t.device.type
    raise ValueError(f"no kernel for tensors on {t.device} (cuda or cpu)")


def kernel(name: str, t: torch.Tensor) -> Callable:
    """The primitive ``name`` for the device of ``t``: the CUDA kernel's
    wrapper (``<name>_cuda``) or the plain version (``<name>_ref``). It
    records no gradient."""
    cuda_mod, ref_mod = _KERNELS[name]
    if _route(t) == "cuda":
        return getattr(cuda_mod, f"{name}_cuda")
    return getattr(ref_mod, f"{name}_ref")


def fused_mp_layer(x: torch.Tensor, edges: torch.Tensor,
                   edge_mask: torch.Tensor,
                   node_mask: Optional[torch.Tensor] = None, *,
                   w_neigh: torch.Tensor,
                   w_self: Optional[torch.Tensor] = None,
                   bias: Optional[torch.Tensor] = None, mode: str = "mean",
                   combine: str = "split",
                   self_scale: Union[None, float, torch.Tensor] = None,
                   act: str = "relu") -> torch.Tensor:
    """One message-passing layer over the packed flat node axis — see
    :func:`repro_torch.kernels.ref.fused_mp_layer_ref`. Inference only."""
    return kernel("fused_mp_layer", x)(
        x, edges, edge_mask, node_mask, w_neigh=w_neigh, w_self=w_self,
        bias=bias, mode=mode, combine=combine, self_scale=self_scale, act=act)


def fused_gat_aggregate(z: torch.Tensor, edges: torch.Tensor,
                        edge_mask: torch.Tensor, att: torch.Tensor,
                        node_mask: torch.Tensor, csr=None) -> torch.Tensor:
    """GAT's gather ⊙ per-head attention → scatter over the packed flat
    node axis — see :func:`repro_torch.kernels.ref.fused_gat_aggregate_ref`.
    ``csr``: :func:`dst_csr` of ``edges[:, 1][None]``, or None (the kernel
    builds its own). Inference only."""
    return kernel("fused_gat_aggregate", z)(z, edges, edge_mask, att,
                                            node_mask, csr=csr)


def dst_csr(dst: torch.Tensor, n_nodes: int,
            src: Optional[torch.Tensor] = None):
    """The destination-sorted CSR of ``[B, E]`` edges — see
    :func:`repro_torch.kernels.ref.dst_csr_ref`. On the card it also
    carries the arrival counters the GAT aggregate needs; built once, it
    serves every :func:`edge_softmax` and :func:`fused_gat_aggregate` call
    over the same edges (of ``dst`` alone: no ``src``)."""
    return kernel("dst_csr", dst)(dst, n_nodes, src)


def segment_readout(h: torch.Tensor, graph_ids: torch.Tensor,
                    node_mask: torch.Tensor, n_graphs: int, *,
                    kind: str = "mean_max") -> torch.Tensor:
    """Per-graph mean / mean⊕max readout — see
    :func:`repro_torch.kernels.ref.segment_readout_ref`. Differentiable
    in ``h``."""
    return _ag.SegmentReadout.apply(h, graph_ids, node_mask, n_graphs, kind)


def edge_softmax(scores: torch.Tensor, dst: torch.Tensor,
                 edge_mask: torch.Tensor, n_nodes: int,
                 csr=None) -> torch.Tensor:
    """Per-destination softmax over incoming edges (GAT attention) — see
    :func:`repro_torch.kernels.ref.edge_softmax_ref`. ``csr``:
    :func:`dst_csr` of ``dst``, or None (the kernel builds its own).
    Differentiable in ``scores``."""
    return _ag.EdgeSoftmax.apply(scores, dst, edge_mask, n_nodes, csr)


def segment_aggregate(edges: torch.Tensor, edge_mask: torch.Tensor,
                      h: torch.Tensor, mode: str = "mean") -> torch.Tensor:
    """Edge-list sum / weighted-mean aggregation ``[B, E]`` edges →
    ``[B, N, F]`` — see :func:`repro_torch.kernels.ref.segment_aggregate_ref`.
    Differentiable in ``h``."""
    return _ag.SegmentAggregate.apply(edges, edge_mask, h, mode)


def segment_scatter(dst: torch.Tensor, edge_mask: torch.Tensor,
                    msgs: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Masked scatter of per-edge messages into per-node sums — see
    :func:`repro_torch.kernels.ref.segment_scatter_ref`. Differentiable in
    ``msgs``."""
    return _ag.SegmentScatter.apply(dst, edge_mask, msgs, n_nodes)


def segment_gather(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather ``h[b, idx[b, e]]`` — see
    :func:`repro_torch.kernels.ref.segment_gather_ref`. Differentiable in
    ``h``."""
    return _ag.SegmentGather.apply(h, idx)


def dense_aggregate(adj: torch.Tensor, h: torch.Tensor,
                    mode: str = "mean") -> torch.Tensor:
    """Dense ``adj @ h`` with the degree-mean folded in — see
    :func:`repro_torch.kernels.ref.dense_aggregate_ref`. Differentiable in
    ``h``."""
    return _ag.DenseAggregate.apply(adj, h, mode)


def sage_aggregate(adj: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Batched GraphSAGE mean aggregation, ``mean_{j∈N(i)} h_j`` —
    :func:`dense_aggregate` in mean form (B7 on the card), see
    :func:`repro_torch.kernels.ref.sage_aggregate_ref`. Differentiable in
    ``h``."""
    return dense_aggregate(adj, h, "mean")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int = 0, q_offset: int = 0,
                    kv_offset: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Masked softmax attention over ``[B, S, H, D]`` with grouped kv heads
    — see :func:`repro_torch.kernels.ref.flash_attention_ref`. Inference
    only."""
    _cuda.refuse_grad("flash_attention", q, k, v)
    return kernel("flash_attention", q)(
        q, k, v, causal=causal, window=window, q_offset=q_offset,
        kv_offset=kv_offset, scale=scale)


def flash_attention_train(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool, window: int = 0,
                          q_offset: int = 0, kv_offset: int = 0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """:func:`flash_attention`, differentiable in q, k and v: the kernel
    with its log-sum-exp forward, ``flash_attention_bwd`` backward (see
    :class:`repro_torch.kernels.autograd.FlashAttention`)."""
    return _ag.FlashAttention.apply(q, k, v, causal, window, q_offset,
                                    kv_offset, scale)


#: one SSD decode step; the JAX package has no kernel for it either
ssd_decode = _ref.ssd_decode_ref


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int,
             s0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked Mamba2 SSD scan, y and the last state — see
    :func:`repro_torch.kernels.ref.ssd_scan_ref`. Inference only."""
    _cuda.refuse_grad("ssd_scan", x, dt, A, B, C, s0)
    return kernel("ssd_scan", x)(x, dt, A, B, C, chunk=chunk, s0=s0)


def ssd_scan_train(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, *, chunk: int,
                   s0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`ssd_scan`, differentiable in x, dt, A, B, C and s0: the scan
    forward, ``ssd_scan_bwd`` backward (see
    :class:`repro_torch.kernels.autograd.SsdScan`)."""
    return _ag.SsdScan.apply(x, dt, A, B, C, s0, chunk)
