"""Kernel dispatch by the device of the tensor.

A CUDA tensor always goes to the hand-written kernel
(:mod:`repro_torch.kernels.segment_spmm`): if the kernel cannot build or
launch, the call raises, and nothing falls back to the plain version. A
CPU tensor goes to the plain version (:mod:`repro_torch.kernels.ref`),
which is how the CPU tests run the port. There is no switch between the
two other than the device, and no size limit: the kernels run at every
packed rung and every layer.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from . import ref as _ref
from . import segment_spmm as _cuda


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cuda", "cpu"):
        return t.device.type
    raise ValueError(f"no kernel for tensors on {t.device} (cuda or cpu)")


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
    :func:`repro_torch.kernels.ref.fused_mp_layer_ref`."""
    fn = (_cuda.fused_mp_layer_cuda if _route(x) == "cuda"
          else _ref.fused_mp_layer_ref)
    return fn(x, edges, edge_mask, node_mask, w_neigh=w_neigh, w_self=w_self,
              bias=bias, mode=mode, combine=combine, self_scale=self_scale,
              act=act)


def segment_readout(h: torch.Tensor, graph_ids: torch.Tensor,
                    node_mask: torch.Tensor, n_graphs: int, *,
                    kind: str = "mean_max") -> torch.Tensor:
    """Per-graph mean / mean⊕max readout — see
    :func:`repro_torch.kernels.ref.segment_readout_ref`."""
    if _route(h) == "cuda":
        return _cuda.segment_readout_cuda(h, graph_ids, node_mask, n_graphs,
                                          kind=kind)
    return _ref.segment_readout_ref(h, graph_ids, node_mask, n_graphs,
                                    kind=kind)


def edge_softmax(scores: torch.Tensor, dst: torch.Tensor,
                 edge_mask: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Per-destination softmax over incoming edges (GAT attention) — see
    :func:`repro_torch.kernels.ref.edge_softmax_ref`."""
    fn = (_cuda.edge_softmax_cuda if _route(scores) == "cuda"
          else _ref.edge_softmax_ref)
    return fn(scores, dst, edge_mask, n_nodes)


def fused_gat_aggregate(z: torch.Tensor, edges: torch.Tensor,
                        edge_mask: torch.Tensor, att: torch.Tensor,
                        node_mask: torch.Tensor) -> torch.Tensor:
    """GAT's gather ⊙ per-head attention → scatter over the packed flat
    node axis — see :func:`repro_torch.kernels.ref.fused_gat_aggregate_ref`."""
    fn = (_cuda.fused_gat_aggregate_cuda if _route(z) == "cuda"
          else _ref.fused_gat_aggregate_ref)
    return fn(z, edges, edge_mask, att, node_mask)
