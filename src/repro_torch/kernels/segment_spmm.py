"""Python wrappers around the hand-written CUDA kernels of the packed path.

* :func:`fused_mp_layer_cuda` — one whole message-passing layer
  (``csrc/fused_mp.cu``), the port of ``fused_mp_layer_pallas``.
* :func:`segment_readout_cuda` — per-graph mean / mean⊕max pooling
  (``csrc/segment_readout.cu``), the port of ``segment_readout_pallas``.
* :func:`edge_softmax_cuda` — per-destination softmax of GAT's edge
  scores (``csrc/edge_softmax.cu``), the port of ``edge_softmax_pallas``.
* :func:`fused_gat_aggregate_cuda` — GAT's gather ⊙ attention → scatter
  (``csrc/gat_aggregate.cu``), the port of ``fused_gat_aggregate_pallas``.

Semantics are exactly those of :mod:`repro_torch.kernels.ref`. Each
wrapper takes CUDA tensors only: it checks device, dtype (float32, int32
indices), shape and contiguity and raises on anything else, allocates
outputs and scratch with ``torch.empty`` / ``torch.zeros``, launches on
the current stream, and raises if the C entry returns a non-zero
``cudaError_t``. Choosing between a kernel and its plain version by
device is :mod:`repro_torch.kernels.ops`' job.

Each wrapper carries a plain integer ``launches``: one per call that
launched its kernel, counted under a lock because the engine's
``run_bin`` is called from several threads. ``chip_smoke.py`` zeroes it
before the main path and reads it after.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Union

import torch

from . import build

_INT32_MAX = 2**31 - 1
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fused_mp_edge_phase": ("fused_mp", [_P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "fused_mp_node_phase": ("fused_mp", [_P, _P, _P, _P, _I, _P, _P, _P, _P,
                                         _P, _I, _I, _I, _I, _I, _I, _P]),
    "segment_readout_accumulate": ("segment_readout",
                                   [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "segment_readout_finalize": ("segment_readout",
                                 [_P, _P, _P, _P, _I, _I, _P]),
    "edge_softmax": ("edge_softmax",
                     [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "fused_gat_aggregate": ("gat_aggregate",
                            [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
}
_bind_lock = threading.Lock()
_count_lock = threading.Lock()
_bound: dict = {}


def _entry(name: str):
    """The C entry ``name`` with its argument types declared."""
    fn = _bound.get(name)
    if fn is None:
        with _bind_lock:
            fn = _bound.get(name)
            if fn is None:
                lib_name, argtypes = _SIGNATURES[name]
                fn = getattr(build.load(lib_name), name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _bound[name] = fn
    return fn


def _call(name: str, *args) -> None:
    rc = _entry(name)(*args)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} was not launched: "
                           f"cudaError_t {rc}")


def _check(t, what: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what} must be a torch.Tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _cuda_device(x) -> torch.device:
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        where = x.device if isinstance(x, torch.Tensor) else type(x).__name__
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {where}")
    return x.device


def _check_dims(**dims: int) -> None:
    for name, v in dims.items():
        if v > _INT32_MAX:
            raise ValueError(f"{name}={v} exceeds the kernel's int32 range")


def fused_mp_layer_cuda(x: torch.Tensor, edges: torch.Tensor,
                        edge_mask: torch.Tensor,
                        node_mask: Optional[torch.Tensor] = None, *,
                        w_neigh: torch.Tensor,
                        w_self: Optional[torch.Tensor] = None,
                        bias: Optional[torch.Tensor] = None,
                        mode: str = "mean", combine: str = "split",
                        self_scale: Union[None, float, torch.Tensor] = None,
                        act: str = "relu") -> torch.Tensor:
    """One packed message-passing layer on the card (``csrc/fused_mp.cu``).

    x: [P, F] float32; edges: [Q, 2] int32 globally offset (src, dst);
    edge_mask: [Q] float32 (may carry GCN weights); node_mask: [P] or
    None; w_neigh / w_self: [F, H]; bias: [H] or None; self_scale for
    ``combine="pre"``: None (1), a Python number, a 0-d tensor, or a [P]
    tensor. Returns [P, H]. Two launches: the edge scatter (skipped when
    Q = 0) and the node-phase product with its epilogue.
    """
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    if combine not in ("split", "pre"):
        raise ValueError(f"combine must be 'split' or 'pre', got {combine!r}")
    if act not in ("relu", "none"):
        raise ValueError(f"act must be 'relu' or 'none', got {act!r}")
    dev = _cuda_device(x)
    if x.dim() != 2:
        raise ValueError(f"x must be [P, F], got shape {tuple(x.shape)}")
    p, f = x.shape
    if edges.dim() != 2 or edges.shape[-1] != 2:
        raise ValueError(f"edges must be [Q, 2], got {tuple(edges.shape)}")
    q = edges.shape[0]
    if w_neigh.dim() != 2:
        raise ValueError(f"w_neigh must be [F, H], got {tuple(w_neigh.shape)}")
    h = w_neigh.shape[1]
    _check_dims(P=p, Q=q, F=2 * f, H=h)
    f32 = torch.float32
    _check(x, "x", f32, (p, f), dev)
    _check(edges, "edges", torch.int32, (q, 2), dev)
    _check(edge_mask, "edge_mask", f32, (q,), dev)
    if node_mask is not None:
        _check(node_mask, "node_mask", f32, (p,), dev)
    _check(w_neigh, "w_neigh", f32, (f, h), dev)
    if bias is not None:
        _check(bias, "bias", f32, (h,), dev)
    split = combine == "split"
    ss, ss_stride = None, 0
    if split:
        if w_self is None:
            raise ValueError("combine='split' requires w_self")
        _check(w_self, "w_self", f32, (f, h), dev)
    elif isinstance(self_scale, torch.Tensor):
        if self_scale.dim() == 0:
            ss = self_scale.reshape(1)
            _check(ss, "self_scale", f32, (1,), dev)
        else:
            ss, ss_stride = self_scale, 1
            _check(ss, "self_scale", f32, (p,), dev)
    else:
        ss = torch.full((1,), 1.0 if self_scale is None else float(self_scale),
                        dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        agg = torch.zeros((p, f), dtype=f32, device=dev)
        deg = torch.zeros((p,), dtype=f32, device=dev) if mode == "mean" else None
        out = torch.empty((p, h), dtype=f32, device=dev)
        if q:
            _call("fused_mp_edge_phase", _ptr(x), _ptr(edges), _ptr(edge_mask),
                  _ptr(agg), _ptr(deg), p, f, q, stream)
        w_self = w_self if split else None
        # float4 loads need rows of whole float4s on 16-byte aligned bases
        vec = f % 4 == 0 and h % 4 == 0 and all(
            t.data_ptr() % 16 == 0 for t in (x, agg, w_neigh, w_self)
            if t is not None)
        _call("fused_mp_node_phase", _ptr(x), _ptr(agg), _ptr(deg), _ptr(ss),
              ss_stride, _ptr(w_self), _ptr(w_neigh), _ptr(bias),
              _ptr(node_mask), _ptr(out), p, f, h, int(split),
              int(act == "relu"), int(vec), stream)
    with _count_lock:
        fused_mp_layer_cuda.launches += 1
    return out


fused_mp_layer_cuda.launches = 0


def segment_readout_cuda(h: torch.Tensor, graph_ids: torch.Tensor,
                         node_mask: torch.Tensor, n_graphs: int, *,
                         kind: str = "mean_max") -> torch.Tensor:
    """Per-graph pooled readout on the card (``csrc/segment_readout.cu``).

    h: [P, F] float32; graph_ids: [P] int32; node_mask: [P] float32.
    Returns [G, F] (``kind="mean"``) or [G, 2F] (``"mean_max"``); a graph
    with no real nodes reads out as zeros. Two launches: accumulate and
    finalize.
    """
    if kind not in ("mean", "mean_max"):
        raise ValueError(f"kind must be 'mean' or 'mean_max', got {kind!r}")
    dev = _cuda_device(h)
    if h.dim() != 2:
        raise ValueError(f"h must be [P, F], got shape {tuple(h.shape)}")
    p, f = h.shape
    g = int(n_graphs)
    if g < 0:
        raise ValueError(f"n_graphs must be ≥ 0, got {g}")
    _check_dims(P=p, F=2 * f, G=g)
    f32 = torch.float32
    _check(h, "h", f32, (p, f), dev)
    _check(graph_ids, "graph_ids", torch.int32, (p,), dev)
    _check(node_mask, "node_mask", f32, (p,), dev)
    want_max = kind == "mean_max"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        sums = torch.zeros((g, f), dtype=f32, device=dev)
        cnt = torch.zeros((g,), dtype=f32, device=dev)
        mx = (torch.full((g, f), torch.finfo(f32).min, dtype=f32, device=dev)
              if want_max else None)
        out = torch.empty((g, 2 * f if want_max else f), dtype=f32, device=dev)
        _call("segment_readout_accumulate", _ptr(h), _ptr(graph_ids),
              _ptr(node_mask), _ptr(sums), _ptr(cnt), _ptr(mx), p, f, g, stream)
        _call("segment_readout_finalize", _ptr(sums), _ptr(cnt), _ptr(mx),
              _ptr(out), f, g, stream)
    with _count_lock:
        segment_readout_cuda.launches += 1
    return out


segment_readout_cuda.launches = 0


def edge_softmax_cuda(scores: torch.Tensor, dst: torch.Tensor,
                      edge_mask: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Per-destination softmax over incoming edges on the card
    (``csrc/edge_softmax.cu``).

    scores: [B, E, H] float32; dst: [B, E] int32; edge_mask: [B, E]
    float32. Returns [B, E, H] weights summing to 1 over each
    destination's real incoming edges; a destination with none gives
    exact zeros. ``E = 0`` returns zeros without a launch. One C call of
    four launches (scratch init, max, exp, normalize).
    """
    dev = _cuda_device(scores)
    if scores.dim() != 3:
        raise ValueError(f"scores must be [B, E, H], got shape "
                         f"{tuple(scores.shape)}")
    b, e, h = scores.shape
    n = int(n_nodes)
    if n < 0:
        raise ValueError(f"n_nodes must be ≥ 0, got {n}")
    _check_dims(B=b, E=e, H=h, N=n)
    f32 = torch.float32
    _check(scores, "scores", f32, (b, e, h), dev)
    _check(dst, "dst", torch.int32, (b, e), dev)
    _check(edge_mask, "edge_mask", f32, (b, e), dev)
    if e == 0:
        return torch.zeros_like(scores)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        out = torch.empty((b, e, h), dtype=f32, device=dev)
        mx = torch.empty((b * n * h,), dtype=torch.int32, device=dev)
        den = torch.empty((b * n * h,), dtype=f32, device=dev)
        _call("edge_softmax", _ptr(scores), _ptr(dst), _ptr(edge_mask),
              _ptr(out), _ptr(mx), _ptr(den), b, e, h, n, stream)
    with _count_lock:
        edge_softmax_cuda.launches += 1
    return out


edge_softmax_cuda.launches = 0


def fused_gat_aggregate_cuda(z: torch.Tensor, edges: torch.Tensor,
                             edge_mask: torch.Tensor, att: torch.Tensor,
                             node_mask: torch.Tensor) -> torch.Tensor:
    """GAT's post-softmax gather ⊙ attention → scatter on the card
    (``csrc/gat_aggregate.cu``).

    z: [P, D] float32 (D = H·dh); edges: [Q, 2] int32 globally offset
    (src, dst); edge_mask: [Q]; att: [Q, H]; node_mask: [P]. Returns
    [P, D]. ``Q = 0`` returns zeros without a launch; ``D % H != 0``
    raises. One launch into a zeroed output.
    """
    dev = _cuda_device(z)
    if z.dim() != 2:
        raise ValueError(f"z must be [P, D], got shape {tuple(z.shape)}")
    p, d = z.shape
    if att.dim() != 2:
        raise ValueError(f"att must be [Q, H], got shape {tuple(att.shape)}")
    q, h = att.shape
    if h <= 0 or d % h:
        raise ValueError(f"head count {h} must divide feature dim {d}")
    _check_dims(P=p, D=d, Q=q, H=h)
    f32 = torch.float32
    _check(z, "z", f32, (p, d), dev)
    _check(edges, "edges", torch.int32, (q, 2), dev)
    _check(edge_mask, "edge_mask", f32, (q,), dev)
    _check(att, "att", f32, (q, h), dev)
    _check(node_mask, "node_mask", f32, (p,), dev)
    with torch.cuda.device(dev):
        out = torch.zeros((p, d), dtype=f32, device=dev)
        if q == 0:
            return out
        stream = torch.cuda.current_stream(dev).cuda_stream
        _call("fused_gat_aggregate", _ptr(z), _ptr(edges), _ptr(edge_mask),
              _ptr(att), _ptr(node_mask), _ptr(out), p, d, q, h, stream)
    with _count_lock:
        fused_gat_aggregate_cuda.launches += 1
    return out


fused_gat_aggregate_cuda.launches = 0
