"""Python wrappers around the hand-written CUDA kernels.

* :func:`fused_mp_layer_cuda` — one whole message-passing layer
  (``csrc/fused_mp.cu``), the port of ``fused_mp_layer_pallas``.
* :func:`segment_readout_cuda` — per-graph mean / mean⊕max pooling
  (``csrc/segment_readout.cu``), the port of ``segment_readout_pallas``.
* :func:`edge_softmax_cuda` — per-destination softmax of GAT's edge
  scores (``csrc/edge_softmax.cu``), the port of ``edge_softmax_pallas``.
* :func:`fused_gat_aggregate_cuda` — GAT's gather ⊙ attention → scatter
  (``csrc/gat_aggregate.cu``), the port of ``fused_gat_aggregate_pallas``.
* :func:`segment_aggregate_cuda` — weighted edge-list sum/mean
  aggregation over ``[B, E]`` edges (``csrc/segment_aggregate.cu``), the
  port of ``segment_aggregate_pallas``.
* :func:`segment_scatter_cuda` — masked scatter of per-edge messages
  (same source), the port of ``segment_scatter_pallas``.
* :func:`segment_gather_cuda` — weighted row gather (same source), the
  port of the gather half ``_seg_gather_kernel``; the backward passes of
  :mod:`repro_torch.kernels.autograd` run on it.
* ``dense_aggregate_cuda`` in :mod:`repro_torch.kernels.sage_spmm` — the
  port of ``dense_aggregate_pallas``, with its helpers from here.
* ``flash_attention_cuda`` (:mod:`repro_torch.kernels.flash_attention`)
  and ``ssd_scan_cuda`` (:mod:`repro_torch.kernels.ssd_scan`) — the LM
  stack's kernels, bound through the entries here.

Semantics are exactly those of :mod:`repro_torch.kernels.ref`. Each
wrapper takes CUDA tensors only: it checks device, dtype (float32, int32
indices), shape and contiguity and raises on anything else, allocates
outputs and scratch with ``torch.empty`` / ``torch.zeros``, launches on
the current stream, and raises if the C entry returns a non-zero
``cudaError_t``. Choosing between a kernel and its plain version by
device is :mod:`repro_torch.kernels.ops`' job.

A launch writes into a fresh tensor, which has no ``grad_fn``. So each
wrapper raises ``RuntimeError`` when grad mode is on and a floating
input requires grad, naming the entry of :mod:`repro_torch.kernels.ops`
that records the gradient (through :mod:`repro_torch.kernels.autograd`);
a wrapper never returns a silently detached result.

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
                                         _P, _I, _I, _I, _I, _I, _I, _P,
                                         _P]),
    "fused_mp_scratch_words": ("fused_mp", [_I, _I, _I]),
    "segment_readout_accumulate": ("segment_readout",
                                   [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "segment_readout_finalize": ("segment_readout",
                                 [_P, _P, _P, _P, _I, _I, _P]),
    "edge_softmax": ("edge_softmax",
                     [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "fused_gat_aggregate": ("gat_aggregate",
                            [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "segment_scatter": ("segment_aggregate",
                        [_P, _P, _P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I,
                         _I, _I, _P]),
    "segment_gather": ("segment_aggregate",
                       [_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P]),
    "dense_aggregate": ("dense_aggregate",
                        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "dense_aggregate_scratch_ints": ("dense_aggregate", [_I, _I]),
    "flash_attention": ("flash_attention",
                        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         ctypes.c_float, _I, _I, _I, _I, _I, _I, _I, _I,
                         _P]),
    "ssd_scan_smem": ("ssd_scan", [_I, _I, _I, _I]),
    "ssd_scan_occupancy": ("ssd_scan", [_I, _I, _I, _I, _P]),
    "ssd_scan": ("ssd_scan", [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _I, _I, _I, _P]),
}
#: what each wrapper's autograd refusal tells the caller to use instead
_GRAD_ENTRY = {
    "fused_mp_layer": "nothing: it is inference only; training runs the "
                      "composed layers through ops.segment_aggregate",
    "fused_gat_aggregate": "nothing: it is inference only; training runs "
                           "the composed GAT layer through "
                           "ops.segment_scatter",
    "segment_readout": "ops.segment_readout",
    "edge_softmax": "ops.edge_softmax",
    "segment_aggregate": "ops.segment_aggregate",
    "segment_scatter": "ops.segment_scatter",
    "segment_gather": "ops.segment_gather",
    "dense_aggregate": "ops.dense_aggregate",
    "flash_attention": "nothing: it is inference only; LM training waits "
                       "for ROADMAP A14b",
    "ssd_scan": "nothing: it is inference only; LM training waits for "
                "ROADMAP A14b",
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


def refuse_grad(name: str, *tensors) -> None:
    """Raise if ``name``'s launch would drop autograd history: grad mode
    is on and a floating input requires grad."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.is_floating_point()
            and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}_cuda launches into a fresh tensor and records no "
            f"autograd history, but an input requires grad; use "
            f"{_GRAD_ENTRY[name]} (repro_torch.kernels.ops), or call it "
            f"under torch.no_grad()")


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


#: the node phase's two kernels (``csrc/fused_mp.cu``): the float32 product
#: on the tensor cores in a 3×TF32 split, and the float32 SGEMM on the FMA
#: pipes with scalar loads; their C route numbers
FUSED_MP_ROUTES = {"tf32x3": 1, "fma": 0}


def fused_mp_plan(f: int, h: int, aligned: bool) -> str:
    """The node-phase kernel of a layer of ``f`` inputs and ``h`` outputs.

    ``"tf32x3"`` where its 16-byte asynchronous copies stage whole rows:
    ``f`` and ``h`` multiples of 4, and ``aligned`` (x, agg and the
    weights start on 16-byte boundaries). Otherwise ``"fma"``. Shapes and
    alignment decide alone; a launch that is refused raises.
    """
    return "tf32x3" if f % 4 == 0 and h % 4 == 0 and aligned else "fma"


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
    tensor. Returns [P, H]. The edge scatter (skipped when Q = 0), then
    the node-phase product with its epilogue on the kernel that
    :func:`fused_mp_plan` picks (the tensor-core route first splits and
    transposes the weights into scratch, a launch of its own);
    ``route_launches`` counts the calls of each route beside ``launches``.
    """
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    if combine not in ("split", "pre"):
        raise ValueError(f"combine must be 'split' or 'pre', got {combine!r}")
    if act not in ("relu", "none"):
        raise ValueError(f"act must be 'relu' or 'none', got {act!r}")
    refuse_grad("fused_mp_layer", x, edge_mask, node_mask, w_neigh, w_self,
                bias, self_scale)
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
    # the tensor-core route's scratch: the weights split, 2 x 2F x H words
    _check_dims(P=p, Q=q, F=2 * f, H=h, W=4 * (f + 32) * h)
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
        route = fused_mp_plan(f, h, all(
            t.data_ptr() % 16 == 0 for t in (x, agg, w_neigh, w_self)
            if t is not None))
        # the tensor-core route's weights, split and transposed
        scratch = None if route == "fma" else torch.empty(
            (_entry("fused_mp_scratch_words")(f, h, int(split)),),
            dtype=torch.int32, device=dev)
        _call("fused_mp_node_phase", _ptr(x), _ptr(agg), _ptr(deg), _ptr(ss),
              ss_stride, _ptr(w_self), _ptr(w_neigh), _ptr(bias),
              _ptr(node_mask), _ptr(out), p, f, h, int(split),
              int(act == "relu"), FUSED_MP_ROUTES[route], _ptr(scratch),
              stream)
    with _count_lock:
        fused_mp_layer_cuda.launches += 1
        fused_mp_layer_cuda.route_launches[route] += 1
    return out


fused_mp_layer_cuda.launches = 0
fused_mp_layer_cuda.route_launches = dict.fromkeys(FUSED_MP_ROUTES, 0)


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
    refuse_grad("segment_readout", h, node_mask)
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
    refuse_grad("edge_softmax", scores, edge_mask)
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
    refuse_grad("fused_gat_aggregate", z, edge_mask, att, node_mask)
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


def _count(fn) -> None:
    with _count_lock:
        fn.launches += 1


def _check_index(t, what: str, b: int, e: int, dev: torch.device) -> int:
    """Check an int32 index view of shape [B, E] whose rows are contiguous
    up to one element stride (a column of an ``[B, E, 2]`` edge array);
    returns that stride."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what} must be a torch.Tensor, got {type(t).__name__}")
    if t.device != dev:
        raise ValueError(f"{what} is on {t.device}, expected {dev}")
    if t.dtype != torch.int32:
        raise TypeError(f"{what} must be torch.int32, got {t.dtype}")
    if tuple(t.shape) != (b, e):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected "
                         f"{(b, e)}")
    if e > 1:
        stride = t.stride(1)
        if b > 1 and t.stride(0) != e * stride:
            raise ValueError(f"{what} must be a strided view of a contiguous "
                             f"[B, E, k] array")
    elif e == 1 and b > 1:
        stride = t.stride(0)
    else:
        return 1                      # at most one element is read
    if stride < 1:
        raise ValueError(f"{what} has element stride {stride}")
    return int(stride)


def _vec(f: int, *rows) -> bool:
    """float4 loads need rows of whole float4s on 16-byte aligned bases
    (the outputs are fresh allocations, aligned)."""
    return f % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in rows
                              if t is not None)


def _scatter(fn, dev, h, msgs, src, dst, em, b: int, e: int, n: int,
             f: int, mean: bool, want_deg: bool):
    """Zeroed outputs, then the ``segment_scatter`` C call, counted on
    ``fn``; nothing is launched (or counted) when there is no edge, since
    the sums are then zero and a mean divides them by 1."""
    s_stride = 1 if src is None else _check_index(src, "src", b, e, dev)
    d_stride = _check_index(dst, "dst", b, e, dev)
    with torch.cuda.device(dev):
        out = torch.zeros((b, n, f), dtype=torch.float32, device=dev)
        deg = (torch.zeros((b, n), dtype=torch.float32, device=dev)
               if mean or want_deg else None)
        if b * e * f and n:
            stream = torch.cuda.current_stream(dev).cuda_stream
            _call("segment_scatter", _ptr(h), _ptr(msgs), _ptr(src), s_stride,
                  _ptr(dst), d_stride, _ptr(em), _ptr(out), _ptr(deg),
                  int(mean), b, n, e, f, int(_vec(f, h, msgs)), stream)
            _count(fn)
    return out, deg


def segment_aggregate_cuda(edges: torch.Tensor, edge_mask: torch.Tensor,
                           h: torch.Tensor, mode: str = "mean", *,
                           return_degree: bool = False):
    """Edge-list aggregation on the card (``csrc/segment_aggregate.cu``):
    ``out[b, i] = agg_{e: dst_e=i} edge_mask_e · h[b, src_e]``.

    edges: [B, E, 2] int32 (src, dst); edge_mask: [B, E] float32 (may
    carry weights); h: [B, N, F] float32. ``mode="mean"`` divides by the
    weighted in-degree ``max(Σ edge_mask, 1)``. Returns [B, N, F], or
    ``(out, deg [B, N])`` with ``return_degree``. One fused
    gather-scatter launch, plus the division in mean mode; ``E = 0``
    gives zeros (and a zero degree) without a launch.
    """
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    refuse_grad("segment_aggregate", h, edge_mask)
    dev = _cuda_device(h)
    if h.dim() != 3:
        raise ValueError(f"h must be [B, N, F], got shape {tuple(h.shape)}")
    b, n, f = h.shape
    if edges.dim() != 3 or edges.shape[-1] != 2:
        raise ValueError(f"edges must be [B, E, 2], got {tuple(edges.shape)}")
    e = edges.shape[1]
    _check_dims(B=b, N=n, E=e, F=f, BNF=b * n * f, BEF=b * e * f)
    _check(h, "h", torch.float32, (b, n, f), dev)
    _check(edges, "edges", torch.int32, (b, e, 2), dev)
    _check(edge_mask, "edge_mask", torch.float32, (b, e), dev)
    out, deg = _scatter(segment_aggregate_cuda, dev, h, None, edges[..., 0],
                        edges[..., 1], edge_mask, b, e, n, f, mode == "mean",
                        return_degree)
    return (out, deg) if return_degree else out


segment_aggregate_cuda.launches = 0


def segment_scatter_cuda(dst: torch.Tensor, edge_mask: torch.Tensor,
                         msgs: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Scatter per-edge messages on the card (``csrc/segment_aggregate.cu``):
    ``out[b, i] = Σ_{e: dst_e=i} edge_mask_e · msgs[b, e]``.

    dst: [B, E] int32 (a column view of ``[B, E, 2]`` edges is taken
    without a copy); edge_mask: [B, E] float32; msgs: [B, E, F] float32.
    Returns [B, N, F]. One launch into a zeroed output; ``E = 0`` gives
    zeros without a launch.
    """
    refuse_grad("segment_scatter", msgs, edge_mask)
    dev = _cuda_device(msgs)
    if msgs.dim() != 3:
        raise ValueError(f"msgs must be [B, E, F], got shape "
                         f"{tuple(msgs.shape)}")
    b, e, f = msgs.shape
    n = int(n_nodes)
    if n < 0:
        raise ValueError(f"n_nodes must be ≥ 0, got {n}")
    _check_dims(B=b, N=n, E=e, F=f, BNF=b * n * f, BEF=b * e * f)
    _check(msgs, "msgs", torch.float32, (b, e, f), dev)
    _check(edge_mask, "edge_mask", torch.float32, (b, e), dev)
    out, _ = _scatter(segment_scatter_cuda, dev, None, msgs, None, dst,
                      edge_mask, b, e, n, f, False, False)
    return out


segment_scatter_cuda.launches = 0


def segment_gather_cuda(h: torch.Tensor, idx: torch.Tensor,
                        w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted row gather on the card (``csrc/segment_aggregate.cu``):
    ``out[b, e] = w[b, e] · h[b, idx[b, e]]``.

    h: [B, N, F] float32; idx: [B, E] int32 (a column view of edges is
    taken without a copy); w: [B, E] float32 or None (weight 1). Returns
    [B, E, F]; ``E = 0`` returns an empty tensor without a launch.
    """
    refuse_grad("segment_gather", h, w)
    dev = _cuda_device(h)
    if h.dim() != 3:
        raise ValueError(f"h must be [B, N, F], got shape {tuple(h.shape)}")
    b, n, f = h.shape
    if idx.dim() != 2 or idx.shape[0] != b:
        raise ValueError(f"idx must be [B, E] with B={b}, got "
                         f"{tuple(idx.shape)}")
    e = idx.shape[1]
    _check_dims(B=b, N=n, E=e, F=f, BNF=b * n * f, BEF=b * e * f)
    _check(h, "h", torch.float32, (b, n, f), dev)
    stride = _check_index(idx, "idx", b, e, dev)
    if w is not None:
        _check(w, "w", torch.float32, (b, e), dev)
    with torch.cuda.device(dev):
        out = torch.empty((b, e, f), dtype=torch.float32, device=dev)
        if b * e * f == 0:
            return out
        stream = torch.cuda.current_stream(dev).cuda_stream
        _call("segment_gather", _ptr(h), _ptr(idx), stride, _ptr(w),
              _ptr(out), b, n, e, f, int(_vec(f, h)), stream)
    _count(segment_gather_cuda)
    return out


segment_gather_cuda.launches = 0
