"""Python wrappers around the hand-written CUDA kernels.

* :func:`fused_mp_layer_cuda` — one whole message-passing layer
  (``csrc/fused_mp.cu``), the port of ``fused_mp_layer_pallas``.
* :func:`segment_readout_cuda` — per-graph mean / mean⊕max pooling
  (``csrc/segment_readout.cu``), the port of ``segment_readout_pallas``,
  on the route :func:`readout_plan` names; :func:`segment_readout_backward_cuda`
  is its gradient, one launch of the same source.
* :func:`edge_softmax_cuda` — per-destination softmax of GAT's edge
  scores (``csrc/edge_softmax.cu``), the port of ``edge_softmax_pallas``.
* :func:`fused_gat_aggregate_cuda` — GAT's gather ⊙ attention → scatter
  (``csrc/gat_aggregate.cu``), the port of ``fused_gat_aggregate_pallas``.
  Both run over a destination-sorted CSR of the edges that
  :func:`dst_csr_cuda` builds: the caller's, shared by a bin's layers, or
  one the call builds itself.
* :func:`segment_aggregate_cuda` — weighted edge-list sum/mean
  aggregation over ``[B, E]`` edges (``csrc/segment_aggregate.cu``), the
  port of ``segment_aggregate_pallas``.
* :func:`segment_scatter_cuda` — masked scatter of per-edge messages
  (same source), the port of ``segment_scatter_pallas``. Both sum over a
  destination-sorted CSR that the call builds on the card
  (``csrc/dst_csr.cuh``; :func:`dst_csr_cuda` builds it alone), on the
  route :func:`segment_plan` picks.
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
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from . import build

_INT32_MAX = 2**31 - 1
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "fused_mp_edge_phase": ("fused_mp", [_P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "fused_mp_node_phase": ("fused_mp", [_P, _P, _P, _P, _I, _P, _P, _P, _P,
                                         _P, _I, _I, _I, _I, _I, _I, _P,
                                         _P]),
    "fused_mp_scratch_words": ("fused_mp", [_I, _I, _I]),
    "segment_readout": ("segment_readout",
                        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "segment_readout_backward": ("segment_readout",
                                 [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _P]),
    "edge_softmax": ("edge_softmax",
                     [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "fused_gat_aggregate": ("gat_aggregate",
                            [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                             _I, _I, _I, _I, _P]),
    "fused_gat_aggregate_scratch_words": ("gat_aggregate", [_I, _I], _L),
    "segment_scatter": ("segment_aggregate",
                        [_P, _P, _P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I,
                         _I, _I, _I, _P, _P]),
    "segment_scatter_scratch_words": ("segment_aggregate", [_I] * 5, _L),
    "dst_csr": ("segment_aggregate",
                [_P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _P]),
    "dst_csr_counter_words": ("segment_aggregate", [_I] * 3, _L),
    "segment_gather": ("segment_aggregate",
                       [_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P]),
    "dense_aggregate": ("dense_aggregate",
                        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "dense_aggregate_scratch_ints": ("dense_aggregate", [_I, _I]),
    "flash_attention": ("flash_attention",
                        [_P] * 6 + [_I] * 8 + [ctypes.c_float] + [_I] * 8
                        + [_P]),
    "flash_attention_bwd": ("flash_attention_bwd",
                            [_P] * 11 + [_I] * 8 + [ctypes.c_float]
                            + [_I] * 5 + [_P]),
    "flash_attention_bwd_smem": ("flash_attention_bwd", [_I] * 4),
    "flash_attention_bwd_occupancy": ("flash_attention_bwd", [_I] * 4
                                      + [_P]),
    "ssd_scan_smem": ("ssd_scan", [_I, _I, _I, _I]),
    "ssd_scan_occupancy": ("ssd_scan", [_I, _I, _I, _I, _P]),
    "ssd_scan": ("ssd_scan", [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _I, _I, _I, _P]),
    "ssd_scan_bwd_smem": ("ssd_scan_bwd", [_I, _I, _I]),
    "ssd_scan_bwd_chunk": ("ssd_scan_bwd", [_I]),
    "ssd_scan_bwd_heads": ("ssd_scan_bwd", [_I, _I, _I]),
    "ssd_scan_bwd_occupancy": ("ssd_scan_bwd", [_I] * 4 + [_P]),
    "ssd_scan_bwd": ("ssd_scan_bwd", [_P] * 21 + [_I] * 7 + [_P]),
}
#: what each wrapper's autograd refusal tells the caller to use instead
_GRAD_ENTRY = {
    "fused_mp_layer": "nothing: it is inference only; training runs the "
                      "composed layers through ops.segment_aggregate",
    "fused_gat_aggregate": "nothing: it is inference only; training runs "
                           "the composed GAT layer through "
                           "ops.segment_scatter",
    "segment_readout": "ops.segment_readout",
    "segment_readout_backward": "nothing: it is the gradient of "
                                "ops.segment_readout, which records none",
    "edge_softmax": "ops.edge_softmax",
    "segment_aggregate": "ops.segment_aggregate",
    "segment_scatter": "ops.segment_scatter",
    "segment_gather": "ops.segment_gather",
    "dense_aggregate": "ops.dense_aggregate",
    "flash_attention": "ops.flash_attention_train (ops.flash_attention is "
                       "inference only)",
    "flash_attention_bwd": "nothing: it is the gradient of "
                           "ops.flash_attention_train, which records none",
    "ssd_scan": "ops.ssd_scan_train (ops.ssd_scan is inference only)",
    "ssd_scan_bwd": "nothing: it is the gradient of ops.ssd_scan_train, "
                    "which records none",
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
                # a third item: the return type, where it is not a
                # cudaError_t
                lib_name, argtypes, *restype = _SIGNATURES[name]
                fn = getattr(build.load(lib_name), name)
                fn.argtypes = argtypes
                fn.restype = restype[0] if restype else ctypes.c_int
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


#: the readout's routes (``csrc/segment_readout.cu``) and their counter
#: slots: the packed layout's sorted prefix of real rows, or any layout
READOUT_ROUTES = {"runs": 0, "general": 1}
#: the order the readout adds in on the runs route: a graph of at most
#: READOUT_WINDOW rows is one warp's sum in ascending row order; a longer
#: one is cut into min(READOUT_WARPS, ceil(n / READOUT_WINDOW)) pieces of
#: equal length (the last shorter), each summed in ascending order, and the
#: pieces are added in order. The general route adds a graph's rows in
#: ascending order, one warp a graph.
READOUT_WINDOW, READOUT_WARPS = 16, 16
_readout_counters: dict = {}


def readout_plan(graph_ids, node_mask) -> str:
    """The readout's route for these rows, as the kernel decides it on the
    card: ``"runs"`` where the real rows (``node_mask > 0``) form a prefix
    whose graph ids do not decrease, as ``collate_packed`` lays a bin out;
    else ``"general"``. numpy arrays or tensors; a statement of the rule,
    not a switch: the kernel checks it itself."""
    def host(a):
        return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
    # the kernel's key of a row: its id where it is real, else INT_MIN
    key = np.where(host(node_mask) > 0, host(graph_ids).astype(np.int32),
                   np.iinfo(np.int32).min)
    n_real = int((key != np.iinfo(np.int32).min).sum())
    prefix = key[:n_real]
    ok = bool(np.all(prefix != np.iinfo(np.int32).min)
              and np.all(prefix[1:] >= prefix[:-1]))
    return "runs" if ok else "general"


def _route_counter(dev: torch.device) -> torch.Tensor:
    """The device's readout route counters (forward runs, general; backward
    runs, general), made zero on first use; the kernel adds to them."""
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    counter = _readout_counters.get(key)
    if counter is None:
        with _bind_lock:
            counter = _readout_counters.get(key)
            if counter is None:
                counter = torch.zeros((4,), dtype=torch.int64,
                                      device=torch.device("cuda", key))
                _readout_counters[key] = counter
    return counter


def readout_route_counts(device=None) -> dict:
    """The launches of the readout and its gradient on each route on
    ``device`` (default: the current one) since the process began. Reading
    waits for the device; the wrappers never read them."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    n = _route_counter(dev).tolist()
    return {"forward": dict(zip(READOUT_ROUTES, n[:2])),
            "backward": dict(zip(READOUT_ROUTES, n[2:]))}


def _readout_checks(h, graph_ids, node_mask, n_graphs: int, kind: str):
    if kind not in ("mean", "mean_max"):
        raise ValueError(f"kind must be 'mean' or 'mean_max', got {kind!r}")
    dev = _cuda_device(h)
    if h.dim() != 2:
        raise ValueError(f"h must be [P, F], got shape {tuple(h.shape)}")
    p, f = h.shape
    g = int(n_graphs)
    if g < 0:
        raise ValueError(f"n_graphs must be ≥ 0, got {g}")
    # the kernel counts (graph, 128-column tile) pairs in 32 bits
    _check_dims(P=p, F=2 * f, G=g, PF=p * f, GF=2 * g * f,
                pairs=g * -(-f // 128))
    _check(h, "h", torch.float32, (p, f), dev)
    _check(graph_ids, "graph_ids", torch.int32, (p,), dev)
    _check(node_mask, "node_mask", torch.float32, (p,), dev)
    return dev, p, f, g


def segment_readout_cuda(h: torch.Tensor, graph_ids: torch.Tensor,
                         node_mask: torch.Tensor, n_graphs: int, *,
                         kind: str = "mean_max") -> torch.Tensor:
    """Per-graph pooled readout on the card (``csrc/segment_readout.cu``).

    h: [P, F] float32; graph_ids: [P] int32; node_mask: [P] float32.
    Returns [G, F] (``kind="mean"``) or [G, 2F] (``"mean_max"``); a graph
    with no real nodes reads out as zeros, and the max keeps a NaN of a
    real row. One launch, each output element written once, on the route
    :func:`readout_plan` names (the kernel checks the rows itself and adds
    to :func:`readout_route_counts`); the same bits run to run. ``G = 0``
    or ``F = 0`` returns without a launch.
    """
    refuse_grad("segment_readout", h, node_mask)
    dev, p, f, g = _readout_checks(h, graph_ids, node_mask, n_graphs, kind)
    want_max = kind == "mean_max"
    with torch.cuda.device(dev):
        out = torch.empty((g, 2 * f if want_max else f), dtype=torch.float32,
                          device=dev)
        if not (g and f):
            return out
        stream = torch.cuda.current_stream(dev).cuda_stream
        _call("segment_readout", _ptr(h), _ptr(graph_ids), _ptr(node_mask),
              _ptr(out), _ptr(_route_counter(dev)), p, f, g, int(want_max),
              int(_vec(f, h)), stream)
    _count(segment_readout_cuda)
    return out


segment_readout_cuda.launches = 0


def segment_readout_backward_cuda(h: torch.Tensor, graph_ids: torch.Tensor,
                                  node_mask: torch.Tensor, z: torch.Tensor,
                                  g: torch.Tensor, *,
                                  kind: str = "mean_max") -> torch.Tensor:
    """The readout's gradient in h on the card (``csrc/segment_readout.cu``).

    h, graph_ids, node_mask: the forward's inputs; z: its output and g the
    incoming gradient, both [G, F] (``kind="mean"``) or [G, 2F]. Returns
    dh [P, F]: ``w·g_mean / max(cnt, 1)`` plus, on the real rows that hold
    their graph's max (column by column), ``g_max / max(ties, 1)``; 0 on
    the rows of no graph. See
    :func:`repro_torch.kernels.ref.segment_readout_backward_ref`. One
    launch, each element written once, on the forward's route; no CSR, no
    other kernel. ``P = 0`` or ``F = 0`` returns without a launch.
    """
    refuse_grad("segment_readout_backward", h, node_mask, z, g)
    if not isinstance(z, torch.Tensor):
        raise TypeError(f"z must be a torch.Tensor, got {type(z).__name__}")
    dev, p, f, n = _readout_checks(h, graph_ids, node_mask, z.shape[0], kind)
    want_max = kind == "mean_max"
    width = 2 * f if want_max else f
    _check(z, "z", torch.float32, (n, width), dev)
    _check(g, "g", torch.float32, (n, width), dev)
    with torch.cuda.device(dev):
        dh = torch.empty((p, f), dtype=torch.float32, device=dev)
        if not (p and f):
            return dh
        stream = torch.cuda.current_stream(dev).cuda_stream
        _call("segment_readout_backward", _ptr(h), _ptr(graph_ids),
              _ptr(node_mask), _ptr(z), _ptr(g), _ptr(dh),
              _ptr(_route_counter(dev)), p, f, n, int(want_max),
              int(_vec(f, h, z, g)), stream)
    _count(segment_readout_backward_cuda)
    return dh


segment_readout_backward_cuda.launches = 0


def edge_softmax_cuda(scores: torch.Tensor, dst: torch.Tensor,
                      edge_mask: torch.Tensor, n_nodes: int,
                      csr=None) -> torch.Tensor:
    """Per-destination softmax over incoming edges on the card
    (``csrc/edge_softmax.cu``).

    scores: [B, E, H] float32; dst: [B, E] int32; edge_mask: [B, E]
    float32; csr: the :class:`DstCsr` of ``dst`` alone
    (``dst_csr_cuda(dst, n_nodes)``), or None to build it here. Returns
    [B, E, H] weights summing to 1 over each destination's real incoming
    edges; a destination with none gives exact zeros. ``E = 0`` returns
    zeros without a launch. One launch over the CSR (two C calls when the
    call builds its own); ``csr_launches`` counts the calls on a shared
    CSR and on their own beside ``launches``.
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
    _check_dims(B=b, E=e, H=h, N=n, BEH=b * e * h, BN=b * (n + 1))
    f32 = torch.float32
    _check(scores, "scores", f32, (b, e, h), dev)
    _check(dst, "dst", torch.int32, (b, e), dev)
    _check(edge_mask, "edge_mask", f32, (b, e), dev)
    if csr is not None:
        _check_csr(csr, b, n, e, dev, counters=False)
    if e == 0:
        return torch.zeros_like(scores)
    with torch.cuda.device(dev):
        own = csr is None
        if own:
            csr = dst_csr_cuda(dst, n)
        out = torch.empty((b, e, h), dtype=f32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _call("edge_softmax", _ptr(scores), _ptr(dst), _ptr(edge_mask),
              _ptr(csr[0]), _ptr(csr[1]), _ptr(out), b, e, h, n, stream)
    with _count_lock:
        edge_softmax_cuda.launches += 1
        edge_softmax_cuda.csr_launches["own" if own else "shared"] += 1
    return out


edge_softmax_cuda.launches = 0
edge_softmax_cuda.csr_launches = {"shared": 0, "own": 0}


#: the GAT aggregate's routes (``csrc/gat_aggregate.cu``) and their C
#: numbers: a warp a row, lanes along the features in floats or in float4s
GAT_ROUTES = {"wide_scalar": 1, "wide_vec": 2}
#: the orders the GAT kernels add in, as their sources fix them: a row of
#: at most GAT_CHUNK entries is one warp's sum; a longer one is cut into
#: chunks of that many (``csrc/seg_chunks.cuh``), added in groups of
#: GAT_GROUP. An edge-softmax segment of at most SOFTMAX_SHORT entries is
#: one thread's sum; a longer one is SOFTMAX_BLOCK threads' tree
#: (``csrc/edge_softmax.cu``).
GAT_CHUNK, GAT_GROUP = 32, 16
SOFTMAX_SHORT, SOFTMAX_BLOCK = 8, 256


class GatPlan(NamedTuple):
    """The GAT aggregate's route and its units (floats or float4s) a lane
    a column tile (1, 2, 4 or 8)."""
    route: str
    units_per_lane: int


def gat_plan(d: int, h: int, aligned: bool) -> GatPlan:
    """The GAT aggregate's plan for ``d = h · dh`` features.

    ``"wide_vec"`` where a lane's float4 lies in one head and loads whole:
    ``dh`` a multiple of 4 and ``aligned`` (z starts on a 16-byte
    boundary); else ``"wide_scalar"``. Shapes and alignment decide alone;
    a launch that is refused raises.
    """
    route = "wide_vec" if (d // h) % 4 == 0 and aligned else "wide_scalar"
    per_lane = -(-(d // 4 if route == "wide_vec" else d) // 32)
    return GatPlan(route, next((v for v in (1, 2, 4) if per_lane <= v), 8))


def fused_gat_aggregate_cuda(z: torch.Tensor, edges: torch.Tensor,
                             edge_mask: torch.Tensor, att: torch.Tensor,
                             node_mask: torch.Tensor,
                             csr=None) -> torch.Tensor:
    """GAT's post-softmax gather ⊙ attention → scatter on the card
    (``csrc/gat_aggregate.cu``).

    z: [P, D] float32 (D = H·dh); edges: [Q, 2] int32 globally offset
    (src, dst); edge_mask: [Q]; att: [Q, H]; node_mask: [P]; csr: the
    :class:`DstCsr` of the edges' destinations
    (``dst_csr_cuda(edges[:, 1][None], P)``), or None to build it here.
    Returns [P, D]. ``Q = 0`` returns zeros without a launch; ``D % H !=
    0`` raises. One launch on :func:`gat_plan`'s route that writes each
    output row once (two C calls when the call builds its own CSR);
    ``route_launches`` and ``csr_launches`` count the calls of each route
    and on a shared CSR or their own beside ``launches``.
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
    cells = -(-q // GAT_CHUNK)
    _check_dims(P=p, D=d, Q=q, H=h, PD=p * d, QH=q * h, W=2 * cells * d)
    f32 = torch.float32
    _check(z, "z", f32, (p, d), dev)
    _check(edges, "edges", torch.int32, (q, 2), dev)
    _check(edge_mask, "edge_mask", f32, (q,), dev)
    _check(att, "att", f32, (q, h), dev)
    _check(node_mask, "node_mask", f32, (p,), dev)
    if csr is not None:
        _check_csr(csr, 1, p, q, dev, counters=True)
    with torch.cuda.device(dev):
        if q == 0 or p == 0:
            return torch.zeros((p, d), dtype=f32, device=dev)
        own = csr is None
        if own:
            csr = dst_csr_cuda(edges[:, 1][None], p)
        plan = gat_plan(d, h, z.data_ptr() % 16 == 0)
        out = torch.empty((p, d), dtype=f32, device=dev)
        part = torch.empty(
            (_entry("fused_gat_aggregate_scratch_words")(q, d),),
            dtype=f32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _call("fused_gat_aggregate", _ptr(z), _ptr(edges), _ptr(edge_mask),
              _ptr(att), _ptr(node_mask), _ptr(csr.rowptr), _ptr(csr.perm),
              _ptr(csr.counters), _ptr(part), _ptr(out), p, d, q, h,
              GAT_ROUTES[plan.route], plan.units_per_lane, stream)
    with _count_lock:
        fused_gat_aggregate_cuda.launches += 1
        fused_gat_aggregate_cuda.route_launches[plan.route] += 1
        fused_gat_aggregate_cuda.csr_launches["own" if own else "shared"] += 1
    return out


fused_gat_aggregate_cuda.launches = 0
fused_gat_aggregate_cuda.route_launches = dict.fromkeys(GAT_ROUTES, 0)
fused_gat_aggregate_cuda.csr_launches = {"shared": 0, "own": 0}


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


#: the segmented sum's routes (``csrc/segment_aggregate.cu``) and their C
#: numbers: a thread a row of at most 8 floats, or a warp a row with lanes
#: along the features in floats or in float4s
SEGMENT_ROUTES = {"narrow": 0, "wide_scalar": 1, "wide_vec": 2}
#: edges one worker sums on each route; a longer segment is cut into chunks
#: of this many, summed by workers of their own and added in chunk order
SEGMENT_CHUNK = {"narrow": 16, "wide_scalar": 32, "wide_vec": 32}


class SegmentPlan(NamedTuple):
    """The segmented sum's route, its units (floats or float4s) a lane a
    column tile on the wide routes (1, 2, 4 or 8; 0 on ``narrow``), its
    chunk, and whether a segment of the largest degree is cut into chunks."""
    route: str
    units_per_lane: int
    chunk: int
    split: bool


def segment_plan(f: int, max_degree: int, aligned: bool) -> SegmentPlan:
    """The segmented sum's plan for rows of ``f`` floats whose largest
    segment holds at most ``max_degree`` edges (``E`` where nothing better
    is known).

    ``"narrow"`` for ``f ≤ 8``; else ``"wide_vec"`` where float4 loads
    stage whole rows (``f`` a multiple of 4 and ``aligned``: the message
    rows start on 16-byte boundaries), or ``"wide_scalar"``. Shapes and
    alignment decide alone; a launch that is refused raises.
    """
    if f <= 8:
        route, units = "narrow", 0
    else:
        route = "wide_vec" if f % 4 == 0 and aligned else "wide_scalar"
        per_lane = -(-(f // 4 if route == "wide_vec" else f) // 32)
        units = next((v for v in (1, 2, 4) if per_lane <= v), 8)
    chunk = SEGMENT_CHUNK[route]
    return SegmentPlan(route, units, chunk, max_degree > chunk)


def _scatter(fn, dev, h, msgs, src, dst, em, b: int, e: int, n: int,
             f: int, mean: bool, want_deg: bool):
    """The ``segment_scatter`` C call (the CSR build, then the sum, each
    output element written once) into fresh outputs, counted on ``fn`` and
    on its route; nothing is launched (or counted) when there is no edge,
    since the sums are then zero and a mean divides them by 1."""
    s_stride = 1 if src is None else _check_index(src, "src", b, e, dev)
    d_stride = _check_index(dst, "dst", b, e, dev)
    with torch.cuda.device(dev):
        if not (b * e * f and n):
            out = torch.zeros((b, n, f), dtype=torch.float32, device=dev)
            deg = (torch.zeros((b, n), dtype=torch.float32, device=dev)
                   if want_deg else None)
            return out, deg
        out = torch.empty((b, n, f), dtype=torch.float32, device=dev)
        deg = (torch.empty((b, n), dtype=torch.float32, device=dev)
               if want_deg else None)
        plan = segment_plan(f, e, _vec(f, h, msgs))
        code = SEGMENT_ROUTES[plan.route]
        scratch = torch.empty(
            (_entry("segment_scatter_scratch_words")(b, n, e, f, code),),
            dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _call("segment_scatter", _ptr(h), _ptr(msgs), _ptr(src), s_stride,
              _ptr(dst), d_stride, _ptr(em), _ptr(out), _ptr(deg),
              int(mean), b, n, e, f, code, plan.units_per_lane,
              _ptr(scratch), stream)
    with _count_lock:
        fn.launches += 1
        fn.route_launches[plan.route] += 1
    return out, deg


def segment_aggregate_cuda(edges: torch.Tensor, edge_mask: torch.Tensor,
                           h: torch.Tensor, mode: str = "mean", *,
                           return_degree: bool = False):
    """Edge-list aggregation on the card (``csrc/segment_aggregate.cu``):
    ``out[b, i] = agg_{e: dst_e=i} edge_mask_e · h[b, src_e]``.

    edges: [B, E, 2] int32 (src, dst); edge_mask: [B, E] float32 (may
    carry weights); h: [B, N, F] float32. ``mode="mean"`` divides by the
    weighted in-degree ``max(Σ edge_mask, 1)``. Returns [B, N, F], or
    ``(out, deg [B, N])`` with ``return_degree``. Two launches: the
    destination-sorted CSR, then the sum on :func:`segment_plan`'s route,
    which reads ``h[src]`` rows, divides in registers and writes each row
    once; ``route_launches`` counts the calls of each route beside
    ``launches``. ``E = 0`` gives zeros (and a zero degree) without a
    launch.
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
segment_aggregate_cuda.route_launches = dict.fromkeys(SEGMENT_ROUTES, 0)


def segment_scatter_cuda(dst: torch.Tensor, edge_mask: torch.Tensor,
                         msgs: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Scatter per-edge messages on the card (``csrc/segment_aggregate.cu``):
    ``out[b, i] = Σ_{e: dst_e=i} edge_mask_e · msgs[b, e]``.

    dst: [B, E] int32 (a column view of ``[B, E, 2]`` edges is taken
    without a copy); edge_mask: [B, E] float32; msgs: [B, E, F] float32.
    Returns [B, N, F]. Two launches, as :func:`segment_aggregate_cuda`'s,
    counted per route in ``route_launches``; ``E = 0`` gives zeros without
    a launch.
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
segment_scatter_cuda.route_launches = dict.fromkeys(SEGMENT_ROUTES, 0)


class DstCsr(NamedTuple):
    """A destination-sorted CSR built on the card (:func:`dst_csr_cuda`):
    ``rowptr`` [B, N + 1] and ``perm`` [B, E] as
    :func:`repro_torch.kernels.ref.dst_csr_ref` returns them, and
    ``counters``, the zeroed arrival counters of its segments longer than
    ``GAT_CHUNK`` entries, which the GAT aggregate counts its window pieces
    on and leaves at 0. The calls that share one CSR run in stream
    order."""
    rowptr: torch.Tensor
    perm: torch.Tensor
    counters: torch.Tensor


def _check_csr(csr, b: int, n: int, e: int, dev: torch.device,
               counters: bool) -> None:
    """Check a CSR passed to a kernel: rowptr [B, N + 1] and perm [B, E]
    int32 on the card, and (``counters``) a :class:`DstCsr`'s counters."""
    if not isinstance(csr, (tuple, list)) or len(csr) < 2:
        raise TypeError(f"csr must be the DstCsr of dst_csr_cuda, got "
                        f"{type(csr).__name__}")
    _check(csr[0], "csr rowptr", torch.int32, (b, n + 1), dev)
    _check(csr[1], "csr perm", torch.int32, (b, e), dev)
    if counters:
        if not isinstance(csr, DstCsr):
            raise TypeError("csr must be the DstCsr of dst_csr_cuda: the "
                            "GAT aggregate counts on its zeroed counters")
        words = _entry("dst_csr_counter_words")(b, n, e)
        _check(csr.counters, "csr counters", torch.int32, (words,), dev)


def dst_csr_cuda(dst: torch.Tensor, n_nodes: int,
                 src: Optional[torch.Tensor] = None) -> DstCsr:
    """The destination-sorted CSR that the segmented sums build, alone, on
    the card (``csrc/dst_csr.cuh``, one launch): for each batch row a stable
    counting sort of the edge indices by destination.

    dst: [B, E] int32 (a column view of ``[B, E, 2]`` edges is taken
    without a copy); src: [B, E] int32 or None. Returns a :class:`DstCsr`:
    row b's edges into d are ``perm[b, rowptr[b, d]:rowptr[b, d + 1]]``,
    ascending, and ``perm[b, k] = -1`` for ``k ≥ rowptr[b, N]``. An edge
    with an endpoint outside [0, N) is in no segment. See
    :func:`repro_torch.kernels.ref.dst_csr_ref`. The GAT kernels take it
    built from ``dst`` alone.
    """
    dev = _cuda_device(dst)
    if dst.dim() != 2:
        raise ValueError(f"dst must be [B, E], got shape {tuple(dst.shape)}")
    b, e = dst.shape
    n = int(n_nodes)
    if n < 0:
        raise ValueError(f"n_nodes must be ≥ 0, got {n}")
    _check_dims(B=b, N=n, E=e, BN=b * (n + 1), BE=b * e)
    d_stride = _check_index(dst, "dst", b, e, dev)
    s_stride = 1 if src is None else _check_index(src, "src", b, e, dev)
    with torch.cuda.device(dev):
        rowptr = torch.empty((b, n + 1), dtype=torch.int32, device=dev)
        perm = torch.empty((b, e), dtype=torch.int32, device=dev)
        counters = torch.empty(
            (_entry("dst_csr_counter_words")(b, n, e),), dtype=torch.int32,
            device=dev)
        if b == 0:
            return DstCsr(rowptr, perm, counters)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _call("dst_csr", _ptr(dst), d_stride, _ptr(src), s_stride,
              _ptr(rowptr), _ptr(perm), _ptr(counters), b, n, e, stream)
    _count(dst_csr_cuda)
    return DstCsr(rowptr, perm, counters)


dst_csr_cuda.launches = 0


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
