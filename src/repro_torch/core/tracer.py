"""ATen graph → OpGraph frontend — the port's counterpart of
``repro.core.tracer``.

The reference lowers a *jaxpr*; the port lowers the ATen graph that
``torch.fx.experimental.proxy_tensor.make_fx`` records when it runs
``fn(params, *data)`` on tensors of the ``meta`` device: shapes and
dtypes flow, nothing is allocated and no kernel runs. Both walks build
the same :class:`~repro_torch.core.ir.OpGraph`:

* **Parameter attribution** — the leaves of the first argument (the
  parameter pytree) and any tensor constant the callable closes over are
  weights; a compute node's ``param_bytes`` is the bytes of its weight
  inputs, with weight-ness carried through layout ops.
* **Per-node costs** from shapes (:func:`_node_costs`, the counterpart of
  the reference's ``_eqn_costs``): FLOPs, MACs and ``bytes_accessed`` =
  input bytes + output bytes.
* **Layout ops** (views, permutes, copies, padding, creation ops) are kept
  as raw nodes for connectivity, as the raw-node rule below says, and
  contracted by :func:`~repro_torch.core.ir.filter_and_preprocess`; an
  op the table does not know becomes ``elementwise``.
* **Scalar constants** — a rank-0 tensor made from no tensor (``full``,
  ``zeros``, ``scalar_tensor``, a rank-0 closure constant) stands for the
  jaxpr's literal: it has no node and its bytes are not counted.

Lowering table (``_ATEN_MAP``, by ATen op name without overload):

==========================================================  ==============
``mm``, ``bmm``, ``addmm``, ``baddbmm``,                    ``dense`` (1)
``dot_general`` (``core.prims``)
``convolution``                                             ``conv`` (2)
``add``, ``sub``, ``rsub``                                  ``add``
``mul`` / ``div``                                           ``mul`` / ``div``
``relu``, ``maximum``, ``minimum``, ``clamp_min``,          ``relu``
``clamp_max``
``exp``, ``log``, ``log1p``, ``expm1``                      ``exp``
``tanh``                                                    ``tanh``
``sigmoid``, ``erf``, ``gelu``                              ``gelu``
``sum``, ``amax``, ``amin``, ``mean``, ``argmax``,          ``reduce`` (3)
``cumsum``, ``sort``, ``topk``, ``top_k`` (``core.prims``)
``max_pool2d_with_indices``, ``avg_pool2d``                 ``pool``
``index_select``, ``gather``, ``embedding``                 ``gather``
``scatter*``, ``index_add``, ``index_put``                  ``scatter``
views, ``permute``, ``expand``, ``cat``, ``slice``,         layout
``constant_pad_nd``, ``_to_copy``, ``clone``, ``detach``,
``repeat``, ``iota`` (``core.prims``)
``stack`` (and any other op the table does not know)        ``elementwise``
``scan_ys`` (``core.prims``)                                none (4)
==========================================================  ==============

(1) ``addmm`` / ``baddbmm`` emit a ``dense`` node and an ``add`` node of
the bias, as the reference's ``x @ w + b`` is ``dot_general`` + ``add``;
``dot_general`` is the primitive itself: ``contract_k`` the product of
its contracting dims, ``batch_dims`` the number of its batch dims;
a ``convolution`` with a bias likewise emits ``conv`` + ``add``.
(2) MACs = output elements × kernel area × ``weight.shape[1]`` (input
channels per group). (3) ``sort``, ``topk`` and ``top_k`` cost n·log₂n.
A multi-output op (``max_pool2d_with_indices``) counts its first output's
bytes and shape only, but ``top_k`` counts the bytes of both outputs,
as ``lax.top_k``'s one equation has both as outvars. (4) No
node: the result has its last operand's origin (the raw-node rule
below); only the LM graph forms call it.

Raw-node rule. The reference keeps one raw node per jaxpr equation, at
the equation's shape, and ``meta["n_raw_nodes"]`` and the shapes enter
the graph's fingerprint (so the labels' noise and the dataset split).
The port records what the jaxpr of the same program holds; ATen adds
layout steps of its own and leaves some of jnp's implicit:

==============================================  ========================
ATen nodes                                      raw nodes (shape)
==============================================  ========================
a compute op                                    1 (+1 ``add`` of a bias)
each operand of a pointwise op whose rank is    +1 ``broadcast_in_dim``
at least 1 and below the output's               (jnp's rank promotion)
a reduction with ``keepdim``                    1 at the reduced shape
                                                +1 ``broadcast_in_dim``
``permute(0,3,1,2)`` [``constant_pad_nd``] →    0, 1, 0: the window op at
conv / pool → ``permute(0,2,3,1)``              its NHWC shape and window
``view`` → ``mm`` → ``view`` over the rows of   0, 1, 0: the product at
an N-D input (``matmul``, ``F.linear``)         its N-D shape
``matmul``'s ``permute`` / ``transpose``,       0 each, 1, 0: the product
same-shape ``expand``, ``clone`` and batch-     at its N-D shape with
merging view → ``bmm`` → view                   N - 2 batch dims
a view, reshape or ``expand`` to its input's    0 (``lax.reshape``
own shape                                       returns its operand)
``clone``, ``contiguous``, ``alias``,           0 (``_REF_EQNS``)
``lift_fresh_copy``
``select`` (an integer index)                   2: slice + squeeze
``index`` by rank-0 integer tensors (a          2: dynamic_slice +
traced index)                                   squeeze
``index_select``, ``embedding``, ``gather``,     +1 ``broadcast_in_dim``
``index_add`` (jnp's ``take``,                   of the index to [..., 1]
``take_along_axis``, ``.at[i].add``)            before the gather or
                                                scatter
``unbind`` (a ``lax.scan``'s per-step slices    0: each slice has its
of its stacked xs: the layers' weights)         stack's origin, a
                                                weight at its bytes
``scan_ys`` (``core.prims``: a scan's stacked    0: its last operand's
ys)                                             origin (the reference
                                                hands the last replica's
                                                value on); of literals,
                                                a value of no node
``alias`` of a literal (the literal bound to    0: a value of no node
an inlined jit's argument)                      whose bytes count
any other layout op (``detach`` is              1
``stop_gradient``, ``_to_copy`` is
``convert_element_type``)
==============================================  ========================

A graph form that is to trace to a jaxpr writes each equation as the
op this table counts for it (``repro_torch.models.graph_form``): a
scan's stack is read with ``unbind``, since an integer ``select`` of a
weight is a real slice + squeeze in the jaxpr (``_causal_dwconv``'s
``w[i]``), and its ys are stacked with ``core.prims.scan_ys``, since an
``aten.stack`` is a node with an edge from every operand.

A ``from_torch`` model that runs its own NCHW convolutions keeps its
NCHW shapes: only the permute pair above is folded.
"""
from __future__ import annotations

import math
import operator
from typing import Any, Dict, List, Optional, Tuple

import torch

from .ir import OpGraph, OpNode, dtype_bytes, filter_and_preprocess

# ---------------------------------------------------------------------------
# ATen op → canonical op mapping
# ---------------------------------------------------------------------------

_ATEN_MAP: Dict[str, str] = {
    "mm": "dense", "bmm": "dense", "addmm": "dense", "baddbmm": "dense",
    "dot_general": "dense",
    "convolution": "conv",
    "add": "add", "sub": "add", "rsub": "add",
    "mul": "mul",
    "div": "div",
    "relu": "relu", "maximum": "relu", "minimum": "relu",
    "clamp_min": "relu", "clamp_max": "relu",
    "exp": "exp", "log": "exp", "log1p": "exp", "expm1": "exp",
    "tanh": "tanh",
    "sigmoid": "gelu", "erf": "gelu", "gelu": "gelu",
    "sum": "reduce", "amax": "reduce", "amin": "reduce", "mean": "reduce",
    "argmax": "reduce", "cumsum": "reduce", "sort": "reduce",
    "topk": "reduce", "top_k": "reduce",
    "max_pool2d_with_indices": "pool", "avg_pool2d": "pool",
    "index_select": "gather", "gather": "gather", "embedding": "gather",
    "scatter": "scatter", "scatter_add": "scatter",
    "scatter_reduce": "scatter", "index_add": "scatter",
    "index_put": "scatter",
}

#: ops that only move, view or make data: raw nodes kept for
#: connectivity, contracted by the filter pass
_LAYOUT_ATEN = {
    "view", "_unsafe_view", "reshape", "t", "transpose", "permute",
    "expand", "unsqueeze", "squeeze", "flatten", "unflatten", "alias",
    "as_strided", "cat", "slice", "select", "split", "split_with_sizes",
    "unbind", "constant_pad_nd", "_to_copy", "clone", "contiguous",
    "detach", "lift_fresh_copy", "copy", "repeat", "flip",
    "full", "full_like", "zeros", "zeros_like", "ones", "ones_like",
    "empty", "empty_like", "scalar_tensor", "arange", "new_zeros",
    "new_ones", "new_full", "new_empty", "iota",
}

#: layout ops that add other than one raw node: the jaxpr equations
#: of the same step (the rest of the raw-node rule is in the module
#: docstring)
_REF_EQNS: Dict[str, int] = {
    "clone": 0, "contiguous": 0, "alias": 0, "lift_fresh_copy": 0,
    "select": 2,             # an integer index: lax.slice + squeeze
    "index": 2,              # by scalar tensors: dynamic_slice + squeeze
    "unbind": 0,             # a scan's per-step slices of its xs
}

#: gathers and scatter-adds whose index operand jnp first broadcasts to
#: [..., 1] (``take``, ``take_along_axis``, ``.at[i].add``), with the index
#: operand's position
_GATHER_INDEX = {"index_select": 2, "embedding": 1, "gather": 2,
                 "index_add": 2}

#: multi-output ops whose bytes count every output (``lax.top_k``)
_ALL_OUTPUT_BYTES = {"top_k"}

#: window ops a channels-last trace wraps in permutes (``_fold_window``)
_WINDOW_ATEN = ("convolution", "max_pool2d_with_indices", "avg_pool2d")

#: canonical ops that do not broadcast their operands the jnp way
_NOT_POINTWISE = {"dense", "conv", "reduce", "pool", "gather", "scatter"}

#: reductions whose third argument is ``keepdim``
_KEEPDIM_ATEN = {"sum", "amax", "amin", "mean", "argmax"}

#: products whose first argument is a bias, which the reference writes as
#: a product + ``add``
_BIAS_PRODUCTS = {"addmm", "baddbmm"}

_POINTWISE_COST = {
    "add": 1.0, "mul": 1.0, "div": 4.0, "relu": 1.0, "gelu": 10.0,
    "tanh": 8.0, "exp": 8.0, "elementwise": 2.0,
}


def _dtype_str(dtype) -> str:
    """``torch.float32`` → ``"float32"``, the reference's spelling."""
    return str(dtype).replace("torch.", "")


def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= int(x)
    return n


def _val(node) -> Any:
    """The meta value fx recorded for a node (a tensor, or a tuple)."""
    return node.meta.get("val") if hasattr(node, "meta") else None


def _first_tensor(v) -> Optional[torch.Tensor]:
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, (tuple, list)) and v and isinstance(v[0], torch.Tensor):
        return v[0]
    return None


def _shape(t) -> Tuple[int, ...]:
    return tuple(int(d) for d in t.shape) if t is not None else ()


def _bytes(t) -> int:
    if t is None:
        return 0
    return _prod(t.shape) * dtype_bytes(_dtype_str(t.dtype))


def _op_name(target) -> str:
    packet = getattr(target, "overloadpacket", None)
    name = getattr(packet, "__name__", None) or getattr(target, "__name__",
                                                        str(target))
    name = name.split(".")[-1]
    # an in-place variant (``index_put_``) lowers as its functional op
    return name[:-1] if name.endswith("_") and not name.endswith("__") \
        else name


def _tensor_args(node) -> List[Any]:
    """The fx nodes among a call's arguments, in argument order (lists,
    such as ``cat``'s, flattened)."""
    out: List[Any] = []

    def walk(a):
        if isinstance(a, torch.fx.Node):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            for x in a:
                walk(x)

    for a in node.args:
        walk(a)
    for a in node.kwargs.values():
        walk(a)
    return out


# ---------------------------------------------------------------------------
# per-node cost model (shape-derived, frontend-level)
# ---------------------------------------------------------------------------

def _node_costs(op: str, name: str, node, out) -> Tuple[float, float,
                                                          Dict[str, Any]]:
    """(flops, macs, attrs) of one ATen call — ``_eqn_costs``' twin."""
    out_elems = _prod(_shape(out))
    args = node.args

    if name in ("mm", "bmm", "addmm", "baddbmm"):
        lhs = _val(args[1] if name in _BIAS_PRODUCTS else args[0])
        k = int(lhs.shape[-1])
        macs = float(out_elems) * float(k)
        attrs = {"contract_k": k, "batch_dims": 1 if lhs.dim() == 3 else 0}
        return 2.0 * macs, macs, attrs

    if name == "dot_general":
        lhs = _val(args[0])
        k = _prod(lhs.shape[d] for d in args[2])
        macs = float(out_elems) * float(k)
        return 2.0 * macs, macs, {"contract_k": int(k),
                                  "batch_dims": len(args[4])}

    if name == "convolution":
        w = _val(args[1])
        spatial = [int(s) for s in w.shape[2:]]
        cin = int(w.shape[1])
        macs = float(out_elems) * float(_prod(spatial)) * float(cin)
        attrs = {"kernel": spatial, "stride": [int(s) for s in args[3]],
                 "groups": int(args[8])}
        return 2.0 * macs, macs, attrs

    if op in ("reduce", "pool"):
        x = _val(args[0]) if args and isinstance(args[0], torch.fx.Node) \
            else None
        in_elems = _prod(_shape(x)) if x is not None else out_elems
        if name in ("sort", "topk", "top_k"):
            n = max(in_elems, 2)
            return float(n) * math.log2(n), 0.0, {}
        if op == "pool":
            # reduce_window's window_dimensions: 1 on every dim the kernel
            # does not slide over
            kernel = [int(k) for k in args[1]]
            if len(kernel) == 1:
                kernel = kernel * 2
            rank = x.dim() if x is not None else len(kernel) + 2
            return float(in_elems), 0.0, {
                "window": [1] * (rank - len(kernel)) + kernel}
        return float(in_elems), 0.0, {}

    if op in ("gather", "scatter"):
        x = _val(args[0]) if args and isinstance(args[0], torch.fx.Node) \
            else None
        moved = max(out_elems, _prod(_shape(x)) if x is not None else 0)
        return 0.0, 0.0, {"moved_elems": int(moved)}

    w = _POINTWISE_COST.get(op, 1.0)
    return w * float(out_elems), 0.0, {}


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------

class _Builder:
    """Accumulates raw nodes/edges while walking the fx graph."""

    def __init__(self):
        self.nodes: List[OpNode] = []
        self.edges: List[Tuple[int, int]] = []

    def new_node(self, op: str, out_shape, dtype, attrs, flops, macs,
                 bytes_accessed, param_bytes) -> int:
        nid = len(self.nodes)
        self.nodes.append(OpNode(
            node_id=nid, op=op, out_shape=tuple(out_shape), dtype=str(dtype),
            attrs=attrs, flops=flops, macs=macs,
            bytes_accessed=bytes_accessed, param_bytes=param_bytes))
        return nid

    def add_edge(self, src: int, dst: int) -> None:
        if src != dst:
            self.edges.append((src, dst))


class _Origin:
    """Where an fx value comes from."""

    __slots__ = ("node", "is_param")

    def __init__(self, node: Optional[int], is_param: bool):
        self.node = node          # producing raw-node id, or None for leaves
        self.is_param = is_param  # transitively derived only from weights


def _is_literal(node, literals: set) -> bool:
    """A rank-0 tensor made from no tensor — a constant, a creation op,
    or ``torch.tensor(c)``'s copy of its constant: the jaxpr's literal."""
    v = _val(node)
    if not (isinstance(v, torch.Tensor) and v.dim() == 0):
        return False
    if node.op == "get_attr":
        return True
    args = _tensor_args(node)
    name = _op_name(node.target)
    if name == "lift_fresh_copy":
        return all(a in literals for a in args)
    return not args and name in _LAYOUT_ATEN


def _emit(b: _Builder, op: str, out, costs, inputs, shape=None,
          out_bytes=None) -> int:
    """One compute node from its ``(value, origin)`` inputs: bytes of
    the inputs and the output, bytes of the weight inputs, edges from the
    producers. A pointwise op's operand ranked below its output (and
    above 0) first goes through a ``broadcast_in_dim`` raw node, as jnp
    broadcasts it; the bytes stay the operand's. ``out_bytes`` replaces
    the output's bytes (a multi-output op's)."""
    flops, macs, attrs = costs
    known = [(v, og) for v, og in inputs if og is not None]
    in_bytes = sum(_bytes(v) for v, _ in known)
    param_bytes = float(sum(_bytes(v) for v, og in known if og.is_param))
    srcs = []
    for v, og in known:
        if op not in _NOT_POINTWISE and 0 < v.dim() < out.dim():
            srcs.append(_broadcast(b, og, (1,) * (out.dim() - v.dim())
                                   + _shape(v), _dtype_str(v.dtype)))
        else:
            srcs.append(og)
    nid = b.new_node(op, _shape(out) if shape is None else shape,
                     _dtype_str(out.dtype), attrs, flops, macs,
                     float(in_bytes + (_bytes(out) if out_bytes is None
                                       else out_bytes)), param_bytes)
    for og in srcs:
        if og.node is not None:
            b.add_edge(og.node, nid)
    return nid


def _broadcast(b: _Builder, og: _Origin, shape, dtype) -> _Origin:
    """A ``broadcast_in_dim`` raw node after ``og``."""
    nid = b.new_node("broadcast_in_dim", shape, dtype, {}, 0.0, 0.0, 0.0,
                     0.0)
    if og.node is not None:
        b.add_edge(og.node, nid)
    return _Origin(nid, og.is_param)


# ---------------------------------------------------------------------------
# folds: ATen's own layout steps, recorded the reference's way
# ---------------------------------------------------------------------------

_TO_NCHW, _TO_NHWC = [0, 3, 1, 2], [0, 2, 3, 1]


def _is_call(node, *names) -> bool:
    return (isinstance(node, torch.fx.Node) and node.op == "call_function"
            and node.target is not operator.getitem
            and _op_name(node.target) in names)


def _only_user(node):
    """The one consumer of ``node`` (a multi-output op's unused outputs
    left out), or None."""
    users = [u for u in node.users
             if u.users or u.target is not operator.getitem]
    return users[0] if len(users) == 1 else None


def _perm(node) -> Optional[List[int]]:
    return [int(d) for d in node.args[1]] if _is_call(node, "permute") \
        else None


class _Folds:
    """The shapes and attributes a compute node is recorded at, and the
    layout nodes that add no raw node (see ``_REF_EQNS``)."""

    def __init__(self):
        self.shape: Dict[Any, Tuple[int, ...]] = {}
        self.attrs: Dict[Any, Dict[str, Any]] = {}
        self.skip: set = set()


def _fold_window(node, f: _Folds) -> None:
    """``permute(0,3,1,2)`` → conv / pool → ``permute(0,2,3,1)``: the
    window op recorded channels-last, its window too."""
    src, inner = node.args[0], node
    if _is_call(src, "constant_pad_nd") and _only_user(src) is node:
        src, inner = src.args[0], src     # "SAME" padding is conv's own
    out = _only_user(node)
    if out is not None and out.target is operator.getitem:
        out = _only_user(out)
    if _perm(src) != _TO_NCHW or _only_user(src) is not inner \
            or out is None or _perm(out) != _TO_NHWC:
        return
    f.shape[node] = _shape(_val(out))
    f.skip.update({src, inner, out} - {node})
    if _op_name(node.target) != "convolution":
        window = [int(k) for k in node.args[1]]
        window = (window * 2)[:2] if len(window) == 1 else window
        f.attrs[node] = {"window": [1] + window + [1]}


def _batch_chain(a, consumer) -> Optional[List[Any]]:
    """The layout nodes ``matmul`` puts before a ``bmm`` operand — the
    permute or transpose that brings the batch dims forward, an
    ``expand`` to the same shape, a ``clone``, and the view that merges
    the batch dims — which a ``dot_general`` carries as its dimension
    numbers; None if ``a`` is not such a view."""
    if not (_is_call(a, "view", "_unsafe_view") and _only_user(a) is consumer):
        return None
    x, y = _shape(_val(a.args[0])), _shape(_val(a))
    if len(x) < 4 or y != (_prod(x[:-2]),) + x[-2:]:
        return None
    chain, node = [a], a.args[0]
    while (_is_call(node, "clone", "permute", "transpose")
           or (_is_call(node, "expand")
               and _shape(_val(node)) == _shape(_val(node.args[0])))) \
            and _only_user(node) is chain[-1]:
        chain.append(node)
        node = node.args[0]
    return chain


def _fold_product(node, f: _Folds) -> None:
    """A product over rows ``view`` → ``mm`` → ``view`` (``matmul`` of an
    N-D input by a matrix), or over batches (``matmul`` of two N-D
    inputs), recorded at its N-D shape, as ``dot_general`` gives it."""
    name = _op_name(node.target)
    out = _only_user(node)
    if not _is_call(out, "view", "_unsafe_view"):
        return
    o, n = _shape(_val(out)), _shape(_val(node))
    if name in ("mm", "addmm"):
        lhs = node.args[1 if name == "addmm" else 0]
        if not (_is_call(lhs, "view", "_unsafe_view")
                and _only_user(lhs) is node):
            return
        x = _shape(_val(lhs.args[0]))
        if len(x) < 3 or _shape(_val(lhs)) != (_prod(x[:-1]), x[-1]) \
                or o != x[:-1] + n[-1:]:
            return
        f.skip.update({lhs, out})
    else:
        chains = [_batch_chain(a, node) for a in node.args[:2]]
        if len(o) < 4 or o[-2:] != n[-2:] or None in chains:
            return
        f.skip.update([out, *chains[0], *chains[1]])
        f.attrs[node] = {"batch_dims": len(o) - 2}
    f.shape[node] = o


def _reduced_shape(node) -> Optional[Tuple[int, ...]]:
    """A keepdim reduction's shape without the kept dims, or None."""
    keep = node.kwargs.get("keepdim",
                           node.args[2] if len(node.args) > 2 else False)
    if not keep:
        return None
    rank = _val(node.args[0]).dim()
    dims = node.args[1] if len(node.args) > 1 and node.args[1] else \
        range(rank)
    dims = {int(d) % max(rank, 1) for d in dims}
    return tuple(s for i, s in enumerate(_shape(_val(node)))
                 if i not in dims)


def _plan_folds(graph: torch.fx.Graph) -> _Folds:
    f = _Folds()
    for node in graph.nodes:
        if _is_call(node, *_WINDOW_ATEN):
            _fold_window(node, f)
        elif _is_call(node, "mm", "addmm", "bmm"):
            _fold_product(node, f)
    return f


def _is_scalar_index(node, name: str) -> bool:
    """``x[..., i]`` by rank-0 integer tensors (``aten.index``): the
    jaxpr's dynamic index, ``dynamic_slice`` + ``squeeze``."""
    if name != "index":
        return False
    idx = [_val(a) for a in _tensor_args(node)[1:]]
    return bool(idx) and all(v.dim() == 0 and not v.is_floating_point()
                             for v in idx)


def _passes_through(node, name: str) -> bool:
    """A layout node that adds no raw node (``_REF_EQNS``)."""
    if name in _REF_EQNS:
        return _REF_EQNS[name] == 0
    if name in ("view", "_unsafe_view", "reshape", "expand"):
        return _shape(_val(node)) == _shape(_val(node.args[0]))
    return False


def _process_graph(b: _Builder, graph: torch.fx.Graph,
                   env: Dict[Any, _Origin]) -> None:
    literals: set = set()
    folds = _plan_folds(graph)
    for node in graph.nodes:
        if node.op in ("placeholder", "output"):
            continue
        if node.op in ("get_attr", "call_function") \
                and _is_literal(node, literals):
            literals.add(node)        # no node, no bytes
            continue
        if node.op == "get_attr":
            env[node] = _Origin(None, True)  # closure constants: weights
            continue
        if node.target is operator.getitem:
            # a multi-output op's outputs all come from its one node
            src = node.args[0]
            if src in env:
                env[node] = env[src]
            continue
        if node.op != "call_function":
            continue
        name = _op_name(node.target)
        out = _first_tensor(_val(node))
        if out is None:
            continue
        ins = _tensor_args(node)

        if name == "scan_ys":
            # a scan's stacked ys: the reference hands on the last
            # replica's value; a stack of literals is a value of no node
            env[node] = env.get(ins[-1]) or _Origin(None, False)
            continue
        if name in _LAYOUT_ATEN and (node in folds.skip
                                     or _passes_through(node, name)):
            src = ins[0] if ins else None
            if src in env:
                env[node] = env[src]
            elif src in literals:
                if name == "alias":
                    # a literal bound to an inlined jit's argument: a
                    # variable of no equation, whose bytes count
                    env[node] = _Origin(None, False)
                else:
                    literals.add(node)
            continue
        if name in _LAYOUT_ATEN or _is_scalar_index(node, name):
            # layout raw node: kept for connectivity, contracted later
            known = [env[a] for a in ins if a in env]
            is_param = len(known) > 0 and all(og.is_param for og in known)
            nid = b.new_node(name, _shape(out), _dtype_str(out.dtype), {},
                             0.0, 0.0, 0.0, 0.0)
            for og in known:
                if og.node is not None:
                    b.add_edge(og.node, nid)
            for _ in range(_REF_EQNS.get(name, 1) - 1):
                nid = b.new_node(name, _shape(out), _dtype_str(out.dtype),
                                 {}, 0.0, 0.0, 0.0, 0.0)
                b.add_edge(nid - 1, nid)
            env[node] = _Origin(nid, is_param)
            continue

        op = _ATEN_MAP.get(name, "elementwise")
        flops, macs, attrs = _node_costs(op, name, node, out)
        costs = (flops, macs, {**attrs, **folds.attrs.get(node, {})})
        shape = folds.shape.get(node)
        kept = _reduced_shape(node) if name in _KEEPDIM_ATEN else None
        bias = node.args[0] if name in _BIAS_PRODUCTS else \
            node.args[2] if name == "convolution" else None
        inputs = [(_val(a), env.get(a)) for a in ins]
        if name in _GATHER_INDEX:
            # jnp's gather takes its indices broadcast to [..., 1]
            idx = node.args[_GATHER_INDEX[name]]
            if env.get(idx) is not None:
                v = _val(idx)
                inputs[ins.index(idx)] = (v, _broadcast(
                    b, env[idx], _shape(v) + (1,), _dtype_str(v.dtype)))
        if bias is None:
            outs = _val(node) if name in _ALL_OUTPUT_BYTES else None
            nid = _emit(b, op, out, costs, inputs,
                        shape=shape if kept is None else kept,
                        out_bytes=None if outs is None
                        else sum(_bytes(v) for v in outs))
        else:
            # product + bias: a dense/conv node, then an add of the bias
            pid = _emit(b, op, out, costs, [(_val(a), env.get(a))
                                            for a in ins if a is not bias],
                        shape=shape)
            add_cost = (_POINTWISE_COST["add"] * _prod(_shape(out)), 0.0, {})
            nid = _emit(b, "add", out, add_cost,
                        [(out, _Origin(pid, False)),
                         (_val(bias), env.get(bias))], shape=shape)
        og = _Origin(nid, False)
        if kept is not None:
            # jnp's keepdims: the reduction, then a broadcast_in_dim
            og = _broadcast(b, og, _shape(out), _dtype_str(out.dtype))
        env[node] = og


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _meta_spec(spec) -> torch.Tensor:
    """A spec leaf as a meta tensor: a tensor (moved to ``meta`` without
    touching the caller's), or a ``(shape, dtype)`` pair."""
    if isinstance(spec, torch.Tensor):
        if spec.device.type == "meta":
            return spec
        return torch.empty(spec.shape, dtype=spec.dtype, device="meta")
    shape, dtype = spec
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.empty(tuple(int(d) for d in shape), dtype=dtype,
                       device="meta")


def _is_spec_pair(x) -> bool:
    return (isinstance(x, tuple) and len(x) == 2
            and isinstance(x[0], (tuple, list, torch.Size))
            and isinstance(x[1], (torch.dtype, str)))


def _to_meta(tree):
    """Every leaf of a spec pytree as a meta tensor (``(shape, dtype)``
    pairs count as leaves)."""
    if _is_spec_pair(tree) or isinstance(tree, torch.Tensor):
        return _meta_spec(tree)
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_meta(v) for v in tree)
    return tree


def _leaves(tree) -> List[torch.Tensor]:
    from torch.utils._pytree import tree_leaves
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _spec_bytes(tree) -> int:
    return sum(_bytes(t) for t in _leaves(tree))


def trace_graph(
    fn,
    params_spec: Any,
    *data_specs: Any,
    meta: Optional[Dict[str, Any]] = None,
) -> OpGraph:
    """Trace ``fn(params, *data)`` on the meta device and lower it to an
    OpGraph.

    Parameters
    ----------
    fn:
        A callable of tensors taking a parameter pytree first, then data.
    params_spec:
        Pytree of tensors or ``(shape, dtype)`` pairs — leaves are weights.
        Tensors off the meta device are replaced by meta tensors of their
        shape and dtype; the caller's tensors are not touched.
    data_specs:
        Pytrees of tensors or ``(shape, dtype)`` pairs — model inputs.
    meta:
        Extra metadata stored on the graph (family name, batch size, ...).
    """
    from torch.fx.experimental.proxy_tensor import make_fx
    params = _to_meta(params_spec)
    data = [_to_meta(d) for d in data_specs]
    gm = make_fx(fn, tracing_mode="fake",
                 _allow_non_fake_inputs=True)(params, *data)

    n_param_leaves = len(_leaves(params))
    b = _Builder()
    env: Dict[Any, _Origin] = {}
    i = 0
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            env[node] = _Origin(None, is_param=(i < n_param_leaves))
            i += 1
    _process_graph(b, gm.graph, env)

    full_meta = dict(meta or {})
    full_meta.setdefault("n_raw_nodes", len(b.nodes))
    full_meta.setdefault("param_bytes", int(_spec_bytes(params)))
    full_meta.setdefault("input_bytes", int(_spec_bytes(data)))
    return filter_and_preprocess(b.nodes, b.edges, meta=full_meta)


def trace_apply(fn, *arg_specs, meta=None) -> OpGraph:
    """Trace a callable whose weights are closure constants (meta
    tensors it closes over)."""
    return trace_graph(lambda _p, *d: fn(*d), (), *arg_specs, meta=meta)


def trace_module(module: torch.nn.Module, *input_specs,
                 state: Optional[Dict[str, Any]] = None,
                 meta: Optional[Dict[str, Any]] = None) -> OpGraph:
    """Trace an ``nn.Module`` through ``torch.func.functional_call`` over
    meta copies of its parameters and buffers (or over ``state``, a name
    → spec mapping), which count as weights. The caller's module and its
    tensors are left as they are."""
    from torch.func import functional_call
    if state is None:
        state = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                 for k, v in list(module.named_parameters())
                 + list(module.named_buffers())}

    def fwd(p, *x):
        return functional_call(module, p, tuple(x))

    return trace_graph(fwd, state, *input_specs, meta=meta)
