"""Graph frontends (paper §3.1 — "Relay Parser").

The paper parses PyTorch / TensorFlow / ONNX / PaddlePaddle through TVM
Relay. The port has two frontends:

* :func:`from_torch` — any PyTorch callable of tensors or ``nn.Module``
  (the model zoo, user models) via the meta-device ATen tracer
  (:mod:`repro_torch.core.tracer`), the counterpart of the JAX package's
  ``from_jax``.
* :func:`from_json` / :func:`from_json_file` — the **portable serialized
  graph schema** (``repro.opgraph.v1``): any external framework exporter
  that can emit a node list with ``op / out_shape / attrs`` is parseable
  without that framework being importable here. A JAX model reaches the
  port this way: the JAX package traces it and exports the document.

Both produce the same :class:`~repro_torch.core.ir.OpGraph` as the JAX
package's frontends, so the rest of the pipeline (NFG → SFG → PMGNS →
MIG) is frontend-agnostic, exactly as in the paper's Fig. 2.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional

import torch

from .ir import (OP_INDEX, GraphValidationError, OpGraph, OpNode,
                 filter_and_preprocess)
from .tracer import trace_graph, trace_module

#: aliases accepted from external exporters → canonical OP_VOCAB names
_OP_ALIASES: Dict[str, str] = {
    "matmul": "dense", "gemm": "dense", "linear": "dense", "dense": "dense",
    "batch_matmul": "dense", "fc": "dense", "einsum": "dense",
    "conv1d": "conv", "conv2d": "conv", "conv3d": "conv",
    "conv2d_transpose": "conv", "depthwise_conv2d": "conv", "conv": "conv",
    "bias_add": "add", "add": "add", "sub": "add", "residual": "add",
    "mul": "mul", "div": "div",
    "relu": "relu", "relu6": "relu", "leaky_relu": "relu", "prelu": "relu",
    "clip": "relu", "hardswish": "gelu", "hardsigmoid": "gelu",
    "gelu": "gelu", "silu": "gelu", "swish": "gelu", "sigmoid": "gelu",
    "mish": "gelu", "elu": "gelu",
    "tanh": "tanh", "exp": "exp", "log": "exp",
    "softmax": "softmax", "log_softmax": "softmax",
    "sum": "reduce", "mean": "reduce", "reduce_mean": "reduce",
    "global_avg_pool2d": "pool", "avg_pool2d": "pool", "max_pool2d": "pool",
    "adaptive_avg_pool2d": "pool", "pool": "pool",
    "batch_norm": "norm", "layer_norm": "norm", "group_norm": "norm",
    "instance_norm": "norm", "rms_norm": "norm", "norm": "norm",
    "embedding": "gather", "gather": "gather", "take": "gather",
    "scatter": "scatter", "one_hot": "scatter",
    "reduce": "reduce", "elementwise": "elementwise",
}


def from_torch(fn_or_module, params_spec: Any = None, *data_specs: Any,
               meta: Optional[Dict[str, Any]] = None) -> OpGraph:
    """Trace a PyTorch callable or ``nn.Module`` into an OpGraph on the
    meta device (see :mod:`repro_torch.core.tracer`).

    A callable is traced as ``fn(params, *data)`` with ``params_spec``'s
    leaves as weights. A module is traced through
    ``torch.func.functional_call`` over meta copies of its parameters and
    buffers (or over ``params_spec``, a name → spec mapping, when given);
    the caller's module is left untouched. Specs are tensors or
    ``(shape, dtype)`` pairs.
    """
    if isinstance(fn_or_module, torch.nn.Module):
        return trace_module(fn_or_module, *data_specs, state=params_spec,
                            meta=meta)
    return trace_graph(fn_or_module, params_spec, *data_specs, meta=meta)


def _validated_edges(doc: Dict[str, Any], node_ids: set) -> list:
    """Edge list as int pairs; typed errors for malformed/dangling refs."""
    edges = []
    for k, e in enumerate(doc.get("edges", []) or []):
        try:
            a, b = int(e[0]), int(e[1])
        except (TypeError, ValueError, IndexError, KeyError):
            raise GraphValidationError(
                f"edge {k} is not an (src, dst) integer pair: {e!r}")
        for nid in (a, b):
            if nid not in node_ids:
                raise GraphValidationError(
                    f"edge {k} ({a} -> {b}) references node {nid}, "
                    f"which is not in the node list", node_id=nid)
        edges.append((a, b))
    return edges


def _check_acyclic(g: OpGraph) -> OpGraph:
    try:
        g.topo_order()
    except ValueError:
        raise GraphValidationError(
            "graph contains a cycle — operator graphs must be DAGs")
    return g


def from_json(doc: Dict[str, Any]) -> OpGraph:
    """Parse the portable schema (or a raw exporter node list) to OpGraph.

    Structurally invalid documents raise
    :class:`~repro_torch.core.ir.GraphValidationError` with node-level context
    (missing fields, dangling edge references, negative shape dims,
    duplicate ids, cycles) instead of leaking raw ``KeyError`` /
    ``IndexError`` from arbitrary user payloads — serving maps this to
    an immediate request rejection before any queue slot is taken.
    """
    if not isinstance(doc, dict):
        raise GraphValidationError(
            f"graph document must be a mapping, got {type(doc).__name__}")
    if "nodes" not in doc:
        raise GraphValidationError("graph document has no 'nodes' list")
    if doc.get("schema") == "repro.opgraph.v1":
        try:
            g = OpGraph.from_json(doc)
        except GraphValidationError:
            raise
        except (KeyError, TypeError, ValueError, IndexError) as e:
            raise GraphValidationError(
                f"malformed repro.opgraph.v1 document: "
                f"{type(e).__name__}: {e}")
        for nd in g.nodes:
            if any(d < 0 for d in nd.out_shape):
                raise GraphValidationError(
                    f"node {nd.node_id} has a negative out_shape dim: "
                    f"{nd.out_shape}", node_id=nd.node_id)
        ids = [nd.node_id for nd in g.nodes]
        if len(set(ids)) != len(ids):
            dup = next(i for i in ids if ids.count(i) > 1)
            raise GraphValidationError(
                f"duplicate node id {dup}", node_id=dup)
        _validated_edges({"edges": [list(e) for e in g.edges]}, set(ids))
        # re-canonicalize op names from foreign exporters; replace nodes
        # instead of assigning nd.op in place — parsing must never
        # mutate OpNodes it shares with the caller's graph objects
        raw = []
        for nd in g.nodes:
            op = nd.op if nd.op in OP_INDEX else _OP_ALIASES.get(nd.op.lower())
            if op is None:
                op = "elementwise"
            raw.append(nd if op == nd.op
                       else dataclasses.replace(nd, op=op))
        return _check_acyclic(
            filter_and_preprocess(raw, g.edges, meta=g.meta))
    # raw exporter format: {"nodes": [{"id", "op", "out_shape", ...}],
    #                       "edges": [[s,d],...], "meta": {...}}
    nodes = []
    seen_ids: set = set()
    for k, d in enumerate(doc["nodes"]):
        if not isinstance(d, dict):
            raise GraphValidationError(
                f"node {k} is not a mapping: {d!r}")
        for field in ("id", "op"):
            if field not in d:
                raise GraphValidationError(
                    f"node {k} is missing required field {field!r}")
        try:
            nid = int(d["id"])
        except (TypeError, ValueError):
            raise GraphValidationError(
                f"node {k} has a non-integer id: {d['id']!r}")
        if nid in seen_ids:
            raise GraphValidationError(
                f"duplicate node id {nid}", node_id=nid)
        seen_ids.add(nid)
        try:
            out_shape = tuple(int(x) for x in d.get("out_shape", ()))
        except (TypeError, ValueError):
            raise GraphValidationError(
                f"node {nid} has a malformed out_shape: "
                f"{d.get('out_shape')!r}", node_id=nid)
        if any(x < 0 for x in out_shape):
            raise GraphValidationError(
                f"node {nid} has a negative out_shape dim: {out_shape}",
                node_id=nid)
        op = str(d["op"]).lower()
        op = _OP_ALIASES.get(op, op if op in OP_INDEX else "elementwise")
        try:
            nodes.append(OpNode(
                node_id=nid, op=op, out_shape=out_shape,
                dtype=str(d.get("dtype", "float32")),
                attrs=dict(d.get("attrs", {})),
                flops=float(d.get("flops", 0.0)),
                macs=float(d.get("macs", 0.0)),
                bytes_accessed=float(d.get("bytes_accessed", 0.0)),
                param_bytes=float(d.get("param_bytes", 0.0)),
            ))
        except (TypeError, ValueError) as e:
            raise GraphValidationError(
                f"node {nid} has malformed numeric fields: {e}",
                node_id=nid)
    edges = _validated_edges(doc, seen_ids)
    return _check_acyclic(
        filter_and_preprocess(nodes, edges, meta=doc.get("meta", {})))


def from_json_file(path: str) -> OpGraph:
    with open(path) as f:
        return from_json(json.load(f))
