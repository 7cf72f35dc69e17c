"""The PyTorch port's tracer and model zoo against the JAX package's.

* The lowering table, op by op: each ATen op of ``tracer._ATEN_MAP`` and
  the layout ops, traced on the meta device, becomes the canonical op (or
  is contracted), with the reference's costs and attributes.
* The raw-node rule: each row of the tracer's table on a small program
  written in torch and in jnp gives the jaxpr tracer's nodes, shapes,
  edges and raw node count.
* Tracer against tracer, per family: the port's ``trace_family`` of each
  of the 11 families at its Table-2 draw and at two small variants is
  the JAX package's graph — every node at the same NHWC shape, edges,
  meta with the raw node count, node and static features, fingerprint —
  and so its labels at the default noise, bit for bit.
* Prediction on zoo graphs: the port's ``predict_zoo`` against the JAX
  package's own ``predict_zoo`` (and its ``predict_many`` on the port's
  graphs) with the same packed GraphSAGE and GAT weights, at 1e-5.
* Entry points: ``submit_torch``, ``predict_torch`` and
  ``predict_graph(from_torch(...))`` agree bit for bit on one module, and
  tracing a user module counts its parameter bytes exactly and leaves it
  untouched.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn as nn  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import frontends as jf  # noqa: E402
from repro.core import gnn as jg  # noqa: E402
from repro.core.predictor import DIPPM as JDIPPM  # noqa: E402
from repro.perfmodel import cost_model as jc  # noqa: E402
from repro.zoo import families as jz  # noqa: E402
from repro_torch.core import DIPPM, GraphValidationError, OP_VOCAB  # noqa: E402
from repro_torch.core import gnn as tg  # noqa: E402
from repro_torch.core import tracer as tt  # noqa: E402
from repro_torch.core.frontends import from_torch  # noqa: E402
from repro_torch.perfmodel import cost_model as tc  # noqa: E402
from repro_torch.zoo import families as tz  # noqa: E402

META = "meta"


def T(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def _aten_names(fn, params, *data):
    from torch.fx.experimental.proxy_tensor import make_fx
    gm = make_fx(fn, tracing_mode="fake", _allow_non_fake_inputs=True)(
        params, *data)
    return [tt._op_name(n.target) for n in gm.graph.nodes
            if n.op == "call_function"]


# ---------------------------------------------------------------------------
# the lowering table, op by op
# ---------------------------------------------------------------------------

X = T(4, 6)
IDX = T(4, dtype=torch.int64)

#: ATen name → (fn(p, x, idx), canonical op of its node)
POINTWISE_AND_REDUCE = {
    "add": (lambda p, x, i: x + p, "add"),
    "sub": (lambda p, x, i: x - p, "add"),
    "rsub": (lambda p, x, i: 2.0 - x, "add"),
    "mul": (lambda p, x, i: x * p, "mul"),
    "div": (lambda p, x, i: x / p, "div"),
    "relu": (lambda p, x, i: torch.relu(x), "relu"),
    "maximum": (lambda p, x, i: torch.maximum(x, p), "relu"),
    "minimum": (lambda p, x, i: torch.minimum(x, p), "relu"),
    "clamp_min": (lambda p, x, i: x.clamp_min(0.0), "relu"),
    "clamp_max": (lambda p, x, i: x.clamp_max(6.0), "relu"),
    "exp": (lambda p, x, i: torch.exp(x), "exp"),
    "log": (lambda p, x, i: torch.log(x), "exp"),
    "log1p": (lambda p, x, i: torch.log1p(x), "exp"),
    "expm1": (lambda p, x, i: torch.expm1(x), "exp"),
    "tanh": (lambda p, x, i: torch.tanh(x), "tanh"),
    "sigmoid": (lambda p, x, i: torch.sigmoid(x), "gelu"),
    "erf": (lambda p, x, i: torch.erf(x), "gelu"),
    "gelu": (lambda p, x, i: F.gelu(x), "gelu"),
    "sum": (lambda p, x, i: x.sum(-1), "reduce"),
    "amax": (lambda p, x, i: x.amax(-1), "reduce"),
    "amin": (lambda p, x, i: x.amin(-1), "reduce"),
    "mean": (lambda p, x, i: x.mean(-1), "reduce"),
    "argmax": (lambda p, x, i: x.argmax(-1), "reduce"),
    "cumsum": (lambda p, x, i: x.cumsum(-1), "reduce"),
    "index_select": (lambda p, x, i: torch.index_select(x, 0, i), "gather"),
    "gather": (lambda p, x, i: torch.gather(
        x, 1, i[:, None].expand(-1, 6)), "gather"),
    "embedding": (lambda p, x, i: F.embedding(i, p), "gather"),
    "scatter": (lambda p, x, i: x.scatter(
        0, i[:, None].expand(-1, 6), p), "scatter"),
    "scatter_add": (lambda p, x, i: x.scatter_add(
        0, i[:, None].expand(-1, 6), p), "scatter"),
    "scatter_reduce": (lambda p, x, i: x.scatter_reduce(
        0, i[:, None].expand(-1, 6), p, "amax"), "scatter"),
    "index_add": (lambda p, x, i: x.index_add(0, i, p), "scatter"),
    "index_put": (lambda p, x, i: x.index_put((i,), p), "scatter"),
}


@pytest.mark.parametrize("aten", sorted(POINTWISE_AND_REDUCE))
def test_lowering_table_op(aten):
    fn, canon = POINTWISE_AND_REDUCE[aten]
    p = T(4, 6)
    assert aten in _aten_names(fn, p, X, IDX)
    g = tt.trace_graph(fn, p, X, IDX)
    assert tt._ATEN_MAP[aten] == canon
    [nd] = [nd for nd in g.nodes if nd.op == canon]
    assert g.num_nodes == 1 and nd.dtype in ("float32", "int64")
    out_elems = nd.out_elems
    if canon == "reduce":
        assert nd.flops == 24.0                 # the input's elements
    elif canon in ("gather", "scatter"):
        assert nd.flops == 0.0
        assert nd.attrs["moved_elems"] == max(out_elems, 24)
    else:
        assert nd.flops == tt._POINTWISE_COST[canon] * out_elems
    # bytes: every tensor input once, the output once
    fx_in = {"embedding": 24 * 4 + 4 * 8, "index_select": 96 + 32,
             "gather": 96 + 4 * 6 * 8, "scatter": 96 + 4 * 6 * 8 + 96,
             "scatter_add": 96 + 4 * 6 * 8 + 96,
             "scatter_reduce": 96 + 4 * 6 * 8 + 96,
             "index_add": 96 + 32 + 96, "index_put": 96 + 32 + 96}
    binary = {"add", "sub", "mul", "div", "maximum", "minimum"}
    in_bytes = fx_in.get(aten, 192 if aten in binary else 96)
    assert nd.bytes_accessed == in_bytes + nd.out_bytes


@pytest.mark.parametrize("aten", ["sort", "topk"])
def test_sort_and_topk_cost_n_log_n(aten):
    fn = (lambda p, x: torch.sort(x, -1)[0]) if aten == "sort" else \
        (lambda p, x: torch.topk(x, 2)[0])
    assert aten in _aten_names(fn, (), X)
    [nd] = tt.trace_graph(fn, (), X).nodes
    assert nd.op == "reduce" and nd.flops == 24 * math.log2(24)
    assert nd.out_shape == ((4, 6) if aten == "sort" else (4, 2))


@pytest.mark.parametrize("aten", ["mm", "bmm", "addmm", "baddbmm"])
def test_lowering_dense(aten):
    fns = {
        "mm": (lambda p, x: x @ p["w"], T(6, 5), X),
        "bmm": (lambda p, x: torch.bmm(x, p["w"]), T(3, 6, 5), T(3, 4, 6)),
        "addmm": (lambda p, x: torch.addmm(p["b"], x, p["w"]), T(6, 5), X),
        "baddbmm": (lambda p, x: torch.baddbmm(p["b"], x, p["w"]),
                    T(3, 6, 5), T(3, 4, 6)),
    }
    fn, w, x = fns[aten]
    params = {"w": w, "b": T(5)}
    assert aten in _aten_names(fn, params, x)
    g = tt.trace_graph(fn, params, x)
    out = 4 * 5 * (3 if x.dim() == 3 else 1)
    dense = g.nodes[0]
    assert dense.op == "dense" and dense.macs == out * 6
    assert dense.flops == 2 * out * 6
    assert dense.attrs == {"contract_k": 6, "batch_dims": x.dim() - 2}
    assert dense.param_bytes == w.numel() * 4
    assert dense.bytes_accessed == (x.numel() + w.numel() + out) * 4
    if aten in ("addmm", "baddbmm"):
        # the reference's x @ w + b: a dense node, then the bias add
        assert [nd.op for nd in g.nodes] == ["dense", "add"]
        add = g.nodes[1]
        assert add.param_bytes == 5 * 4 and add.flops == out
        assert add.bytes_accessed == (out + 5 + out) * 4
        assert g.edges == [(0, 1)]
    else:
        assert g.num_nodes == 1
    assert g.meta["param_bytes"] == (w.numel() + 5) * 4


@pytest.mark.parametrize("bias", [False, True])
def test_lowering_convolution(bias):
    w, b = T(8, 2, 3, 3), T(8)

    def fn(p, x):
        return F.conv2d(x, p["w"], p["b"] if bias else None, stride=2,
                        padding=1, groups=2)

    x = T(2, 4, 9, 9)
    assert "convolution" in _aten_names(fn, {"w": w, "b": b}, x)
    g = tt.trace_graph(fn, {"w": w, "b": b}, x)
    conv = g.nodes[0]
    out = 2 * 8 * 5 * 5
    assert conv.op == "conv" and conv.out_shape == (2, 8, 5, 5)
    assert conv.macs == out * 9 * 2          # × kernel area × weight.shape[1]
    assert conv.attrs == {"kernel": [3, 3], "stride": [2, 2], "groups": 2}
    assert conv.param_bytes == w.numel() * 4
    assert [nd.op for nd in g.nodes] == (["conv", "add"] if bias
                                         else ["conv"])
    if bias:
        assert g.nodes[1].param_bytes == 8 * 4


@pytest.mark.parametrize("aten", ["max_pool2d_with_indices", "avg_pool2d"])
def test_lowering_pool(aten):
    fn = (lambda p, x: F.max_pool2d(x, 2, 2)) if aten.startswith("max") \
        else (lambda p, x: F.avg_pool2d(x, 3, 1, padding=1))
    x = T(2, 3, 8, 8)
    assert aten in _aten_names(fn, (), x)
    [nd] = tt.trace_graph(fn, (), x).nodes
    k = 2 if aten.startswith("max") else 3
    assert nd.op == "pool" and nd.flops == x.numel()
    assert nd.attrs == {"window": [1, 1, k, k]}
    # a multi-output op counts its first output only (not the indices)
    assert nd.bytes_accessed == (x.numel() + nd.out_elems) * 4


LAYOUT = {
    "view": lambda y: y.view(2, 12),
    "permute": lambda y: y.permute(1, 0),
    "expand": lambda y: y[None].expand(3, 4, 6),
    "cat": lambda y: torch.cat([y, y], 0),
    "slice": lambda y: y[:, 1:3],
    "constant_pad_nd": lambda y: F.pad(y, (1, 1)),
    "_to_copy": lambda y: y.to(torch.float64),
    "clone": lambda y: y.clone(),
    "detach": lambda y: y.detach(),
}


@pytest.mark.parametrize("aten", sorted(LAYOUT))
def test_layout_ops_are_contracted(aten):
    """A layout op has no node; the dataflow through it is kept, and a
    weight stays a weight through it."""
    def fn(p, x):
        return torch.exp(LAYOUT[aten](torch.relu(x)) + 1.0)
    assert aten in _aten_names(fn, (), X)
    g = tt.trace_graph(fn, (), X)
    assert [nd.op for nd in g.nodes] == ["relu", "add", "exp"]
    assert g.edges == [(0, 1), (1, 2)]
    assert aten in tt._LAYOUT_ATEN

    def fw(p, x):
        return x * LAYOUT[aten](p).reshape(-1)[:6]
    [mul] = tt.trace_graph(fw, T(4, 6), X).nodes
    assert mul.op == "mul"
    assert mul.param_bytes == 6 * (8 if aten == "_to_copy" else 4)


def test_unknown_ops_literals_and_dtypes():
    def fn(p, x):
        y = torch.rsqrt(x) ** 3                      # unknown → elementwise
        s = torch.sqrt(torch.scalar_tensor(8.0))     # a literal's op: a root
        return (y / s).to(torch.bfloat16)

    g = tt.trace_graph(fn, (), X)
    assert [nd.op for nd in g.nodes] == ["elementwise", "elementwise",
                                         "elementwise", "div"]
    sqrt = g.nodes[2]
    # the scalar constant has no node and no bytes, as a jaxpr literal
    assert sqrt.out_shape == () and sqrt.bytes_accessed == 4.0
    assert (1, 3) in g.edges and (2, 3) in g.edges
    # torch.tensor(c) records a constant and its fresh copy: one literal
    [mul] = tt.trace_graph(lambda p, x: x * torch.tensor(2.0), (), X).nodes
    assert mul.op == "mul" and mul.bytes_accessed == 2 * 96
    assert mul.param_bytes == 0.0
    assert {nd.dtype for nd in g.nodes} == {"float32"}
    g16 = tt.trace_graph(lambda p, x: torch.relu(x), (),
                         ((3, 5), torch.bfloat16))
    assert g16.nodes[0].dtype == "bfloat16"
    assert g16.meta["input_bytes"] == 30


def test_trace_apply_closure_constants_are_weights():
    w, b = T(6, 3), T(3)
    g = tt.trace_apply(lambda x: torch.relu(x @ w + b), X, meta={"k": 1})
    assert [nd.op for nd in g.nodes] == ["dense", "add", "relu"]
    assert g.nodes[0].param_bytes == 72 and g.nodes[1].param_bytes == 12
    # dot_general, the bias's broadcast_in_dim, add, max: the reference's
    # four equations
    assert g.meta == {"k": 1, "n_raw_nodes": 4, "param_bytes": 0,
                      "input_bytes": 96}


def test_spec_pairs_and_host_tensors_become_meta():
    host = torch.ones(6, 3)
    g = tt.trace_graph(lambda p, x: x @ p["w"], {"w": host},
                       ((4, 6), "float32"))
    assert g.meta["param_bytes"] == 72 and g.meta["input_bytes"] == 96
    assert host.device.type == "cpu" and float(host.sum()) == 18.0


# ---------------------------------------------------------------------------
# the raw-node rule: one small program, traced by both tracers
# ---------------------------------------------------------------------------

def _jax_rule_cases():
    from jax import lax
    same = ("NHWC", "HWIO", "NHWC")
    f32 = jnp.float32
    return {
        # name: (torch fn, torch params, torch data, jax fn, jax params,
        #        jax data)
        "rank_broadcast": (
            lambda p, x: x * p["g"] + p["b"], {"g": T(4), "b": T(4)},
            [T(2, 3, 4)],
            lambda p, x: x * p["g"] + p["b"], {"g": (4,), "b": (4,)},
            [(2, 3, 4)]),
        "keepdim_reduce": (
            lambda p, x: x - x.sum(-1, keepdim=True) / 4, {}, [T(2, 3, 4)],
            lambda p, x: x - jnp.sum(x, -1, keepdims=True) / 4, {},
            [(2, 3, 4)]),
        "nhwc_conv": (
            lambda p, x: F.conv2d(x.permute(0, 3, 1, 2), p["w"], stride=2,
                                  padding=1).permute(0, 2, 3, 1),
            {"w": T(8, 3, 3, 3)}, [T(2, 8, 8, 3)],
            lambda p, x: lax.conv_general_dilated(
                x, p["w"], (2, 2), "SAME", dimension_numbers=same),
            {"w": (3, 3, 3, 8)}, [(2, 8, 8, 3)]),
        "nhwc_maxpool": (
            lambda p, x: F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(
                0, 2, 3, 1), {}, [T(2, 8, 8, 3)],
            lambda p, x: lax.reduce_window(x, -jnp.inf, lax.max, (1, 2, 2, 1),
                                           (1, 2, 2, 1), "SAME"),
            {}, [(2, 8, 8, 3)]),
        "nhwc_avgpool": (
            lambda p, x: F.avg_pool2d(x.permute(0, 3, 1, 2), 3, 1, padding=1,
                                      divisor_override=1).permute(0, 2, 3, 1)
            / 9.0, {}, [T(2, 8, 8, 3)],
            lambda p, x: lax.reduce_window(x, 0.0, lax.add, (1, 3, 3, 1),
                                           (1, 1, 1, 1), "SAME") / 9.0,
            {}, [(2, 8, 8, 3)]),
        "rows_product": (
            lambda p, x: torch.relu(x @ p["w"]), {"w": T(4, 6)},
            [T(2, 5, 4)],
            lambda p, x: jax.nn.relu(x @ p["w"]), {"w": (4, 6)},
            [(2, 5, 4)]),
        "batched_product": (
            lambda p, q, k: torch.matmul(q.permute(0, 2, 1, 3),
                                         k.permute(0, 2, 3, 1)),
            {}, [T(2, 5, 3, 4), T(2, 7, 3, 4)],
            lambda p, q, k: jnp.einsum("bnhd,bmhd->bhnm", q, k), {},
            [(2, 5, 3, 4), (2, 7, 3, 4)]),
        "same_shape_reshape": (
            lambda p, x: torch.exp(x.reshape(2, 3) + 1.0), {}, [T(2, 3)],
            lambda p, x: jnp.exp(x.reshape(2, 3) + 1.0), {}, [(2, 3)]),
        "permuted_reshape": (
            lambda p, x: torch.exp(x.permute(0, 2, 1).reshape(2, -1)), {},
            [T(2, 3, 4)],
            lambda p, x: jnp.exp(x.transpose(0, 2, 1).reshape(2, -1)), {},
            [(2, 3, 4)]),
        "integer_index": (
            lambda p, x: torch.exp(x[:, 0]), {}, [T(2, 3, 4)],
            lambda p, x: jnp.exp(x[:, 0]), {}, [(2, 3, 4)]),
        "stop_gradient": (
            lambda p, x: x - x.amax(-1).unsqueeze(-1).detach(), {},
            [T(2, 3)],
            lambda p, x: x - lax.stop_gradient(jnp.max(x, -1,
                                                       keepdims=True)),
            {}, [(2, 3)]),
        "convert": (
            lambda p, x: x.to(torch.bfloat16) * 2.0, {}, [T(2, 3)],
            lambda p, x: x.astype(jnp.bfloat16) * 2.0, {}, [(2, 3)]),
    }, f32


RULE_CASES = ["rank_broadcast", "keepdim_reduce", "nhwc_conv",
              "nhwc_maxpool", "nhwc_avgpool", "rows_product",
              "batched_product", "same_shape_reshape", "permuted_reshape",
              "integer_index", "stop_gradient", "convert"]


@pytest.mark.parametrize("case", RULE_CASES)
def test_raw_node_rule_matches_reference(case):
    """Each row of the tracer's raw-node rule on a program written both
    ways: the same nodes at the same shapes and attributes, the same
    edges and the same raw node count as the reference's tracer."""
    from repro.core import tracer as jt
    cases, f32 = _jax_rule_cases()
    tfn, tp, td, jfn, jp, jd = cases[case]
    spec = lambda s: jax.ShapeDtypeStruct(s, f32)  # noqa: E731
    g = tt.trace_graph(tfn, tp, *td)
    g_ref = jt.trace_graph(jfn, {k: spec(v) for k, v in jp.items()},
                           *[spec(d) for d in jd])
    assert _nodes(g) == _nodes(g_ref)
    assert g.edges == g_ref.edges
    assert g.meta == g_ref.meta


def test_user_nchw_convolution_keeps_its_layout():
    """A convolution with no NHWC permute pair is recorded at its own
    NCHW shape, and its window at the NCHW dims."""
    g = tt.trace_graph(lambda p, x: F.max_pool2d(F.conv2d(x, p["w"]), 2),
                       {"w": T(8, 3, 3, 3)}, T(2, 3, 10, 10))
    assert [(nd.op, nd.out_shape) for nd in g.nodes] == [
        ("conv", (2, 8, 8, 8)), ("pool", (2, 8, 4, 4))]
    assert g.nodes[1].attrs == {"window": [1, 1, 2, 2]}
    assert g.meta["n_raw_nodes"] == 2


# ---------------------------------------------------------------------------
# tracer against tracer, per family
# ---------------------------------------------------------------------------

VARIANTS = {
    "vit": [dict(dim=64, depth=2, patch=16, res=32, batch=1),
            dict(dim=96, depth=1, patch=8, res=64, batch=2)],
    "swin": [dict(dim=32, depths=[1, 1, 1, 1], window=2, res=64, batch=1),
             dict(dim=32, depths=[2, 1], window=4, res=32, batch=2)],
    "vgg": [dict(convs=[1, 1, 1, 1, 1], width=0.25, res=32, batch=1),
            dict(convs=[2, 1, 2, 1, 1], width=0.25, res=64, batch=2)],
    "resnet": [dict(depths=[1, 1, 1, 1], width=0.25, res=32, batch=1,
                    bottleneck=False),
               dict(depths=[1, 2, 1, 1], width=0.25, res=64, batch=2,
                    bottleneck=True)],
    "densenet": [dict(blocks=[2, 2, 2, 2], growth=8, res=32, batch=1),
                 dict(blocks=[1, 3, 2, 1], growth=16, res=64, batch=2)],
    "mobilenet": [dict(width=0.35, res=32, batch=1),
                  dict(width=0.5, res=64, batch=2)],
    "mnasnet": [dict(width=0.35, res=32, batch=1),
                dict(width=0.5, res=64, batch=2)],
    "efficientnet": [dict(width=0.5, depth=0.5, res=32, batch=1),
                     dict(width=0.75, depth=0.8, res=64, batch=2)],
    "visformer": [dict(dim=64, conv_depth=1, tx_depth=1, res=32, batch=1),
                  dict(dim=128, conv_depth=2, tx_depth=2, res=48, batch=2)],
    "poolformer": [dict(dim=16, depths=[1, 1, 1, 1], res=32, batch=1),
                   dict(dim=16, depths=[2, 1, 2, 1], res=64, batch=2)],
    "convnext": [dict(dim=16, depths=[1, 1, 1, 1], res=32, batch=1),
                 dict(dim=16, depths=[2, 1, 2, 1], res=64, batch=2)],
}
CASES = [(fam, i) for fam in VARIANTS for i in range(2)]


def _check_dag(g):
    assert [nd.node_id for nd in g.nodes] == list(range(g.num_nodes))
    assert all(nd.op in OP_VOCAB for nd in g.nodes)
    assert all(0 <= s < g.num_nodes and 0 <= d < g.num_nodes and s != d
               for s, d in g.edges)
    assert len(g.topo_order()) == g.num_nodes


def _nodes(g):
    return [(nd.op, nd.out_shape, nd.dtype, nd.attrs, nd.flops, nd.macs,
             nd.bytes_accessed, nd.param_bytes) for nd in g.nodes]


def assert_same_graph(g, g_ref):
    """The reference's graph: every node (op, shape, dtype, attributes,
    costs, bytes), the edges, the whole meta (``n_raw_nodes`` too), the
    node features, the static features and the fingerprint."""
    from repro.core.node_features import node_feature_matrix as jx
    from repro.core.static_features import static_features as js
    from repro_torch.core.node_features import node_feature_matrix as tx
    from repro_torch.core.static_features import static_features as ts
    assert _nodes(g) == _nodes(g_ref)
    assert g.edges == g_ref.edges
    assert g.meta == g_ref.meta
    assert np.array_equal(tx(g), jx(g_ref))
    assert np.array_equal(ts(g), js(g_ref))
    assert g.fingerprint() == g_ref.fingerprint()


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def table2_draw(fam):
    """The family's config in the seed-0 Table-2 draw of all families."""
    rng = np.random.default_rng(0)
    for f in jz.FAMILIES:
        cfg = jz.family_variants(f, rng)
        if f == fam:
            return cfg


@pytest.mark.parametrize("fam", sorted(jz.FAMILIES))
def test_table2_draw_node_for_node(fam):
    """At its Table-2 size (the seed-0 draw), every family's trace is the
    reference's graph: the same ops in the same order at the same NHWC
    shapes, with the same costs, bytes and parameter bytes, the same
    edges, meta (the raw node count too), features and fingerprint."""
    cfg = table2_draw(fam)
    g_ref = jz.trace_family(fam, cfg)
    assert_same_graph(tz.trace_family(fam, cfg), g_ref)
    # chip_smoke.py's zoo_path holds the card machine's traces to these
    assert g_ref.meta["n_raw_nodes"] == _chip_smoke().ZOO_REF_RAW_NODES[fam]


@pytest.mark.parametrize("fam,i", CASES)
def test_trace_family_against_reference(fam, i):
    """Two small variants of each family: the reference's graph, and so
    its labels at the default noise, bit for bit."""
    cfg = VARIANTS[fam][i]
    g_ref = jz.trace_family(fam, dict(cfg))
    g = tz.trace_family(fam, dict(cfg))
    _check_dag(g)
    assert_same_graph(g, g_ref)
    for k in ("family", "batch", "res", *cfg):
        assert g.meta[k] == g_ref.meta[k], k
    assert dataclasses.asdict(tc.estimate(g)) == \
        dataclasses.asdict(jc.estimate(g_ref))


def test_family_variants_draw_for_draw():
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(3):
        for fam in jz.FAMILIES:
            assert tz.family_variants(fam, a) == jz.family_variants(fam, b)
    assert a.random() == b.random()
    assert tz.TABLE2_FRACTIONS == jz.TABLE2_FRACTIONS
    assert list(tz.FAMILIES) == list(jz.FAMILIES)
    axes = {"depth": [6, 12], "dim": [192, 384], "batch": [1, 8]}
    assert tz.variant_grid("vit", axes) == jz.variant_grid("vit", axes)
    with pytest.raises(KeyError):
        tz.variant_grid("alexnet", axes)


def test_build_family_meta_and_specs_on_meta():
    specs, fwd, meta = tz.build_family("resnet", {"res": 64, "batch": 2})
    assert meta == {"family": "resnet", "batch": 2, "res": 64}
    leaves = torch.utils._pytree.tree_leaves(specs)
    assert leaves and all(t.device.type == "meta" for t in leaves)


# ---------------------------------------------------------------------------
# prediction on zoo graphs
# ---------------------------------------------------------------------------

GRID = {"vit": tz.variant_grid("vit", {"depth": [1, 2], "dim": [64, 96],
                                       "batch": [1, 2], "res": [32],
                                       "patch": [16]}),
        "resnet": tz.variant_grid("resnet", {"width": [0.25], "res": [32, 64],
                                             "batch": [1, 4],
                                             "depths": [[1, 1, 1, 1]]})}


@pytest.mark.parametrize("variant", ["graphsage", "gat"])
@pytest.mark.parametrize("family", sorted(GRID))
def test_predict_zoo_matches_jax_predict_many(variant, family):
    """The port's ``predict_zoo`` against the reference's own
    ``predict_zoo``, each on its own package's traces, with the same
    weights."""
    jcfg = jg.PMGNSConfig(hidden=32, n_gnn_blocks=2, n_fc_blocks=2,
                          layout="packed", variant=variant)
    tcfg = tg.PMGNSConfig(**dataclasses.asdict(jcfg))
    tree = jax.tree_util.tree_map(
        np.asarray, jg.pmgns_init(jax.random.PRNGKey(5), jcfg))
    port = DIPPM.from_params(tree, tcfg, device="cpu")
    grid = GRID[family]
    out = port.predict_zoo(family, grid)
    assert [c for c, _ in out] == grid
    ref = JDIPPM.from_params(jax.tree_util.tree_map(jnp.asarray, tree),
                             jcfg).predict_zoo(family, grid)
    assert [c for c, _ in ref] == grid
    got = np.asarray([[p.latency_ms, p.energy_j, p.memory_mb]
                      for _, p in out])
    want = np.asarray([[p.latency_ms, p.energy_j, p.memory_mb]
                       for _, p in ref])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert [p.mig for _, p in out] == [p.mig for _, p in ref]
    # and on the same graphs: the port's traces read by the reference
    graphs = [jf.from_json(tz.trace_family(family, c).to_json())
              for c in grid]
    many = JDIPPM.from_params(jax.tree_util.tree_map(jnp.asarray, tree),
                              jcfg).predict_many(graphs)
    np.testing.assert_allclose(
        got, [[p.latency_ms, p.energy_j, p.memory_mb] for p in many],
        rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

class Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 8, 3, padding=1)
        self.norm = nn.LayerNorm(8)
        self.act = nn.GELU()
        self.fc = nn.Linear(8, 10)

    def forward(self, x):
        y = self.conv(x).permute(0, 2, 3, 1)
        return self.fc(self.act(self.norm(y))).mean((1, 2))


SPEC = ((2, 3, 16, 16), torch.float32)


def test_user_module_traces_exactly_and_stays_untouched():
    torch.manual_seed(0)
    net = Net()
    before = {k: (v.device, v.data_ptr(), v.detach().clone(), v.requires_grad)
              for k, v in net.state_dict(keep_vars=True).items()}
    g = from_torch(net, None, SPEC, meta={"batch": 2})
    n_bytes = sum(p.numel() * 4 for p in net.parameters())
    assert g.meta["param_bytes"] == n_bytes
    assert sum(nd.param_bytes for nd in g.nodes) == n_bytes
    assert g.meta["input_bytes"] == 2 * 3 * 16 * 16 * 4
    assert [nd.op for nd in g.nodes] == ["conv", "add", "elementwise",
                                         "gelu", "dense", "add", "reduce"]
    _check_dag(g)
    after = net.state_dict(keep_vars=True)
    for k, (dev, ptr, val, rg) in before.items():
        assert after[k].device == dev and after[k].data_ptr() == ptr
        assert after[k].requires_grad == rg
        assert torch.equal(after[k].detach(), val)
    # a state mapping traces the same graph
    state = {k: v.detach() for k, v in net.state_dict().items()}
    assert from_torch(net, state, SPEC, meta={"batch": 2}).fingerprint() \
        == g.fingerprint()


def test_entry_points_agree_bit_for_bit():
    cfg = tg.PMGNSConfig(hidden=32, layout="packed")
    dippm = DIPPM.from_params(tg.pmgns_init(0, cfg), cfg, device="cpu")
    net = Net()
    a = dippm.predict_torch(net, None, SPEC, batch=2)
    b = dippm.predict_graph(from_torch(net, None, SPEC, meta={"batch": 2}))
    with dippm.serve() as svc:
        c = svc.submit_torch(net, None, SPEC, batch=2).result(timeout=60)
        bad = svc.submit_torch(lambda p, x: x @ p, T(3, 3), ((2, 4), "float32"))
        with pytest.raises(GraphValidationError, match="did not trace"):
            bad.result(timeout=60)
        stats = svc.stats
    rows = [(p.latency_ms, p.energy_j, p.memory_mb) for p in (a, b, c)]
    assert rows[0] == rows[1] == rows[2]
    assert stats.invalid == 1 and stats.failed == 1
    assert stats.submitted == 2
