"""The port's LM graphs against the JAX package's.

* ``lm.param_specs`` is ``repro.models.lm.param_specs`` leaf for leaf
  (path, shape, dtype) for the six archs the port runs.
* ``lm.forward`` traced on the meta device is the reference's graph of
  its ``lm.forward`` for each of them, at the dataset factory's smallest
  and largest shapes (batch 1, seq 64; batch 8, seq 256): every node
  (op, shape, dtype, attributes, FLOPs, MACs, bytes, parameter bytes),
  the edges, the whole meta with the raw node count, the fingerprint,
  and so the node features, the static features and the labels at the
  factory's noise, bit for bit.
* The new rows of the tracer's raw-node rule and the jnp steps of the
  graph forms (a scan's xs and ys, a literal bound to a jitted function,
  a dynamic index, jnp's gathers, ``dot_general``, ``jnp.tri``), each on
  a small program written both ways.
* The graph forms compute the serving function: ``_flash_fwd_chunks`` /
  ``blockwise_attention`` and ``_ssd_chunked`` on seeded float32
  CPU tensors against the reference's jnp functions and against the
  kernels' plain versions, at 1e-5 relative.
* An arch whose layers have no graph form yet (MoE, MLA) raises naming
  ROADMAP A14c-2 on the meta device, one whose blocks the port does not
  run (cross-attention, the audio frontend) A14c-3, and a meta tensor
  that reaches a kernel entry raises.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro import nn as jnn  # noqa: E402
from repro.core import tracer as jt  # noqa: E402
from repro.core.frontends import from_jax  # noqa: E402
from repro.core.node_features import node_feature_matrix as j_x  # noqa: E402
from repro.core.static_features import static_features as j_static  # noqa: E402,E501
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.perfmodel.cost_model import estimate as j_estimate  # noqa: E402
from repro.perfmodel.devices import DEVICES as J_DEVICES  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import prims  # noqa: E402
from repro_torch.core import tracer as tt  # noqa: E402
from repro_torch.core.frontends import from_torch  # noqa: E402
from repro_torch.core.node_features import node_feature_matrix as t_x  # noqa: E402,E501
from repro_torch.core.static_features import static_features as t_static  # noqa: E402,E501
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.models import graph_form as G  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.perfmodel.cost_model import estimate as t_estimate  # noqa: E402,E501
from repro_torch.perfmodel.devices import DEVICES as T_DEVICES  # noqa: E402

PORTED = ["qwen2.5-3b", "mamba2-370m", "zamba2-2.7b", "yi-34b",
          "h2o-danube-3-4b", "chatglm3-6b"]
#: arch → the ROADMAP item its refusal names on the meta device
UNPORTED = {"deepseek-v2-236b": "A14c-2", "grok-1-314b": "A14c-2",
            "llama-3.2-vision-11b": "A14c-3", "hubert-xlarge": "A14c-3"}
#: the factory's smallest and largest (batch, seq)
SHAPES = [(1, 64), (8, 256)]
#: the factory's device and noise
DEVICE, SIGMA = "a100-40gb", 0.01
RTOL = 1e-5


def _nodes(g):
    return [(nd.op, nd.out_shape, nd.dtype, nd.attrs, nd.flops, nd.macs,
             nd.bytes_accessed, nd.param_bytes) for nd in g.nodes]


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, prefix + (k,)))
        return out
    return {prefix: tree}


# ---------------------------------------------------------------------------
# param_specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", PORTED)
def test_param_specs_match_reference(arch):
    from repro.configs import get_smoke_config as jget
    got = _paths(lm.param_specs(get_smoke_config(arch)))
    want = _paths(jlm.param_specs(jget(arch)))
    assert set(got) == set(want)
    for path, (shape, dtype) in got.items():
        assert shape == tuple(want[path].shape), path
        assert str(dtype).replace("torch.", "") == str(want[path].dtype), \
            path
    # (shape, dtype) pairs: nothing is allocated
    assert all(isinstance(v, tuple) and isinstance(v[1], torch.dtype)
               for v in got.values())


# ---------------------------------------------------------------------------
# lm.forward: the reference's graph and record
# ---------------------------------------------------------------------------

def _graphs(arch, batch, seq):
    from repro.configs import get_smoke_config as jget
    jcfg, tcfg = jget(arch), get_smoke_config(arch)
    meta = {"family": arch, "batch": batch, "seq": seq}
    gj = from_jax(lambda p, t: jlm.forward(p, jcfg, {"tokens": t})[0],
                  jlm.param_specs(jcfg),
                  jax.ShapeDtypeStruct((batch, seq), jnp.int32), meta=meta)
    gt = from_torch(lambda p, t: lm.forward(p, tcfg, {"tokens": t})[0],
                    lm.param_specs(tcfg), ((batch, seq), torch.int32),
                    meta=meta)
    return gj, gt


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"b{s[0]}s{s[1]}")
@pytest.mark.parametrize("arch", PORTED)
def test_lm_graph_and_record_match_reference(arch, shape):
    try:
        G.trace_internals()
    except ImportError as e:
        pytest.fail(f"RoPE's constant cannot be traced: {e}")
    gj, gt = _graphs(arch, *shape)
    assert _nodes(gt) == _nodes(gj)
    assert gt.edges == gj.edges
    assert gt.meta == gj.meta and gt.meta["n_raw_nodes"] > gt.num_nodes
    assert gt.fingerprint() == gj.fingerprint()
    x, xr = t_x(gt), j_x(gj)
    assert x.dtype == xr.dtype and np.array_equal(x, xr)
    assert np.array_equal(t_static(gt), j_static(gj))
    y = t_estimate(gt, T_DEVICES[DEVICE], noise_sigma=SIGMA).as_targets()
    yr = j_estimate(gj, J_DEVICES[DEVICE], noise_sigma=SIGMA).as_targets()
    assert np.asarray(y).dtype == np.asarray(yr).dtype
    assert np.array_equal(y, yr)


@pytest.mark.parametrize("arch", sorted(UNPORTED))
def test_unported_arch_raises_on_the_meta_device(arch):
    cfg = get_smoke_config(arch)
    with pytest.raises(NotImplementedError, match=UNPORTED[arch]):
        lm.param_specs(cfg)
    tok = torch.empty((1, 64), dtype=torch.int32, device="meta")
    with pytest.raises(NotImplementedError, match=UNPORTED[arch]):
        lm.forward({}, cfg, {"tokens": tok})


def test_meta_tensor_at_a_kernel_entry_raises():
    q = torch.empty((1, 64, 4, 16), device="meta")
    k = torch.empty((1, 64, 2, 16), device="meta")
    with pytest.raises(ValueError, match="meta"):
        ops.flash_attention(q, k, k, causal=True)
    x = torch.empty((1, 64, 8, 16), device="meta")
    dt = torch.empty((1, 64, 8), device="meta")
    bc = torch.empty((1, 64, 1, 16), device="meta")
    with pytest.raises(ValueError, match="meta"):
        ops.ssd_scan(x, dt, torch.empty(8, device="meta"), bc, bc, chunk=32)


# ---------------------------------------------------------------------------
# the raw-node rule and the jnp steps, each written both ways
# ---------------------------------------------------------------------------

def _rule_cases():
    f32, i32 = jnp.float32, jnp.int32

    def t_scan_xs(p, x):
        for w in p["w"].unbind(0):
            x = torch.tanh(x @ w)
        return x

    def j_scan_xs(p, x):
        return lax.scan(lambda h, w: (jnp.tanh(h @ w), None), x, p["w"])[0]

    def t_scan_ys(p, x):
        states, h = [], x
        for w in p["w"].unbind(0):
            states.append(h)
            h = h * w + 1.0
        return torch.exp(prims.scan_ys(states)) + h.sum()

    def j_scan_ys(p, x):
        h, ys = lax.scan(lambda c, w: (c * w + 1.0, c), x, p["w"])
        return jnp.exp(ys) + h.sum()

    def t_literal_ys(p, x):
        zero = torch.zeros((), device=x.device)
        for w in p["w"].unbind(0):
            x = x @ w
        return x + prims.scan_ys([zero] * 3).sum()

    def j_literal_ys(p, x):
        x, aux = lax.scan(lambda h, w: (h @ w, jnp.zeros((), f32)), x,
                          p["w"])
        return x + aux.sum()

    cases = {
        # name: (torch fn, params, data, jnp fn, params, data); specs are
        # (shape, dtype) with a jnp dtype
        "scan_xs": (t_scan_xs, j_scan_xs, {"w": ((3, 4, 4), f32)},
                    [((2, 4), f32)]),
        "scan_ys": (t_scan_ys, j_scan_ys, {"w": ((3, 4), f32)},
                    [((4,), f32)]),
        "scan_literal_ys": (t_literal_ys, j_literal_ys,
                            {"w": ((3, 4, 4), f32)}, [((2, 4), f32)]),
        "jit_literal_arg": (lambda p, x: G.softplus(x),
                            lambda p, x: jax.nn.softplus(x), {},
                            [((2, 8), f32)]),
        "dynamic_index": (
            lambda p, x: torch.exp(torch.ops.aten.index(
                x, [None, None, G.index(-1, 5, x.device)])),
            lambda p, x: jnp.exp(x[:, :, -1]), {}, [((2, 3, 5, 4), f32)]),
        "strided_gather": (lambda p, x: G.lanes(x, 1, 2) * 2.0,
                           lambda p, x: x[..., 1::2] * 2.0, {},
                           [((2, 3, 8), f32)]),
        "take_rows": (lambda p, i: G.take_rows(p["e"], i) * 2.0,
                      lambda p, i: jnp.take(p["e"], i, axis=0) * 2.0,
                      {"e": ((10, 4), f32)}, [((2, 3), i32)]),
        "dot_general": (
            lambda p, q, k: prims.dot_general(
                k, q, [3], [4], [0, 2], [0, 2]).permute(0, 1, 4, 3, 2),
            lambda p, q, k: jnp.einsum("bqgrd,bkgd->bgrqk", q, k), {},
            [((2, 5, 3, 2, 4), f32), ((2, 7, 3, 4), f32)]),
        "tri_where": (
            lambda p, x: G.where(G.tril_ones(4, x.device), x,
                                       0.0),
            lambda p, x: jnp.where(jnp.tril(jnp.ones((4, 4), bool)), x, 0.0),
            {}, [((4, 4), f32)]),
        "rmsnorm_mean": (lambda p, x: G.rmsnorm(p, x),
                         lambda p, x: jnn.rmsnorm(p, x),
                         {"scale": ((8,), f32)}, [((2, 3, 8), f32)]),
    }
    return cases


RULE_CASES = ["scan_xs", "scan_ys", "scan_literal_ys", "jit_literal_arg",
              "dynamic_index", "strided_gather", "take_rows", "dot_general",
              "tri_where", "rmsnorm_mean"]


def _tspec(spec):
    shape, dtype = spec
    return (shape, getattr(torch, jnp.dtype(dtype).name))


@pytest.mark.parametrize("case", RULE_CASES)
def test_raw_node_rule_matches_reference(case):
    tfn, jfn, params, data = _rule_cases()[case]
    g = tt.trace_graph(tfn, {k: _tspec(v) for k, v in params.items()},
                       *[_tspec(d) for d in data])
    g_ref = jt.trace_graph(
        jfn, {k: jax.ShapeDtypeStruct(*v) for k, v in params.items()},
        *[jax.ShapeDtypeStruct(*d) for d in data])
    assert _nodes(g) == _nodes(g_ref)
    assert g.edges == g_ref.edges
    assert g.meta == g_ref.meta


class _TwoBranches(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.a = torch.nn.Linear(8, 8)
        self.b = torch.nn.Linear(8, 8)

    def forward(self, x):
        return torch.tanh(torch.stack([self.a(x), self.b(x)]))


def test_stack_in_a_user_module_keeps_every_operand():
    """An ``aten.stack`` outside the graph forms is a node with an edge
    from each operand: both branches feed it (a scan's ys, which take
    their last operand's origin, are ``prims.scan_ys`` only)."""
    g = from_torch(_TwoBranches(), None, ((2, 8), torch.float32))
    ops_ = [nd.op for nd in g.nodes]
    assert ops_.count("dense") == 2 and ops_.count("add") == 2
    stack = ops_.index("elementwise")
    branches = [i for i, op in enumerate(ops_) if op == "add"]
    feeds = {a for a, b in g.edges if b == stack}
    assert set(branches) <= feeds
    assert (stack, ops_.index("tanh")) in g.edges


def test_prims_compute_their_jax_primitive():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((2, 5, 3, 4)).astype(np.float32)
    b = rng.standard_normal((2, 3, 4, 6)).astype(np.float32)
    dims = (([3], [2]), ([0, 2], [0, 1]))
    want = np.asarray(lax.dot_general(a, b, dims))
    got = prims.dot_general(torch.tensor(a), torch.tensor(b), [3], [2],
                            [0, 2], [0, 1])
    assert got.shape == want.shape == (2, 3, 5, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6)
    # nothing to contract: a product over batch dims only
    w = rng.standard_normal((2, 3)).astype(np.float32)
    v = rng.standard_normal((2, 3, 4)).astype(np.float32)
    got = prims.dot_general(torch.tensor(w), torch.tensor(v), [], [],
                            [0, 1], [0, 1])
    np.testing.assert_array_equal(got.numpy(), w[..., None] * v)
    ys = [torch.tensor(rng.standard_normal((3, 2)).astype(np.float32))
          for _ in range(4)]
    np.testing.assert_array_equal(prims.scan_ys(ys).numpy(),
                                  np.stack([y.numpy() for y in ys]))
    for dim in (0, 1):
        np.testing.assert_array_equal(
            prims.iota([3, 4], dim, torch.int32, "cpu").numpy(),
            np.asarray(lax.broadcasted_iota(jnp.int32, (3, 4), dim)))


# ---------------------------------------------------------------------------
# the graph forms compute the serving function
# ---------------------------------------------------------------------------

ATTN_CASES = {
    # name: (B, Sq, Skv, H, Hkv, D, causal, window, q_chunk, kv_chunk)
    "one_chunk_gqa": (2, 64, 64, 4, 2, 16, True, 0, 2048, 1024),
    "window": (1, 64, 64, 4, 2, 16, True, 16, 2048, 1024),
    "chunked_padded": (1, 40, 40, 2, 1, 8, True, 0, 16, 16),
    "not_causal": (2, 24, 32, 2, 2, 8, False, 0, 2048, 8),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_graph_form_computes_attention(case):
    b, sq, skv, h, hkv, d, causal, window, qc, kc = ATTN_CASES[case]
    rng = np.random.default_rng(7)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    got = G.blockwise_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=causal,
        window=window, q_chunk=qc, kv_chunk=kc).numpy()
    want = np.asarray(JL.blockwise_attention(q, k, v, causal=causal,
                                             window=window, q_chunk=qc,
                                             kv_chunk=kc))
    plain = kref.flash_attention_ref(torch.tensor(q), torch.tensor(k),
                                     torch.tensor(v), causal=causal,
                                     window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(got, plain, rtol=RTOL, atol=1e-6)


def test_flash_fwd_chunks_lse_matches_reference():
    rng = np.random.default_rng(3)
    nq, b, qc, g, r, d, nk, kc = 2, 1, 16, 2, 2, 8, 3, 8
    qs = rng.standard_normal((nq, b, qc, g, r, d)).astype(np.float32)
    ks = rng.standard_normal((nk, b, kc, g, d)).astype(np.float32)
    vs = rng.standard_normal((nk, b, kc, g, d)).astype(np.float32)
    scale = 1.0 / math.sqrt(d)
    out, lse = G._flash_fwd_chunks(torch.tensor(qs), torch.tensor(ks),
                                   torch.tensor(vs), 8, 0, nk * kc, True, 0,
                                   scale)
    wout, wlse = JL._flash_fwd_chunks(qs, ks, vs, 8, 0, nk * kc, True, 0,
                                      scale, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(wout), rtol=RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), np.asarray(wlse), rtol=RTOL,
                               atol=1e-6)


SSD_CASES = {
    # name: (Bt, S, H, P, N, chunk, with s0)
    "two_chunks": (1, 64, 8, 16, 16, 32, False),
    "batch_eight_chunks": (2, 256, 4, 8, 8, 32, False),
    "padded_from_state": (2, 40, 4, 8, 16, 16, True),
}


@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_graph_form_computes_the_scan(case):
    bt, s, h, p, n, chunk, with_s0 = SSD_CASES[case]
    rng = np.random.default_rng(11)
    x = rng.standard_normal((bt, s, h, p)).astype(np.float32)
    dt = (0.05 + 0.1 * rng.random((bt, s, h))).astype(np.float32)
    a = -np.exp(0.1 * rng.standard_normal(h)).astype(np.float32)
    bm = rng.standard_normal((bt, s, h, n)).astype(np.float32)
    cm = rng.standard_normal((bt, s, h, n)).astype(np.float32)
    s0 = rng.standard_normal((bt, h, n, p)).astype(np.float32) \
        if with_s0 else None
    T = torch.tensor
    y, last = G._ssd_chunked(T(x), T(dt), T(a), T(bm), T(cm), chunk,
                              s0=None if s0 is None else T(s0))
    wy, wlast = JL._ssd_chunked(x, dt, a, bm, cm, chunk, s0=s0)
    py, plast = kref.ssd_scan_ref(T(x), T(dt), T(a), T(bm), T(cm),
                                  chunk=chunk,
                                  s0=None if s0 is None else T(s0))
    for got, want in ((y, wy), (last, wlast), (y, py), (last, plast)):
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                   atol=RTOL * scale)
