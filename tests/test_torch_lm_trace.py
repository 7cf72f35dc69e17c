"""The port's LM graphs against the JAX package's.

* ``lm.param_specs`` is ``repro.models.lm.param_specs`` leaf for leaf
  (path, shape, dtype) for the eight archs the port runs (the
  mixture-of-experts and MLA archs deepseek-v2 and grok-1 among them, the
  router a float32 leaf).
* ``lm.forward`` traced on the meta device is the reference's graph of
  its ``lm.forward`` for each of them, at the dataset factory's smallest
  and largest shapes (batch 1, seq 64; batch 8, seq 256): every node
  (op, shape, dtype, attributes, FLOPs, MACs, bytes, parameter bytes),
  the edges, the whole meta with the raw node count, the fingerprint,
  and so the node features, the static features and the labels at the
  factory's noise, bit for bit.
* The new rows of the tracer's raw-node rule and the jnp steps of the
  graph forms (a scan's xs and ys, a literal bound to a jitted function,
  a dynamic index, jnp's gathers, ``dot_general``, ``jnp.tri``,
  ``lax.top_k``, ``take_along_axis``, ``.at[i].add``, jnp's softmax),
  each on a small program written both ways.
* The MoE block's graph form (``_route`` and ``moe_apply_local``) and the
  full-sequence MLA layer trace to the reference's jaxpr of that
  function alone, node for node.
* The graph forms compute the serving function: ``_flash_fwd_chunks`` /
  ``blockwise_attention`` (also at MLA's Dv != D) and ``_ssd_chunked`` on
  seeded float32 CPU tensors against the reference's jnp functions and
  against the kernels' plain versions, at 1e-5 relative; the MoE graph
  form against the reference's ``_route`` / ``moe_apply_local`` (a router
  of unit scale, so no near-ties; replicas dropped at a capacity factor
  of 0.5), its ids, keep masks and slots equal to the serving form's.
* The cross-attention and audio archs (llama-3.2-vision, hubert) are
  traceable: their specs and a meta-device forward (their graphs are held
  to the reference's in ``tests/test_torch_lm_vision_audio.py``); and a
  meta tensor that reaches a kernel entry raises.

torch runs one intra-op thread while the file runs, as the other LM
test files do.
"""
import dataclasses
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
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.perfmodel.cost_model import estimate as t_estimate  # noqa: E402,E501
from repro_torch.perfmodel.devices import DEVICES as T_DEVICES  # noqa: E402

MOE_ARCHS = ["deepseek-v2-236b", "grok-1-314b"]
PORTED = ["qwen2.5-3b", "mamba2-370m", "zamba2-2.7b", "yi-34b",
          "h2o-danube-3-4b", "chatglm3-6b"] + MOE_ARCHS
#: the cross-attention and audio archs (refused on the meta device, naming
#: ROADMAP A14c-3, until it was ported)
VISION_AUDIO = ["hubert-xlarge", "llama-3.2-vision-11b"]
#: the factory's smallest and largest (batch, seq)
SHAPES = [(1, 64), (8, 256)]
#: the factory's device and noise
DEVICE, SIGMA = "a100-40gb", 0.01
RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the file's float32 sums in one order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_and_mla_archs_are_traceable(arch):
    """``check_supported`` takes the MoE and MLA archs at the smoke and the
    full config; ``param_specs`` keeps the router in float32 whatever
    ``param_dtype`` is."""
    from repro_torch.configs import get_config
    for cfg in (get_smoke_config(arch), get_config(arch)):
        lm.check_supported(cfg)
        specs = lm.param_specs(cfg)
        assert specs["blocks"]["ffn"]["router"][1] == torch.float32
        assert specs["blocks"]["ffn"]["experts"]["wg"][1] == \
            getattr(torch, cfg.param_dtype)


@pytest.mark.parametrize("arch", VISION_AUDIO)
def test_unported_arch_raises_on_the_meta_device(arch):
    """Both archs trace now: ``check_supported`` takes them, ``param_specs``
    gives the reference's leaves, and ``lm.forward`` over meta tensors
    gives meta logits; only an input the frontend needs, left out, still
    raises."""
    from repro.configs import get_smoke_config as jget
    cfg = get_smoke_config(arch)
    lm.check_supported(cfg)
    specs = lm.param_specs(cfg)
    assert set(_paths(specs)) == set(_paths(jlm.param_specs(jget(arch))))
    tree = {}
    for path, (shape, dtype) in _paths(specs).items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.empty(shape, dtype=dtype, device="meta")
    meta = dict(device="meta")
    if cfg.frontend == "audio_frames":
        inputs = {"features": torch.empty((1, 64, cfg.d_model), **meta)}
    else:
        inputs = {"tokens": torch.empty((1, 64), dtype=torch.int32, **meta),
                  "vision_embeds": torch.empty(
                      (1, cfg.vision_tokens, cfg.vision_dim), **meta)}
    logits, _ = lm.forward(tree, cfg, inputs)
    assert logits.is_meta and logits.shape == (1, 64, cfg.vocab)
    with pytest.raises(KeyError):
        lm.forward(tree, cfg, {})


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
        "top_k": (lambda p, x: _top_k_both(prims.top_k(x, 2)),
                  lambda p, x: _top_k_both(lax.top_k(x, 2)), {},
                  [((3, 5), f32)]),
        "take_along_axis": (
            lambda p, x, i: torch.gather(
                x, 1, G.wrap_index(i[:, None], 5))[:, 0] * 2,
            lambda p, x, i: jnp.take_along_axis(x, i[:, None], axis=1)[:, 0]
            * 2, {}, [((4, 5), i32), ((4,), i32)]),
        "scatter_add": (
            lambda p, x, i: torch.zeros((6, 3), device=x.device).index_add(
                0, G.wrap_index(i, 6), x) * 2.0,
            lambda p, x, i: jnp.zeros((6, 3), f32).at[i].add(x) * 2.0, {},
            [((4, 3), f32), ((4,), i32)]),
        "softmax": (lambda p, x: G.softmax(x) * 2.0,
                    lambda p, x: jax.nn.softmax(x, axis=-1) * 2.0, {},
                    [((3, 4, 5), f32)]),
    }
    return cases


def _top_k_both(vi):
    """Both outputs of a top-k on: the values doubled, the indices +1."""
    v, i = vi
    return v * 2.0, i + 1


RULE_CASES = ["scan_xs", "scan_ys", "scan_literal_ys", "jit_literal_arg",
              "dynamic_index", "strided_gather", "take_rows", "dot_general",
              "tri_where", "rmsnorm_mean", "top_k", "take_along_axis",
              "scatter_add", "softmax"]


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


def test_flash_graph_form_at_mla_dims():
    """The graph form at MLA's full-sequence dims (D = nope + rope over
    Dv = v_head_dim, scale 1 / sqrt(D)), in one chunk and in padded
    chunks, against the reference and the flash twin."""
    rng = np.random.default_rng(5)
    b, s, h, d, dv = 2, 40, 4, 24, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, h, d)).astype(np.float32)
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    scale = 1.0 / math.sqrt(d)
    T = torch.tensor
    plain = kref.flash_attention_ref(T(q), T(k), T(v), causal=True,
                                     scale=scale).numpy()
    for qc, kc in ((2048, 1024), (16, 16)):
        got = G.blockwise_attention(T(q), T(k), T(v), causal=True,
                                    q_chunk=qc, kv_chunk=kc,
                                    scale=scale).numpy()
        want = np.asarray(JL.blockwise_attention(q, k, v, causal=True,
                                                 q_chunk=qc, kv_chunk=kc,
                                                 scale=scale))
        assert got.shape == (b, s, h, dv)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
        np.testing.assert_allclose(got, plain, rtol=RTOL, atol=1e-6)


# ---------------------------------------------------------------------------
# MoE and MLA: the graph forms against the reference
# ---------------------------------------------------------------------------

#: tokens of the MoE graph-form tests
MOE_TOKENS = 48


def _moe_cfgs(arch, capacity_factor=None):
    from repro.configs import get_smoke_config as jget
    jcfg, tcfg = jget(arch), get_smoke_config(arch)
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=capacity_factor))
    return jcfg, tcfg


def _layer_specs(jcfg, part):
    """One MoE layer's ``ffn`` or ``attn`` tree (the stack's axis cut): the
    reference's specs and the port's ``(shape, dtype)`` pairs."""
    tree = jlm.param_specs(jcfg)["blocks"][part]
    jspec = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape[1:], x.dtype), tree)
    tspec = jax.tree_util.tree_map(
        lambda x: (tuple(x.shape[1:]), getattr(torch, str(x.dtype))), tree)
    return jspec, tspec


def _moe_params(jcfg, seed):
    """Seeded numpy weights for one MoE layer: experts at 0.1, the router
    at unit scale (the top-k has no near-ties)."""
    jspec, _ = _layer_specs(jcfg, "ffn")
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(
        lambda x: (0.1 * rng.standard_normal(x.shape)).astype(np.float32),
        jspec)
    p["router"] = rng.standard_normal(jspec["router"].shape).astype(
        np.float32)
    return p


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


@pytest.mark.parametrize("factor", [None, 0.5], ids=["default", "drops"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_graph_form_computes_the_reference(arch, factor):
    jcfg, tcfg = _moe_cfgs(arch, factor)
    mo = tcfg.moe
    p = _moe_params(jcfg, 1)
    x = np.random.default_rng(2).standard_normal(
        (MOE_TOKENS, jcfg.d_model)).astype(np.float32)
    tp, tx = _torch_tree(p), torch.tensor(x)
    probs, ids, aux = G.moe_route(tp["router"], tx, mo.n_experts, mo.top_k)
    wprobs, wids, waux = JL._route(p["router"], x, jcfg.moe)
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(wids))
    np.testing.assert_allclose(probs.numpy(), np.asarray(wprobs), rtol=RTOL,
                               atol=1e-7)
    np.testing.assert_allclose(float(aux), float(waux), rtol=RTOL)
    # the dispatch: the serving form's (held to the reference by
    # tests/test_torch_lm_moe_mla.py)
    keep, slot = G.moe_slots(ids, mo.n_experts, int(math.ceil(
        MOE_TOKENS * mo.top_k / mo.n_experts * mo.capacity_factor)))
    skeep, sslot, _ = TL.moe_slots(ids.long(), mo, MOE_TOKENS)
    assert torch.equal(keep, skeep) and torch.equal(slot.long(), sslot)
    if factor is not None:
        assert bool((~keep).any())
    y, yaux = G.moe_apply_local(tp, mo, tx)
    wy, wyaux = JL.moe_apply_local(p, jcfg, x)
    wy = np.asarray(wy)
    np.testing.assert_allclose(y.numpy(), wy, rtol=RTOL,
                               atol=RTOL * float(np.abs(wy).max()))
    assert float(yaux) == float(aux)
    sy, saux = TL.moe_apply_local(tp, tcfg, tx)
    np.testing.assert_allclose(y.numpy(), sy.numpy(), rtol=RTOL,
                               atol=RTOL * float(np.abs(wy).max()))
    np.testing.assert_allclose(float(saux), float(aux), rtol=RTOL)


def _part_fns(arch, part):
    """(torch fn, jnp fn, param specs both ways, data specs) of one layer
    part traced alone."""
    jcfg, tcfg = _moe_cfgs(arch)
    f32, i32 = jnp.float32, jnp.int32
    x = ((2, 32, jcfg.d_model), f32)
    if part == "route":
        jspec, tspec = _layer_specs(jcfg, "ffn")
        mo = tcfg.moe
        return (lambda p, x: G.moe_route(p["router"], x, mo.n_experts,
                                         mo.top_k),
                lambda p, x: JL._route(p["router"], x, jcfg.moe),
                jspec, tspec, [((64, jcfg.d_model), f32)])
    if part == "block":
        jspec, tspec = _layer_specs(jcfg, "ffn")
        return (lambda p, x: TL.moe_apply_local(p, tcfg, x),
                lambda p, x: JL.moe_apply_local(p, jcfg, x),
                jspec, tspec, [((64, jcfg.d_model), f32)])
    jspec, tspec = _layer_specs(jcfg, "attn")
    return (lambda p, x, pos: TL.mla_apply(p, tcfg, x, positions=pos)[0],
            lambda p, x, pos: JL.mla_apply(p, jcfg, x, positions=pos)[0],
            jspec, tspec, [x, ((2, 32), i32)])


@pytest.mark.parametrize("arch,part", [
    ("grok-1-314b", "route"), ("grok-1-314b", "block"),
    ("deepseek-v2-236b", "route"), ("deepseek-v2-236b", "block"),
    ("deepseek-v2-236b", "mla")])
def test_moe_and_mla_graph_forms_are_the_reference_jaxpr(arch, part):
    """``_route``, ``moe_apply_local`` (routing, dispatch, experts and the
    shared MLP) and MLA's full-sequence form, each traced alone on the
    meta device: the reference's jaxpr of the same function, node for
    node, with edges and the raw node count."""
    tfn, jfn, jspec, tspec, data = _part_fns(arch, part)
    g = tt.trace_graph(tfn, tspec, *[_tspec(d) for d in data])
    g_ref = jt.trace_graph(jfn, jspec,
                           *[jax.ShapeDtypeStruct(*d) for d in data])
    assert _nodes(g) == _nodes(g_ref)
    assert g.edges == g_ref.edges
    assert g.meta == g_ref.meta
