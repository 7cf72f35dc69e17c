"""The PyTorch port's graph front end against the JAX package's.

The same documents and numpy inputs go through both packages: parsed
graphs, fingerprints, feature matrices, samples, bin plans and packed
arrays must be exactly equal, and malformed documents must raise the same
typed errors. Also holds the port to its import rule: nothing under
``src/repro_torch`` (nor ``chip_smoke.py``) imports JAX or the JAX
package.
"""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import batching as jb  # noqa: E402
from repro.core import frontends as jf  # noqa: E402
from repro.core import ir as jir  # noqa: E402
from repro.core import node_features as jnf  # noqa: E402
from repro.core.static_features import static_features as j_static  # noqa: E402
from repro.dataset.builder import synthetic_samples as j_synthetic  # noqa: E402
from repro_torch.core import batching as tb  # noqa: E402
from repro_torch.core import frontends as tf  # noqa: E402
from repro_torch.core import ir as tir  # noqa: E402
from repro_torch.core import node_features as tnf  # noqa: E402
from repro_torch.core.static_features import static_features as t_static  # noqa: E402
from repro_torch.dataset.builder import synthetic_samples as t_synthetic  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
OPS = list(jir.OP_VOCAB) + ["Conv2D", "ReLU", "gemm", "reshape", "transpose",
                            "mystery_op"]


def _dag_doc(seed, n, schema=True):
    """A seeded DAG document with aliased and layout ops mixed in."""
    rng = np.random.default_rng(seed)
    nodes, edges = [], []
    for i in range(n):
        op = str(rng.choice(OPS))
        rank = int(rng.integers(1, 5))
        shape = [int(v) for v in rng.integers(1, 64, rank)]
        attrs = {}
        if rng.random() < 0.3:
            attrs = {"kernel": [3, 3], "stride": [2], "groups": 4,
                     "window": [2], "contract_k": 64, "moved_elems": 128}
        nodes.append({"id": i, "op": op, "out_shape": shape,
                      "dtype": str(rng.choice(["float32", "bfloat16",
                                               "int8"])),
                      "attrs": attrs, "flops": float(rng.integers(0, 1e6)),
                      "macs": float(rng.integers(0, 1e5)),
                      "bytes_accessed": float(rng.integers(0, 1e6)),
                      "param_bytes": float(rng.integers(0, 1e4))})
        if i:
            for s in sorted(set(rng.integers(0, i, min(i, 3)).tolist())):
                edges.append([s, i])
    doc = {"nodes": nodes, "edges": edges,
           "meta": {"batch": int(rng.integers(1, 64)), "family": "dag"}}
    if schema:
        doc["schema"] = "repro.opgraph.v1"
    return doc


DOCS = [_dag_doc(s, n, schema=s % 2 == 0)
        for s, n in enumerate([1, 2, 7, 40, 130, 600, 1300])]


@pytest.mark.parametrize("i", range(len(DOCS)))
def test_parsed_graph_and_fingerprint_equal(i):
    gj, gt = jf.from_json(DOCS[i]), tf.from_json(DOCS[i])
    assert gt.to_json() == gj.to_json()
    assert gt.fingerprint() == gj.fingerprint()
    # the port's own round trip keeps the hash
    assert tir.OpGraph.loads(gt.dumps()).fingerprint() == gj.fingerprint()


@pytest.mark.parametrize("i", range(len(DOCS)))
def test_adjacency_degrees_and_graph_tensors_equal(i):
    gj, gt = jf.from_json(DOCS[i]), tf.from_json(DOCS[i])
    np.testing.assert_array_equal(gt.adjacency(), gj.adjacency())
    np.testing.assert_array_equal(gt.in_degrees(), gj.in_degrees())
    assert gt.in_degrees().dtype == gj.in_degrees().dtype
    np.testing.assert_array_equal(tnf.adjacency_matrix(gt),
                                  jnf.adjacency_matrix(gj))
    for got, want in zip(tnf.graph_tensors(gt), jnf.graph_tensors(gj)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for nt, nj in zip(gt.nodes[:20], gj.nodes[:20]):
        np.testing.assert_array_equal(tnf.node_feature(nt),
                                      jnf.node_feature(nj))


@pytest.mark.parametrize("i", range(len(DOCS)))
def test_features_and_samples_equal(i):
    gj, gt = jf.from_json(DOCS[i]), tf.from_json(DOCS[i])
    np.testing.assert_array_equal(tnf.node_feature_matrix(gt),
                                  jnf.node_feature_matrix(gj))
    for ext in (False, True):
        np.testing.assert_array_equal(t_static(gt, ext), j_static(gj, ext))
        sj = jb.sample_from_graph(gj, extended_static=ext)
        st = tb.sample_from_graph(gt, extended_static=ext)
        for k in ("x", "edges", "mask", "static"):
            np.testing.assert_array_equal(getattr(st, k), getattr(sj, k))
        assert st.meta == sj.meta


# the JSON cases of tests/test_lifecycle.py and tests/test_ir_tracer.py
BAD_DOCS = [
    ([1, 2], "must be a mapping"),
    ({"edges": []}, "no 'nodes'"),
    ({"nodes": [17]}, "not a mapping"),
    ({"nodes": [{"op": "dense"}]}, "missing required field 'id'"),
    ({"nodes": [{"id": "x", "op": "dense"}]}, "non-integer id"),
    ({"nodes": [{"id": 0, "op": "dense"}, {"id": 0, "op": "relu"}]},
     "duplicate node id 0"),
    ({"nodes": [{"id": 0, "op": "dense", "out_shape": "bad"}]},
     "malformed out_shape"),
    ({"nodes": [{"id": 0, "op": "dense", "out_shape": [4, -1]}]},
     "negative out_shape"),
    ({"nodes": [{"id": 0, "op": "dense", "out_shape": [4]}],
      "edges": [[0, 7]]}, "references node 7"),
    ({"nodes": [{"id": 0, "op": "dense", "out_shape": [4]}],
      "edges": ["nope"]}, "integer pair"),
    ({"nodes": [{"id": 0, "op": "dense", "out_shape": [4]},
                {"id": 1, "op": "relu", "out_shape": [4]}],
      "edges": [[0, 1], [1, 0]]}, "cycle"),
    ({"nodes": [{"id": 3, "op": "dense", "out_shape": [4, -2]}]},
     "negative out_shape"),
    ({"schema": "repro.opgraph.v1", "nodes": [{"id": 0}]}, "malformed"),
    ({"schema": "repro.opgraph.v1",
      "nodes": [{"id": 0, "op": "dense", "out_shape": [2]}],
      "edges": [[0, 4]]}, "references node 4"),
]


@pytest.mark.parametrize("doc,msg", BAD_DOCS)
def test_typed_validation_errors_match(doc, msg):
    with pytest.raises(jir.GraphValidationError, match=msg) as ej:
        jf.from_json(doc)
    with pytest.raises(tir.GraphValidationError, match=msg) as et:
        tf.from_json(doc)
    assert str(et.value) == str(ej.value)
    assert et.value.node_id == ej.value.node_id


def test_foreign_aliases_and_no_mutation():
    doc = {"nodes": [{"id": 0, "op": "Conv2D", "out_shape": [1, 8, 8, 16]},
                     {"id": 1, "op": "ReLU", "out_shape": [1, 8, 8, 16]},
                     {"id": 2, "op": "GEMM", "out_shape": [1, 10]}],
           "edges": [[0, 1], [1, 2]], "meta": {"batch": 1}}
    g = tf.from_json(doc)
    assert [nd.op for nd in g.nodes] == ["conv", "relu", "dense"]
    src = tir.OpGraph(nodes=[tir.OpNode(0, "gemm", (4, 64), flops=512.0),
                             tir.OpNode(1, "ReLU", (4, 64), flops=256.0)],
                      edges=[(0, 1)], meta={"family": "external"})
    sdoc = src.to_json()
    g1 = tf.from_json(sdoc)
    assert [nd.op for nd in src.nodes] == ["gemm", "ReLU"]
    assert [nd.op for nd in g1.nodes] == ["dense", "relu"]
    assert g1.fingerprint() == jf.from_json(sdoc).fingerprint()


def test_fingerprint_invariant_under_node_reordering():
    g = tf.from_json(DOCS[4])
    g_rev = tir.OpGraph(nodes=list(reversed(g.nodes)), edges=list(g.edges),
                        meta=dict(g.meta))
    assert g_rev.fingerprint() == g.fingerprint()


def test_synthetic_samples_equal():
    sj = j_synthetic(30, seed=4, n_min=4, n_max=60)
    st = t_synthetic(30, seed=4, n_min=4, n_max=60)
    for a, b in zip(st, sj):
        for k in ("x", "edges", "mask", "static", "y"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


@pytest.mark.parametrize("budgets", [(None, None, None), (256, None, None),
                                     (512, 600, 8), (100, 90, 3)])
def test_bin_plans_and_packed_arrays_equal(budgets):
    samples_j = j_synthetic(60, seed=5, n_min=4, n_max=120)
    samples_t = t_synthetic(60, seed=5, n_min=4, n_max=120)
    plan_j = jb.pack_graphs(samples_j, *budgets)
    plan_t = tb.pack_graphs(samples_t, *budgets)
    assert plan_t == plan_j
    assert tb.packed_rung_ladder(*budgets) == jb.packed_rung_ladder(*budgets)
    assert tb.resolve_packed_budgets(*budgets) == \
        jb.resolve_packed_budgets(*budgets)
    for idx in plan_t:
        cj = [samples_j[i] for i in idx]
        ct = [samples_t[i] for i in idx]
        assert tb.packed_shape(ct, *budgets) == jb.packed_shape(cj, *budgets)
        aj, at = jb.collate_packed(cj, *budgets), tb.collate_packed(ct, *budgets)
        assert at.keys() == aj.keys()
        for k in aj:
            assert at[k].dtype == aj[k].dtype
            np.testing.assert_array_equal(at[k], aj[k])


def test_bucket_helpers_equal():
    for n in (0, 1, 2, 15, 16, 17, 100, 1023, 1024, 1025, 5000):
        assert tb.next_pow2(n) == jb.next_pow2(n)
        assert tb.bucket_for(n) == jb.bucket_for(n)
        assert tb.edge_bucket_for(n) == jb.edge_bucket_for(n)
        assert tb.edge_floor(n) == jb.edge_floor(n)


# ---------------------------------------------------------------------------
# import rule and device rule
# ---------------------------------------------------------------------------

FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert len(files) >= 15
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_no_jax_and_nothing_of_repro():
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                if name.split(".")[0] in FORBIDDEN:
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} "
                               f"imports {name}")
    assert not bad, "\n".join(bad)


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.serve, "
            "repro_torch.dataset.builder, repro_torch.kernels.ops, "
            "repro_torch.kernels.build; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ml_dtypes', 'repro')); "
            "assert not bad, bad")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from repro_torch.core import DIPPM, PMGNSConfig, PredictionEngine
    from repro_torch.core.gnn import params_from_numpy, pmgns_init
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PMGNSConfig(layout="packed", hidden=8, n_gnn_blocks=1,
                      n_fc_blocks=1)
    tree = pmgns_init(0, cfg)
    for call in (lambda: DIPPM.from_params(tree, cfg),
                 lambda: PredictionEngine(tree, cfg),
                 lambda: params_from_numpy(tree, cfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert DIPPM.from_params(tree, cfg, device="cpu").device.type == "cpu"
