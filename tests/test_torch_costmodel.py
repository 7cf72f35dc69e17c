"""The PyTorch port's cost model against the JAX package's, exactly.

One variant of each of the 11 zoo families, traced by the JAX package,
and six seeded random DAG documents are exported with ``to_json`` and
read with the port's ``from_json``. The port's ``estimate`` on that graph
must equal the reference's ``estimate`` on the reference's graph, every
``CostEstimate`` field with ``==``, on both devices and at both noise
levels; the fusion groups and the peak activation bytes must be equal
too. The labels' jitter hashes the graph's fingerprint, so this also
holds the port's fingerprint to the reference's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import frontends as jf  # noqa: E402
from repro.perfmodel import cost_model as jc  # noqa: E402
from repro.perfmodel import devices as jd  # noqa: E402
from repro.zoo import families as jz  # noqa: E402
from repro_torch.core import frontends as tf  # noqa: E402
from repro_torch.perfmodel import cost_model as tc  # noqa: E402
from repro_torch.perfmodel import devices as td  # noqa: E402

OPS = ["dense", "conv", "add", "mul", "div", "relu", "gelu", "tanh", "exp",
       "softmax", "reduce", "norm", "pool", "gather", "scatter",
       "elementwise", "Conv2D", "gemm", "reshape", "transpose"]


def _dag_doc(seed, n):
    """A seeded random DAG document (layout and aliased ops mixed in)."""
    rng = np.random.default_rng(100 + seed)
    nodes, edges = [], []
    for i in range(n):
        nodes.append({
            "id": i, "op": str(rng.choice(OPS)),
            "out_shape": [int(v) for v in rng.integers(1, 96,
                                                       rng.integers(1, 5))],
            "dtype": str(rng.choice(["float32", "bfloat16", "int8"])),
            "flops": float(rng.integers(0, 1e9)),
            "macs": float(rng.integers(0, 1e8)),
            "bytes_accessed": float(rng.integers(0, 1e8)),
            "param_bytes": float(rng.integers(0, 1e6))})
        if i:
            for s in sorted(set(rng.integers(0, i, min(i, 3)).tolist())):
                edges.append([s, i])
    meta = {"batch": int(rng.integers(1, 64))}
    if seed % 2:
        meta.update(param_bytes=float(rng.integers(1, 1e8)),
                    input_bytes=float(rng.integers(1, 1e7)))
    return {"nodes": nodes, "edges": edges, "meta": meta}


def _zoo_graphs():
    rng = np.random.default_rng(0)
    return {f"zoo-{fam}": jz.trace_family(fam, jz.family_variants(fam, rng))
            for fam in jz.FAMILIES}


@pytest.fixture(scope="module")
def graphs():
    """name → (reference graph, the port's parse of its to_json)."""
    ref = _zoo_graphs()
    for seed, n in enumerate([3, 17, 40, 96, 160, 300]):
        ref[f"dag-{seed}"] = jf.from_json(_dag_doc(seed, n))
    return {k: (g, tf.from_json(g.to_json())) for k, g in ref.items()}


NAMES = [f"zoo-{fam}" for fam in jz.FAMILIES] + [f"dag-{s}" for s in range(6)]


def test_device_profiles_are_the_references():
    assert list(td.DEVICES) == list(jd.DEVICES)
    for name, prof in jd.DEVICES.items():
        assert dataclasses.asdict(td.DEVICES[name]) == \
            dataclasses.asdict(prof)
    assert [f.name for f in dataclasses.fields(td.DeviceProfile)] == \
        [f.name for f in dataclasses.fields(jd.DeviceProfile)]
    assert td.A100 == td.DEVICES["a100-40gb"]
    assert td.TPU_V5E == td.DEVICES["tpu-v5e"]


@pytest.mark.parametrize("name", NAMES)
def test_estimate_equals_reference(graphs, name):
    g_ref, g_port = graphs[name]
    assert g_port.fingerprint() == g_ref.fingerprint()
    assert tc._fusion_groups(g_port) == jc._fusion_groups(g_ref)
    assert tc._peak_activation_bytes(g_port) == \
        jc._peak_activation_bytes(g_ref)
    for dev in jd.DEVICES:
        for sigma in (0.0, 0.01):
            want = jc.estimate(g_ref, jd.DEVICES[dev], noise_sigma=sigma)
            got = tc.estimate(g_port, td.DEVICES[dev], noise_sigma=sigma)
            for field in dataclasses.fields(jc.CostEstimate):
                a = getattr(got, field.name)
                b = getattr(want, field.name)
                assert a == b and type(a) is type(b), \
                    (name, dev, sigma, field.name, a, b)
            assert np.array_equal(got.as_targets(), want.as_targets())
            assert got.as_targets().dtype == np.float32
            assert np.array_equal(
                tc.estimate_targets(g_port, dev, sigma),
                jc.estimate_targets(g_ref, dev, sigma))


def test_jitter_is_seeded_by_the_fingerprint(graphs):
    """The noise moves each label by at most 3σ (1.5σ for memory), the
    same graph always draws the same noise, and two graphs that differ
    only in their meta draw different noise."""
    g_ref, g_port = graphs["zoo-vit"]
    base = tc.estimate(g_port, noise_sigma=0.0)
    noisy = tc.estimate(g_port, noise_sigma=0.01)
    assert noisy == tc.estimate(g_port, noise_sigma=0.01)
    assert abs(noisy.latency_ms / base.latency_ms - 1) <= 0.03
    assert abs(noisy.energy_j / base.energy_j - 1) <= 0.03
    assert abs(noisy.memory_mb / base.memory_mb - 1) <= 0.015
    other = tf.from_json({**g_ref.to_json(),
                          "meta": {**g_ref.meta, "tag": 1}})
    assert tc._jitter(other, "lat", 0.01) != tc._jitter(g_port, "lat", 0.01)
    assert tc._jitter(g_port, "lat", 0.0) == 1.0
