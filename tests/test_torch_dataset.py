"""The PyTorch port's dataset builder against the JAX package's.

* ``build_dataset(36, seed=0, extra_families=("convnext",))`` at the
  default ``noise_sigma`` plans the same (family, config) pairs in the
  same order in both packages, and every record is the reference's bit
  for bit: node and static features, edges, the noisy labels and the
  meta with its fingerprint.
* The v1 format is read both ways: a dataset saved by the JAX package
  loads in the port with equal arrays, metas and skip accounting, and the
  other way round; a factory-built ``dippm-ds-v2`` manifest goes to the
  factory's reader.
* ``record_fingerprint``, ``split_assignment``, ``split_dataset`` and
  ``records_to_samples`` give the reference's results on the same
  records, and each package's split of its own build is the other's.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.dataset import builder as jb  # noqa: E402
from repro_torch.dataset import builder as tb  # noqa: E402

N_GRAPHS, SEED = 36, 0


def _build(mod, monkeypatch):
    """Build at the default noise, recording the plan as it is traced."""
    plan = []
    inner = mod._trace_and_label

    def spy(family, cfg, device_name, noise_sigma):
        plan.append((family, cfg))
        return inner(family, cfg, device_name, noise_sigma)

    monkeypatch.setattr(mod, "_trace_and_label", spy)
    out = mod.build_dataset(N_GRAPHS, seed=SEED,
                            extra_families=("convnext",))
    monkeypatch.undo()
    return out, plan


@pytest.fixture(scope="module")
def built():
    mp = pytest.MonkeyPatch()
    ref, ref_plan = _build(jb, mp)
    port, plan = _build(tb, mp)
    return ref, ref_plan, port, plan


def test_build_plan_and_labels_match_reference(built):
    ref, ref_plan, port, plan = built
    expect = sum(max(1, int(round(f * N_GRAPHS)))
                 for f in tb.TABLE2_FRACTIONS.values()) + 1
    assert len(plan) == len(ref_plan) == expect
    assert plan == ref_plan
    assert isinstance(port, tb.DatasetBuildResult) and port.n_skipped == 0
    assert len(port) == len(ref) == expect
    for r, q in zip(port, ref):
        assert r.family == q.family and r.n_nodes == q.n_nodes
        assert r.meta == q.meta            # the fingerprint too
        assert r.x.dtype == np.float32 and r.edges.dtype == np.int32
        assert r.y.dtype == np.float32
        for k in ("x", "edges", "static", "y"):
            u, v = getattr(r, k), getattr(q, k)
            assert u.dtype == v.dtype and np.array_equal(u, v), \
                (r.family, k)
        assert np.all(np.isfinite(r.y)) and np.all(r.y > 0)
    fams = {r.family for r in port}
    assert "convnext" in fams and len(fams) == 11


def _skips(mod):
    return [mod.SkipRecord(family="vit", cfg={"batch": 1, "res": 224},
                           error="ValueError", message="bad variant"),
            mod.SkipRecord(family="vit", cfg={"batch": 2, "res": 160},
                           error="ValueError", message="bad variant")]


def _as(mod, records):
    return [mod.DatasetRecord(x=r.x, edges=r.edges, static=r.static, y=r.y,
                              family=r.family, n_nodes=r.n_nodes,
                              meta=dict(r.meta)) for r in records]


def _same_records(a, b):
    assert len(a) == len(b)
    for r, q in zip(a, b):
        for k in ("x", "edges", "static", "y"):
            u, v = getattr(r, k), getattr(q, k)
            assert u.dtype == v.dtype and np.array_equal(u, v), k
        assert (r.family, r.n_nodes, r.meta) == (q.family, q.n_nodes,
                                                 q.meta)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_v1_datasets_load_both_ways(built, tmp_path, writer):
    ref, _, port, _ = built
    records = port[:12]
    w, r = (jb, tb) if writer == "jax" else (tb, jb)
    res = w.DatasetBuildResult(_as(w, records), _skips(w))
    path = str(tmp_path / writer)
    w.save_dataset(res, path, shard_size=5)
    loaded = r.load_dataset(path)
    same = w.load_dataset(path)
    _same_records(loaded, same)
    _same_records(loaded, records)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["version"] == tb.DATASET_VERSION == jb.DATASET_VERSION
    assert manifest["n_skipped"] == 2
    assert manifest["skips_by_family"] == {"vit": {"ValueError": 2}}
    assert [s["cfg"] for s in manifest["skips"]] == \
        [s.cfg for s in _skips(jb)]
    assert [s["file"] for s in manifest["shards"]] == \
        ["shard0000.npz", "shard0001.npz", "shard0002.npz"]
    # the same records written by the other package: the same manifest
    other = str(tmp_path / "other")
    r.save_dataset(r.DatasetBuildResult(_as(r, records), _skips(r)), other,
                   shard_size=5)
    with open(os.path.join(other, "manifest.json")) as f:
        assert f.read() == json.dumps(manifest)


def test_manifest_versions(tmp_path):
    path = tmp_path / "v2"
    path.mkdir()
    (path / "manifest.json").write_text(json.dumps(
        {"version": "dippm-ds-v2", "shards": []}))
    assert tb.load_dataset(str(path)) == []      # the factory's reader
    (path / "manifest.json").write_text(json.dumps(
        {"version": "dippm-ds-v0", "n": 0}))
    with pytest.raises(ValueError, match="version mismatch"):
        tb.load_dataset(str(path))


def test_splits_and_fingerprints_match_reference(built):
    _, _, port, _ = built
    ref = _as(jb, port)
    bare = _as(tb, port[:6])
    for r in bare:
        r.meta.pop("fingerprint")
    for r, q in zip(list(port) + bare, ref + _as(jb, bare)):
        assert tb.record_fingerprint(r) == jb.record_fingerprint(q)
    for fp in ("a", "b" * 64, tb.record_fingerprint(port[0])):
        for seed in (0, 3):
            assert tb.split_assignment(fp, seed) == \
                jb.split_assignment(fp, seed)
    for seed in (0, 1):
        a = tb.split_dataset(port, seed=seed)
        b = jb.split_dataset(ref, seed=seed)
        assert list(a) == list(b)
        for k in a:
            assert [tb.record_fingerprint(r) for r in a[k]] == \
                [jb.record_fingerprint(r) for r in b[k]], k
    assert {r.family for r in tb.split_dataset(port)["unseen"]} == \
        {"convnext"}


def test_each_package_splits_its_own_build_alike(built):
    ref, _, port, _ = built
    for seed in (0, 1):
        a = tb.split_dataset(port, seed=seed)
        b = jb.split_dataset(ref, seed=seed)
        assert {k: [r.meta["fingerprint"] for r in v] for k, v in a.items()} \
            == {k: [r.meta["fingerprint"] for r in v] for k, v in b.items()}


def test_records_to_samples_match_reference(built):
    _, _, port, _ = built
    got = tb.records_to_samples(port)
    want = jb.records_to_samples(_as(jb, port))
    assert len(got) == len(want)
    for s, t in zip(got, want):
        for k in ("x", "edges", "mask", "static", "y"):
            assert np.array_equal(getattr(s, k), getattr(t, k)), k
        assert s.meta == t.meta
