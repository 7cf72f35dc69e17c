"""The PyTorch port's dataset factory against the JAX package's.

* Plans: the same entries and the same plan hash for the reference
  test's config (with an LM arch) and for zoo-only configs.
* Shards: a zoo-only plan built by each package gives shards with the
  same sha256, and manifests equal but for the workers' peak RSS.
* v2 datasets load both ways through ``load_dataset``, with equal arrays
  and metas; a reference-built dataset with LM records (llama-3.2-vision)
  loads in the port, which resumes it by verification alone.
* A plan with LM entries of the six dense, SSD and hybrid archs, around a
  zoo record, built by each package: the same shard sha256 and manifests;
  killed and resumed on two workers, the same bytes again. A plan with
  one deepseek-v2 (MLA, mixture-of-experts) and one grok-1 (mixture-of-
  experts) entry beside a vgg record: the same shard sha256 and
  manifests.
* Kill and resume, a corrupt shard and ``workers=2`` give the same bytes;
  a changed config raises ``PlanMismatchError``; failed traces become
  the reference's skip records.
* A plan with LM entries of the audio-frame arch hubert-xlarge, which the
  reference's factory traces with tokens where its frontend reads
  ``features`` (ROADMAP §C), is refused by name before anything is
  written.
"""
import hashlib
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.dataset import builder as jb  # noqa: E402
from repro.dataset import factory as jf  # noqa: E402
from repro_torch.dataset import builder as tb  # noqa: E402
from repro_torch.dataset import factory as tf  # noqa: E402

#: the reference test's mixed config: zoo + held-out + one LM arch
CFG = dict(n_graphs=12, seed=3, shard_size=5, extra_families=("convnext",),
           lm_archs=("mamba2-370m",))

#: a small zoo-only build: a CNN, a transformer, an inverted-residual net
#: and the held-out family, three shards of at most three records
ZOO = dict(n_graphs=6, seed=3, shard_size=3,
           fractions={"vgg": 0.34, "vit": 0.33, "mobilenet": 0.33},
           extra_families=("convnext",))

#: an LM arch beside two small zoo records
LM_MIX = dict(n_graphs=2, seed=0, shard_size=4, fractions={"vgg": 1.0},
              lm_archs=("mamba2-370m",), lm_fraction=0.5)

#: the six archs whose LM stack the port runs, around a vgg record:
#: seven records in three shards
LM_ARCHS = ("qwen2.5-3b", "mamba2-370m", "zamba2-2.7b", "yi-34b",
            "h2o-danube-3-4b", "chatglm3-6b")
LM_SIX = dict(n_graphs=2, seed=0, shard_size=3, fractions={"vgg": 0.5},
              lm_archs=LM_ARCHS, lm_fraction=0.5)

#: the mixture-of-experts and MLA archs around a vgg record: three records
#: in two shards
MOE_ARCHS = ("deepseek-v2-236b", "grok-1-314b")
LM_MOE = dict(n_graphs=2, seed=0, shard_size=2, fractions={"vgg": 0.5},
              lm_archs=MOE_ARCHS, lm_fraction=0.5)

#: the cross-attention arch, which both factories build
LM_VISION = dict(LM_MIX, lm_archs=("llama-3.2-vision-11b",))
#: the audio-frame arch, which the JAX package's factory cannot trace
A14C_ARCH = "hubert-xlarge"

PLAN_CFGS = {"reference_test": CFG, "zoo": ZOO, "lm_mix": LM_MIX,
             "lm_six": LM_SIX, "lm_moe": LM_MOE,
             "default": {}, "paper_320": dict(n_graphs=320, seed=1),
             "zoo_held_out": dict(n_graphs=64, seed=5, shard_size=16,
                                  extra_families=("convnext",),
                                  noise_sigma=0.02)}


def _shas(path):
    shard_dir = os.path.join(path, "shards")
    out = {}
    for f in sorted(os.listdir(shard_dir)):
        if f.endswith(".npz"):
            with open(os.path.join(shard_dir, f), "rb") as fh:
                out[f] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _manifest(path):
    man = tf.read_manifest(path)
    for sh in man["shards"]:
        sh.pop("max_rss_kb")
    return man


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """ZOO built once by each package."""
    root = tmp_path_factory.mktemp("factory")
    ref, port = str(root / "ref"), str(root / "port")
    ref_res = jf.build(ref, jf.FactoryConfig(**ZOO))
    port_res = tf.build(port, tf.FactoryConfig(**ZOO))
    return ref, ref_res, port, port_res


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------

def test_names_and_constants():
    assert tf.FACTORY_VERSION == jf.FACTORY_VERSION == "dippm-ds-v2"
    assert tf.LM_BATCHES == jf.LM_BATCHES
    assert tf.LM_SEQLENS == jf.LM_SEQLENS
    for name in ("FactoryConfig", "FactoryPlan", "FactoryBuildResult",
                 "PlanMismatchError", "make_plan", "plan_hash", "build",
                 "build_shard", "read_plan", "read_manifest",
                 "iter_records", "load_factory_dataset"):
        assert hasattr(tf, name), name


@pytest.mark.parametrize("name", sorted(PLAN_CFGS))
def test_plan_and_hash_match_reference(name):
    kw = PLAN_CFGS[name]
    cfg, ref = tf.FactoryConfig(**kw), jf.FactoryConfig(**kw)
    plan, want = tf.make_plan(cfg), jf.make_plan(ref)
    assert plan.to_json() == want.to_json()
    assert tf.plan_hash(cfg) == jf.plan_hash(ref) == want.plan_hash
    assert cfg.content_json() == ref.content_json()
    assert plan.n_shards == want.n_shards
    assert [plan.shard_range(i) for i in range(plan.n_shards)] == \
        [want.shard_range(i) for i in range(want.n_shards)]
    # workers stay out of the hash: FactoryConfig has no such field
    assert "workers" not in cfg.content_json()
    assert tf.FactoryPlan.from_json(json.loads(json.dumps(
        plan.to_json()))).plan_hash == plan.plan_hash


def test_plan_with_lm_entries_is_planned_as_the_reference():
    plan = tf.make_plan(tf.FactoryConfig(**CFG))
    assert {e["kind"] for e in plan.entries} == {"zoo", "lm"}
    lm = [e for e in plan.entries if e["kind"] == "lm"]
    assert lm and all(e["cfg"]["batch"] in tf.LM_BATCHES
                      and e["cfg"]["seq"] in tf.LM_SEQLENS for e in lm)


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_plan_is_the_reference_plan():
    """``chip_smoke.py``'s factory plan: its hash is the JAX package's
    plan of the same config, and one entry of each of the nine LM archs
    it traces (all but hubert-xlarge, which the reference's factory
    cannot trace)."""
    cs = _chip_smoke()
    want = jf.make_plan(cs.factory_config(jf))
    plan = tf.make_plan(cs.factory_config(tf))
    assert want.plan_hash == plan.plan_hash == cs.FACTORY_PLAN_HASH
    assert plan.to_json() == want.to_json()
    assert sorted(e["family"] for e in plan.entries if e["kind"] == "lm") \
        == sorted(cs.FACTORY_LM_ARCHS)
    assert plan.n_shards == len(cs.FACTORY_REF_SHA256)


def test_npz_bytes_match_reference():
    rng = np.random.default_rng(0)
    arrays = {"x0": rng.standard_normal((5, 32)).astype(np.float32),
              "e0": np.arange(8, dtype=np.int32).reshape(4, 2),
              "_meta": np.frombuffer(b'{"a": 1}', dtype=np.uint8)}
    data = tf._npz_bytes(arrays)
    assert data == jf._npz_bytes(arrays)
    assert data == tf._npz_bytes(dict(arrays))       # a pure function
    import io
    import zipfile
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        assert [i.filename for i in zf.infolist()] == \
            ["x0.npy", "e0.npy", "_meta.npy"]
        assert {i.date_time for i in zf.infolist()} == {(1980, 1, 1, 0, 0,
                                                         0)}


# ---------------------------------------------------------------------------
# build: the reference's bytes
# ---------------------------------------------------------------------------

def test_shards_are_the_reference_bytes(built):
    ref, ref_res, port, port_res = built
    assert port_res.n_built == ref_res.n_built == 7
    assert port_res.n_skipped == 0 and port_res.n_shards == 3
    assert port_res.plan_hash == ref_res.plan_hash
    assert _shas(port) == _shas(ref)
    assert _manifest(port) == _manifest(ref)
    for i in range(port_res.n_shards):
        name = f"shard{i:05d}.json"
        with open(os.path.join(port, "shards", name)) as f:
            a = json.load(f)
        with open(os.path.join(ref, "shards", name)) as f:
            b = json.load(f)
        a.pop("max_rss_kb"), b.pop("max_rss_kb")
        assert a == b
    with open(os.path.join(port, "plan.json"), "rb") as f:
        got = f.read()
    with open(os.path.join(ref, "plan.json"), "rb") as f:
        assert got == f.read()
    assert port_res.max_rss_kb > 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_v2_datasets_load_both_ways(built, writer):
    ref, _, port, _ = built
    path = ref if writer == "jax" else port
    a = tb.load_dataset(path)
    b = jb.load_dataset(path)
    streamed = list(tf.iter_records(path, verify=True))
    assert len(a) == len(b) == len(streamed) == 7
    for r, q, s in zip(a, b, streamed):
        for k in ("x", "edges", "static", "y"):
            u, v, w = getattr(r, k), getattr(q, k), getattr(s, k)
            assert u.dtype == v.dtype and np.array_equal(u, v), k
            assert np.array_equal(u, w), k
        assert (r.family, r.n_nodes, r.meta) == (q.family, q.n_nodes, q.meta)
        assert {"fingerprint", "plan_index"} <= set(r.meta)
        assert tb.record_fingerprint(r) == r.meta["fingerprint"]
    assert {r.family for r in a} == {"vgg", "vit", "mobilenet", "convnext"}
    assert tf.load_factory_dataset(path) is not None


def test_reference_dataset_with_lm_records_loads(tmp_path):
    path = str(tmp_path / "lm")
    res = jf.build(path, jf.FactoryConfig(**LM_VISION))
    assert res.n_built == 3 and res.n_skipped == 0
    got = tb.load_dataset(path)
    want = jb.load_dataset(path)
    assert [r.meta for r in got] == [r.meta for r in want]
    assert sum(r.meta.get("kind") == "lm" for r in got) == 1
    for r, q in zip(got, want):
        assert np.array_equal(r.x, q.x) and np.array_equal(r.y, q.y)
    # the port resumes it by verification: every shard kept, none traced
    shas = _shas(path)
    again = tf.build(path)
    assert again.shards_built == 0 and again.n_built == res.n_built
    assert _shas(path) == shas


@pytest.fixture(scope="module")
def lm_built(tmp_path_factory):
    """LM_SIX built once by each package."""
    root = tmp_path_factory.mktemp("factory_lm")
    ref, port = str(root / "ref"), str(root / "port")
    ref_res = jf.build(ref, jf.FactoryConfig(**LM_SIX))
    port_res = tf.build(port, tf.FactoryConfig(**LM_SIX))
    return ref, ref_res, port, port_res


def test_lm_shards_are_the_reference_bytes(lm_built):
    ref, ref_res, port, port_res = lm_built
    assert port_res.n_built == ref_res.n_built == 7
    assert port_res.n_skipped == ref_res.n_skipped == 0
    assert port_res.n_shards == 3
    assert _shas(port) == _shas(ref)
    assert _manifest(port) == _manifest(ref)
    recs = tf.load_factory_dataset(port, verify=True)
    lm = [r for r in recs if r.meta.get("kind") == "lm"]
    assert sorted(r.family for r in lm) == sorted(LM_ARCHS)
    assert all(tb.record_fingerprint(r) == r.meta["fingerprint"]
               for r in lm)
    assert all(set(r.meta) == {"batch", "seq", "kind", "fingerprint",
                               "plan_index"} for r in lm)


def test_moe_and_mla_shards_are_the_reference_bytes(tmp_path):
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_res = jf.build(ref, jf.FactoryConfig(**LM_MOE))
    port_res = tf.build(port, tf.FactoryConfig(**LM_MOE))
    assert port_res.n_built == ref_res.n_built == 3
    assert port_res.n_skipped == ref_res.n_skipped == 0
    assert port_res.n_shards == 2
    assert _shas(port) == _shas(ref)
    assert _manifest(port) == _manifest(ref)
    lm = [r for r in tf.load_factory_dataset(port, verify=True)
          if r.meta.get("kind") == "lm"]
    assert sorted(r.family for r in lm) == sorted(MOE_ARCHS)


def test_lm_plan_killed_and_resumed_on_two_workers(lm_built, tmp_path):
    _, _, port, _ = lm_built
    out = str(tmp_path / "ds")
    partial = tf.build(out, tf.FactoryConfig(**LM_SIX),
                       _stop_after_shards=1)
    assert partial.shards_built == 1 and not partial.manifest_path
    resumed = tf.build(out, workers=2)
    assert resumed.shards_reused == 1 and resumed.shards_built == 2
    assert _shas(out) == _shas(port)
    assert _manifest(out) == _manifest(port)


# ---------------------------------------------------------------------------
# resume, corruption, workers, mismatch, skips, LM refusal
# ---------------------------------------------------------------------------

def test_kill_and_resume_gives_the_same_bytes(built, tmp_path):
    _, _, port, port_res = built
    out = str(tmp_path / "ds")
    partial = tf.build(out, tf.FactoryConfig(**ZOO), _stop_after_shards=1)
    assert partial.shards_built == 1 and not partial.manifest_path
    assert not os.path.exists(os.path.join(out, "manifest.json"))
    resumed = tf.build(out)                     # the plan from plan.json
    assert resumed.shards_reused == 1
    assert resumed.shards_built == port_res.n_shards - 1
    assert _shas(out) == _shas(port)
    assert _manifest(out) == _manifest(port)
    again = tf.build(out, tf.FactoryConfig(**ZOO))  # pure verification
    assert again.shards_built == 0 and again.shards_reused == 3


def test_corrupt_shard_is_rebuilt_to_the_same_bytes(built, tmp_path):
    _, _, port, _ = built
    out = str(tmp_path / "ds")
    shutil.copytree(port, out)
    with open(os.path.join(out, "shards", "shard00001.npz"), "wb") as f:
        f.write(b"garbage")
    with pytest.raises(IOError, match="checksum"):
        list(tf.iter_records(out, verify=True))
    res = tf.build(out, tf.FactoryConfig(**ZOO))
    assert res.shards_built == 1 and res.shards_reused == 2
    assert _shas(out) == _shas(port)
    assert len(list(tf.iter_records(out, verify=True))) == 7


def test_two_workers_write_the_same_bytes(built, tmp_path):
    _, _, port, _ = built
    out = str(tmp_path / "ds")
    res = tf.build(out, tf.FactoryConfig(**ZOO), workers=2)
    assert res.shards_built == 3 and res.n_built == 7
    assert _shas(out) == _shas(port)
    assert _manifest(out) == _manifest(port)


def test_plan_mismatch_raises(built):
    _, _, port, _ = built
    with pytest.raises(tf.PlanMismatchError):
        tf.build(port, tf.FactoryConfig(**{**ZOO, "seed": 99}))
    with pytest.raises(FileNotFoundError):
        tf.build(os.path.join(port, "missing"))


def test_failed_traces_are_the_reference_skip_records(tmp_path):
    kw = dict(n_graphs=4, seed=0, shard_size=4,
              fractions={"nosuchfamily": 1.0})
    ref, port = str(tmp_path / "ref"), str(tmp_path / "port")
    a = jf.build(ref, jf.FactoryConfig(**kw))
    b = tf.build(port, tf.FactoryConfig(**kw))
    assert b.n_built == 0 and b.n_skipped == 4
    assert b.skips_by_family == a.skips_by_family == {
        "nosuchfamily": {"KeyError": 4}}
    assert _shas(port) == _shas(ref)
    assert _manifest(port) == _manifest(ref)
    assert tf.load_factory_dataset(port, verify=True) == []


def test_lm_plan_is_refused_before_anything_is_written(tmp_path):
    out = str(tmp_path / "ds")
    cfg = tf.FactoryConfig(**dict(CFG, lm_archs=("mamba2-370m", A14C_ARCH)))
    with pytest.raises(ValueError, match=f"{A14C_ARCH}.*features"):
        tf.build(out, cfg)
    assert not os.path.exists(out)
    with pytest.raises(ValueError, match=A14C_ARCH) as e:
        tf.build_shard(tf.make_plan(cfg), 0, out)
    assert "mamba2-370m" not in str(e.value)
    assert not os.path.exists(out)


def test_version_mismatch_is_named(tmp_path):
    path = tmp_path / "ds"
    path.mkdir()
    (path / "manifest.json").write_text(json.dumps(
        {"version": "dippm-ds-v1", "shards": []}))
    with pytest.raises(ValueError, match="dippm-ds-v2"):
        list(tf.iter_records(str(path)))
