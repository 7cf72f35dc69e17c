"""Paper-scale dataset factory — sharded, resumable, multi-worker; the
port of ``repro.dataset.factory``.

``repro_torch.dataset.builder.build_dataset`` is single-process, fully
in-memory and non-resumable, which caps it at toy scale. The factory
splits the build into three crash-isolated stages:

1. **Plan** — :func:`make_plan` expands a :class:`FactoryConfig` into a
   deterministic work plan: one entry per graph, ``(kind, family,
   variant-config, seed)``, covering the Table-2 zoo mix, optional
   held-out families and optional LM tracings. Entry ``i``'s variant
   config is drawn from ``default_rng([seed, i])``, so the plan is
   reproducible and order-independent; the canonical plan JSON is
   hashed into ``plan_hash`` (the dataset's identity). The plan, and so
   its hash, is the reference's for the same config, LM entries
   included. It is written to ``<out>/plan.json`` before any tracing
   starts.
2. **Shards** — the plan is cut into fixed-size slices; each worker
   claims whole slices and builds them on its own: trace on the meta
   device → label (``perfmodel.cost_model``) → an in-memory shard of at
   most ``shard_size`` records → a *byte-deterministic* compressed
   ``.npz`` (fixed zip timestamps, fixed member order) → atomic rename +
   a ``.json`` sidecar with the shard's sha256, record and skip counts
   and the worker's peak RSS. Host memory is bounded by one shard. A
   failed trace becomes a structured skip record (family, error type,
   message). A shard's bytes are the reference's shard's for the same
   plan, LM records included.
3. **Manifest** — once every shard is done, :func:`build` writes
   ``<out>/manifest.json``: plan hash, per-shard checksums, family
   counts and aggregated ``skips_by_family``.

Resume: re-running :func:`build` on the same directory verifies each
existing shard against its sidecar checksum, keeps the good ones and
rebuilds only what is missing or corrupt. Shard bytes are a pure
function of the plan, so a killed-and-resumed build writes shards
byte-identical to an uninterrupted one.

An LM entry traces ``lm.forward`` of the arch's smoke config at the
entry's (batch, seq) on the meta device over ``lm.param_specs``, and
gives the reference's graph, so its record too is the reference's: the
dense, SSD and hybrid archs, the mixture-of-experts and MLA archs
(deepseek-v2, grok-1) through their graph forms, and llama-3.2-vision
with a float32 ``vision_embeds`` spec beside the tokens, as the
reference traces it. An audio-frame arch (hubert-xlarge) is refused by
name, by :func:`build` and :func:`build_shard`, before anything is
written: the reference's factory passes it only ``tokens`` where its
frontend reads ``features``, so it has no record to equal (ROADMAP.md
§C).

Consumption is streaming: :func:`iter_records` yields
:class:`~repro_torch.dataset.builder.DatasetRecord` one shard at a time
and closes each file handle.

CLI::

    PYTHONPATH=src python -m repro_torch.dataset.factory --out build/ds \
        --n-graphs 2000 --workers 4
    PYTHONPATH=src python -m repro_torch.dataset.factory --n-graphs 320 \
        --print-plan-hash       # the dataset's identity, no build
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import logging
import os
import zipfile
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .builder import DatasetRecord, _trace_and_label

log = logging.getLogger("repro_torch.dataset.factory")

FACTORY_VERSION = "dippm-ds-v2"

#: default variant axes for LLM tracing entries (``FactoryConfig.lm_archs``)
LM_BATCHES = (1, 2, 4, 8)
LM_SEQLENS = (64, 128, 256)


# ---------------------------------------------------------------------------
# config + plan
# ---------------------------------------------------------------------------

def _pyify(obj):
    """Recursively convert numpy scalars/arrays to JSON-native types."""
    if isinstance(obj, dict):
        return {str(k): _pyify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_pyify(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return [_pyify(v) for v in obj.tolist()]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    return obj


@dataclasses.dataclass(frozen=True)
class FactoryConfig:
    """Everything that determines dataset *content* (hashed into the plan).

    ``workers`` deliberately lives outside the hash inputs — parallelism
    must never change the bytes produced.
    """
    n_graphs: int = 1024
    seed: int = 0
    device_name: str = "a100-40gb"
    noise_sigma: float = 0.01
    fractions: Optional[Dict[str, float]] = None   # default TABLE2_FRACTIONS
    extra_families: Tuple[str, ...] = ()           # e.g. ("convnext",)
    lm_archs: Tuple[str, ...] = ()                 # configs arch names
    lm_fraction: float = 0.05                      # of n_graphs, across archs
    shard_size: int = 256

    def content_json(self) -> Dict[str, Any]:
        d = _pyify(dataclasses.asdict(self))
        d["fractions"] = d["fractions"]  # None stays None (Table-2 default)
        return d


@dataclasses.dataclass
class FactoryPlan:
    """Materialized work plan: ``entries[i]`` fully determines record i."""
    config: Dict[str, Any]
    entries: List[Dict[str, Any]]
    shard_size: int
    plan_hash: str

    @property
    def n_entries(self) -> int:
        return len(self.entries)

    @property
    def n_shards(self) -> int:
        return max(1, -(-len(self.entries) // self.shard_size))

    def shard_range(self, shard_index: int) -> Tuple[int, int]:
        a = shard_index * self.shard_size
        return a, min(a + self.shard_size, len(self.entries))

    def to_json(self) -> Dict[str, Any]:
        return {"version": FACTORY_VERSION, "plan_hash": self.plan_hash,
                "config": self.config, "shard_size": self.shard_size,
                "entries": self.entries}

    @staticmethod
    def from_json(doc: Dict[str, Any]) -> "FactoryPlan":
        return FactoryPlan(config=doc["config"], entries=doc["entries"],
                           shard_size=int(doc["shard_size"]),
                           plan_hash=doc["plan_hash"])


def _plan_hash(config: Dict[str, Any], entries: List[Dict[str, Any]],
               shard_size: int) -> str:
    canon = json.dumps({"config": config, "shard_size": shard_size,
                        "entries": entries},
                       sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canon.encode()).hexdigest()


def make_plan(cfg: FactoryConfig) -> FactoryPlan:
    """Expand a config into the deterministic (family × cfg × seed) plan."""
    from ..zoo.families import TABLE2_FRACTIONS, family_variants
    fractions = dict(cfg.fractions or TABLE2_FRACTIONS)

    slots: List[Tuple[str, str]] = []           # (kind, family)
    for fam, frac in fractions.items():
        slots += [("zoo", fam)] * max(1, int(round(frac * cfg.n_graphs)))
    for fam in cfg.extra_families:
        slots += [("zoo", fam)] * max(1, cfg.n_graphs // 50)
    if cfg.lm_archs:
        per_arch = max(1, int(round(cfg.lm_fraction * cfg.n_graphs
                                    / len(cfg.lm_archs))))
        for arch in cfg.lm_archs:
            slots += [("lm", arch)] * per_arch

    entries: List[Dict[str, Any]] = []
    for idx, (kind, fam) in enumerate(slots):
        # per-entry RNG: entry i's config never depends on other entries
        rng = np.random.default_rng([cfg.seed, idx])
        if kind == "zoo":
            vcfg = _pyify(family_variants(fam, rng))
        else:
            vcfg = {"batch": int(rng.choice(LM_BATCHES)),
                    "seq": int(rng.choice(LM_SEQLENS))}
        entries.append({"index": idx, "kind": kind, "family": fam,
                        "cfg": vcfg, "seed": int(cfg.seed)})

    # deterministic interleave so every shard sees a diverse family mix
    perm = np.random.default_rng([cfg.seed, 0xD1BB]).permutation(len(entries))
    entries = [entries[int(i)] for i in perm]
    for new_idx, e in enumerate(entries):
        e["index"] = new_idx

    config = cfg.content_json()
    return FactoryPlan(config=config, entries=entries,
                       shard_size=cfg.shard_size,
                       plan_hash=_plan_hash(config, entries, cfg.shard_size))


def plan_hash(cfg: FactoryConfig) -> str:
    """Dataset identity hash without building anything (CI cache key)."""
    return make_plan(cfg).plan_hash


# ---------------------------------------------------------------------------
# tracing one entry
# ---------------------------------------------------------------------------

def _trace_entry(entry: Dict[str, Any], device_name: str,
                 noise_sigma: float) -> DatasetRecord:
    if entry["kind"] == "zoo":
        return _trace_and_label(entry["family"], dict(entry["cfg"]),
                                device_name, noise_sigma)
    return _trace_lm_entry(entry, device_name, noise_sigma)


def _trace_lm_entry(entry: Dict[str, Any], device_name: str,
                    noise_sigma: float) -> DatasetRecord:
    """Trace one LM smoke config from ``repro_torch.configs`` into a
    record: ``lm.forward``'s logits on the meta device, labelled."""
    import torch
    from ..configs import get_smoke_config
    from ..core.frontends import from_torch
    from ..core.node_features import node_feature_matrix
    from ..core.static_features import static_features
    from ..models import lm
    from ..perfmodel.cost_model import estimate
    from ..perfmodel.devices import DEVICES

    arch = entry["family"]
    batch = int(entry["cfg"]["batch"])
    seq = int(entry["cfg"]["seq"])
    acfg = get_smoke_config(arch)
    data_specs = [((batch, seq), torch.int32)]
    if acfg.frontend == "tokens+vision":
        data_specs.append(((batch, acfg.vision_tokens, acfg.vision_dim),
                           torch.float32))

    def fwd(params, tokens, *rest):
        inputs = {"tokens": tokens}
        if rest:
            inputs["vision_embeds"] = rest[0]
        logits, _ = lm.forward(params, acfg, inputs)
        return logits

    g = from_torch(fwd, lm.param_specs(acfg), *data_specs,
                   meta={"family": arch, "batch": batch, "seq": seq})
    est = estimate(g, DEVICES[device_name], noise_sigma=noise_sigma)
    return DatasetRecord(
        x=node_feature_matrix(g),
        edges=np.asarray(g.edges, dtype=np.int32).reshape(-1, 2),
        static=static_features(g),
        y=est.as_targets(),
        family=arch,
        n_nodes=g.num_nodes,
        meta={"batch": batch, "seq": seq, "kind": "lm",
              "fingerprint": g.fingerprint()},
    )


def _refuse_audio_lm(plan: FactoryPlan) -> None:
    """Raise before anything is written if the plan holds an LM entry of
    an audio-frame arch (hubert-xlarge): the reference's
    ``_trace_lm_entry`` passes only ``tokens``, while its frontend reads
    ``inputs["features"]``, so the JAX package writes a skip record where
    the port would write a graph."""
    from ..configs import get_smoke_config
    refused = []
    for arch in sorted({e["family"] for e in plan.entries
                        if e["kind"] == "lm"}):
        try:
            acfg = get_smoke_config(arch)
        except Exception:
            continue            # an unknown arch: a skip record, as ever
        if acfg.frontend == "audio_frames":
            refused.append(arch)
    if refused:
        raise ValueError(
            f"the plan holds LM entries of {', '.join(refused)}, whose "
            f"audio-frame frontend reads inputs['features']; the reference "
            f"factory traces an LM entry with tokens only, so it has no "
            f"record for the port's to equal; leave them out of lm_archs")


# ---------------------------------------------------------------------------
# deterministic shard serialization
# ---------------------------------------------------------------------------

def _npz_bytes(arrays: Dict[str, np.ndarray]) -> bytes:
    """``np.savez_compressed`` twin with reproducible bytes.

    numpy's writer stamps each zip member with the current mtime, so two
    otherwise-identical builds differ at the byte level and checksums
    can't certify a resumed shard. Here every member gets the DOS epoch
    and members are written in insertion order; zlib at a fixed level is
    deterministic, so shard bytes are a pure function of the arrays.
    """
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for name, arr in arrays.items():
            ab = io.BytesIO()
            np.lib.format.write_array(ab, np.asanyarray(arr),
                                      allow_pickle=False)
            zi = zipfile.ZipInfo(name + ".npy",
                                 date_time=(1980, 1, 1, 0, 0, 0))
            zi.compress_type = zipfile.ZIP_DEFLATED
            zi.external_attr = 0o600 << 16
            zf.writestr(zi, ab.getvalue())
    return buf.getvalue()


def _atomic_write(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _shard_name(shard_index: int) -> str:
    return f"shard{shard_index:05d}.npz"


def _sidecar_name(shard_index: int) -> str:
    return f"shard{shard_index:05d}.json"


def _max_rss_kb() -> int:
    try:
        import resource
        return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
    except Exception:  # pragma: no cover — non-POSIX
        return 0


def build_shard(plan: FactoryPlan, shard_index: int,
                out_dir: str) -> Dict[str, Any]:
    """Trace + label one plan slice and commit it atomically.

    Returns the sidecar dict. At most ``shard_size`` records are ever
    held in memory; a failed trace becomes a structured skip record. A
    plan with LM entries of an audio-frame arch is refused before
    anything is written.
    """
    _refuse_audio_lm(plan)
    a, b = plan.shard_range(shard_index)
    device = plan.config["device_name"]
    sigma = float(plan.config["noise_sigma"])
    records: List[DatasetRecord] = []
    skips: List[Dict[str, Any]] = []
    for entry in plan.entries[a:b]:
        try:
            rec = _trace_entry(entry, device, sigma)
            rec.meta["plan_index"] = entry["index"]
            records.append(rec)
        except Exception as e:
            skips.append({"index": entry["index"], "family": entry["family"],
                          "cfg": entry["cfg"], "error": type(e).__name__,
                          "message": str(e)[:300]})
            log.warning("factory: skipping %s %s: %s: %s", entry["family"],
                        entry["cfg"], type(e).__name__, e)

    arrays: Dict[str, np.ndarray] = {}
    metas = []
    for i, r in enumerate(records):
        arrays[f"x{i}"] = r.x
        arrays[f"e{i}"] = r.edges
        arrays[f"s{i}"] = r.static
        arrays[f"y{i}"] = r.y
        metas.append(_pyify({"family": r.family, "n_nodes": r.n_nodes,
                             **r.meta}))
    header = {"version": FACTORY_VERSION, "plan_hash": plan.plan_hash,
              "shard_index": shard_index, "plan_range": [a, b],
              "metas": metas, "skips": skips}
    arrays["_meta"] = np.frombuffer(
        json.dumps(header, sort_keys=True).encode(), dtype=np.uint8)

    shard_dir = os.path.join(out_dir, "shards")
    os.makedirs(shard_dir, exist_ok=True)
    data = _npz_bytes(arrays)
    fpath = os.path.join(shard_dir, _shard_name(shard_index))
    _atomic_write(fpath, data)

    sidecar = {"file": f"shards/{_shard_name(shard_index)}",
               "shard_index": shard_index,
               "sha256": hashlib.sha256(data).hexdigest(),
               "bytes": len(data), "n": len(records),
               "n_skipped": len(skips), "plan_range": [a, b],
               "skips": skips, "max_rss_kb": _max_rss_kb()}
    _atomic_write(os.path.join(shard_dir, _sidecar_name(shard_index)),
                  json.dumps(sidecar, sort_keys=True, indent=1).encode())
    return sidecar


def _build_shard_job(out_dir: str, shard_index: int) -> Dict[str, Any]:
    """Worker entry point: re-reads the committed plan (single source of
    truth) so only ``(out_dir, shard_index)`` crosses the process
    boundary."""
    plan = read_plan(out_dir)
    return build_shard(plan, shard_index, out_dir)


def _verify_shard(out_dir: str, shard_index: int) -> Optional[Dict[str, Any]]:
    """Sidecar dict if the shard is present and checksum-clean, else None."""
    shard_dir = os.path.join(out_dir, "shards")
    spath = os.path.join(shard_dir, _sidecar_name(shard_index))
    fpath = os.path.join(shard_dir, _shard_name(shard_index))
    if not (os.path.exists(spath) and os.path.exists(fpath)):
        return None
    try:
        with open(spath) as f:
            sidecar = json.load(f)
        with open(fpath, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
    except (OSError, ValueError):
        return None
    if digest != sidecar.get("sha256"):
        log.warning("factory: shard %d checksum mismatch — rebuilding",
                    shard_index)
        return None
    return sidecar


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

class PlanMismatchError(RuntimeError):
    """The directory holds a dataset built from a different plan."""


@dataclasses.dataclass
class FactoryBuildResult:
    path: str
    plan_hash: str
    n_planned: int
    n_built: int
    n_skipped: int
    n_shards: int
    shards_built: int       # built in *this* call
    shards_reused: int      # verified + skipped (resume)
    skips_by_family: Dict[str, Dict[str, int]]
    max_rss_kb: int         # max over workers' peak RSS
    manifest_path: str


def read_plan(path: str) -> FactoryPlan:
    with open(os.path.join(path, "plan.json")) as f:
        return FactoryPlan.from_json(json.load(f))


def read_manifest(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _aggregate_skips(sidecars: Sequence[Dict[str, Any]]
                     ) -> Dict[str, Dict[str, int]]:
    out: Dict[str, Dict[str, int]] = {}
    for sc in sidecars:
        for sk in sc.get("skips", ()):
            fam = out.setdefault(sk["family"], {})
            fam[sk["error"]] = fam.get(sk["error"], 0) + 1
    return out


def build(out_dir: str, cfg: Optional[FactoryConfig] = None, *,
          workers: int = 1, progress: bool = False,
          _stop_after_shards: Optional[int] = None) -> FactoryBuildResult:
    """Build (or resume) the dataset at ``out_dir``.

    * First call: commits ``plan.json``, builds every shard, writes
      ``manifest.json``.
    * Re-run after a crash/kill: verifies existing shards by checksum,
      rebuilds only missing/corrupt ones — the result is byte-identical
      to an uninterrupted build.
    * Re-run on a complete dataset: pure verification, no tracing.

    ``cfg=None`` resumes whatever plan the directory holds. Passing a
    config whose plan hash differs from the committed one raises
    :class:`PlanMismatchError` (delete the directory to rebuild). A plan
    with LM entries of an audio-frame arch raises ``ValueError`` before
    anything is written (:func:`_refuse_audio_lm`). ``workers > 1`` fans
    shard builds over spawned processes that re-read ``plan.json``; bytes
    are identical regardless of worker count. ``_stop_after_shards`` is a
    test hook simulating a mid-build kill.
    """
    plan_path = os.path.join(out_dir, "plan.json")
    if os.path.exists(plan_path):
        plan = read_plan(out_dir)
        if cfg is not None:
            want = make_plan(cfg)
            if want.plan_hash != plan.plan_hash:
                raise PlanMismatchError(
                    f"{out_dir} was planned with hash "
                    f"{plan.plan_hash[:12]}…, requested config hashes to "
                    f"{want.plan_hash[:12]}… — delete the directory or "
                    f"point the build elsewhere")
        _refuse_audio_lm(plan)
    else:
        if cfg is None:
            raise FileNotFoundError(
                f"{plan_path} does not exist and no FactoryConfig given")
        plan = make_plan(cfg)
        _refuse_audio_lm(plan)
        os.makedirs(out_dir, exist_ok=True)
        _atomic_write(plan_path,
                      json.dumps(plan.to_json(), sort_keys=True).encode())

    sidecars: Dict[int, Dict[str, Any]] = {}
    pending: List[int] = []
    for si in range(plan.n_shards):
        sc = _verify_shard(out_dir, si)
        if sc is None:
            pending.append(si)
        else:
            sidecars[si] = sc
    reused = len(sidecars)

    if _stop_after_shards is not None:
        pending = pending[:_stop_after_shards]

    if pending and workers > 1:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        ctx = mp.get_context("spawn")
        nw = min(workers, len(pending))
        with ProcessPoolExecutor(max_workers=nw, mp_context=ctx) as pool:
            for sc in pool.map(_build_shard_job,
                               [out_dir] * len(pending), pending):
                sidecars[sc["shard_index"]] = sc
                if progress:
                    print(f"[factory] shard {sc['shard_index'] + 1}"
                          f"/{plan.n_shards}: {sc['n']} records, "
                          f"{sc['n_skipped']} skipped", flush=True)
    else:
        for si in pending:
            sc = build_shard(plan, si, out_dir)
            sidecars[si] = sc
            if progress:
                print(f"[factory] shard {si + 1}/{plan.n_shards}: "
                      f"{sc['n']} records, {sc['n_skipped']} skipped",
                      flush=True)

    ordered = [sidecars[i] for i in sorted(sidecars)]
    complete = len(ordered) == plan.n_shards
    n_built = sum(sc["n"] for sc in ordered)
    n_skipped = sum(sc["n_skipped"] for sc in ordered)
    skips_by_family = _aggregate_skips(ordered)

    manifest_path = os.path.join(out_dir, "manifest.json")
    if complete:
        fam_counts: Dict[str, int] = {}
        for e in plan.entries:
            fam_counts[e["family"]] = fam_counts.get(e["family"], 0) + 1
        manifest = {
            "version": FACTORY_VERSION,
            "plan_hash": plan.plan_hash,
            "config": plan.config,
            "n_planned": plan.n_entries,
            "n_built": n_built,
            "n_skipped": n_skipped,
            "planned_by_family": fam_counts,
            "skips_by_family": skips_by_family,
            "shards": [{k: v for k, v in sc.items() if k != "skips"}
                       for sc in ordered],
        }
        _atomic_write(manifest_path,
                      json.dumps(manifest, sort_keys=True, indent=1).encode())

    return FactoryBuildResult(
        path=out_dir, plan_hash=plan.plan_hash, n_planned=plan.n_entries,
        n_built=n_built, n_skipped=n_skipped, n_shards=plan.n_shards,
        shards_built=len(pending), shards_reused=reused,
        skips_by_family=skips_by_family,
        max_rss_kb=max((sc.get("max_rss_kb", 0) for sc in ordered),
                       default=0),
        manifest_path=manifest_path if complete else "")


# ---------------------------------------------------------------------------
# streaming reader
# ---------------------------------------------------------------------------

def _shard_records(npz: "np.lib.npyio.NpzFile") -> Iterator[DatasetRecord]:
    header = json.loads(bytes(npz["_meta"].tobytes()).decode())
    for i, meta in enumerate(header["metas"]):
        yield DatasetRecord(
            x=npz[f"x{i}"], edges=npz[f"e{i}"], static=npz[f"s{i}"],
            y=npz[f"y{i}"], family=meta["family"],
            n_nodes=int(meta["n_nodes"]),
            meta={k: v for k, v in meta.items()
                  if k not in ("family", "n_nodes")})


def iter_records(path: str, verify: bool = False
                 ) -> Iterator[DatasetRecord]:
    """Stream records shard-by-shard (one shard in memory at a time).

    Each shard's npz handle is closed before the next opens, so a full
    scan holds O(shard) memory. ``verify=True`` additionally checks
    every shard's sha256 against the manifest before reading it.
    """
    manifest = read_manifest(path)
    if manifest.get("version") != FACTORY_VERSION:
        raise ValueError(
            f"dataset version mismatch at {path!r}: manifest says "
            f"{manifest.get('version')!r}, this reader expects "
            f"{FACTORY_VERSION!r}")
    for sh in manifest["shards"]:
        fpath = os.path.join(path, sh["file"])
        if verify:
            with open(fpath, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            if digest != sh["sha256"]:
                raise IOError(f"shard {sh['file']} checksum mismatch: "
                              f"{digest[:12]}… != {sh['sha256'][:12]}…")
        with np.load(fpath) as npz:
            yield from _shard_records(npz)


def load_factory_dataset(path: str, verify: bool = False
                         ) -> List[DatasetRecord]:
    """Materialize the whole dataset (small/CI scale convenience)."""
    return list(iter_records(path, verify=verify))


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _cli() -> None:  # pragma: no cover — exercised via CI
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--n-graphs", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shard-size", type=int, default=256)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--extra-families", default="convnext",
                    help="comma-separated held-out families ('' for none)")
    ap.add_argument("--lm-archs", default="",
                    help="comma-separated configs arch names (a build "
                         "refuses the audio-frame arch hubert-xlarge, which "
                         "the reference factory cannot trace)")
    ap.add_argument("--print-plan-hash", action="store_true",
                    help="print the plan hash and exit (no build)")
    args = ap.parse_args()

    cfg = FactoryConfig(
        n_graphs=args.n_graphs, seed=args.seed, shard_size=args.shard_size,
        extra_families=tuple(f for f in args.extra_families.split(",") if f),
        lm_archs=tuple(a for a in args.lm_archs.split(",") if a))
    if args.print_plan_hash:
        print(plan_hash(cfg))
        return
    if not args.out:
        ap.error("--out is required unless --print-plan-hash")
    res = build(args.out, cfg, workers=args.workers, progress=True)
    print(f"[factory] {res.n_built}/{res.n_planned} records in "
          f"{res.n_shards} shards ({res.shards_reused} reused, "
          f"{res.n_skipped} skipped) plan={res.plan_hash[:12]} "
          f"peak_rss={res.max_rss_kb / 1024:.0f}MB → {res.path}")


if __name__ == "__main__":  # pragma: no cover
    _cli()
