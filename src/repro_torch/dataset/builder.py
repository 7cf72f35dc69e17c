"""DIPPM graph dataset builder (paper §4.1) — the port of
``repro.dataset.builder``.

Builds the paper's multi-regression dataset: for each family in Table 2
it samples variant configs (depth / width / resolution / batch), traces
them on the meta device into OpGraphs
(:func:`repro_torch.zoo.families.trace_family`), and labels every graph
with ``Y = (latency_ms, energy_j, memory_mb)`` from the analytic cost
model (:mod:`repro_torch.perfmodel.cost_model`). Each record keeps

    X  — [n, 32] node features        (paper §3.2)
    A  — sparse edge list             (densified at batch time)
    F_s — 5 static features           (paper §3.3, eq. 1)
    Y  — 3 regression targets         (paper §4.1)

Storage is the v1 layout (``manifest.json`` + ``shardNNNN.npz`` with edge
lists), which either package reads from the other (the same manifest
bytes, the same arrays); paper-scale builds use the factory's sharded v2
layout (:mod:`repro_torch.dataset.factory`), which :func:`load_dataset`
reads too. :func:`records_to_samples` pads to bucketed sparse-edge
``GraphSample``s.
:func:`synthetic_samples` makes cheap random samples with the same
storage contract for tests and benchmarks.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.batching import DEFAULT_BUCKETS, GraphSample, pad_sample
from ..core.node_features import node_feature_matrix
from ..core.static_features import static_features
from ..perfmodel.cost_model import estimate
from ..perfmodel.devices import DEVICES
from ..zoo.families import TABLE2_FRACTIONS, family_variants, trace_family

log = logging.getLogger("repro_torch.dataset")

DATASET_VERSION = "dippm-ds-v1"


@dataclasses.dataclass
class DatasetRecord:
    x: np.ndarray        # [n, 32] float32
    edges: np.ndarray    # [e, 2] int32 (src, dst)
    static: np.ndarray   # [5] float32
    y: np.ndarray        # [3] float32
    family: str
    n_nodes: int
    meta: Dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SkipRecord:
    """One failed variant trace — structured, so shrinkage is auditable."""
    family: str
    cfg: Dict
    error: str        # exception type name
    message: str

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


class DatasetBuildResult(List[DatasetRecord]):
    """``build_dataset``'s return value: the records, plus skip accounting.

    A plain ``list`` subclass so every existing caller keeps working;
    ``.skips`` carries the structured skip records and
    ``.skips_by_family()`` the per-family × per-error counters that
    :func:`save_dataset` surfaces in the manifest.
    """

    def __init__(self, records: Sequence[DatasetRecord] = (),
                 skips: Sequence[SkipRecord] = ()):
        super().__init__(records)
        self.skips: List[SkipRecord] = list(skips)

    @property
    def n_skipped(self) -> int:
        return len(self.skips)

    def skips_by_family(self) -> Dict[str, Dict[str, int]]:
        out: Dict[str, Dict[str, int]] = {}
        for sk in self.skips:
            fam = out.setdefault(sk.family, {})
            fam[sk.error] = fam.get(sk.error, 0) + 1
        return out


def _trace_and_label(family: str, cfg: Dict, device_name: str,
                     noise_sigma: float) -> DatasetRecord:
    g = trace_family(family, cfg)
    est = estimate(g, DEVICES[device_name], noise_sigma=noise_sigma)
    return DatasetRecord(
        x=node_feature_matrix(g),
        edges=np.asarray(g.edges, dtype=np.int32).reshape(-1, 2),
        static=static_features(g),
        y=est.as_targets(),
        family=family,
        n_nodes=g.num_nodes,
        meta={"batch": cfg["batch"], "res": cfg["res"],
              "fingerprint": g.fingerprint()},
    )


def build_dataset(
    n_graphs: int = 1024,
    seed: int = 0,
    device_name: str = "a100-40gb",
    noise_sigma: float = 0.01,
    fractions: Optional[Dict[str, float]] = None,
    extra_families: Sequence[str] = (),
    progress_every: int = 0,
) -> DatasetBuildResult:
    """Build ``n_graphs`` records following the Table-2 family mix.

    ``extra_families`` (e.g. ``("convnext",)``) are built *in addition*, one
    share each, and tagged so they can be held out (Table 5 "unseen").

    Returns a :class:`DatasetBuildResult` (a ``list`` of records whose
    ``.skips`` holds a :class:`SkipRecord` per failed variant trace) so
    silent dataset shrinkage is visible to callers and manifests.

    This is the small, in-memory path; paper-scale builds go through the
    sharded, resumable, multi-worker ``repro_torch.dataset.factory``.
    """
    fractions = dict(fractions or TABLE2_FRACTIONS)
    rng = np.random.default_rng(seed)
    plan: List[Tuple[str, Dict]] = []
    for fam, frac in fractions.items():
        count = max(1, int(round(frac * n_graphs)))
        for _ in range(count):
            plan.append((fam, family_variants(fam, rng)))
    for fam in extra_families:
        for _ in range(max(1, n_graphs // 50)):
            plan.append((fam, family_variants(fam, rng)))
    rng.shuffle(plan)

    result = DatasetBuildResult()
    for i, (fam, cfg) in enumerate(plan):
        try:
            result.append(_trace_and_label(fam, cfg, device_name,
                                           noise_sigma))
        except Exception as e:  # pragma: no cover — bad variant config
            result.skips.append(SkipRecord(
                family=fam, cfg=cfg, error=type(e).__name__,
                message=str(e)[:300]))
            log.warning("skipping %s %s: %s: %s", fam, cfg,
                        type(e).__name__, e)
        if progress_every and (i + 1) % progress_every == 0:
            print(f"[dataset] {i + 1}/{len(plan)} graphs traced")
    return result


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------

def save_dataset(records: Sequence[DatasetRecord], path: str,
                 shard_size: int = 2048) -> None:
    """Write the v1 (in-memory) shard format.

    If ``records`` is a :class:`DatasetBuildResult`, its skip accounting
    is recorded in the manifest (``n_skipped`` / ``skips_by_family`` /
    ``skips``) so a saved dataset carries the evidence of any shrinkage.
    The JAX package's ``load_dataset`` reads what this writes, and the
    other way round.
    """
    os.makedirs(path, exist_ok=True)
    manifest = {"version": DATASET_VERSION, "n": len(records), "shards": []}
    if isinstance(records, DatasetBuildResult) and records.skips:
        manifest["n_skipped"] = records.n_skipped
        manifest["skips_by_family"] = records.skips_by_family()
        manifest["skips"] = [sk.to_json() for sk in records.skips]
    for si in range(0, len(records), shard_size):
        shard = records[si:si + shard_size]
        arrs: Dict[str, np.ndarray] = {}
        metas = []
        for i, r in enumerate(shard):
            arrs[f"x{i}"] = r.x
            arrs[f"e{i}"] = r.edges
            arrs[f"s{i}"] = r.static
            arrs[f"y{i}"] = r.y
            metas.append({"family": r.family, "n_nodes": r.n_nodes,
                          **r.meta})
        fname = f"shard{si // shard_size:04d}.npz"
        np.savez_compressed(os.path.join(path, fname), **arrs)
        manifest["shards"].append({"file": fname, "metas": metas})
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def load_dataset(path: str) -> List[DatasetRecord]:
    """Load a saved dataset — v1 (this module's layout) or v2 (the
    factory's), written by either package.

    A factory-built ``dippm-ds-v2`` dataset goes to the factory's
    streaming reader. Every shard's npz handle is closed before the next
    shard opens.
    """
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    version = manifest.get("version")
    if version == "dippm-ds-v2":
        from .factory import load_factory_dataset
        return load_factory_dataset(path)
    if version != DATASET_VERSION:
        raise ValueError(
            f"dataset version mismatch at {path!r}: manifest says "
            f"{version!r}, expected {DATASET_VERSION!r} (v1 builder "
            f"layout) or 'dippm-ds-v2' (factory layout)")
    records: List[DatasetRecord] = []
    for sh in manifest["shards"]:
        with np.load(os.path.join(path, sh["file"])) as data:
            for i, meta in enumerate(sh["metas"]):
                records.append(DatasetRecord(
                    x=data[f"x{i}"], edges=data[f"e{i}"],
                    static=data[f"s{i}"], y=data[f"y{i}"],
                    family=meta["family"], n_nodes=meta["n_nodes"],
                    meta={k: v for k, v in meta.items()
                          if k not in ("family", "n_nodes")}))
    return records


# ---------------------------------------------------------------------------
# splits + batching glue
# ---------------------------------------------------------------------------

def record_fingerprint(r: DatasetRecord) -> str:
    """Canonical content hash for split assignment.

    Prefers the traced graph's ``OpGraph.fingerprint()`` (stashed in
    ``meta`` by the builder); records from older datasets fall
    back to a content hash of the stored arrays. Either way the value
    depends only on the record itself, never on dataset size or order.
    """
    fp = r.meta.get("fingerprint")
    if fp:
        return str(fp)
    h = hashlib.sha256()
    for a in (r.x, r.edges, r.static, r.y):
        arr = np.ascontiguousarray(a)
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    h.update(r.family.encode())
    return h.hexdigest()


def split_assignment(fingerprint: str, seed: int = 0,
                     train: float = 0.70, val: float = 0.15) -> str:
    """'train' | 'val' | 'test' from a record's canonical hash.

    Membership is a pure function of ``(fingerprint, seed)``: growing
    the dataset adds records to splits but never moves an existing
    record between them (the paper's 70/15/15 becomes the *expected*
    fraction rather than an exact count).
    """
    digest = hashlib.sha256(f"{fingerprint}|split|{seed}".encode()).digest()
    u = int.from_bytes(digest[:8], "big") / float(2 ** 64)
    if u < train:
        return "train"
    if u < train + val:
        return "val"
    return "test"


def split_dataset(records: Sequence[DatasetRecord], seed: int = 0,
                  train: float = 0.70, val: float = 0.15,
                  holdout_families: Sequence[str] = ("convnext",),
                  ) -> Dict[str, List[DatasetRecord]]:
    """70/15/15 split (paper Table 3) + family holdout ("unseen").

    Split membership is derived per record from its canonical
    fingerprint hash (:func:`split_assignment`), not from a
    size-dependent permutation — so adding records to a growing dataset
    never reshuffles the existing train/val/test assignments, and a
    model evaluated on "test" was never trained on those graphs even
    across dataset versions.
    """
    out: Dict[str, List[DatasetRecord]] = {
        "train": [], "val": [], "test": [], "unseen": []}
    for r in records:
        if r.family in holdout_families:
            out["unseen"].append(r)
        else:
            out[split_assignment(record_fingerprint(r), seed,
                                 train, val)].append(r)
    return out


def records_to_samples(records: Sequence[DatasetRecord],
                       buckets=DEFAULT_BUCKETS) -> List[GraphSample]:
    """Records → padded sparse-edge ``GraphSample``s (one shared pad path).

    Samples keep the edge list sparse; the dense ``[B, N, N]`` adjacency
    only exists inside the trainer's batches, so a paper-scale dataset
    stays O(nodes + edges) on the host.
    """
    return [pad_sample(r.x, r.edges, r.static, y=r.y,
                       meta={"family": r.family, **r.meta}, buckets=buckets)
            for r in records]


def synthetic_samples(n: int, seed: int = 0, n_min: int = 4,
                      n_max: int = 30,
                      y_scale: float = 100.0) -> List[GraphSample]:
    """Random labeled ``GraphSample``s (chain + random extra edges)."""
    rng = np.random.default_rng(seed)
    out: List[GraphSample] = []
    for i in range(n):
        nn = int(rng.integers(n_min, n_max))
        x = rng.standard_normal((nn, 32)).astype(np.float32)
        edges = ([(j, j + 1) for j in range(nn - 1)]
                 + [(int(rng.integers(nn)), int(rng.integers(nn)))
                    for _ in range(nn // 2)])
        out.append(pad_sample(
            x, np.asarray(edges, np.int32),
            rng.standard_normal(5).astype(np.float32),
            y=(rng.random(3) * y_scale + 1).astype(np.float32),
            meta={"i": i}))
    return out
