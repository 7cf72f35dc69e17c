"""Accuracy-reproduction harness — the paper's Table 3/4 protocol — the port
of ``repro.train.accuracy``.

A predictor earns trust from a *protocol*, not a single number: a fixed
split recipe, training to convergence, and per-family error for every
regression head. This module runs the JAX package's procedure on the
port's trainer:

* :class:`AccuracyProtocol` — the paper's settings (hidden 512, Huber,
  Adam at the LR-finder value, 70/15/15 fingerprint-stable split + family
  holdout) plus convergence knobs; the reference's fields and defaults.
* :func:`train_to_convergence` — a chunked early-stopping loop over
  :func:`~repro_torch.train.gnn_trainer.train_pmgns`: train
  ``chunk_epochs`` at a time (each chunk resumes the last one's
  checkpoint), stop when val MAPE has not improved by ``min_delta`` for
  ``patience`` consecutive chunks, keep the best chunk's parameters.
* :func:`evaluate_per_family` — overall *and* per-family MAPE for the
  latency / energy / memory heads.
* :func:`run_accuracy` — records (or a v1 / factory v2 dataset path) →
  split → train → per-split, per-family report.

Everything runs on the card unless ``device="cpu"`` is passed (then the
kernels' plain versions). ``chip_smoke.py``'s ``accuracy`` phase checks
the report against ``benchmarks/baselines/accuracy_mape.json``, the JAX
package's gate.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.batching import GraphSample
from ..core.gnn import PMGNSConfig
from ..dataset.builder import (DatasetRecord, load_dataset,
                               records_to_samples, split_dataset)
from .gnn_trainer import TrainConfig, evaluate, train_pmgns

HEADS = ("latency", "energy", "memory")
Device = Union[None, str, torch.device]


@dataclasses.dataclass(frozen=True)
class AccuracyProtocol:
    """Paper Table 3/4 settings + convergence policy.

    ``lr_boost`` follows ``benchmarks/table4_gnn.py``: the paper's
    lr=2.754e-5 is tuned for ~2300 steps/epoch at 10.5k graphs; a
    CI-scale dataset has proportionally fewer steps per epoch, so the
    boost keeps optimizer work per epoch comparable. Set it to 1.0 for
    the literal paper setting at full scale.
    """
    variant: str = "graphsage"
    hidden: int = 512
    lr: float = 2.754e-5
    lr_boost: float = 100.0
    batch_size: int = 32
    huber_delta: float = 1.0
    grad_clip: Optional[float] = 1.0   # boosted LR needs global-norm clip
    seed: int = 0
    train_frac: float = 0.70
    val_frac: float = 0.15
    holdout_families: Tuple[str, ...] = ("convnext",)
    max_epochs: int = 30
    chunk_epochs: int = 15     # chunk size trades early-stop granularity
                               # for the per-chunk restore and validation
    patience: int = 1          # chunks without val-MAPE improvement
    min_delta: float = 1e-3    # improvement below this counts as stalled

    def model_config(self) -> PMGNSConfig:
        return PMGNSConfig(variant=self.variant, hidden=self.hidden)

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def train_to_convergence(
    model_cfg: PMGNSConfig,
    train_samples: Sequence[GraphSample],
    val_samples: Sequence[GraphSample],
    proto: AccuracyProtocol = AccuracyProtocol(),
    checkpoint_dir: Optional[str] = None,
    *,
    device: Device = None,
) -> Tuple[Any, List[Dict[str, float]], Dict[str, Any]]:
    """Early-stopped training; returns ``(params, history, info)``.

    Runs ``train_pmgns`` in ``chunk_epochs`` increments, each chunk
    resuming the previous one's checkpoint exactly (the machinery a killed
    long run would use). After each chunk the val MAPE decides: improved
    by ``min_delta`` → keep going (and keep the params); stalled for
    ``patience`` chunks or ``max_epochs`` reached → stop and return the
    *best* chunk's parameters, a numpy tree with the target stats folded
    in (``train_pmgns``'s). When validation never gives a finite MAPE the
    final parameters are kept and ``best_val_mape`` is NaN. ``info``
    records ``epochs_trained`` / ``best_epoch`` / ``best_val_mape`` /
    ``converged`` (True when stopped by patience rather than the epoch
    cap). Without ``checkpoint_dir`` the chunks share a temporary
    directory, removed on the way out.
    """
    tmp = None
    if checkpoint_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="dippm-acc-")
        checkpoint_dir = tmp.name
    history: List[Dict[str, float]] = []
    best_mape = float("inf")
    best_params = None
    best_epoch = -1
    stall = 0
    epochs_done = 0
    converged = False
    try:
        os.makedirs(checkpoint_dir, exist_ok=True)
        while epochs_done < proto.max_epochs:
            target = min(epochs_done + proto.chunk_epochs, proto.max_epochs)
            tcfg = TrainConfig(
                epochs=target, batch_size=proto.batch_size,
                lr=proto.lr * proto.lr_boost,
                grad_clip=proto.grad_clip,
                huber_delta=proto.huber_delta, seed=proto.seed,
                checkpoint_dir=checkpoint_dir,
                checkpoint_every=proto.chunk_epochs)
            params, hist = train_pmgns(
                model_cfg, train_samples, val_samples, tcfg,
                resume_from=checkpoint_dir, device=device)
            history += [h for h in hist if not h.get("resumed_complete")]
            epochs_done = target
            val_mape = float(hist[-1].get("val_mape", float("nan")))
            if np.isfinite(val_mape) and val_mape < best_mape - proto.min_delta:
                best_mape = val_mape
                best_params = params
                best_epoch = epochs_done - 1
                stall = 0
            else:
                stall += 1
                if stall >= proto.patience:
                    converged = True
                    break
        if best_params is None:   # val empty / never finite — keep final
            best_params = params
            best_epoch = epochs_done - 1
            best_mape = float("nan")
    finally:
        if tmp is not None:
            tmp.cleanup()

    info = {"epochs_trained": epochs_done, "best_epoch": best_epoch,
            "best_val_mape": best_mape, "converged": converged}
    return best_params, history, info


def evaluate_per_family(params, model_cfg: PMGNSConfig,
                        samples: Sequence[GraphSample],
                        batch_size: int = 32, *, device: Device = None
                        ) -> Dict[str, Dict[str, float]]:
    """Per-family metrics dict: ``{family: {mape, mape_latency, …, n}}``.

    Families are read from each sample's ``meta`` (set by
    ``records_to_samples``); the per-family groups reuse
    :func:`~repro_torch.train.gnn_trainer.evaluate`, so numbers per family
    and overall come from one implementation.
    """
    groups: Dict[str, List[GraphSample]] = {}
    for s in samples:
        fam = str((s.meta or {}).get("family", "?"))
        groups.setdefault(fam, []).append(s)
    return {fam: evaluate(params, model_cfg, grp, batch_size, device=device)
            for fam, grp in sorted(groups.items())}


def _split_report(metrics: Dict[str, float]) -> Dict[str, float]:
    keep = ("loss", "mape", "mape_latency", "mape_energy", "mape_memory", "n")
    return {k: (round(float(metrics[k]), 6) if k != "n" else metrics[k])
            for k in keep if k in metrics}


def run_accuracy(
    dataset: Union[str, Sequence[DatasetRecord]],
    proto: AccuracyProtocol = AccuracyProtocol(),
    checkpoint_dir: Optional[str] = None,
    *,
    device: Device = None,
) -> Dict[str, Any]:
    """Dataset → split → train-to-convergence → per-family MAPE report.

    ``dataset`` is a list of records or the path of a v1 or factory (v2)
    dataset directory (:func:`~repro_torch.dataset.builder.load_dataset`).
    The report carries the protocol, split sizes, convergence info, the
    val MAPE of every epoch, per-split overall MAPE and per-family MAPE for
    all three heads (the held-out "unseen" family included), and the
    trained ``params`` (a numpy tree ``save_artifact`` takes). Raises
    ``ValueError`` when the train or val split is empty.
    """
    records = (load_dataset(dataset) if isinstance(dataset, str)
               else list(dataset))
    sp = split_dataset(records, seed=proto.seed, train=proto.train_frac,
                       val=proto.val_frac,
                       holdout_families=proto.holdout_families)
    samples = {k: records_to_samples(v) for k, v in sp.items()}
    if not samples["train"] or not samples["val"]:
        raise ValueError(
            f"split too small to train: sizes "
            f"{ {k: len(v) for k, v in sp.items()} }")

    model_cfg = proto.model_config()
    params, history, info = train_to_convergence(
        model_cfg, samples["train"], samples["val"], proto,
        checkpoint_dir=checkpoint_dir, device=device)

    report: Dict[str, Any] = {
        "protocol": proto.to_json(),
        "splits": {k: len(v) for k, v in sp.items()},
        **info,
        "history_val_mape": [round(float(h["val_mape"]), 6)
                             for h in history if "val_mape" in h],
        "per_family": {},
    }
    for split in ("val", "test", "unseen"):
        if samples[split]:
            report[split] = _split_report(
                evaluate(params, model_cfg, samples[split], proto.batch_size,
                         device=device))
            report["per_family"][split] = {
                fam: _split_report(m) for fam, m in
                evaluate_per_family(params, model_cfg, samples[split],
                                    proto.batch_size, device=device).items()}
    report["params"] = params   # callers may save/serve the predictor
    return report
