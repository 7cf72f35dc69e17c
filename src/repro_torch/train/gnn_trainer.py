"""PMGNS training stack (paper §4.3, Table 3 settings) — the port of
``repro.train.gnn_trainer``.

Settings faithful to the paper: Adam, lr 2.754e-5 (their LR-finder
value), Huber loss, dropout 0.05, hidden 512, MAPE metric. Training runs
on the card by default (``device=None`` means ``"cuda"``) and on the CPU
when asked, where every kernel takes its plain version.

1. **Storage and schedule** — samples hold sparse edge lists; each epoch
   is stacked into per-bucket ``[S, B, ...]`` segments
   (:func:`~repro_torch.core.batching.stack_epoch_segments`) in the
   layout of ``PMGNSConfig.resolved_layout`` (dense ``adj``, sparse
   ``edges``, or the packed flat node axis). The shuffle comes from
   ``_epoch_rng(seed, epoch)``, numpy as in the JAX trainer, so both
   trainers see the same batches in the same order.
2. **Steps** — each step is the weighted Huber loss
   (:func:`_loss_terms`; batch-padding rows are exact no-ops), its
   gradients through the kernels' ``autograd.Function``\\ s, and an Adam
   update (:mod:`repro_torch.optim`) written into the parameters in
   place. ``TrainConfig(mode="scan")`` moves each segment to the device
   once and runs its steps with no host sync, the loss sums staying on
   the device until the segment ends; ``mode="eager"`` moves each step's
   batch and syncs every step. Both compute the same losses.
3. **Randomness** — dropout draws from a ``torch.Generator`` on the
   device seeded from ``(seed, epoch, step)``, so a resumed run repeats
   the uninterrupted one bit for bit. Its bits are torch's, not
   ``jax.random``'s: compare with the JAX trainer at dropout 0.
4. **Data parallelism** — ``TrainConfig(data_parallel=True)`` splits
   each step's batch rows over the ranks of the default
   ``torch.distributed`` group, one process per card (``gloo`` processes
   on the CPU), as the JAX trainer's ``shard_map`` splits them over its
   devices. The caller initialises the group (backend, ``init_method``,
   ``rank``, ``world_size``) and passes each rank's own ``device``; the
   trainer builds a ``("data",)`` mesh over it
   (:mod:`repro_torch.launch.mesh`). Every rank stacks the same segments
   with the batch padded to a multiple of the world size (zero-weight
   rows) and keeps its own rows of each; the loss divides by the whole
   step's weight, the gradients are summed over the group in one flat
   all-reduce a step, and every rank applies the same Adam update. The
   same trainer runs one rank (or no group) and N ranks unchanged.
5. **Durability** — ``TrainConfig(checkpoint_dir=..., checkpoint_every=k)``
   checkpoints ``(params, opt_state, step, epoch, target stats)`` in the
   JAX package's format (:mod:`repro_torch.checkpoint`), from rank 0 only;
   ``train_pmgns(resume_from=...)`` continues a run exactly.

Targets are regressed in log1p space; MAPE is computed in physical units
after decoding, like the paper.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import CheckpointManager, latest_step, restore_checkpoint
from ..core.batching import (GraphSample, batches_by_bucket, collate_packed,
                             next_pow2, pack_graphs, resolve_packed_budgets,
                             stack_epoch_segments)
from ..core.gnn import (PMGNS, PMGNSConfig, check_supported, decode_targets,
                        encode_targets, huber, params_from_numpy,
                        params_to_numpy, pmgns_apply, pmgns_init,
                        resolve_device)
from ..optim import adam, constant
from ..optim.optimizers import tree_leaves, tree_map

Params = Dict[str, Any]


@dataclasses.dataclass
class TrainConfig:
    epochs: int = 10
    batch_size: int = 32
    lr: float = 2.754e-5          # paper Table 3
    huber_delta: float = 1.0
    seed: int = 0
    log_every: int = 0            # 0 = silent
    grad_clip: Optional[float] = None   # global-norm clip (adam transform)
    mode: str = "scan"            # "scan" (a segment per transfer) | "eager"
    scan_steps: int = 32          # max steps per stacked segment
    data_parallel: bool = False   # split batch rows over the default group
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0     # epochs between checkpoints (0 = off)
    checkpoint_keep: int = 3


def _loss_terms(params: Params, cfg: PMGNSConfig,
                batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator], delta: float,
                mean: torch.Tensor, std: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Σ wt·huber, Σ wt·n_targets) — the weighted-loss building blocks.

    ``batch["wt"]`` (1 real row / 0 padding) makes batch-padding rows
    exact no-ops: they contribute nothing to either term, so a padded
    remainder step computes the same loss and gradients as the short
    batch it stands for.
    """
    pred = pmgns_apply(params, cfg, batch, train=True, generator=generator)
    target = (encode_targets(batch["y"]) - mean) / std
    h = huber(pred, target, delta)                       # [B, T]
    wt = batch.get("wt")
    if wt is None:
        wt = torch.ones((h.shape[0],), dtype=h.dtype, device=h.device)
    return torch.sum(h * wt[:, None]), torch.sum(wt) * h.shape[-1]


def _target_stats(samples: Sequence[GraphSample]
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-target mean/std of the log-space labels over the train set.
    Training on standardized targets converges in O(100) steps instead of
    O(10k); the stats are folded into the last FC layer afterwards
    (:func:`_fold_stats`), so the trained model predicts raw log space."""
    ys = np.stack([np.log1p(np.maximum(np.asarray(s.y, np.float32), 0.0))
                   for s in samples])
    mean = ys.mean(axis=0)
    std = np.maximum(ys.std(axis=0), 1e-3)
    return mean.astype(np.float32), std.astype(np.float32)


def _fold_stats(params: Params, cfg: PMGNSConfig, mean, std) -> Params:
    """A copy of ``params`` whose last FC layer predicts ``y·σ + μ``
    (``w' = w·σ``, ``b' = b·σ + μ``); tensor or numpy leaves."""
    last = f"b{cfg.n_fc_blocks - 1}"
    head = dict(params["fc"][last])
    head["w"] = head["w"] * std[None, :]
    head["b"] = head["b"] * std + mean
    return {**params, "fc": {**params["fc"], last: head}}


def _tensor_tree(params: Union[PMGNS, Params], cfg: PMGNSConfig,
                 device) -> Params:
    """``params`` as a tree of tensors: a :class:`PMGNS`'s own, a tensor
    tree as it is, a numpy tree moved to ``device`` (default ``"cuda"``)."""
    if isinstance(params, PMGNS):
        return params.tree()
    if isinstance(tree_leaves(params)[0], torch.Tensor):
        return params
    return params_from_numpy(params, cfg, device).tree()


@torch.no_grad()
def _eval_batch(params: Params, cfg: PMGNSConfig,
                batch: Dict[str, torch.Tensor], delta: float = 1.0
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-graph (huber loss, APE [·, 3], prediction [·, 3]) rows on the
    host — aggregated there so packed batches can drop their padded graph
    slots before averaging."""
    pred = pmgns_apply(params, cfg, batch, train=False)
    y = batch["y"]
    loss_rows = torch.mean(huber(pred, encode_targets(y), delta), dim=-1)
    pred_phys = decode_targets(pred)
    ape = torch.abs(pred_phys - y) / torch.abs(y).clamp_min(1e-6)
    return (loss_rows.cpu().numpy(), ape.cpu().numpy(),
            pred_phys.cpu().numpy())


def _eval_packed_batches(samples: Sequence[GraphSample],
                         batch_size: int) -> List[Dict[str, np.ndarray]]:
    """Packed eval bins at one shared budget triple (order-free metrics),
    as the JAX trainer bins them."""
    total = sum(s.n_nodes for s in samples)
    nb, eb, gb = resolve_packed_budgets(
        min(next_pow2(batch_size * 256), next_pow2(max(total, 1))))
    bins = pack_graphs(samples, nb, eb, gb)
    return [collate_packed([samples[j] for j in idx], nb, eb, gb)
            for idx in bins]


def evaluate(params: Union[PMGNS, Params], cfg: PMGNSConfig,
             samples: Sequence[GraphSample], batch_size: int = 32, *,
             device: Union[None, str, torch.device] = None
             ) -> Dict[str, float]:
    """Loss + overall and per-target MAPE over a sample set.

    The batch layout follows ``cfg.resolved_layout``; packed eval
    bin-packs mixed-size graphs onto one flat node axis and masks the
    padded graph slots out of every metric. ``params`` is a
    :class:`PMGNS`, a tensor tree, or a numpy tree (moved to ``device``,
    default ``"cuda"``).
    """
    samples = list(samples)
    tree = _tensor_tree(params, cfg, device)
    dev = tree_leaves(tree)[0].device
    layout = cfg.resolved_layout
    if layout == "packed":
        batches = _eval_packed_batches(samples, batch_size)
    else:
        batches = batches_by_bucket(samples, batch_size,
                                    sparse=layout == "sparse")
    losses, apes = [], []
    for b in batches:
        wt = b.pop("wt", None)
        tb = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
        loss_rows, ape, _ = _eval_batch(tree, cfg, tb)
        real = (np.asarray(wt) > 0 if wt is not None
                else np.ones(ape.shape[0], bool))
        losses.append(float(loss_rows[real].sum()))
        apes.append(ape[real])
    if not apes:
        return {"loss": float("nan"), "mape": float("nan")}
    ape_all = np.concatenate(apes, axis=0)
    n = ape_all.shape[0]
    return {
        "loss": float(np.sum(losses) / n),
        "mape": float(ape_all.mean()),
        "mape_latency": float(ape_all[:, 0].mean()),
        "mape_energy": float(ape_all[:, 1].mean()),
        "mape_memory": float(ape_all[:, 2].mean()),
        "n": n,
    }


_PREDICT_ENGINE_CACHE: List[Any] = []   # [(params, cfg, engine)] — one slot


def predict_batch(params: Union[PMGNS, Params], cfg: PMGNSConfig,
                  samples: Sequence[GraphSample], engine=None, *,
                  device: Union[None, str, torch.device] = None
                  ) -> np.ndarray:
    """Physical-unit predictions [n, 3] for a list of samples, through the
    prediction engine (``repro_torch.core.engine``) on ``cfg``'s own
    layout, so eval and serving share one inference implementation. A
    one-slot module cache reuses the engine across calls with the *same
    params object*.
    """
    if engine is not None:
        return engine.predict_samples(list(samples))
    from ..core.engine import EngineConfig, PredictionEngine
    from ..core.static_features import STATIC_FEATURE_DIM_EXT
    if not (_PREDICT_ENGINE_CACHE
            and _PREDICT_ENGINE_CACHE[0][0] is params
            and _PREDICT_ENGINE_CACHE[0][1] == cfg):
        eng = PredictionEngine(params, cfg, EngineConfig(
            extended_static=(cfg.static_dim == STATIC_FEATURE_DIM_EXT)),
            device=device)
        _PREDICT_ENGINE_CACHE[:] = [(params, cfg, eng)]
    return _PREDICT_ENGINE_CACHE[0][2].predict_samples(list(samples))


# ---------------------------------------------------------------------------
# the epoch loop
# ---------------------------------------------------------------------------

def _epoch_rng(seed: int, epoch: int) -> np.random.Generator:
    """Shuffle RNG derived from (seed, epoch) — resume-safe by design, and
    the JAX trainer's, so both see the same schedule."""
    return np.random.default_rng([seed, 1, epoch])


def _step_generator(seed: int, epoch: int, step: int, device: torch.device,
                    rank: int = 0) -> torch.Generator:
    """The dropout generator of one step, seeded from (seed, epoch, step)
    and, past rank 0, the data-parallel rank, as the JAX trainer folds the
    axis index into its key: ranks draw different masks, and rank 0 draws
    a single-device run's."""
    entropy = [seed, 2, epoch, step] + ([rank] if rank else [])
    state = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) << 32 | int(state[1]))
    return gen


def _restore(path: str, model: PMGNS, opt_state, dev: torch.device):
    """Load the latest checkpoint under ``path`` into ``model`` (in place)
    → ``(opt_state, step, epoch, t_mean, t_std)``."""
    host = params_to_numpy(model)
    zero = np.zeros((), np.float32)
    like = {"params": host, "opt_state": {"m": host, "v": host},
            "step": zero, "epoch": zero, "t_mean": zero, "t_std": zero}
    state = restore_checkpoint(path, None, like)
    with torch.no_grad():
        for p, v in zip(tree_leaves(model.tree()),
                        tree_leaves(state["params"])):
            p.copy_(torch.as_tensor(v))
    opt_state = tree_map(lambda _, v: torch.as_tensor(v, device=dev),
                         opt_state, state["opt_state"])
    step = torch.as_tensor(np.int32(state["step"]), device=dev)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa: E731
                                    device=dev)
    return (opt_state, step, int(state["epoch"]), f32(state["t_mean"]),
            f32(state["t_std"]))


def _data_group(device: torch.device):
    """The ``data`` axis's process group over every rank of the default
    group, or None without a default group (one rank, no collective)."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    from ..launch.mesh import make_mesh
    return make_mesh((dist.get_world_size(),), ("data",),
                     device.type).get_group("data")


def _split_flat(flat: torch.Tensor, like: Sequence[torch.Tensor]
                ) -> List[torch.Tensor]:
    return [v.view_as(t) for t, v in
            zip(like, flat.split([t.numel() for t in like]))]


def _all_reduce_flat(tensors: Sequence[torch.Tensor], group
                     ) -> List[torch.Tensor]:
    """The sum of ``tensors`` over ``group``, in one flat all-reduce."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return _split_flat(flat, tensors)


@torch.no_grad()
def _broadcast_from_first(tensors: Sequence[torch.Tensor], group) -> None:
    """Overwrite ``tensors`` on every rank of ``group`` with its first
    rank's, in one flat broadcast."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.broadcast(flat, src=dist.get_global_rank(group, 0), group=group)
    for t, v in zip(tensors, _split_flat(flat, tensors)):
        t.copy_(v)


def _barrier(group, device: torch.device) -> None:
    """Return once every rank of ``group`` has reached this point (a
    one-element all-reduce on ``device``, read back on the host)."""
    flag = torch.ones(1, device=device)
    dist.all_reduce(flag, group=group)
    flag.item()


def train_pmgns(
    model_cfg: PMGNSConfig,
    train_samples: Sequence[GraphSample],
    val_samples: Sequence[GraphSample] = (),
    cfg: TrainConfig = TrainConfig(),
    resume_from: Optional[str] = None,
    *,
    device: Union[None, str, torch.device] = None,
) -> Tuple[Params, List[Dict[str, float]]]:
    """Train the PMGNS; returns ``(params, per-epoch history)``, the
    params as a numpy pytree with the target stats folded into the head
    (what ``save_artifact`` and ``params_from_numpy`` take).

    ``device=None`` trains on the card and raises without one; pass
    ``device="cpu"`` for the plain versions. ``resume_from`` points at a
    checkpoint directory: the latest committed checkpoint restores
    ``(params, opt_state, step, epoch, target stats)`` and training
    continues from the next epoch, bit-matching an uninterrupted run; with
    no committed checkpoint there, training starts fresh.

    ``cfg.data_parallel`` splits each step's rows over the ranks of the
    default process group, which the caller has initialised; each rank
    calls this with its own ``device`` and gets the same result. Without a
    group it trains alone. Rank 0's initial parameters are broadcast,
    only rank 0 writes checkpoints, and every rank restores them.
    """
    if cfg.mode not in ("scan", "eager"):
        raise ValueError(f"TrainConfig.mode must be 'scan' or 'eager', "
                         f"got {cfg.mode!r}")
    layout = model_cfg.resolved_layout
    if cfg.data_parallel and layout == "packed":
        raise ValueError(
            "data_parallel=True shards the scan's batch axis, but packed "
            "segments have no batch axis to shard (one flat node axis per "
            "step) — train data-parallel with layout='sparse' instead")
    check_supported(model_cfg)
    dev = resolve_device(device)
    train_samples = list(train_samples)
    model = params_from_numpy(pmgns_init(cfg.seed, model_cfg), model_cfg,
                              dev, requires_grad=True)
    params = model.tree()
    leaves = tree_leaves(params)
    opt = adam(constant(cfg.lr), grad_clip_norm=cfg.grad_clip)
    opt_state = opt.init(params)
    step = torch.zeros((), dtype=torch.int32, device=dev)
    mean_np, std_np = _target_stats(train_samples)
    t_mean = torch.as_tensor(mean_np, device=dev)
    t_std = torch.as_tensor(std_np, device=dev)
    start_epoch = 0
    if resume_from is not None and latest_step(resume_from) is not None:
        opt_state, step, last, t_mean, t_std = _restore(
            resume_from, model, opt_state, dev)
        start_epoch = last + 1
    if cfg.data_parallel and cfg.mode != "scan":
        raise ValueError(
            "data_parallel=True requires mode='scan' — the eager reference "
            "loop is single-device by design")
    group, rank, world = None, 0, 1
    if cfg.data_parallel:
        group = _data_group(dev)
    if group is not None:
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        _broadcast_from_first(leaves, group)

    def train_step(batch: Dict[str, torch.Tensor], k: int, epoch: int,
                   wn_total: Optional[torch.Tensor] = None):
        """One loss + gradient + Adam update; returns the device-side
        (Σ wt·huber, Σ wt·n_targets) of the step's rows. Under data
        parallelism the loss divides by ``wn_total``, the whole step's
        Σ wt·n_targets, and the gradients are summed over the group."""
        nonlocal opt_state, step
        gen = (_step_generator(cfg.seed, epoch, k, dev, rank)
               if model_cfg.dropout > 0 else None)
        wl, wn = _loss_terms(params, model_cfg, batch, gen, cfg.huber_delta,
                             t_mean, t_std)
        denom = wn if wn_total is None else wn_total
        grads = torch.autograd.grad(wl / torch.clamp_min(denom, 1.0), leaves,
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        if group is not None:
            grads = _all_reduce_flat(grads, group)
        with torch.no_grad():
            grad_tree = _unflatten(params, iter(grads))
            new, opt_state = opt.update(step, opt_state, params, grad_tree)
            for p, v in zip(leaves, tree_leaves(new)):
                p.copy_(v)
            step = step + 1
        return wl.detach(), wn.detach()

    def validate() -> Dict[str, float]:
        with torch.no_grad():
            folded = _fold_stats(params, model_cfg, t_mean, t_std)
        return {f"val_{key}": v for key, v in evaluate(
            folded, model_cfg, val_samples, cfg.batch_size).items()}

    mgr = (CheckpointManager(cfg.checkpoint_dir, keep=cfg.checkpoint_keep)
           if cfg.checkpoint_dir and rank == 0 else None)
    history: List[Dict[str, float]] = []
    for epoch in range(start_epoch, cfg.epochs):
        t0 = time.time()
        segments = stack_epoch_segments(
            train_samples, cfg.batch_size, rng=_epoch_rng(cfg.seed, epoch),
            batch_multiple=world, max_steps=cfg.scan_steps, layout=layout)
        total_steps = sum(int(s["wt"].shape[0]) for s in segments)
        wl_sum, wn_sum, k = 0.0, 0.0, 0
        for seg in segments:
            n_steps = int(seg["wt"].shape[0])
            if cfg.mode == "scan":
                wn_steps = None
                if group is not None:
                    # the whole step's Σ wt·n_targets, on the host: the
                    # reference's psum of the shards' sums (0/1 weights
                    # times T, so the float32 sums are exact either way);
                    # then this rank's rows of every leaf
                    wn_steps = torch.as_tensor(
                        seg["wt"].sum(axis=1, dtype=np.float32)
                        * np.float32(seg["y"].shape[-1]), device=dev)
                    per = seg["wt"].shape[1] // world
                    seg = {key: np.ascontiguousarray(
                        v[:, rank * per:(rank + 1) * per])
                        for key, v in seg.items()}
                # one transfer per segment; the sums stay on the device
                on_dev = {key: torch.as_tensor(v, device=dev)
                          for key, v in seg.items()}
                # float64, so the sum is eager's host sum of the same terms
                wl_seg = torch.zeros((), dtype=torch.float64, device=dev)
                wn_seg = torch.zeros((), dtype=torch.float64, device=dev)
                for si in range(n_steps):
                    wl, wn = train_step(
                        {key: v[si] for key, v in on_dev.items()}, k, epoch,
                        None if wn_steps is None else wn_steps[si])
                    wl_seg = wl_seg + wl.double()
                    wn_seg = wn_seg + wn.double()
                    k += 1
                if group is not None:
                    sums = torch.stack([wl_seg, wn_seg])
                    dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=group)
                    wl_seg, wn_seg = sums[0], sums[1]
                wl_sum += float(wl_seg)
                wn_sum += float(wn_seg)
            else:
                # reference loop: a transfer and a blocking sync per step
                for si in range(n_steps):
                    wl, wn = train_step(
                        {key: torch.as_tensor(v[si], device=dev)
                         for key, v in seg.items()}, k, epoch)
                    wl_sum += float(wl)
                    wn_sum += float(wn)
                    k += 1
        rec = {"epoch": epoch, "train_loss": wl_sum / max(wn_sum, 1.0),
               "steps": total_steps, "seconds": time.time() - t0}
        if val_samples:
            rec.update(validate())
        history.append(rec)
        if cfg.checkpoint_dir and cfg.checkpoint_every and \
                (epoch + 1) % cfg.checkpoint_every == 0:
            if mgr is not None:
                mgr.save(int(step), {
                    "params": params, "opt_state": opt_state,
                    "step": np.asarray(int(step), np.int32),
                    "epoch": np.asarray(epoch, np.int64),
                    "t_mean": t_mean, "t_std": t_std})
            if group is not None:
                _barrier(group, dev)
        if cfg.log_every and (epoch % cfg.log_every == 0):
            print(f"[pmgns] epoch {epoch}: "
                  + " ".join(f"{key}={v:.4g}" for key, v in rec.items()
                             if key != "epoch"))
    if mgr is not None:
        mgr.wait()
    if group is not None and cfg.checkpoint_dir:
        _barrier(group, dev)        # rank 0's last checkpoint is on disk
    if not history and start_epoch > 0:
        # resumed at/past cfg.epochs: the run is already complete. Emit
        # one terminal record so relaunch loops indexing hist[-1] work.
        rec = {"epoch": start_epoch - 1, "train_loss": float("nan"),
               "steps": 0, "seconds": 0.0, "resumed_complete": True}
        if val_samples:
            rec.update(validate())
        history.append(rec)
    with torch.no_grad():
        folded = _fold_stats(params, model_cfg, t_mean, t_std)
    return tree_map(lambda t: t.detach().cpu().numpy(), folded), history


def _unflatten(tree: Params, it) -> Params:
    """The leaves that iterator ``it`` yields, in :func:`tree_leaves`
    order, placed in the structure of ``tree``."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], it) for k in sorted(tree)}
    return next(it)
