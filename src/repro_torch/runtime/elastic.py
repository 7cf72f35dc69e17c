"""Elastic scaling and replica placement — the port of
``repro.runtime.elastic``.

Losing devices should not lose the run: checkpoints are mesh-agnostic
(``repro_torch.checkpoint`` stores logical arrays), so the restart plan
is 1) pick the largest healthy mesh, 2) rebuild shardings from the same
partition rules on the new mesh, 3) place the restored state. Global
batch is preserved by raising gradient-accumulation microbatches to
compensate for lost data-parallel ways. Step 2 needs the sharding rules,
which are not ported yet, so :func:`reshard_state` raises (ROADMAP.md
A14d); :func:`replica_placement` is what the serving fleet uses.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

_NOT_PORTED_RESHARD = (
    "reshard_state places a state on a new mesh by the sharding rules "
    "(models/parallel.py, sharding/rules.py), which are not ported yet "
    "(ROADMAP.md A14d)")


@dataclasses.dataclass
class ElasticPlan:
    mesh_shape: Tuple[int, ...]
    mesh_axes: Tuple[str, ...]
    microbatches: int
    note: str


@dataclasses.dataclass(frozen=True)
class ReplicaPlacement:
    """Device binding for a serving fleet — the inference-side analogue
    of :class:`ElasticPlan`. ``device_ids[r]`` is the index, into the
    fleet's device list, of the device replica ``r`` is bound to."""

    n_replicas: int
    device_ids: Tuple[int, ...]
    note: str


def replica_placement(n_replicas: Optional[int],
                      n_devices: int) -> ReplicaPlacement:
    """Round-robin replica→device binding for a serving fleet.

    ``n_replicas=None`` defaults to one replica per device. More
    replicas than devices is allowed — extras share devices
    round-robin (on a card, each replica runs on a CUDA stream of its
    own, which still buys staging / kernel overlap) — and after a
    replica failure the surviving placement is simply the healthy
    subset (the fleet requeues in-flight bins; every replica holds its
    own copy of the parameters).
    """
    if n_devices < 1:
        raise ValueError("need at least one device")
    n = int(n_replicas) if n_replicas else n_devices
    if n < 1:
        raise ValueError(f"need at least one replica, got {n}")
    ids = tuple(i % n_devices for i in range(n))
    return ReplicaPlacement(
        n_replicas=n, device_ids=ids,
        note=f"{n} replicas over {n_devices} devices (round-robin)")


def elastic_restart_plan(n_healthy_devices: int, *,
                         model_parallel: int = 16,
                         global_batch: int = 256,
                         prev_microbatches: int = 1) -> ElasticPlan:
    """Largest (data, model) mesh that fits the healthy device count,
    keeping the model-parallel degree fixed (weights must still fit) and
    scaling microbatches so the global batch stays constant."""
    if n_healthy_devices < model_parallel:
        raise ValueError(
            f"need ≥{model_parallel} devices for model parallelism, "
            f"have {n_healthy_devices}")
    data = n_healthy_devices // model_parallel
    # keep data a power-of-two divisor of the global batch
    while data > 1 and global_batch % data != 0:
        data -= 1
    lost_factor = max(1, (global_batch // data) //
                      max(global_batch // (data * prev_microbatches), 1))
    micro = prev_microbatches * lost_factor
    return ElasticPlan(
        mesh_shape=(data, model_parallel),
        mesh_axes=("data", "model"),
        microbatches=micro,
        note=f"data={data} model={model_parallel}; microbatches→{micro} "
             f"to hold global_batch={global_batch}",
    )


def reshard_state(state: Any, cfg: Any, new_mesh: Any,
                  policy: Optional[Any] = None) -> Any:
    """Place a restored state on a new mesh by the partition rules —
    not ported yet: raises ``NotImplementedError`` (ROADMAP.md A14d)."""
    raise NotImplementedError(_NOT_PORTED_RESHARD)
