"""``repro_torch.runtime`` — fault tolerance and replica placement.

The port of ``repro.runtime`` less its gradient compression
(``compression.py``) and ``elastic.reshard_state``, which wait for the
sharding rules (ROADMAP.md A14d):

* :class:`HeartbeatMonitor`, :class:`FailureInjector`,
  :class:`TrainingSupervisor` — heartbeats, chaos drills and the
  checkpoint/restart loop (``fault.py``).
* :func:`replica_placement`, :func:`elastic_restart_plan` — where a
  serving fleet's replicas run, and the re-mesh plan after a loss of
  devices (``elastic.py``).
"""
from .elastic import (ElasticPlan, ReplicaPlacement, elastic_restart_plan,
                      replica_placement, reshard_state)
from .fault import (FailureInjector, HeartbeatMonitor, SupervisorReport,
                    TrainingSupervisor)

__all__ = ["HeartbeatMonitor", "FailureInjector", "SupervisorReport",
           "TrainingSupervisor", "ReplicaPlacement", "replica_placement",
           "ElasticPlan", "elastic_restart_plan", "reshard_state"]
