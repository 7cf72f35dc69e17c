"""``repro_torch.runtime`` — fault tolerance, replica placement and
gradient compression.

The port of ``repro.runtime`` less ``elastic.reshard_state``, which waits
for the sharding rules (ROADMAP.md A14d):

* :class:`HeartbeatMonitor`, :class:`FailureInjector`,
  :class:`TrainingSupervisor` — heartbeats, chaos drills and the
  checkpoint/restart loop (``fault.py``).
* :func:`replica_placement`, :func:`elastic_restart_plan` — where a
  serving fleet's replicas run, and the re-mesh plan after a loss of
  devices (``elastic.py``).
* :func:`compressed_grad_allreduce` — the int8 all-reduce with error
  feedback over a mesh axis (``compression.py``).
"""
from .compression import (compressed_grad_allreduce, int8_compress,
                          int8_decompress)
from .elastic import (ElasticPlan, ReplicaPlacement, elastic_restart_plan,
                      replica_placement, reshard_state)
from .fault import (FailureInjector, HeartbeatMonitor, SupervisorReport,
                    TrainingSupervisor)

__all__ = ["HeartbeatMonitor", "FailureInjector", "SupervisorReport",
           "TrainingSupervisor", "ReplicaPlacement", "replica_placement",
           "ElasticPlan", "elastic_restart_plan", "reshard_state",
           "int8_compress", "int8_decompress", "compressed_grad_allreduce"]
