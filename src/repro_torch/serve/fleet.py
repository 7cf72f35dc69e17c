"""The replica fleet's error type.

``repro.serve.fleet`` puts N device-bound engines behind a least-loaded
dispatcher with per-replica circuit breakers and requeue on failure
(``ReplicaPool``). Its port over ``torch.cuda`` devices, with
``runtime/fault.py`` and ``runtime/elastic.replica_placement``, is
ROADMAP.md A8b. Until then this module holds only
:class:`NoHealthyReplicaError`, the error the service treats as an
infrastructure failure (fail the bin, never quarantine its graphs).
"""
from __future__ import annotations

__all__ = ["NoHealthyReplicaError"]


class NoHealthyReplicaError(RuntimeError):
    """No replica can take this bin: every breaker is open (or has
    already refused this bin). Chains the last underlying replica
    error via ``__cause__`` — the serving layer treats this as an
    *infrastructure* failure (fail the bin, never quarantine its
    graphs)."""
