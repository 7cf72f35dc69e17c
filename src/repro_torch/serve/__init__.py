"""``repro_torch.serve`` — request-oriented serving on top of the engine.

The port of ``repro.serve``, less the replica fleet (ROADMAP.md A8b):

* :class:`PredictionService` / :class:`ServeConfig` / :class:`ServeStats`
  — the micro-batching request/response service (``service.py``).
* :class:`PredictionCache` — content-addressed fingerprint→prediction
  LRU with single-flight dedup (``cache.py``).
* :class:`PredictionFuture` / :class:`QueueFullError` — request
  plumbing (``queue.py``).
* Lifecycle primitives (``lifecycle.py``) — typed terminal errors
  (:class:`DeadlineExceededError`, :class:`PoisonRequestError`,
  :class:`ServiceDrainingError`, re-exported
  :class:`PredictionInvalidError` / :class:`GraphValidationError`),
  :class:`CircuitBreaker` policy (:class:`BreakerConfig`) and the
  poison-fingerprint :class:`QuarantineList`.
* :func:`save_artifact` / :func:`load_artifact` — versioned, pickle-free
  model artifacts that load in either package (``artifact.py``).

Entry point: ``DIPPM.serve(**overrides)`` for a dedicated service, or
construct :class:`PredictionService` around trained params or an engine.
"""
from .artifact import (ARTIFACT_SCHEMA, ARTIFACT_VERSION, load_artifact,
                       save_artifact)
from .cache import PredictionCache
from .fleet import NoHealthyReplicaError
from .lifecycle import (BreakerConfig, CircuitBreaker,
                        DeadlineExceededError, GraphValidationError,
                        PoisonRequestError, PredictionInvalidError,
                        QuarantineList, ServiceDrainingError)
from .queue import PredictionFuture, QueueFullError
from .service import PredictionService, ServeConfig, ServeStats

__all__ = [
    "PredictionService", "ServeConfig", "ServeStats", "PredictionCache",
    "NoHealthyReplicaError", "PredictionFuture",
    "QueueFullError", "save_artifact", "load_artifact", "ARTIFACT_SCHEMA",
    "ARTIFACT_VERSION",
    "DeadlineExceededError", "PoisonRequestError", "ServiceDrainingError",
    "PredictionInvalidError", "GraphValidationError",
    "BreakerConfig", "CircuitBreaker", "QuarantineList",
]
