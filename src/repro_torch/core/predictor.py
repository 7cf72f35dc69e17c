"""User-facing DIPPM API — the paper's Fig. 5 usability surface.

    from repro_torch.core import DIPPM
    dippm = DIPPM.load("model.npz")              # on the card by default
    out = dippm.predict_json(doc)
    out.latency_ms, out.energy_j, out.memory_mb, out.mig, out.tpu_slice

The port of ``repro.core.predictor``. Every prediction path is a thin
client of a shared default :class:`~repro_torch.serve.PredictionService`
over the default engine: ``predict_graph`` is a submit + flush + wait
round trip, ``predict_many`` a synchronous burst through the same
micro-batcher. ``DIPPM.serve(**overrides)`` hands out a dedicated service
for request traffic, and ``save`` writes the pickle-free artifact that
both packages load. ``predict_jax`` and ``predict_zoo`` wait for the
torch frontend (ROADMAP.md A13).
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .frontends import from_json
from .gnn import PMGNS, PMGNSConfig
from .ir import OpGraph
from .mig import predict_mig, predict_pods, predict_tpu_slice


@dataclasses.dataclass
class Prediction:
    """One model's predicted inference profile + resource advice.

    ``latency_ms`` / ``energy_j`` / ``memory_mb`` are the PMGNS regression
    targets in physical units; ``mig`` / ``tpu_slice`` / ``pods`` are the
    §3.5 resource recommendations derived from the predicted memory.
    """

    latency_ms: float
    energy_j: float
    memory_mb: float
    mig: Optional[str]
    tpu_slice: Optional[str]
    pods: int
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __repr__(self) -> str:  # pragma: no cover — cosmetic
        return (f"Prediction(latency={self.latency_ms:.3f} ms, "
                f"energy={self.energy_j:.4f} J, "
                f"memory={self.memory_mb:.1f} MB, mig={self.mig}, "
                f"tpu_slice={self.tpu_slice}, pods={self.pods})")


def make_prediction(y: np.ndarray,
                    meta: Optional[Dict[str, Any]] = None) -> Prediction:
    """Wrap decoded targets ``[latency_ms, energy_j, memory_mb]`` into a
    :class:`Prediction` with the §3.5 MIG / TPU-slice advice attached."""
    lat, enr, mem = [float(v) for v in np.asarray(y).reshape(-1)[:3]]
    return Prediction(
        latency_ms=lat, energy_j=enr, memory_mb=mem,
        mig=predict_mig(mem),
        tpu_slice=predict_tpu_slice(mem),
        pods=predict_pods(mem),
        meta=dict(meta or {}),
    )


class DIPPM:
    """Trained predictor + frontends + resource advisors, on one device."""

    def __init__(self, params: Union[PMGNS, dict], cfg: PMGNSConfig, *,
                 device: Union[None, str, torch.device] = None):
        from .engine import EngineConfig, PredictionEngine
        self.cfg = cfg
        #: the default engine: holds the parameters on ``device``
        #: (``"cuda"`` unless the caller asks for another)
        self._engine = PredictionEngine(params, cfg, EngineConfig(),
                                        device=device)
        self.params = self._engine.params
        self.device = self._engine.device
        self._service = None
        #: guards the lazy default service — concurrent first calls must
        #: share ONE batcher thread, not race into duplicates
        self._init_lock = threading.Lock()

    # -- constructors ---------------------------------------------------------
    @classmethod
    def from_params(cls, params: Union[PMGNS, dict], cfg: PMGNSConfig, *,
                    device: Union[None, str, torch.device] = None) -> "DIPPM":
        """Wrap already-trained PMGNS parameters (a numpy pytree or a
        :class:`PMGNS`). ``device`` defaults to ``"cuda"`` and raises if
        CUDA is missing; pass ``device="cpu"`` for the plain versions."""
        return cls(params, cfg, device=device)

    @classmethod
    def load(cls, path: str, *,
             device: Union[None, str, torch.device] = None) -> "DIPPM":
        """Load a predictor from a v2/v3 artifact written by either
        package (``repro_torch.serve.artifact.load_artifact``)."""
        from ..serve.artifact import load_artifact
        params, cfg, _meta = load_artifact(path)
        return cls(params, cfg, device=device)

    def save(self, path: str, metadata: Optional[Dict[str, Any]] = None,
             precision: Optional[str] = None) -> str:
        """Write a v3 artifact (npz params + JSON config) to ``path`` —
        see :func:`repro_torch.serve.artifact.save_artifact`; the JAX
        package's ``DIPPM.load`` reads it too."""
        from ..serve.artifact import save_artifact
        from .gnn import params_to_numpy
        return save_artifact(path, params_to_numpy(self.params), self.cfg,
                             metadata=metadata, precision=precision)

    # -- serving --------------------------------------------------------------
    def serve(self, **overrides) -> "PredictionService":
        """A dedicated micro-batching service over this predictor.

        Keyword overrides are :class:`repro_torch.serve.ServeConfig`
        fields (``max_wait_ms``, ``max_batch_graphs``, ``node_budget``,
        ``max_queue``, ...). Each call returns a **fresh** service with its
        own engine (sharing these parameters, on this device) and batcher
        thread — close it, or use it as a context manager, when done. The
        facade's own ``predict_*`` methods use a separate shared default
        service and are unaffected.
        """
        from ..serve import PredictionService, ServeConfig
        return PredictionService(self.params, self.cfg,
                                 ServeConfig(**overrides), device=self.device)

    def _default_service(self) -> "PredictionService":
        """The lazily built shared service behind ``predict_graph`` /
        ``predict_many``. It wraps the default engine, so facade calls
        and direct engine sweeps share one shape set and one set of
        stats. A finalizer closes it when this ``DIPPM`` is collected, so
        a loop over many loaded predictors does not pile up batcher
        threads."""
        if self._service is None:
            from ..serve import PredictionService
            with self._init_lock:
                if self._service is None:   # double-checked: one batcher
                    svc = PredictionService(engine=self._engine)
                    weakref.finalize(self, PredictionService.close, svc,
                                     timeout=1.0)
                    self._service = svc
        return self._service

    # -- prediction -----------------------------------------------------------
    def engine(self, **overrides) -> "PredictionEngine":
        """The batched prediction engine for this predictor.

        With no arguments, returns the default engine that
        ``predict_graph`` / ``predict_many`` use. Keyword overrides are
        :class:`~repro_torch.core.engine.EngineConfig` fields and return a
        **fresh** engine on the same device, sharing the parameters.
        """
        from .engine import EngineConfig, PredictionEngine
        if overrides:
            return PredictionEngine(self.params, self.cfg,
                                    EngineConfig(**overrides),
                                    device=self.device)
        return self._engine

    def predict_graph(self, g: OpGraph) -> Prediction:
        """Predict one pre-built :class:`OpGraph`: a synchronous round
        trip through the shared default service, so concurrent callers
        coalesce into shared bins."""
        return self._default_service().predict_one(g)

    def predict_json(self, doc: Dict[str, Any]) -> Prediction:
        """Predict a portable serialized graph (``repro.opgraph.v1``)."""
        return self.predict_graph(from_json(doc))

    def predict_many(self, graphs: Sequence[OpGraph],
                     return_stats: bool = False):
        """Predict many graphs at once, bin-packed, preserving input order:
        a synchronous burst through the shared default service (the same
        bins as a direct engine sweep).

        With ``return_stats=True`` returns ``(predictions, stats)`` where
        ``stats`` is a detached
        :class:`~repro_torch.core.engine.EngineStats` snapshot.
        """
        svc = self._default_service()
        preds: List[Prediction] = svc.predict_many(list(graphs))
        if return_stats:
            return preds, svc.engine.stats.snapshot()
        return preds
