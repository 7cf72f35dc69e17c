"""Fault tolerance: supervised training loop, heartbeats, failure drills.

The port of ``repro.runtime.fault`` (pure Python; the supervisor runs
over :class:`repro_torch.checkpoint.CheckpointManager`, whose on-disk
format is the JAX package's).

At 1000+ nodes the mean time between *some* host failing is minutes. The
contract here:

* every train step is pure and checkpoint-addressed → any crash restarts
  from the last committed manifest (``repro_torch.checkpoint``), losing
  at most ``save_every`` steps;
* per-host heartbeat files give the supervisor a liveness + straggler
  signal without any coordination fabric (works on GCS/NFS in real
  deployments);
* ``FailureInjector`` drives chaos drills in tests — the restart path is
  exercised, not assumed.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..checkpoint import CheckpointManager


class HeartbeatMonitor:
    """File-based heartbeats: hosts beat, the supervisor reads."""

    def __init__(self, path: str, host_id: int = 0):
        self.path = path
        self.host_id = host_id
        os.makedirs(path, exist_ok=True)

    def beat(self, step: int, extra: Optional[Dict] = None) -> None:
        rec = {"host": self.host_id, "step": step, "time": time.time()}
        if extra:
            rec.update(extra)
        tmp = os.path.join(self.path, f"host_{self.host_id}.json.tmp")
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, os.path.join(self.path,
                                     f"host_{self.host_id}.json"))

    def read_all(self) -> List[Dict]:
        out = []
        for name in os.listdir(self.path):
            if name.startswith("host_") and name.endswith(".json"):
                try:
                    with open(os.path.join(self.path, name)) as f:
                        out.append(json.load(f))
                except (json.JSONDecodeError, OSError):
                    continue  # torn write — treat as missing beat
        return out

    def stale_hosts(self, timeout_s: float, now: Optional[float] = None
                    ) -> List[int]:
        now = now or time.time()
        return [r["host"] for r in self.read_all()
                if now - r["time"] > timeout_s]

    def stragglers(self, lag_steps: int = 2) -> List[int]:
        """Hosts more than ``lag_steps`` behind the median step."""
        recs = self.read_all()
        if not recs:
            return []
        steps = sorted(r["step"] for r in recs)
        median = steps[len(steps) // 2]
        return [r["host"] for r in recs if r["step"] < median - lag_steps]


class FailureInjector:
    """Deterministic chaos for tests: fail at chosen steps.

    Thread-safe — serving replica workers
    (:class:`repro_torch.serve.fleet.ReplicaPool`) call :meth:`maybe_fail`
    from concurrent dispatch threads, where ``step`` is the replica's
    per-dispatch counter. :meth:`fail_next` arms N one-shot failures
    for the very next dispatches regardless of step number (the
    "kill this replica now, mid-stream" drill).
    """

    def __init__(self, fail_at_steps: List[int] = ()):  # noqa: B006
        self.fail_at = set(fail_at_steps)
        self.failures = 0
        self._armed = 0
        self._windows: List[tuple] = []
        self._lock = threading.Lock()

    def fail_next(self, n: int = 1) -> None:
        """Arm the next ``n`` :meth:`maybe_fail` calls to fail."""
        with self._lock:
            self._armed += n

    def fail_window(self, start: int, end: int) -> None:
        """Fail every dispatch with ``start <= step < end`` — an outage
        *interval* rather than a point failure. Chaos drills use this to
        model a replica that is down for a stretch and then recovers,
        which is exactly the shape a circuit breaker (open → cooldown →
        half-open probe) is built for."""
        if end <= start:
            raise ValueError(f"empty failure window [{start}, {end})")
        with self._lock:
            self._windows.append((start, end))

    def maybe_fail(self, step: int) -> None:
        with self._lock:
            fire = (step in self.fail_at or self._armed > 0
                    or any(s <= step < e for s, e in self._windows))
            if fire:
                self.fail_at.discard(step)
                if self._armed:
                    self._armed -= 1
                self.failures += 1
        if fire:
            raise RuntimeError(f"injected failure at step {step}")


@dataclasses.dataclass
class SupervisorReport:
    steps_run: int
    restarts: int
    final_step: int
    history: List[Dict]


class TrainingSupervisor:
    """Checkpoint/restart loop around a pure step function.

    ``step_fn(state, step) -> state`` must be pure; ``state`` is a
    nested dict of tensors, arrays or numbers (restored with numpy
    leaves, as :meth:`CheckpointManager.restore_latest` returns them). Crashes (including injected ones) restart from the last
    committed checkpoint. This is the single-process twin of the per-host
    launcher: the restart logic is identical, the scheduler is your
    cluster manager.
    """

    def __init__(self, ckpt_dir: str, *, save_every: int = 10,
                 max_restarts: int = 10,
                 monitor: Optional[HeartbeatMonitor] = None,
                 injector: Optional[FailureInjector] = None):
        self.mgr = CheckpointManager(ckpt_dir, save_async=False)
        self.save_every = save_every
        self.max_restarts = max_restarts
        self.monitor = monitor
        self.injector = injector

    def run(self, init_state: Any, step_fn: Callable[[Any, int], Any],
            total_steps: int) -> SupervisorReport:
        restarts = 0
        history: List[Dict] = []
        while True:
            state, last = self.mgr.restore_latest(init_state)
            step = 0 if last is None else last + 1
            try:
                while step < total_steps:
                    if self.injector is not None:
                        self.injector.maybe_fail(step)
                    state = step_fn(state, step)
                    if self.monitor is not None:
                        self.monitor.beat(step)
                    if (step + 1) % self.save_every == 0 or \
                            step == total_steps - 1:
                        self.mgr.save(step, state)
                    step += 1
                return SupervisorReport(
                    steps_run=total_steps, restarts=restarts,
                    final_step=step - 1, history=history)
            except RuntimeError as e:
                restarts += 1
                history.append({"restart": restarts, "at_step": step,
                                "error": str(e)})
                if restarts > self.max_restarts:
                    raise
