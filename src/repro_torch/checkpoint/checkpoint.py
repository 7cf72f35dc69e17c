"""Atomic, async-capable checkpointing — the port of ``repro.checkpoint``.

The on-disk format is the JAX package's, byte for byte in layout: one
directory per step, ``step_<N>/shard_<H>.npz`` plus a ``manifest.json``
written LAST, so a checkpoint is valid iff its manifest exists (atomic
commit) and a torn write leaves only ignorable garbage. Keys are the
dict paths of the state tree joined with ``/`` (dict keys in sorted
order, as ``jax.tree_util`` flattens them), stored in the npz as ``__``.
A checkpoint written by either package restores in the other.

A state tree is nested dicts whose leaves are tensors, numpy arrays or
numbers; tensors are copied to host numpy when saved. Restore returns
the structure of ``like`` with numpy leaves; the caller moves them to
its device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree, prefix: str = "", out: Optional[Dict] = None
             ) -> Dict[str, Any]:
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}/{k}" if prefix else str(k), out)
    else:
        out[prefix] = tree
    return out


def _unflatten_like(like, data: Dict[str, np.ndarray], prefix: str = ""):
    if isinstance(like, dict):
        return {k: _unflatten_like(like[k], data,
                                   f"{prefix}/{k}" if prefix else str(k))
                for k in like}
    if prefix not in data:
        raise KeyError(f"checkpoint missing key {prefix}")
    return data[prefix]


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return _host(tree)


def save_checkpoint(path: str, step: int, state: Any,
                    host_id: int = 0, n_hosts: int = 1) -> str:
    """Write ``state`` for ``step``; the manifest commits atomically."""
    step_dir = os.path.join(path, f"step_{step:010d}")
    os.makedirs(step_dir, exist_ok=True)
    flat = {k: _host(v) for k, v in _flatten(state).items()}
    shard_file = os.path.join(step_dir, f"shard_{host_id:05d}.npz")
    tmp = shard_file + ".tmp"
    with open(tmp, "wb") as f:  # np.savez(path) appends ".npz" — use a fh
        np.savez(f, **{k.replace("/", "__"): v for k, v in flat.items()})
    os.replace(tmp, shard_file)

    if host_id == 0:
        manifest = {
            "step": step,
            "n_hosts": n_hosts,
            "keys": sorted(flat.keys()),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": {k: str(v.dtype) for k, v in flat.items()},
            "time": time.time(),
        }
        mtmp = os.path.join(step_dir, "manifest.json.tmp")
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
        os.replace(mtmp, os.path.join(step_dir, "manifest.json"))
    return step_dir


def latest_step(path: str) -> Optional[int]:
    """Highest step with a committed manifest (ignores torn writes)."""
    if not os.path.isdir(path):
        return None
    best = None
    for name in os.listdir(path):
        if not name.startswith("step_"):
            continue
        if not os.path.exists(os.path.join(path, name, "manifest.json")):
            continue  # uncommitted / torn
        try:
            s = int(name.split("_")[1])
        except ValueError:
            continue
        best = s if best is None or s > best else best
    return best


def restore_checkpoint(path: str, step: Optional[int], like: Any) -> Any:
    """Restore into the structure of ``like`` (numpy leaves); ``step=None``
    takes the latest committed one."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {path}")
    step_dir = os.path.join(path, f"step_{step:010d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        json.load(f)                  # an unreadable manifest is no commit
    data: Dict[str, np.ndarray] = {}
    for name in sorted(os.listdir(step_dir)):
        if name.startswith("shard_") and name.endswith(".npz"):
            with np.load(os.path.join(step_dir, name)) as blob:
                for k in blob.files:
                    data[k.replace("__", "/")] = blob[k]
    return _unflatten_like(like, data)


class CheckpointManager:
    """Step-addressed manager: keep-last-k GC + async save thread."""

    def __init__(self, path: str, keep: int = 3, save_async: bool = True):
        self.path = path
        self.keep = keep
        self.save_async = save_async
        self._thread: Optional[threading.Thread] = None
        os.makedirs(path, exist_ok=True)

    def save(self, step: int, state: Any) -> None:
        # snapshot to host memory synchronously (cheap), write async
        host = _to_host(state)
        if self.save_async:
            self.wait()
            self._thread = threading.Thread(
                target=self._save_and_gc, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._save_and_gc(step, host)

    def _save_and_gc(self, step: int, state: Any) -> None:
        save_checkpoint(self.path, step, state)
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.path)
            if n.startswith("step_") and os.path.exists(
                os.path.join(self.path, n, "manifest.json")))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.path, f"step_{s:010d}"),
                          ignore_errors=True)

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def restore_latest(self, like: Any) -> tuple:
        step = latest_step(self.path)
        if step is None:
            return like, None
        self.wait()
        return restore_checkpoint(self.path, step, like), step
