"""Reading versioned model artifacts — pickle-free predictor persistence.

The port of ``load_artifact`` from ``repro.serve.artifact``. A v2/v3
artifact is one ``.npz`` file holding:

* ``__dippm_artifact__`` — a UTF-8 JSON header (as a uint8 array) with
  ``schema`` / ``schema_version``, the full ``PMGNSConfig`` as plain
  JSON, a per-leaf manifest (key → shape/dtype/encoding) and caller
  metadata;
* one array per parameter leaf, keyed ``params/<path>`` with ``/``-joined
  pytree paths (``params/gnn/b0/self/w``).

Leaf encodings (v3): none (stored verbatim, which is all of v2);
``"bf16"`` — a ``uint16`` bit view of bfloat16, widened here to float32
by a shift, with no ``ml_dtypes``; ``"int8"`` — int8 values with per-row
float32 scales in a sibling ``params/<path>::scale`` entry. Files are
read with ``allow_pickle=False``. The legacy pickle format (v1) is not
read by the port: re-save such a file with the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Tuple

import numpy as np

from ..core.gnn import PMGNSConfig

__all__ = ["load_artifact", "ARTIFACT_SCHEMA", "ARTIFACT_VERSION"]

ARTIFACT_SCHEMA = "repro.dippm.artifact"
ARTIFACT_VERSION = 3

_PARAM_PREFIX = "params/"
_SCALE_SUFFIX = "::scale"


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, leaf in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
    return tree


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 values stored as a ``uint16`` bit view → float32 (exact:
    a bfloat16 is the upper half of a float32)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def int8_decompress(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """int8 values × per-row float32 scales → float32 (the port's copy of
    ``repro.runtime.compression.int8_decompress``)."""
    return q.astype(np.float32) * scale


def _decode_leaf(key: str, spec: Dict[str, Any], z) -> np.ndarray:
    """Rebuild one leaf from its npz entries per the manifest encoding."""
    arr = z[_PARAM_PREFIX + key]
    enc = spec.get("encoding")
    if enc == "bf16":
        arr = bf16_bits_to_f32(arr)
    elif enc == "int8":
        arr = int8_decompress(arr, z[_PARAM_PREFIX + key + _SCALE_SUFFIX])
    elif enc is not None:
        raise ValueError(f"unknown artifact encoding {enc!r} for {key}")
    if list(arr.shape) != list(spec["shape"]):
        raise ValueError(
            f"artifact corrupt: {key} has shape {arr.shape}, "
            f"manifest says {spec['shape']}")
    return arr


def load_artifact(path: str) -> Tuple[Dict, PMGNSConfig, Dict[str, Any]]:
    """Load an artifact → ``(params, cfg, metadata)``, params as a numpy
    pytree.

    Encoded leaves decode back to float32 per the manifest. A file that
    is not a zip (the legacy pickle format), an unknown schema, or a
    ``schema_version`` newer than this library raises ``ValueError``.
    """
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic != b"PK":
        raise ValueError(
            f"{path} is not an npz artifact — legacy pickle predictors "
            f"(schema v1) are not read by repro_torch; re-save it with "
            f"the JAX package's DIPPM.save")
    with np.load(path, allow_pickle=False) as z:
        if "__dippm_artifact__" not in z.files:
            raise ValueError(
                f"{path} is an npz without an artifact header — not a "
                f"DIPPM artifact")
        doc = json.loads(bytes(z["__dippm_artifact__"]).decode("utf-8"))
        if doc.get("schema") != ARTIFACT_SCHEMA:
            raise ValueError(
                f"unknown artifact schema {doc.get('schema')!r} "
                f"(expected {ARTIFACT_SCHEMA!r})")
        version = doc.get("schema_version")
        if not isinstance(version, int) or version > ARTIFACT_VERSION:
            raise ValueError(
                f"artifact schema_version {version!r} is newer than this "
                f"library supports (≤ {ARTIFACT_VERSION})")
        manifest = doc.get("params", {})
        flat = {key: _decode_leaf(key, spec, z)
                for key, spec in manifest.items()}
    known = {f.name for f in dataclasses.fields(PMGNSConfig)}
    cfg_doc = {k: v for k, v in doc.get("cfg", {}).items() if k in known}
    return _unflatten(flat), PMGNSConfig(**cfg_doc), dict(
        doc.get("metadata", {}))
