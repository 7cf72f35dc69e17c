"""Versioned model artifacts — pickle-free predictor persistence.

The port of ``save_artifact`` and ``load_artifact`` from
``repro.serve.artifact``: a file written by either package loads in the
other. A v2/v3 artifact is one ``.npz`` file holding:

* ``__dippm_artifact__`` — a UTF-8 JSON header (as a uint8 array) with
  ``schema`` / ``schema_version``, the full ``PMGNSConfig`` as plain
  JSON, a per-leaf manifest (key → shape/dtype/encoding) and caller
  metadata;
* one array per parameter leaf, keyed ``params/<path>`` with ``/``-joined
  pytree paths (``params/gnn/b0/self/w``).

Leaf encodings (v3), chosen by ``save_artifact``'s ``precision``: none
(``"f32"``, stored verbatim, which is all of v2); ``"bf16"`` — floating
leaves rounded to nearest-even bfloat16 and stored as a ``uint16`` bit
view (numpy bit arithmetic here, giving ``ml_dtypes``' bits without
``ml_dtypes``); ``"int8"`` (``precision="int8-weights"``) — ≥2-D floating
leaves as int8 values with per-row float32 scales in a sibling
``params/<path>::scale`` entry. Files are read with
``allow_pickle=False``. The legacy pickle format (v1) is not read by the
port: re-save such a file with the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..core.gnn import PMGNSConfig

__all__ = ["save_artifact", "load_artifact", "ARTIFACT_SCHEMA",
           "ARTIFACT_VERSION"]

ARTIFACT_SCHEMA = "repro.dippm.artifact"
ARTIFACT_VERSION = 3

_PARAM_PREFIX = "params/"
_SCALE_SUFFIX = "::scale"


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            key = str(k)
            if "/" in key:
                raise ValueError(
                    f"param key {key!r} contains '/', which is the "
                    f"artifact path separator")
            _flatten(tree[k], f"{prefix}{key}/", out)
        return
    out[prefix[:-1]] = np.asarray(tree)         # drop the trailing '/'


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, leaf in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
    return tree


def f32_to_bf16_bits(v: np.ndarray) -> np.ndarray:
    """float32 → bfloat16 rounded to nearest, ties to even, as a ``uint16``
    bit view: the bits ``ml_dtypes.bfloat16`` gives (a NaN becomes the
    quiet NaN of its sign; an overflow rounds to infinity)."""
    bits = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
    nan = np.isnan(v)
    # no overflow: only NaN bit patterns exceed 0xFFFF7FFF, and they are
    # replaced below
    rounded = np.where(nan, 0, bits) + (0x7FFF + ((bits >> 16) & 1))
    out = (rounded >> 16).astype(np.uint16)
    quiet = np.where(bits >> 31, 0xFFC0, 0x7FC0).astype(np.uint16)
    return np.where(nan, quiet, out)


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 values stored as a ``uint16`` bit view → float32 (exact:
    a bfloat16 is the upper half of a float32)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def int8_compress(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """→ (int8 values, float32 per-row scales): symmetric quantization
    over the last axis (the port's copy of
    ``repro.runtime.compression.int8_compress``)."""
    xf = np.asarray(x, dtype=np.float32)
    amax = np.max(np.abs(xf), axis=-1, keepdims=True)
    scale = np.maximum(amax / np.float32(127.0), np.float32(1e-12))
    q = np.clip(np.round(xf / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def int8_decompress(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """int8 values × per-row float32 scales → float32 (the port's copy of
    ``repro.runtime.compression.int8_decompress``)."""
    return q.astype(np.float32) * scale


def _encode_leaf(key: str, v: np.ndarray, precision: str,
                 arrays: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Store one leaf into ``arrays`` and return its manifest entry."""
    spec: Dict[str, Any] = {"shape": list(v.shape), "dtype": str(v.dtype)}
    floating = np.issubdtype(v.dtype, np.floating)
    if precision == "bf16" and floating:
        arrays[_PARAM_PREFIX + key] = f32_to_bf16_bits(v)
        spec["encoding"] = "bf16"
    elif precision == "int8-weights" and floating and v.ndim >= 2:
        q, scale = int8_compress(v)
        arrays[_PARAM_PREFIX + key] = q
        arrays[_PARAM_PREFIX + key + _SCALE_SUFFIX] = scale
        spec["encoding"] = "int8"
    else:
        arrays[_PARAM_PREFIX + key] = v
    return spec


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


def save_artifact(path: str, params, cfg: PMGNSConfig,
                  metadata: Optional[Dict[str, Any]] = None,
                  precision: Optional[str] = None) -> str:
    """Write a v3 artifact (npz params + JSON header) to ``path``.

    ``params`` is the PMGNS pytree as nested dicts of numpy arrays
    (``params_to_numpy`` gives it for a :class:`~repro_torch.core.gnn.PMGNS`). ``metadata`` is free-form
    JSON-able caller context. ``precision`` selects the weight encoding
    (``f32`` verbatim, ``bf16`` half-size, ``int8-weights`` quarter-size
    weights); the default follows ``cfg.precision`` only for
    ``int8-weights``, as in the JAX package: a runtime ``bf16`` policy
    never rounds the stored weights implicitly. Returns ``path``, used
    as given (no ``.npz`` suffix is appended).
    """
    if precision is None:
        precision = ("int8-weights" if cfg.precision == "int8-weights"
                     else "f32")
    if precision not in ("f32", "bf16", "int8-weights"):
        raise ValueError(
            f"precision must be f32|bf16|int8-weights, got {precision!r}")
    flat: Dict[str, np.ndarray] = {}
    _flatten(params, "", flat)
    arrays: Dict[str, np.ndarray] = {}
    manifest = {k: _encode_leaf(k, v, precision, arrays)
                for k, v in flat.items()}
    doc = {
        "schema": ARTIFACT_SCHEMA,
        "schema_version": ARTIFACT_VERSION,
        "cfg": dataclasses.asdict(cfg),
        "precision": precision,
        "metadata": dict(metadata or {}),
        "params": manifest,
    }
    header = np.frombuffer(json.dumps(doc).encode("utf-8"), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, __dippm_artifact__=header, **arrays)
    return path


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
