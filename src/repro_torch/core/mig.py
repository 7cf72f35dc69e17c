"""MIG Predictor (paper §3.5, eq. 2) + the TPU-slice adaptation.

The paper's rule: PMGNS predicts memory for the full GPU (7g.40gb), which
Fig. 3 shows upper-bounds consumption on every smaller profile, so a simple
bin table maps predicted memory α → smallest safe MIG profile.

TPU adaptation (see DESIGN.md §2): MIG partitions one A100 into isolated
instances; the operational analogue on Cloud TPU is choosing the smallest
**slice** (v5e: 1 / 4 / 8 / 16 / … chips, 16 GB HBM each) whose aggregate
HBM fits the predicted footprint with a safety margin for framework
overhead + collective buffers. Same rule shape, TPU resource axis.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# A100 MIG profiles (faithful to eq. 2)
# ---------------------------------------------------------------------------

#: (name, max memory in MB). 1 GB = 1024 MB here, matching the paper's bins.
MIG_PROFILES: Tuple[Tuple[str, float], ...] = (
    ("1g.5gb", 5 * 1024.0),
    ("2g.10gb", 10 * 1024.0),
    ("3g.20gb", 20 * 1024.0),
    ("7g.40gb", 40 * 1024.0),
)


def predict_mig(alpha_mb: float) -> Optional[str]:
    """Eq. 2: memory α (MB, predicted for the full GPU) → MIG profile."""
    if alpha_mb <= 0:
        return None
    for name, cap in MIG_PROFILES:
        if alpha_mb < cap:
            return name
    return None  # exceeds 40 GB — no single-GPU profile fits


def mig_utilization(actual_mb: float) -> List[Tuple[str, float]]:
    """Per-profile utilization column of Table 5 (actual / capacity)."""
    out = []
    for name, cap in MIG_PROFILES:
        if actual_mb < cap:
            out.append((name, actual_mb / cap))
    return out


# ---------------------------------------------------------------------------
# TPU v5e slice advisor (hardware adaptation)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TPUSlice:
    name: str
    chips: int
    hbm_gb_per_chip: float = 16.0

    @property
    def total_mb(self) -> float:
        return self.chips * self.hbm_gb_per_chip * 1024.0


#: v5e slice menu (topology name → chips), smallest first.
TPU_V5E_SLICES: Tuple[TPUSlice, ...] = (
    TPUSlice("v5e-1", 1),
    TPUSlice("v5e-4", 4),
    TPUSlice("v5e-8", 8),
    TPUSlice("v5e-16", 16),
    TPUSlice("v5e-32", 32),
    TPUSlice("v5e-64", 64),
    TPUSlice("v5e-128", 128),
    TPUSlice("v5e-256", 256),   # one pod
)

#: fraction of HBM reserved for XLA workspace / collective buffers / runtime
TPU_HBM_HEADROOM = 0.10


def predict_tpu_slice(alpha_mb: float,
                      slices: Sequence[TPUSlice] = TPU_V5E_SLICES,
                      headroom: float = TPU_HBM_HEADROOM) -> Optional[str]:
    """Smallest v5e slice whose usable aggregate HBM fits α (MB)."""
    if alpha_mb <= 0:
        return None
    for sl in slices:
        if alpha_mb < sl.total_mb * (1.0 - headroom):
            return sl.name
    return None  # needs multi-pod


def predict_pods(alpha_mb: float, chips_per_pod: int = 256,
                 hbm_gb: float = 16.0,
                 headroom: float = TPU_HBM_HEADROOM) -> int:
    """Number of pods required when a single pod's HBM is insufficient."""
    usable_per_pod = chips_per_pod * hbm_gb * 1024.0 * (1.0 - headroom)
    pods = 1
    while alpha_mb >= usable_per_pod * pods:
        pods += 1
    return pods
