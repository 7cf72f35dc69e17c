"""Device profiles of the analytic label model.

The port's copy of ``repro.perfmodel.devices``, field for field and value
for value. Each profile holds the constants the cost model
(:mod:`repro_torch.perfmodel.cost_model`) uses for the device being
*labelled* — the paper's A100 measurement target and a TPU v5e. They are
data-sheet figures and fitted efficiencies of those devices, not
measurements of this port or of the card it runs on.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    name: str
    #: peak dense matmul throughput, FLOP/s (precision the family runs at)
    peak_flops: float
    #: HBM bandwidth, bytes/s
    hbm_bw: float
    #: HBM capacity, bytes
    hbm_bytes: float
    #: interconnect bandwidth per link, bytes/s
    link_bw: float
    #: achievable fraction of peak for well-tiled matmuls (empirical)
    matmul_eff: float
    #: achievable fraction of peak bandwidth for streaming ops
    bw_eff: float
    #: per-kernel launch/dispatch overhead, seconds
    kernel_overhead: float
    #: idle/static power draw, W
    p_idle: float
    #: dynamic power at full utilization, W (total board = p_idle + p_dyn)
    p_dyn: float
    #: fixed framework/runtime memory overhead, bytes (CUDA ctx / TPU rt)
    runtime_overhead_bytes: float
    #: workspace multiplier for temporaries (fusion slack)
    workspace_frac: float


#: NVIDIA A100-SXM4-40GB — the paper's measurement target.
A100 = DeviceProfile(
    name="a100-40gb",
    peak_flops=312e12,          # fp16/bf16 tensor core
    hbm_bw=1555e9,
    hbm_bytes=40e9,
    link_bw=300e9,              # NVLink3 aggregate / direction
    matmul_eff=0.55,
    bw_eff=0.75,
    kernel_overhead=6e-6,       # ~6 us per kernel launch (CUDA)
    p_idle=55.0,
    p_dyn=345.0,                # 400 W TDP
    runtime_overhead_bytes=1.35e9,   # CUDA context + cuDNN/cuBLAS workspaces
    workspace_frac=0.15,
)

#: Google TPU v5e.
TPU_V5E = DeviceProfile(
    name="tpu-v5e",
    peak_flops=197e12,          # bf16
    hbm_bw=819e9,
    hbm_bytes=16e9,
    link_bw=50e9,               # per ICI link
    matmul_eff=0.65,
    bw_eff=0.80,
    kernel_overhead=2e-6,       # fused XLA programs, fewer dispatches
    p_idle=60.0,
    p_dyn=170.0,
    runtime_overhead_bytes=0.6e9,
    workspace_frac=0.10,
)

DEVICES: Dict[str, DeviceProfile] = {p.name: p for p in (A100, TPU_V5E)}
