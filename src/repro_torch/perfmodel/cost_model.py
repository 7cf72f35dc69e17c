"""Analytic per-graph cost model — the labels of the DIPPM dataset.

The port's copy of ``repro.perfmodel.cost_model``: numpy and ``hashlib``
over :class:`~repro_torch.core.ir.OpGraph`, with every sum taken in the
same order, so that the same graph gets bit-equal labels in both
packages. The paper measured each of its models on a real A100 (NVML +
CUDA, mean of 30 runs); here the labels come from a roofline model of
the device being labelled (:mod:`repro_torch.perfmodel.devices`):

* **latency** — per-fusion-group roofline ``max(flops/peak', bytes/bw')``
  plus dispatch overhead; pointwise ops fold into their producer's group.
* **memory** — parameter bytes + runtime overhead + the liveness-scanned
  peak activation footprint (topological order, free after last use) +
  workspace slack.
* **energy** — ``latency × (P_idle + u · P_dyn)`` with utilization ``u``
  from the compute-versus-bandwidth balance.
* **measurement noise** — a deterministic ±σ jitter seeded by the graph's
  fingerprint, so two graphs that differ by one node get different
  jitter.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List

import numpy as np

from ..core.ir import OpGraph
from .devices import A100, DEVICES, DeviceProfile

#: ops that a compiler would fuse into the preceding producer kernel
_FUSABLE = {"add", "mul", "div", "relu", "gelu", "tanh", "exp",
            "elementwise", "norm", "softmax"}
#: ops that anchor their own kernel / fusion group
_ANCHORS = {"dense", "conv", "pool", "reduce", "gather", "scatter"}


@dataclasses.dataclass
class CostEstimate:
    latency_ms: float
    energy_j: float
    memory_mb: float
    # breakdown (seconds / bytes) for analysis & tests
    compute_s: float
    bandwidth_s: float
    overhead_s: float
    param_bytes: float
    activation_bytes: float
    n_fusion_groups: int
    utilization: float

    def as_targets(self) -> np.ndarray:
        """[latency_ms, energy_j, memory_mb] — the paper's Y vector."""
        return np.asarray(
            [self.latency_ms, self.energy_j, self.memory_mb],
            dtype=np.float32)


def _fusion_groups(g: OpGraph) -> List[List[int]]:
    """Partition nodes into fusion groups: anchors absorb pointwise chains."""
    order = g.topo_order()
    preds: Dict[int, List[int]] = {i: [] for i in range(g.num_nodes)}
    for s, d in g.edges:
        preds[d].append(s)
    group_of: Dict[int, int] = {}
    groups: List[List[int]] = []
    for nid in order:
        nd = g.nodes[nid]
        if nd.op in _FUSABLE and preds[nid]:
            # fuse into the (first) producer's group
            gid = group_of.get(preds[nid][0])
            if gid is not None:
                groups[gid].append(nid)
                group_of[nid] = gid
                continue
        groups.append([nid])
        group_of[nid] = len(groups) - 1
    return groups


def _peak_activation_bytes(g: OpGraph) -> float:
    """Liveness scan over topo order: alloc at producer, free at last use."""
    n = g.num_nodes
    order = g.topo_order()
    pos = {nid: i for i, nid in enumerate(order)}
    last_use = {nid: pos[nid] for nid in range(n)}
    for s, d in g.edges:
        last_use[s] = max(last_use[s], pos[d])
    events_free: Dict[int, List[int]] = {}
    for nid, t in last_use.items():
        events_free.setdefault(t, []).append(nid)
    live = 0.0
    peak = 0.0
    for t, nid in enumerate(order):
        live += g.nodes[nid].out_bytes
        peak = max(peak, live)
        for f in events_free.get(t, []):
            live -= g.nodes[f].out_bytes
    return float(peak)


def _jitter(g: OpGraph, salt: str, sigma: float) -> float:
    """Deterministic multiplicative noise in [1-3σ, 1+3σ], seeded by graph."""
    if sigma <= 0:
        return 1.0
    h = hashlib.sha256((g.fingerprint() + salt).encode()).digest()
    u = int.from_bytes(h[:8], "big") / float(2 ** 64)   # uniform [0,1)
    z = (u - 0.5) * 2.0  # [-1, 1)
    return float(1.0 + sigma * 3.0 * (z ** 3))  # heavier middle, clipped tails


def estimate(
    g: OpGraph,
    device: DeviceProfile = A100,
    noise_sigma: float = 0.01,
) -> CostEstimate:
    """Estimate (latency, energy, memory) of one inference of ``g``."""
    groups = _fusion_groups(g)

    compute_s = 0.0
    bandwidth_s = 0.0
    latency_s = 0.0
    for grp in groups:
        flops = sum(g.nodes[i].flops for i in grp)
        # bytes: the anchor's bytes + the fused pointwise outputs' bytes
        # (they stay on chip once and are written once)
        anchor = g.nodes[grp[0]]
        byts = anchor.bytes_accessed
        for i in grp[1:]:
            byts += g.nodes[i].out_bytes
        tc = flops / (device.peak_flops * device.matmul_eff) \
            if anchor.op in ("dense", "conv") else \
            flops / (device.peak_flops * 0.02)  # vector units, not MXU
        tb = byts / (device.hbm_bw * device.bw_eff)
        compute_s += tc
        bandwidth_s += tb
        latency_s += max(tc, tb)
    overhead_s = device.kernel_overhead * len(groups)
    latency_s += overhead_s

    # memory: params + runtime + live activations (+ workspace slack)
    pbytes = float(g.meta.get("param_bytes", g.total_param_bytes()))
    act = _peak_activation_bytes(g) * (1.0 + device.workspace_frac)
    in_bytes = float(g.meta.get("input_bytes", 0.0))
    mem_bytes = pbytes + act + in_bytes + device.runtime_overhead_bytes

    util = compute_s / max(latency_s, 1e-12)
    util = float(np.clip(util, 0.02, 1.0))
    energy_j = latency_s * (device.p_idle + util * device.p_dyn)

    jl = _jitter(g, "lat" + device.name, noise_sigma)
    je = _jitter(g, "enr" + device.name, noise_sigma)
    jm = _jitter(g, "mem" + device.name, noise_sigma * 0.5)

    return CostEstimate(
        latency_ms=float(latency_s * 1e3 * jl),
        energy_j=float(energy_j * je),
        memory_mb=float(mem_bytes / 1e6 * jm),
        compute_s=compute_s, bandwidth_s=bandwidth_s, overhead_s=overhead_s,
        param_bytes=pbytes, activation_bytes=act,
        n_fusion_groups=len(groups), utilization=util,
    )


def estimate_targets(g: OpGraph, device_name: str = "a100-40gb",
                     noise_sigma: float = 0.01) -> np.ndarray:
    """``estimate(...).as_targets()`` for a device named in ``DEVICES``."""
    return estimate(g, DEVICES[device_name], noise_sigma).as_targets()
