"""Python wrapper around the hand-written dense aggregation kernel.

:func:`dense_aggregate_cuda` runs ``csrc/dense_aggregate.cu``, the port of
``dense_aggregate_pallas`` (``sage_aggregate_pallas`` wraps it in the JAX
package): ``out[b] = A'_b @ (scale ⊙ h_b)`` with ``A' = adj`` or
``adjᵀ``, and the degree-mean folded into the epilogue. The transpose
flag and the per-source-row scale make the backward pass of a mean layer,
``Aᵀ @ (g / max(deg, 1))``, the same kernel
(:mod:`repro_torch.kernels.autograd`).

The wrapper follows :mod:`repro_torch.kernels.segment_spmm`: CUDA tensors
only, checked for device, dtype, shape and contiguity; outputs allocated
with ``torch.empty``; one launch on the current stream, counted in
``dense_aggregate_cuda.launches``; a non-zero ``cudaError_t`` raises, and
so does a floating input that requires grad while grad mode is on.
"""
from __future__ import annotations

from typing import Optional

import torch

from .segment_spmm import (_call, _check, _check_dims, _count, _cuda_device,
                           _ptr, refuse_grad)

#: gridDim.z carries the batch row
_MAX_BATCH = 65535


def dense_aggregate_cuda(adj: torch.Tensor, h: torch.Tensor,
                         mode: str = "mean", *,
                         scale: Optional[torch.Tensor] = None,
                         transpose: bool = False,
                         return_degree: bool = False):
    """Dense aggregation on the card (``csrc/dense_aggregate.cu``).

    adj: [B, N, N] float32 with ``adj[b, dst, src]`` (weights allowed);
    h: [B, N, F] float32; scale: [B, N] float32 per source row, or None.
    ``mode="mean"`` divides output row i by ``max(Σ_k A'[i, k], 1)``.
    Returns [B, N, F], or ``(out, deg [B, N])`` with ``return_degree``
    (the row sums of A', which the backward pass scales by). One launch.
    """
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    refuse_grad("dense_aggregate", adj, h, scale)
    dev = _cuda_device(h)
    if h.dim() != 3:
        raise ValueError(f"h must be [B, N, F], got shape {tuple(h.shape)}")
    b, n, f = h.shape
    if b > _MAX_BATCH:
        raise ValueError(f"B={b} exceeds the kernel's grid limit {_MAX_BATCH}")
    if f == 0 and n:
        raise ValueError("h must have at least one feature column")
    _check_dims(B=b, N=n, F=f, BNN=b * n * n, BNF=b * n * f)
    f32 = torch.float32
    _check(adj, "adj", f32, (b, n, n), dev)
    _check(h, "h", f32, (b, n, f), dev)
    if scale is not None:
        _check(scale, "scale", f32, (b, n), dev)
    with torch.cuda.device(dev):
        out = torch.empty((b, n, f), dtype=f32, device=dev)
        deg = (torch.empty((b, n), dtype=f32, device=dev)
               if return_degree else None)
        if b * n == 0:
            return (out, deg) if return_degree else out
        vec = n % 4 == 0 and f % 4 == 0 and all(
            t.data_ptr() % 16 == 0 for t in (adj, h))
        stream = torch.cuda.current_stream(dev).cuda_stream
        _call("dense_aggregate", _ptr(adj), _ptr(h), _ptr(scale), _ptr(out),
              _ptr(deg), b, n, f, int(transpose), int(mode == "mean"),
              int(vec), stream)
    _count(dense_aggregate_cuda)
    return (out, deg) if return_degree else out


dense_aggregate_cuda.launches = 0
