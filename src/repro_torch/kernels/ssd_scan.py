"""Python wrapper around the hand-written chunked SSD scan.

:func:`ssd_scan_cuda` runs ``csrc/ssd_scan.cu``, the port of
``ssd_scan_pallas``: the function of ``_ssd_chunked``
(``repro/models/layers.py``) — y and the last state from an optional
initial state — with B and C read per group. Semantics are those of
:func:`repro_torch.kernels.ref.ssd_scan_ref`.

The wrapper follows :mod:`repro_torch.kernels.segment_spmm`: CUDA tensors
only, checked for device, dtype, shape, contiguity and alignment; outputs
allocated with ``torch.empty``; one launch on the current stream, counted
in ``ssd_scan_cuda.launches``; a non-zero ``cudaError_t`` raises, and so
does an input that requires grad while grad mode is on (the kernel has no
backward; LM training is ROADMAP A14b).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .segment_spmm import (_call, _check, _check_dims, _count, _cuda_device,
                           _entry, _ptr, refuse_grad)

#: gridDim.y carries the batch row
_MAX_BATCH = 65535
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, *, chunk: int,
                  s0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan on the card (``csrc/ssd_scan.cu``).

    x: [Bt, S, H, P] and B, C: [Bt, S, G, N], all float32 or all bfloat16;
    dt: [Bt, S, H], A: [H] and s0: [Bt, H, N, P] (or None: zeros) float32;
    ``H % G == 0``, ``P % 4 == 0``, ``N % 4 == 0``. Returns (y [Bt, S, H, P],
    last state [Bt, H, N, P]), float32. The kernel's chunk is ``chunk`` (cut
    to S), halved while its shared memory exceeds the card's: the same
    function, blocked otherwise. One launch (none when Bt·H = 0).
    """
    refuse_grad("ssd_scan", x, dt, A, B, C, s0)
    dev = _cuda_device(x)
    if x.dim() != 4 or B.dim() != 4:
        raise ValueError(f"x and B must be 4-d, got {tuple(x.shape)} and "
                         f"{tuple(B.shape)}")
    bt, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if p % 4 or n % 4 or p == 0 or n == 0:
        raise ValueError(f"P={p} and N={n} must be positive multiples of 4")
    if g == 0 or h % g:
        raise ValueError(f"H={h} is not a multiple of the groups G={g}")
    if bt > _MAX_BATCH:
        raise ValueError(f"Bt={bt} exceeds the kernel's grid limit "
                         f"{_MAX_BATCH}")
    if chunk < 1:
        raise ValueError(f"chunk must be ≥ 1, got {chunk}")
    _check_dims(BSHP=bt * s * h * p, BSGN=bt * s * g * n, BHNP=bt * h * n * p)
    f32 = torch.float32
    _check(x, "x", x.dtype, (bt, s, h, p), dev)
    _check(dt, "dt", f32, (bt, s, h), dev)
    _check(A, "A", f32, (h,), dev)
    _check(B, "B", x.dtype, (bt, s, g, n), dev)
    _check(C, "C", x.dtype, (bt, s, g, n), dev)
    if s0 is not None:
        _check(s0, "s0", f32, (bt, h, n, p), dev)
    if any(t.data_ptr() % 16 for t in (x, B, C) + ((s0,) if s0 is not None
                                                     else ())):
        raise ValueError("x, B, C and s0 must be 16-byte aligned")
    lc = _entry("ssd_scan_chunk")(n, p, max(1, min(chunk, s)))
    if lc == 0:
        raise ValueError(f"N={n}, P={p}: no chunk fits the kernel's shared "
                         f"memory")
    with torch.cuda.device(dev):
        y = torch.empty((bt, s, h, p), dtype=f32, device=dev)
        state = torch.empty((bt, h, n, p), dtype=f32, device=dev)
        if bt * h == 0:
            return y, state
        stream = torch.cuda.current_stream(dev).cuda_stream
        _call("ssd_scan", _ptr(x), _ptr(dt), _ptr(A), _ptr(B), _ptr(C),
              _ptr(s0), _ptr(y), _ptr(state), _DTYPES[x.dtype], bt, s, h, p,
              g, n, lc, stream)
    _count(ssd_scan_cuda)
    return y, state


ssd_scan_cuda.launches = 0
