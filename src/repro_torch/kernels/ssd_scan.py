"""Python wrapper around the hand-written chunked SSD scan.

:func:`ssd_scan_cuda` runs ``csrc/ssd_scan.cu``, the port of
``ssd_scan_pallas``: the function of ``_ssd_chunked``
(``repro/models/layers.py``) — y and the last state from an optional
initial state — with B and C read per group. Semantics are those of
:func:`repro_torch.kernels.ref.ssd_scan_ref`. x, B and C in bfloat16 run
on the tensor cores (``mma.sync`` with float32 operands split into bf16
hi + lo); in float32 on the FMA pipes. :func:`ssd_plan` picks the chunk
the kernel runs and its shared memory.

:func:`ssd_scan_bwd_cuda` runs ``csrc/ssd_scan_bwd.cu``, its gradient
(:func:`repro_torch.kernels.ref.ssd_scan_bwd_ref`): dx, ddt, dA, dB, dC
and ds0 from the gradients on y and on the last state.

The wrappers follow :mod:`repro_torch.kernels.segment_spmm`: CUDA tensors
only, checked for device, dtype, shape, contiguity and alignment; outputs
and scratch allocated with ``torch.empty``; one C call on the current
stream, counted in the wrapper's ``launches``; a non-zero ``cudaError_t``
raises, and so does an input that requires grad while grad mode is on:
training takes ``ops.ssd_scan_train`` (``autograd.SsdScan``: this
forward, then the backward kernel).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from .segment_spmm import (_call, _check, _check_dims, _count, _cuda_device,
                           _entry, _ptr, refuse_grad)

#: gridDim.y carries the batch row
_MAX_BATCH = 65535
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: dynamic shared memory a block may take (227 KB)
MAX_SMEM = 232448
#: the tensor-core kernel: chunk rows (two 16-row tiles for each of four
#: warps), and the widest N and P its registers hold
_TC_MAX_CHUNK, _TC_MAX_N, _TC_MAX_P = 128, 128, 64


class SsdPlan(NamedTuple):
    """How ``csrc/ssd_scan.cu`` blocks one call."""
    lc: int           #: the chunk the kernel runs (the same function)
    n_pad: int        #: N as the kernel's tiles hold it
    p_pad: int        #: P as the kernel's tiles hold it
    smem_bytes: int   #: dynamic shared memory a block


def _pad_width(v: int) -> int:
    """A width padded to a power of two ≥ 16 (the ``mma`` tiles)."""
    return max(16, 1 << (v - 1).bit_length())


def ssd_plan(n: int, p: int, chunk: int, s: int,
             dtype: torch.dtype) -> SsdPlan:
    """The kernel's chunk and shared memory for N, P, the model's chunk and
    the sequence length S.

    The chunk is the model's, cut to S. float32 (the FMA kernel): rounded
    up to a multiple of 4, then halved while its block's shared memory
    ``4 (2 N Lc + Lc P + Lc² + N P + 3 Lc)`` exceeds 227 KB. bfloat16 (the
    tensor-core kernel): N and P padded to a power of two ≥ 16, the chunk
    rounded up to a multiple of 16 and cut to 128 rows, then halved while
    its block's shared memory exceeds 227 KB: two ring slots, each the
    larger of a chunk's x, B and C tiles (``2 Lc (2 N' + P')`` bytes) and
    the state's three-term split (``6 N' P'``), and 2 KB of per-row decay
    terms. Only the rounding moves with the chunk. Raises ``ValueError``
    where no chunk fits, or for bfloat16 N > 128 or P > 64.
    """
    if dtype == torch.float32:
        n_pad, p_pad, step, cap = n, p, 4, math.inf

        def smem(c):
            return 4 * (2 * n * c + c * p + c * c + n * p + 3 * c)
    else:
        if n > _TC_MAX_N or p > _TC_MAX_P:
            raise ValueError(f"N={n}, P={p}: the bfloat16 kernel takes N ≤ "
                             f"{_TC_MAX_N} and P ≤ {_TC_MAX_P}")
        n_pad, p_pad, step, cap = (_pad_width(n), _pad_width(p), 16,
                                   _TC_MAX_CHUNK)

        def smem(c):          # two ring slots, then cum, dt, w, gd
            return 2 * max(2 * c * (2 * n_pad + p_pad),
                           6 * n_pad * p_pad) + 2048
    lc = min(-(-max(1, min(chunk, s)) // step) * step, cap)
    while lc > step and smem(lc) > MAX_SMEM:
        lc = -(-(lc // 2) // step) * step
    if smem(lc) > MAX_SMEM:
        raise ValueError(f"N={n}, P={p}: no chunk fits the kernel's shared "
                         f"memory")
    return SsdPlan(lc, n_pad, p_pad, smem(lc))


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, *, chunk: int,
                  s0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan on the card (``csrc/ssd_scan.cu``).

    x: [Bt, S, H, P] and B, C: [Bt, S, G, N], all float32 or all bfloat16;
    dt: [Bt, S, H], A: [H] and s0: [Bt, H, N, P] (or None: zeros) float32;
    ``H % G == 0``, ``P % 4 == 0``, ``N % 4 == 0`` (bfloat16: N ≤ 128,
    P ≤ 64). Returns (y [Bt, S, H, P], last state [Bt, H, N, P]), float32.
    The kernel's chunk is :func:`ssd_plan`'s: the same function, blocked
    otherwise. One launch (none when Bt·H = 0).
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
    lc = ssd_plan(n, p, chunk, s, x.dtype).lc
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


def ssd_scan_bwd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                      B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor, *,
                      chunk: int,  # ignored: blocks in ssd_scan_bwd_chunk()
                      s0: Optional[torch.Tensor] = None,
                      d_last: Optional[torch.Tensor] = None):
    """The gradients of :func:`ssd_scan_cuda` on the card
    (``csrc/ssd_scan_bwd.cu``).

    x, B, C, dt, A and s0 as :func:`ssd_scan_cuda`; dy: [Bt, S, H, P] and
    d_last: [Bt, H, N, P] (or None: zero) float32, the gradients on y and
    on the last state. Returns (dx, ddt, dA, dB, dC, ds0): dx in x's dtype,
    dB and dC [Bt, S, G, N] in B's (a group's heads summed in ascending
    order), ddt, dA and ds0 float32; ds0 is None when s0 is. ``chunk``
    selects nothing here: it is taken only so that this wrapper and
    ``ref.ssd_scan_bwd_ref`` take the same arguments under ``ops.kernel``. The kernel blocks the sequence in the
    library's ``ssd_scan_bwd_chunk()`` rows (64) whatever ``chunk`` (the
    same function, blocked otherwise); it raises where N and P are not
    multiples of 4 or its gradient kernel's shared memory (the library's
    ``ssd_scan_bwd_smem``: 189,184 bytes at N = 128, P = 64) exceeds
    227 KB. ``launches`` counts calls (each launches five kernels: the
    chunks' own terms, the scan over chunks, the gradients, the sums over
    a group's heads and over chunks).
    """
    refuse_grad("ssd_scan_bwd", x, dt, A, B, C, dy, s0, d_last)
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
    if bt > _MAX_BATCH or bt * h > _MAX_BATCH:
        raise ValueError(f"Bt={bt}, H={h}: Bt and Bt·H must be at most "
                         f"{_MAX_BATCH} (the kernel's grid)")
    smem = _entry("ssd_scan_bwd_smem")(n, p)
    if smem > MAX_SMEM:
        raise ValueError(f"N={n}, P={p}: the backward's block needs {smem} "
                         f"bytes of shared memory, over {MAX_SMEM}")
    lc = _entry("ssd_scan_bwd_chunk")()
    nc = -(-s // lc)
    if nc > _MAX_BATCH:
        raise ValueError(f"S={s} exceeds the kernel's grid limit "
                         f"{_MAX_BATCH * lc}")
    _check_dims(BSHP=bt * s * h * p, BSHN=bt * s * h * n,
                BCHNP=bt * nc * h * n * p)
    f32 = torch.float32
    _check(x, "x", x.dtype, (bt, s, h, p), dev)
    _check(dt, "dt", f32, (bt, s, h), dev)
    _check(A, "A", f32, (h,), dev)
    _check(B, "B", x.dtype, (bt, s, g, n), dev)
    _check(C, "C", x.dtype, (bt, s, g, n), dev)
    _check(dy, "dy", f32, (bt, s, h, p), dev)
    for t, name in ((s0, "s0"), (d_last, "d_last")):
        if t is not None:
            _check(t, name, f32, (bt, h, n, p), dev)
    with torch.cuda.device(dev):
        dx = torch.empty_like(x)
        ddt = torch.empty((bt, s, h), dtype=f32, device=dev)
        da = torch.empty((h,), dtype=f32, device=dev)
        db, dc = torch.empty_like(B), torch.empty_like(C)
        ds0 = None if s0 is None else torch.empty_like(s0)
        if bt * h * s == 0:
            da.zero_()
            return dx, ddt, da, db, dc, None if ds0 is None else ds0.zero_()
        sin = torch.empty((bt, nc, h, n, p), dtype=f32, device=dev)
        gout = torch.empty_like(sin)
        tot = torch.empty((bt, nc, h), dtype=f32, device=dev)
        dah = torch.empty_like(tot)
        dbh = torch.empty((bt, s, h, n), dtype=f32, device=dev)
        dch = torch.empty_like(dbh)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _call("ssd_scan_bwd", _ptr(x), _ptr(dt), _ptr(A), _ptr(B), _ptr(C),
              _ptr(s0), _ptr(dy), _ptr(d_last), _ptr(sin), _ptr(gout),
              _ptr(tot), _ptr(dx), _ptr(ddt), _ptr(dbh), _ptr(dch),
              _ptr(dah), _ptr(da), _ptr(db), _ptr(dc), _ptr(ds0),
              _DTYPES[x.dtype], bt, s, h, p, g, n, stream)
    _count(ssd_scan_bwd_cuda)
    return dx, ddt, da, db, dc, ds0


ssd_scan_bwd_cuda.launches = 0
