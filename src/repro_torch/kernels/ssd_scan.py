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
and ds0 from the gradients on y and on the last state. bfloat16 runs on
the tensor cores (two walks over the chunks for the entry states and exit
gradients, then a block a head slice for the gradients, every float
operand split into bf16 terms), float32 on the FMA pipes;
:func:`ssd_bwd_plan` says how a call runs.

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
                           _ptr, refuse_grad)

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


#: the backward blocks the sequence in 64-row chunks on both routes
_BWD_CHUNK = 64
#: the backward's tensor-core route: the most heads a gradient block walks
_BWD_TC_HEADS = 8


class SsdBwdPlan(NamedTuple):
    """How ``csrc/ssd_scan_bwd.cu`` runs one call."""
    route: str        #: "tc" (bfloat16, the tensor cores) or "fma"
    lc: int           #: rows a chunk
    n_pad: int        #: N as the kernel's tiles hold it
    p_pad: int        #: P as the kernel's tiles hold it
    heads: int        #: heads a gradient block walks
    partials: int     #: float32 partials of dB and dC a group
    smem_bytes: int   #: dynamic shared memory of a gradient block
    walk_smem: int    #: ... of a walk block (tc) or a chunk block (fma)


def ssd_bwd_plan(n: int, p: int, h: int, g: int,
                 dtype: torch.dtype) -> SsdBwdPlan:
    """The backward's route, chunk, heads a block, partials and shared
    memory for N, P, H heads in G groups, as the C entries
    ``ssd_scan_bwd_smem`` / ``_chunk`` / ``_heads`` compute them.

    float32 (the FMA route, five launches): 64-row chunks, a gradient
    block a (head, chunk, batch row) writing the head's part of dB and dC
    (``partials`` = the group's heads), ``4 (2·64 (N + P + 2) + 320 + 2·64·65
    + N (P + 1) + 3·16·64 + 32 P + 384)`` bytes (189,184 at N 128, P 64) and
    a chunk block ``4 (2·64 (N + P + 2) + 320)``. bfloat16 (the tensor
    cores, four launches): N and P padded to a power of two ≥ 16 (N ≤ 128,
    P ≤ 64, else ``ValueError``); a group's H / G heads in
    ``ceil(H / G / 8)`` slices as even as they go, each walked by one
    gradient block and written as one float32 partial; a gradient block
    holds the chunk's B and C, two ring slots of a head's x, dy, Gout and
    Sin (each float operand in two bf16 terms) and two heads' per-row terms
    and row sums: ``256 N' + 2 (384 P' + 8 N' P') + 5,184`` (218,176 at
    128 / 64); a walk block two slots of a chunk's B or C and
    its x or dy's two terms and their row scales, and the state's two
    terms on their way out, ``256 N' + 512 P' + 512 + 4 N' P'`` (98,816).
    """
    if g <= 0 or h % g:
        raise ValueError(f"H={h} is not a multiple of the groups G={g}")
    hpg = h // g
    if dtype == torch.float32:
        stage = 2 * 64 * (n + 1) + 2 * 64 * (p + 1) + 5 * 64
        grad = stage + 2 * 64 * 65 + n * (p + 1) + 3 * 16 * 64 \
            + 2 * (p // 4) * 64 + 256 + 2 * 64
        return SsdBwdPlan("fma", _BWD_CHUNK, n, p, 1, hpg, 4 * grad,
                          4 * stage)
    if dtype != torch.bfloat16:
        raise TypeError(f"the backward takes float32 or bfloat16, got {dtype}")
    if n > _TC_MAX_N or p > _TC_MAX_P:
        raise ValueError(f"N={n}, P={p}: the bfloat16 kernel takes N ≤ "
                         f"{_TC_MAX_N} and P ≤ {_TC_MAX_P}")
    nt, pt = _pad_width(n), _pad_width(p)
    slices = -(-hpg // _BWD_TC_HEADS)
    heads = -(-hpg // slices)
    grad = 256 * nt + 2 * (384 * pt + 8 * nt * pt) + 5184
    return SsdBwdPlan("tc", _BWD_CHUNK, nt, pt, heads, -(-hpg // heads), grad,
                      256 * nt + 512 * pt + 512 + 4 * nt * pt)


def ssd_scan_bwd_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                      B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor, *,
                      chunk: int,  # ignored: blocks in 64-row chunks
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
    ``ref.ssd_scan_bwd_ref`` take the same arguments under ``ops.kernel``.
    The kernel blocks the sequence in 64 rows whatever ``chunk`` (the
    same function, blocked otherwise) on the route of
    :func:`ssd_bwd_plan`: bfloat16 on the tensor cores (N ≤ 128, P ≤ 64;
    218,176 bytes of shared memory a gradient block at N = 128, P = 64),
    float32 on the FMA pipes (189,184); it raises where N and P are not
    multiples of 4, or a route does not take them. ``launches`` counts
    calls (each launches five kernels in float32: the chunks' own terms,
    the scan over chunks, the gradients, the sums over a group's heads and
    over chunks; four in bfloat16: the two walks over the chunks in one,
    the gradients of a head slice, the sums over a group's slices and over
    chunks).
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
    plan = ssd_bwd_plan(n, p, h, g, x.dtype)
    if plan.smem_bytes > MAX_SMEM:
        raise ValueError(f"N={n}, P={p}: the backward's block needs "
                         f"{plan.smem_bytes} bytes of shared memory, over "
                         f"{MAX_SMEM}")
    lc = plan.lc
    nc = -(-s // lc)
    if nc > _MAX_BATCH:
        raise ValueError(f"S={s} exceeds the kernel's grid limit "
                         f"{_MAX_BATCH * lc}")
    tc = plan.route == "tc"
    _check_dims(BSHP=bt * s * h * p, BSHN=bt * s * h * n,
                BCHNP=bt * nc * h * (2 * plan.n_pad * plan.p_pad if tc
                                     else n * p))
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
    if tc and any(t is not None and t.data_ptr() % 16
                  for t in (x, B, C, dy, s0, d_last)):
        raise ValueError("x, B, C, dy, s0 and d_last must be 16-byte "
                         "aligned")
    with torch.cuda.device(dev):
        dx = torch.empty_like(x)
        ddt = torch.empty((bt, s, h), dtype=f32, device=dev)
        da = torch.empty((h,), dtype=f32, device=dev)
        db, dc = torch.empty_like(B), torch.empty_like(C)
        ds0 = None if s0 is None else torch.empty_like(s0)
        if bt * h * s == 0:
            da.zero_()
            return dx, ddt, da, db, dc, None if ds0 is None else ds0.zero_()
        dah = torch.empty((bt, nc, h), dtype=f32, device=dev)
        if tc:
            # the walks' states and dy in two bf16 terms, padded widths;
            # the head slices' float32 partials of dB and dC
            terms = (bt, nc, h, 2)
            sin = torch.empty(terms + (plan.n_pad, plan.p_pad),
                              dtype=torch.bfloat16, device=dev)
            gout = torch.empty_like(sin)
            dys = torch.empty(terms + (lc, plan.p_pad), dtype=torch.bfloat16,
                              device=dev)
            tot = None
            dbh = torch.empty((bt, s, g * plan.partials, n), dtype=f32,
                              device=dev)
        else:
            sin = torch.empty((bt, nc, h, n, p), dtype=f32, device=dev)
            gout = torch.empty_like(sin)
            dys = None
            tot = torch.empty((bt, nc, h), dtype=f32, device=dev)
            dbh = torch.empty((bt, s, h, n), dtype=f32, device=dev)
        dch = torch.empty_like(dbh)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _call("ssd_scan_bwd", _ptr(x), _ptr(dt), _ptr(A), _ptr(B), _ptr(C),
              _ptr(s0), _ptr(dy), _ptr(d_last), _ptr(sin), _ptr(gout),
              _ptr(tot), _ptr(dx), _ptr(ddt), _ptr(dbh), _ptr(dch),
              _ptr(dah), _ptr(da), _ptr(db), _ptr(dc), _ptr(ds0), _ptr(dys),
              _DTYPES[x.dtype], bt, s, h, p, g, n, stream)
    _count(ssd_scan_bwd_cuda)
    return dx, ddt, da, db, dc, ds0


ssd_scan_bwd_cuda.launches = 0
