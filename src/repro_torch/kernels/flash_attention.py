"""Python wrapper around the hand-written flash-attention kernel.

:func:`flash_attention_cuda` runs ``csrc/flash_attention.cu``, the port of
``flash_attention_pallas``: the function of ``blockwise_attention``
(``repro/models/layers.py``) over the model's ``[B, S, H, D]`` layout,
with grouped-query heads, causal and sliding-window masks, and the query
and key offsets a decode step and the ring cache give. Semantics are
those of :func:`repro_torch.kernels.ref.flash_attention_ref`.

The wrapper follows :mod:`repro_torch.kernels.segment_spmm`: CUDA tensors
only, checked for device, dtype (float32 or bfloat16, q, k and v alike),
shape, contiguity and alignment; the output allocated with
``torch.empty``; one launch on the current stream, counted in
``flash_attention_cuda.launches``; a non-zero ``cudaError_t`` raises, and
so does an input that requires grad while grad mode is on (the kernel has
no backward; LM training is ROADMAP A14b).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .segment_spmm import (_call, _check, _check_dims, _count, _cuda_device,
                           _ptr, refuse_grad)

#: head dims the kernel takes: D % 8 == 0 and D <= _MAX_D
_MAX_D = 128
#: gridDim.y carries batch × heads
_MAX_BH = 65535
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: int = 0, q_offset: int = 0,
                         kv_offset: int = 0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Masked streaming-softmax attention on the card
    (``csrc/flash_attention.cu``).

    q: [B, Sq, H, D]; k, v: [B, Skv, Hkv, D], all float32 or all bfloat16,
    contiguous; ``H % Hkv == 0``; ``D % 8 == 0`` and ``D <= 128``.
    ``q_offset`` / ``kv_offset`` are the positions of the first query row
    and the first key (``kv_offset`` may be negative: the ring cache).
    Returns [B, Sq, H, D] in q's dtype; a row with no kept key is 0. One
    launch (none when the output is empty).
    """
    refuse_grad("flash_attention", q, k, v)
    dev = _cuda_device(q)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be [B, S, H, D], got {tuple(q.shape)} "
                         f"and {tuple(k.shape)}")
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if d % 8 or not 0 < d <= _MAX_D:
        raise ValueError(f"head dim {d} is not a multiple of 8 in [8, "
                         f"{_MAX_D}]")
    if hkv == 0 or h % hkv:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")
    if b * h > _MAX_BH:
        raise ValueError(f"B*H={b * h} exceeds the kernel's grid limit "
                         f"{_MAX_BH}")
    _check_dims(BSHD=b * sq * h * d, BSKD=b * skv * hkv * d)
    _check(q, "q", q.dtype, (b, sq, h, d), dev)
    _check(k, "k", q.dtype, (b, skv, hkv, d), dev)
    _check(v, "v", q.dtype, (b, skv, hkv, d), dev)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    offsets = dict(q_offset=q_offset, kv_offset=kv_offset, window=window)
    for name, val in offsets.items():
        if not isinstance(val, int):
            raise TypeError(f"{name} must be a Python int, got "
                            f"{type(val).__name__}")
    _check_dims(q_end=abs(q_offset) + sq, kv_end=abs(kv_offset) + skv)
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    with torch.cuda.device(dev):
        out = torch.empty_like(q)
        if out.numel() == 0:
            return out
        stream = torch.cuda.current_stream(dev).cuda_stream
        _call("flash_attention", _ptr(q), _ptr(k), _ptr(v), _ptr(out),
              _DTYPES[q.dtype], b, sq, skv, h, hkv, d, scale, int(causal),
              int(window), q_offset, kv_offset, stream)
    _count(flash_attention_cuda)
    return out


flash_attention_cuda.launches = 0
