"""Python wrappers around the hand-written flash-attention kernels.

:func:`flash_attention_cuda` runs ``csrc/flash_attention.cu``, the port of
``flash_attention_pallas``: the function of ``blockwise_attention``
(``repro/models/layers.py``) over the model's ``[B, S, H, D]`` layout,
with grouped-query heads, causal and sliding-window masks, the query
and key offsets a decode step and the ring cache give, and a value head
dim ``Dv <= D`` (MLA: D 192 over Dv 128 over the full sequence, D 576
over Dv 512 in its weight-absorbed cached form). Semantics are those of
:func:`repro_torch.kernels.ref.flash_attention_ref`.

The C entry picks one of three launch shapes by the query length, the
dtype and D (the source's header says why):

* ``Sq > 1`` in bfloat16 with ``D <= 128``: TMA loads and ``wgmma`` on
  the tensor cores, with p rounded to bf16 before ``p @ V``;
* ``Sq > 1`` in bfloat16 with ``D > 128`` (MLA): ``mma.sync`` on the
  tensor cores, a CTA a 64-row query tile and 128 or 256 columns of O;
* ``Sq > 1`` in float32: products on the FMA pipes, so the parity dtype
  is not computed in TF32;
* ``Sq == 1``, either dtype: split-KV decode over the plan of
  :func:`decode_split_plan`, then a log-sum-exp merge of the splits.

``with_lse=True`` (training) also returns each row's log-sum-exp, written
by the three ``Sq > 1`` kernels (a one-row call then takes them too); it
and the backward take ``D <= 192`` (MLA's 192 over Dv 128 over the full
sequence) with any ``Dv <= D``.

:func:`flash_attention_bwd_cuda` runs ``csrc/flash_attention_bwd.cu``,
the gradient: the custom VJP's ``bwd`` of the JAX package's
``_make_flash`` (no Pallas kernel), semantics those of
:func:`repro_torch.kernels.ref.flash_attention_bwd_ref`. Training reaches
both through ``kernels.autograd.FlashAttention``.

The choice is by dtype and shape, not a fallback: a launch that fails
raises, and so does a tensor map that ``cuTensorMapEncodeTiled`` refuses.

The wrappers follow :mod:`repro_torch.kernels.segment_spmm`: CUDA tensors
only, checked for device, dtype (float32 or bfloat16, q, k and v alike),
shape, contiguity and alignment; outputs and scratch allocated with
``torch.empty``; the launches on the current stream, one call counted
once in ``launches`` (a decode call with more than one split launches two
kernels, the split pass and the merge, and the backward three, and each
still counts one); an input that requires grad while grad mode is on
raises (use ``ops.flash_attention_train``).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from .segment_spmm import (_check, _check_dims, _count, _cuda_device,
                           _entry, _ptr, refuse_grad)

#: head dims the kernel takes: D % 8 == 0 and D <= _MAX_D, Dv % 8 == 0
#: and Dv <= D
_MAX_D = 576
#: the log-sum-exp and the backward: D <= _MAX_D_TRAIN (and Dv <= D)
_MAX_D_TRAIN = 192
#: gridDim.y carries batch × heads
_MAX_BH = 65535
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: keys a decode tile by dtype (``dec::tile_keys`` in the source), halved
#: past D = _DECODE_NARROW_D (:func:`decode_tile`)
_DECODE_TILE = {torch.float32: 32, torch.bfloat16: 64}
_DECODE_NARROW_D = 128
#: query rows (heads of one kv head) a decode CTA holds (``dec::kMaxRows``)
_DECODE_ROWS = 8
#: decode CTAs per SM the split plan aims for, at least: every CTA of a
#: step is resident at once (45–106 KB of shared memory a CTA), so splits
#: only help while there are fewer CTAs than SMs, and each adds scratch
#: traffic and the merge launch (``chip_smoke.py`` times decode shapes
#: with fewer and with more CTAs than SMs under this target, under twice
#: it and under one split)
_DECODE_WAVES = 1


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """The SM count of CUDA device ``index``, asked once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_tile(dtype: torch.dtype, d: int) -> int:
    """Keys a decode tile holds for q / k head dim ``d``: the split plan's
    ``tile``."""
    tile = _DECODE_TILE[dtype]
    return tile if d <= _DECODE_NARROW_D else tile // 2


class SplitPlan(NamedTuple):
    """Keys ``[key_lo, key_hi)`` of a one-row step, cut into ``n_splits``
    runs of ``split_len`` keys (the last may be shorter)."""
    key_lo: int
    key_hi: int
    split_len: int
    n_splits: int


def decode_split_plan(skv: int, *, causal: bool, window: int = 0,
                      q_offset: int = 0, kv_offset: int = 0, ctas: int,
                      sm_count: int, tile: int,
                      waves: int = _DECODE_WAVES) -> SplitPlan:
    """The split plan of a decode step (one query row at ``q_offset``).

    The live keys are those the mask can keep: positions ``≥ 0``, not
    after the row if ``causal``, within ``window`` of it if ``window > 0``
    — one contiguous range ``[key_lo, key_hi)`` of key indices, empty when
    no key is kept. ``ctas`` is the number of CTAs one split gives (batch ×
    kv heads × row groups); the range is cut into runs of whole ``tile``s,
    short enough that ``ctas × n_splits`` covers ``waves × sm_count``
    where the keys allow (else one tile a split); ``waves=0`` asks for one
    split. No split is empty, and the last may be shorter. An empty range
    is one split of no keys, whose rows read 0.
    """
    lo = max(0, -kv_offset)
    hi = skv
    if causal:
        hi = min(hi, q_offset - kv_offset + 1)
    if window > 0:
        lo = max(lo, q_offset - window + 1 - kv_offset)
    if hi <= lo:
        return SplitPlan(0, 0, 0, 1)
    n_tiles = -(-(hi - lo) // tile)
    want = max(1, -(-waves * sm_count // max(ctas, 1)))
    split_len = max(1, n_tiles // want) * tile
    return SplitPlan(lo, hi, split_len, -(-(hi - lo) // split_len))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: int = 0, q_offset: int = 0,
                         kv_offset: int = 0,
                         scale: Optional[float] = None,
                         decode_waves: int = _DECODE_WAVES,
                         with_lse: bool = False):
    """Masked streaming-softmax attention on the card
    (``csrc/flash_attention.cu``).

    q: [B, Sq, H, D]; k: [B, Skv, Hkv, D]; v: [B, Skv, Hkv, Dv], all
    float32 or all bfloat16, contiguous; ``H % Hkv == 0``; ``D`` and
    ``Dv`` multiples of 8 with ``Dv <= D <= 576``. ``q_offset`` /
    ``kv_offset`` are the positions of the first query row and the first
    key (``kv_offset`` may be negative: the ring cache). Returns
    [B, Sq, H, Dv] in q's dtype; a row with no kept key is 0.
    ``decode_waves`` is the split plan's target at ``Sq == 1``
    (:func:`decode_split_plan`'s ``waves``; 0 runs one split).
    ``with_lse`` returns ``(out, lse)``, lse [B, H, Sq] float32 as
    :func:`~repro_torch.kernels.ref.flash_attention_ref` gives it
    (``D <= 192``).

    ``launches`` counts calls: one per call that reaches the card, also a
    decode call whose C entry launches the split pass and the merge.
    """
    refuse_grad("flash_attention", q, k, v)
    dev = _cuda_device(q)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be [B, S, H, D], got {tuple(q.shape)} "
                         f"and {tuple(k.shape)}")
    if v.dim() != 4:
        raise ValueError(f"v must be [B, S, H, Dv], got {tuple(v.shape)}")
    b, sq, h, d = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if d % 8 or not 0 < d <= _MAX_D:
        raise ValueError(f"head dim {d} is not a multiple of 8 in [8, "
                         f"{_MAX_D}]")
    if dv % 8 or not 0 < dv <= d:
        raise ValueError(f"v's head dim {dv} is not a multiple of 8 in "
                         f"[8, {d}] (q's head dim)")
    if with_lse and d > _MAX_D_TRAIN:
        raise ValueError(f"with_lse takes D <= {_MAX_D_TRAIN}, got D={d}")
    if hkv == 0 or h % hkv:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")
    if b * h > _MAX_BH:
        raise ValueError(f"B*H={b * h} exceeds the kernel's grid limit "
                         f"{_MAX_BH}")
    _check_dims(BSHD=b * sq * h * d, BSKD=b * skv * hkv * d)
    _check(q, "q", q.dtype, (b, sq, h, d), dev)
    _check(k, "k", q.dtype, (b, skv, hkv, d), dev)
    _check(v, "v", q.dtype, (b, skv, hkv, dv), dev)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    _check_offsets(sq, skv, q_offset, kv_offset, window)
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    plan = SplitPlan(0, 0, 0, 1)
    with torch.cuda.device(dev):
        out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=dev)
        lse = None
        if with_lse:   # with no key at all, the running maximum's -1e30
            lse = (torch.full((b, h, sq), -1e30, device=dev) if skv == 0
                   else torch.empty((b, h, sq), device=dev))
        if out.numel() == 0:
            return (out, lse) if with_lse else out
        scratch = None
        if sq == 1 and not with_lse:
            plan = decode_split_plan(
                skv, causal=bool(causal), window=window, q_offset=q_offset,
                kv_offset=kv_offset,
                ctas=b * hkv * -(-(h // hkv) // _DECODE_ROWS),
                sm_count=_sm_count(dev.index),
                tile=decode_tile(q.dtype, d), waves=decode_waves)
            if plan.n_splits > 1:
                scratch = torch.empty(b * h * plan.n_splits * (dv + 2),
                                      dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entry("flash_attention")(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(scratch), _ptr(lse),
            _DTYPES[q.dtype], b, sq, skv, h, hkv, d, dv, scale, int(causal),
            int(window), q_offset, kv_offset, *plan, stream)
    if rc < 0:
        why = ("no cuTensorMapEncodeTiled entry point" if rc == -1000
               else f"cuTensorMapEncodeTiled returned CUresult {-rc}")
        raise RuntimeError(f"CUDA kernel flash_attention was not launched: "
                           f"{why}")
    if rc != 0:
        raise RuntimeError(f"CUDA kernel flash_attention was not launched: "
                           f"cudaError_t {rc}")
    _count(flash_attention_cuda)
    return (out, lse) if with_lse else out


flash_attention_cuda.launches = 0


def _check_offsets(sq: int, skv: int, q_offset, kv_offset, window) -> None:
    offsets = dict(q_offset=q_offset, kv_offset=kv_offset, window=window)
    for name, val in offsets.items():
        if not isinstance(val, int):
            raise TypeError(f"{name} must be a Python int, got "
                            f"{type(val).__name__}")
    _check_dims(q_end=abs(q_offset) + sq, kv_end=abs(kv_offset) + skv)


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool, window: int = 0,
                             q_offset: int = 0, kv_offset: int = 0,
                             scale: Optional[float] = None):
    """The gradients ``(dq, dk, dv)`` of :func:`flash_attention_cuda` on
    the card (``csrc/flash_attention_bwd.cu``).

    q: [B, Sq, H, D]; k: [B, Skv, Hkv, D]; v: [B, Skv, Hkv, Dv]; out,
    dout: [B, Sq, H, Dv] (``D`` and ``Dv`` multiples of 8 with ``Dv <= D
    <= 192``), all float32 or all bfloat16, contiguous, 16-byte aligned;
    lse: [B, H, Sq] float32 (``flash_attention_cuda(..., with_lse=True)``'s).
    The masks and offsets are the forward's. Returns dq, dk, dv in the
    inputs' dtype, shaped as q, k and v; dk and dv of a kv head are summed
    over its query heads. ``launches`` counts calls (each launches three
    kernels: delta, dk / dv, dq).
    """
    refuse_grad("flash_attention_bwd", q, k, v, out, lse, dout)
    dev = _cuda_device(q)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be [B, S, H, D], got {tuple(q.shape)} "
                         f"and {tuple(k.shape)}")
    if v.dim() != 4:
        raise ValueError(f"v must be [B, S, H, Dv], got {tuple(v.shape)}")
    b, sq, h, d = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if d % 8 or not 0 < d <= _MAX_D_TRAIN:
        raise ValueError(f"head dim {d} is not a multiple of 8 in [8, "
                         f"{_MAX_D_TRAIN}]")
    if dv % 8 or not 0 < dv <= d:
        raise ValueError(f"v's head dim {dv} is not a multiple of 8 in "
                         f"[8, {d}] (q's head dim)")
    if hkv == 0 or h % hkv:
        raise ValueError(f"H={h} is not a multiple of Hkv={hkv}")
    if b * h > _MAX_BH:
        raise ValueError(f"B*H={b * h} exceeds the kernel's grid limit "
                         f"{_MAX_BH}")
    _check_dims(BSHD=b * sq * h * d, BSKD=b * skv * hkv * d)
    for t, name, shape in ((q, "q", (b, sq, h, d)), (k, "k", (b, skv, hkv, d)),
                           (v, "v", (b, skv, hkv, dv)),
                           (out, "out", (b, sq, h, dv)),
                           (dout, "dout", (b, sq, h, dv))):
        _check(t, name, q.dtype, shape, dev)
    _check(lse, "lse", torch.float32, (b, h, sq), dev)
    if any(t.data_ptr() % 16 for t in (q, k, v, out, dout)):
        raise ValueError("q, k, v, out and dout must be 16-byte aligned")
    _check_offsets(sq, skv, q_offset, kv_offset, window)
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    with torch.cuda.device(dev):
        dq, dk, dv_out = (torch.empty_like(t) for t in (q, k, v))
        delta = torch.empty((b, h, sq), device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entry("flash_attention_bwd")(
            _ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(dout), _ptr(lse),
            _ptr(delta), _ptr(dq), _ptr(dk), _ptr(dv_out), _DTYPES[q.dtype],
            b, sq, skv, h, hkv, d, dv, scale, int(causal), int(window),
            q_offset, kv_offset, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel flash_attention_bwd was not "
                           f"launched: cudaError_t {rc}")
    _count(flash_attention_bwd_cuda)
    return dq, dk, dv_out


flash_attention_bwd_cuda.launches = 0
