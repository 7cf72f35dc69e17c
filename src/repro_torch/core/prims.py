"""Jaxpr steps that no single ATen op writes, as torch custom ops.

A graph form of a JAX function (``repro_torch.models.graph_form``'s
``_flash_fwd_chunks`` and ``_ssd_chunked``) is written step for step as
the jaxpr's equations, so that :mod:`repro_torch.core.tracer` records
the reference's raw nodes. Three steps have no one-op counterpart in
ATen:

* ``dot_general`` — a product over any contracting and batch dims, with
  its output in the primitive's own order (batch dims, the lhs's free
  dims, the rhs's free dims). ``jnp.einsum`` lowers to it; ATen's
  ``matmul`` would add permutes, views and expands of its own, or (with
  nothing to contract) a ``mul``. The tracer lowers it to one ``dense``
  node with the reference's ``contract_k`` and ``batch_dims``.
* ``iota`` — ``lax.broadcasted_iota``: an integer tensor counting along
  one dim of an N-D shape, which ``jnp.tri`` makes in one equation and
  ATen in an ``arange``, a view and an expand. The tracer records it as
  one layout raw node.
* ``top_k`` — ``lax.top_k``: the k largest along the last dim in
  descending order, the lower index first among equals, and their int32
  indices. ``torch.topk`` promises no order of ties and gives int64
  indices, which a conversion would add a node to. The tracer lowers it
  to one ``reduce`` node whose bytes count both outputs, as the
  reference's counts every outvar of an equation.
* ``scan_ys`` — the stacked per-step outputs (ys) of a ``lax.scan``
  whose body the reference replicates once per step. The jaxpr's scan
  hands on the last replica's value and adds no equation for the stack,
  so the tracer gives the result its last operand's origin. An
  ``aten.stack`` of a user's program stays a node with an edge from
  every operand.

All four run on any device (the graph forms run on the CPU in the tests and
on the card in ``chip_smoke.py``) and have fake versions for tracing.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

_LIB = "repro_torch"


def _free(rank: int, *used: Sequence[int]) -> List[int]:
    taken = {int(d) for dims in used for d in dims}
    return [d for d in range(rank) if d not in taken]


def dot_general_shape(lhs_shape, rhs_shape, lc, rc, lb, rb) -> List[int]:
    """``lax.dot_general``'s output shape: batch dims, then the lhs's free
    dims, then the rhs's free dims, each in operand order."""
    lf = _free(len(lhs_shape), lc, lb)
    rf = _free(len(rhs_shape), rc, rb)
    return ([int(lhs_shape[d]) for d in lb] + [int(lhs_shape[d]) for d in lf]
            + [int(rhs_shape[d]) for d in rf])


@torch.library.custom_op(f"{_LIB}::dot_general", mutates_args=())
def dot_general(lhs: torch.Tensor, rhs: torch.Tensor, lc: List[int],
                rc: List[int], lb: List[int], rb: List[int]) -> torch.Tensor:
    """``lax.dot_general(lhs, rhs, ((lc, rc), (lb, rb)))``: one batched
    product, float32 accumulation as the operands' dtype gives it."""
    lf = _free(lhs.dim(), lc, lb)
    rf = _free(rhs.dim(), rc, rb)
    nb = 1
    for d in lb:
        nb *= lhs.shape[d]
    k = 1
    for d in lc:
        k *= lhs.shape[d]
    m = 1
    for d in lf:
        m *= lhs.shape[d]
    n = 1
    for d in rf:
        n *= rhs.shape[d]
    a = lhs.permute(*lb, *lf, *lc).reshape(nb, m, k)
    b = rhs.permute(*rb, *rc, *rf).reshape(nb, k, n)
    out = torch.bmm(a, b)
    return out.reshape(dot_general_shape(lhs.shape, rhs.shape, lc, rc,
                                         lb, rb))


@dot_general.register_fake
def _(lhs, rhs, lc, rc, lb, rb):
    return lhs.new_empty(dot_general_shape(lhs.shape, rhs.shape, lc, rc,
                                           lb, rb))


@torch.library.custom_op(f"{_LIB}::iota", mutates_args=())
def iota(shape: List[int], dimension: int, dtype: torch.dtype,
         device: torch.device) -> torch.Tensor:
    """``lax.broadcasted_iota(dtype, shape, dimension)``."""
    view = [1] * len(shape)
    view[dimension] = shape[dimension]
    return torch.arange(shape[dimension], dtype=dtype, device=device) \
        .view(view).expand(*shape).contiguous()


@iota.register_fake
def _(shape, dimension, dtype, device):
    return torch.empty(shape, dtype=dtype, device=device)


@torch.library.custom_op(f"{_LIB}::top_k", mutates_args=())
def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k(x, k)``: a stable descending sort, its first k."""
    vals, ids = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k].contiguous(), ids[..., :k].to(torch.int32)


@top_k.register_fake
def _(x, k):
    shape = tuple(x.shape[:-1]) + (k,)
    return x.new_empty(shape), x.new_empty(shape, dtype=torch.int32)


@torch.library.custom_op(f"{_LIB}::scan_ys", mutates_args=())
def scan_ys(ys: List[torch.Tensor]) -> torch.Tensor:
    """A scan's per-step outputs stacked along a new leading axis."""
    return torch.stack(ys)


@scan_ys.register_fake
def _(ys):
    return ys[0].new_empty((len(ys),) + tuple(ys[0].shape))
