"""Device meshes over a ``torch.distributed`` process group — the port of
``repro.launch.mesh``.

A :class:`torch.distributed.device_mesh.DeviceMesh` is PyTorch's
counterpart of a ``jax.sharding.Mesh``: named axes over the ranks of the
default process group, with one process group per axis
(``mesh.get_group("data")``). Nothing here creates the default group. The
caller initialises it explicitly, with its backend, ``init_method``,
``rank`` and ``world_size``, before it asks for a mesh::

    torch.distributed.init_process_group(
        "nccl", init_method="tcp://localhost:29500", rank=r, world_size=w)
    mesh = make_mesh((w,), ("data",))

Each rank runs on its own card (``torch.cuda.set_device(r)`` before the
mesh), or on the CPU under ``gloo`` with ``device_type="cpu"``.
"""
from __future__ import annotations

from typing import Tuple

import torch.distributed as dist


def _check_group() -> None:
    if not dist.is_initialized():
        raise RuntimeError(
            "a device mesh needs the default process group: call "
            "torch.distributed.init_process_group(backend, init_method=..., "
            "rank=..., world_size=...) first")


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's 16×16 pod mesh (or 2×16×16 over two pods) with
    FSDP and tensor parallelism on its axes; it waits for the sharding
    rules (ROADMAP.md A14d)."""
    raise NotImplementedError(
        "make_production_mesh needs the sharding rules and the model's "
        "parallel layout, which are not ported yet (ROADMAP.md A14d)")


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: str = "cuda"):
    """A mesh of ``shape`` over the default group's ranks, its axes named
    ``axes`` (row-major: the last axis varies fastest across ranks)."""
    from torch.distributed.device_mesh import init_device_mesh
    _check_group()
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_host_mesh(model: int = 1, device_type: str = "cuda"):
    """``(world // model, model)`` over every rank, axes
    ``("data", "model")``."""
    _check_group()
    data = max(1, dist.get_world_size() // model)
    return make_mesh((data, model), ("data", "model"), device_type)


def data_axes_of(mesh) -> Tuple[str, ...]:
    """The mesh's data-parallel axes (``pod``, ``data``), in mesh order."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
