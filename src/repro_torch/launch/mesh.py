"""Device meshes: ``torch.distributed`` DeviceMeshes over a process group.

The port's copy of the JAX package's ``launch/mesh.py``, plus what the
reference gets from ``--xla_force_host_platform_device_count``: a mesh
larger than the machine, for a trace.  :func:`fake_world` brings up the
``"fake"`` process-group backend (one process stands for rank 0 of a world
of any size; its collectives move no data) and tears it down afterwards;
:func:`traced_mesh` builds a mesh inside it.  A real mesh needs a real
process group (gloo, tested on the CPU; NCCL, untested), initialised by
the caller with its address, world size and rank.  A mesh is ``[data,
model]`` or ``[pod, data, model]`` (:func:`mesh_axes`); ``DeviceMesh``
gives each axis's process group (``mesh.get_group(axis)``), and
:func:`axis_groups` every group of each axis, as an export lists them.
"""
from __future__ import annotations

import contextlib
import math

import torch.distributed as dist

from ..device import resolve_device


def mesh_axes(shape: tuple[int, ...]) -> tuple[str, ...]:
    """The axis names of a mesh of ``shape``, as the reference's campaign
    names them: ``(data, model)``, or ``(pod, data, model)``."""
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device=None):
    """A DeviceMesh of ``shape`` named ``axes`` over the default process
    group, whose world size must be the product of ``shape``, for tensors
    on ``device`` (None: the card)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(resolve_device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def axis_groups(mesh) -> dict[str, list[list[int]]]:
    """For each axis of ``mesh``: every group of that axis, each the global
    ranks that differ only in their coordinate on it (``[[0, 1], [2, 3]]``
    for the model axis of ``[2, 2]``), in the order XLA prints
    ``replica_groups``."""
    ranks = mesh.mesh
    return {axis: ranks.movedim(i, -1).reshape(-1, ranks.shape[i]).tolist()
            for i, axis in enumerate(mesh.mesh_dim_names)}


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return make_mesh(shape, mesh_axes(shape), device)


@contextlib.contextmanager
def fake_world(size: int):
    """A default process group of the ``"fake"`` backend, this process its
    rank 0 of ``size``, for the duration of the block.  It refuses to
    replace a process group that is already up."""
    if dist.is_initialized():
        raise RuntimeError(
            "fake_world: a process group is already initialised; a traced "
            "mesh will not replace it")
    # registers the "fake" backend; a private module of torch, checked
    # against torch 2.11.0+cu128 and 2.13.0+cpu
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def traced_mesh(shape: tuple[int, ...], device=None):
    """A mesh of ``shape`` in a fake world of its size: the counterpart of
    the reference campaign's ``_mesh_for`` under forced host devices.
    Yields the DeviceMesh."""
    shape = tuple(shape)
    with fake_world(math.prod(shape)):
        yield make_mesh(shape, mesh_axes(shape), device)
