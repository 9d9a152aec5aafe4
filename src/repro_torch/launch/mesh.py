"""Sweep meshes over ``torch.distributed`` ranks, and their helpers.

Counterpart of the JAX package's ``launch/mesh.py`` sweep half. JAX runs
one controller over a mesh of devices; PyTorch runs one process per rank.
So a mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` over the
process group the caller initialised (its backend, address, world size,
rank and timeout): every rank builds the same mesh, calls the same entry
point with the same host arrays, and gets the same result. This module
picks no backend and starts no process group of its own.

A one-axis mesh over the whole world is the world group itself
(``DeviceMesh.from_group``). Any other shape goes through
``init_device_mesh``, which makes its axis groups with the world's
backend.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_sweep_mesh(shape=None, *, device_type: str = "cuda") -> DeviceMesh:
    """Mesh for sharding a sweep's batch axis (or one fleet's device axis)
    over the ranks.

    ``shape``: lane counts per mesh axis (``(4,)``, ``(2, 2)``); ``None``
    spreads one flat axis over every rank of the world. Axis names are
    batch axes (``"data"`` for one axis, ``"batch0"``, ``"batch1"``, ...
    otherwise). Every rank must call it with the same arguments, after
    ``torch.distributed.init_process_group``. ``device_type="cuda"`` needs
    a card: each rank runs on its current CUDA device.
    """
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_sweep_mesh(device_type='cuda') needs a CUDA "
                           "device and none is available; pass "
                           "device_type='cpu' for ranks on the CPU")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_sweep_mesh needs a process group: call torch.distributed."
            "init_process_group (backend, init_method, world_size, rank, "
            "timeout) on every rank first")
    world = dist.get_world_size()
    shape = (world,) if shape is None else tuple(int(s) for s in shape)
    axes = ("data",) if len(shape) == 1 else \
        tuple(f"batch{i}" for i in range(len(shape)))
    if shape == (world,):
        return DeviceMesh.from_group(dist.group.WORLD, device_type,
                                     mesh_dim_names=axes)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def mesh_axes(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names)


def batch_axes_of(mesh) -> tuple:
    """Mesh axes the batch dim is sharded over."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def device_axis_of(mesh) -> str:
    """The single mesh axis the simulator's DEVICE dimension shards over.

    Device-axis sharding (``jaxsim.run_device_sharded``) places one
    fleet's per-device state over the mesh, so it needs exactly one batch
    axis for its per-event collectives: build the mesh with
    ``make_sweep_mesh((k,))``. Multi-axis meshes are for sweep-axis
    sharding, where lanes never talk to each other.
    """
    axes = batch_axes_of(mesh)
    if len(axes) != 1:
        raise ValueError(
            f"device-axis sharding needs a single batch-axis mesh "
            f"(make_sweep_mesh((k,))); got axes {axes}")
    return axes[0]


def n_lanes(mesh) -> int:
    """Number of shards the batch axis spreads over (1 for mesh=None)."""
    if mesh is None:
        return 1
    names = mesh.mesh_dim_names
    return math.prod(mesh.shape[names.index(a)] for a in batch_axes_of(mesh))


def n_chips(mesh) -> int:
    """Ranks in the mesh (on one card several ranks share it)."""
    return mesh.size()


def lane_position(mesh) -> int:
    """This rank's position along the mesh's flattened batch axes; a rank
    outside the mesh raises."""
    ranks = mesh.mesh.flatten().tolist()
    rank = dist.get_rank()
    if rank not in ranks:
        raise ValueError(f"rank {rank} is not in the mesh {ranks}")
    return ranks.index(rank)


def mesh_group(mesh):
    """The process group over every rank of the mesh: the axis group of a
    one-axis mesh, the world group of a multi-axis mesh that spans it."""
    if mesh.ndim == 1:
        return mesh.get_group(0)
    if mesh.size() != dist.get_world_size():
        raise ValueError("a multi-axis sweep mesh must span the world "
                         f"({dist.get_world_size()} ranks); got "
                         f"{mesh.size()}")
    return dist.group.WORLD
