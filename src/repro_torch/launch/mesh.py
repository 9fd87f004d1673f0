"""Device meshes over ``torch.distributed`` (the port of ``repro.launch.mesh``).

The production layout is 16 x 16 per pod and two pods: ("data", "model"),
or ("pod", "data", "model") across pods. A mesh needs a default process
group whose world size is the mesh's size; nothing here starts one or
shrinks a mesh to fit the ranks there are.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(shape, names, device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` with dims ``names`` over the default
    process group's ranks, in rank order."""
    shape, names = tuple(int(s) for s in shape), tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and names {names} differ in length")
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a default process group: call "
                           "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"mesh {dict(zip(names, shape))} needs {math.prod(shape)} "
                         f"ranks, the process group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def mesh_shape_dict(mesh: DeviceMesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
