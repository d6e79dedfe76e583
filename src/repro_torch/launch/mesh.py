"""Production mesh construction, `repro/launch/mesh.py` over
`torch.distributed.device_mesh`.

Single pod: 16x16 = 256 devices, axes (data, model).  Multi-pod:
2x16x16 = 512 devices, axes (pod, data, model); the pod axis is an outer
data-parallel axis in training and a replica axis in serving.

Functions, not module constants: importing this module touches no process
group.  The caller initialises one (NCCL on the card, gloo on the CPU, the
`fake` backend in the dry-run) before it asks for a mesh, and a mesh whose
size differs from the group's world size raises.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _mesh(shape, axes, device) -> DeviceMesh:
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: call "
                           "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} holds {math.prod(shape)} devices, "
                         f"the process group {world}")
    if device is None:
        device = "cuda"
    dev_type = torch.device(device).type
    return DeviceMesh(dev_type, torch.arange(world).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_mesh(shape, axes, *, device=None) -> DeviceMesh:
    """A mesh of any shape over the initialised process group, on the
    device type of `device` (the CUDA card unless asked otherwise)."""
    return _mesh(shape, axes, device)


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of a production mesh (pod folds into data)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def tp_axis(mesh) -> str:
    return "model"


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size}, `jax.sharding.Mesh.shape`'s mapping."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


class AbstractMesh:
    """Axis names and sizes with no devices and no process group
    (`jax.sharding.AbstractMesh`): what the sharding rules read."""

    def __init__(self, shape, axes):
        self.shape = tuple(int(s) for s in shape)
        self.mesh_dim_names = tuple(axes)

    def size(self) -> int:
        return math.prod(self.shape)
