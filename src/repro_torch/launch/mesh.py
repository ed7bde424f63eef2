"""Device meshes over the initialised ``torch.distributed`` world
(counterpart of ``repro.launch.mesh``).

Functions, never module-level constants: a mesh needs an initialised
process group (``torch.distributed.init_process_group``), and importing
this module must not need one.  A mesh spans the whole world, one rank a
device; its device type follows the group's backend (``'cuda'`` for NCCL,
``'cpu'`` for gloo).
"""

from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "a device mesh needs an initialised process group "
            "(torch.distributed.init_process_group)")
    return dist.get_world_size()


def _make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> DeviceMesh:
    world = _world_size()
    if world != math.prod(shape):
        raise ValueError(
            f"a mesh of shape {shape} needs a world of {math.prod(shape)} "
            f"ranks, the initialised world has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16x16 = 256 ranks a pod; 2 pods = 512 ranks multi-pod.  Raises
    ``ValueError`` on a world of another size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes)


def make_mesh_for(
    n_devices: int | None = None,
    *,
    model_parallel: int = 1,
    pods: int = 1,
) -> DeviceMesh:
    """A (pod, data, model) mesh over the world's ranks, the elastic-rescale
    path (checkpoint restores reshard to it).  ``n_devices`` defaults to
    the world size and must equal it."""
    n = n_devices or _world_size()
    if n % (model_parallel * pods):
        raise ValueError(f"{n} devices not divisible by tp*pods")
    data = n // (model_parallel * pods)
    if pods > 1:
        return _make_mesh((pods, data, model_parallel), ("pod", "data", "model"))
    return _make_mesh((data, model_parallel), ("data", "model"))


def dp_axes_of(mesh: DeviceMesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
