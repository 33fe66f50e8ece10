"""Mesh construction: the port of ``repro.launch.mesh``.

Functions only (no module-level meshes), so importing this module touches
no device and starts no process group.

The production meshes (16 x 16 chips, or 2 x 16 x 16) are ``MeshShape``s:
axis names and sizes, no devices.  One card cannot host a 256-rank
``DeviceMesh``, and the dry-run (``launch.dryrun``) needs only the sizes to
resolve the sharding rules and count each device's bytes.
``make_local_mesh`` builds a real ``DeviceMesh`` of shape (1, n) with the
production axis names, on which tensors can be distributed as DTensors.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.sharding.logical import mesh_axis_sizes


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A device-free mesh: axis names and their sizes."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16x16 single pod (256 chips) or 2x16x16 multi-pod (512 chips)."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def named_mesh(name) -> MeshShape:
    """The dry-run's meshes by name: ``single`` 16 x 16, ``multi`` 2 x 16 x
    16, ``local`` 1 x 1 (one card); a ``MeshShape`` is itself."""
    if isinstance(name, MeshShape):
        return name
    if name == "local":
        return MeshShape(("data", "model"), (1, 1))
    return make_production_mesh(multi_pod=name == "multi")


# Whether make_local_mesh started the default process group, which is
# itself process-wide state: close_local_mesh destroys only that one.
_started_group = False


def make_local_mesh(device="cuda"):
    """A (1, n) ``DeviceMesh`` with the production axis names over the n
    ranks of the running process group.  With none running it starts a
    world of one from a ``HashStore`` (``nccl`` on CUDA, ``gloo`` on the
    CPU), which ``close_local_mesh`` destroys."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    global _started_group
    device = resolve_device(str(device))
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
        _started_group = True
    n = dist.get_world_size()
    return DeviceMesh(device.type, torch.arange(n).reshape(1, n),
                      mesh_dim_names=("data", "model"))


def close_local_mesh():
    """Destroy the process group if ``make_local_mesh`` started it; leave
    one that the caller started alone."""
    import torch.distributed as dist
    global _started_group
    if _started_group and dist.is_initialized():
        dist.destroy_process_group()
    _started_group = False


@contextlib.contextmanager
def local_mesh(device="cuda"):
    """``make_local_mesh`` for the span of a ``with`` block."""
    mesh = make_local_mesh(device)
    try:
        yield mesh
    finally:
        close_local_mesh()


def data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh_axis_sizes(mesh))


def dp_degree(mesh) -> int:
    sizes = mesh_axis_sizes(mesh)
    d = 1
    for a in data_axes(mesh):
        d *= sizes[a]
    return d
