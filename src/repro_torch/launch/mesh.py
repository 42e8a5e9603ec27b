"""Production and host meshes (the port of ``repro.launch.mesh``).

Functions, not module constants: importing this module touches no
process group.  A mesh is a ``torch.distributed.device_mesh.DeviceMesh``
with the reference's axis names; the sharding rules read only its axis
names and sizes, which :class:`AbstractMesh` carries without any
process group (for tests of the rules).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..core.interpreters import resolve_device


def production_shape(multi_pod: bool = False):
    """``(shape, axis names)`` of the production mesh: (16, 16) over
    ``("data", "model")``, or (2, 16, 16) over ``("pod", "data",
    "model")``."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes alone, as the rules see a mesh."""

    sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def abstract_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    return AbstractMesh(*production_shape(multi_pod))


def init_fake_world(world_size: int) -> None:
    """Start a process group of ``world_size`` ranks in this one process,
    this process being rank 0, on the ``"fake"`` backend: its
    collectives return at once and move nothing, so a 256-rank mesh can
    be built, and run on meta tensors, on one host.  A group already
    started is kept when its size is ``world_size``; a fake one of
    another size is replaced."""
    if dist.is_initialized() and dist.get_backend() == "fake" \
            and dist.get_world_size() != world_size:
        dist.destroy_process_group()
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks is running; wanted {world_size}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu") -> DeviceMesh:
    """The production mesh over the running process group, which must
    have 256 (512 with ``multi_pod``) ranks; with none running, over a
    fake group of that size (:func:`init_fake_world`): there is no such
    cluster to run on, only the dry run's accounting."""
    shape, axes = production_shape(multi_pod)
    init_fake_world(math.prod(shape))
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device=None) -> DeviceMesh:
    """A (1, 1) mesh over ``("data", "model")`` of a one-rank process
    group, which the caller starts (e.g. NCCL on ``tcp://127.0.0.1``);
    the axes match the production mesh's, so the rules resolve alike.
    The mesh lies on the card unless ``device="cpu"`` is passed; without
    a card and with no ``device`` it raises, as every entry point of the
    port does."""
    if not dist.is_initialized() or dist.get_world_size() != 1:
        raise RuntimeError("make_host_mesh needs a running process group "
                           "of one rank")
    return init_device_mesh(resolve_device(device).type, (1, 1),
                            mesh_dim_names=("data", "model"))
