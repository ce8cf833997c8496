"""Device meshes of the port, on ``torch.distributed``.

The counterpart of the JAX package's ``repro.launch.mesh``: a
``DeviceMesh`` over the ranks of the default process group, with the same
axis names (``data`` and ``model``, ``pod`` where a mesh has one).  Each
process is one rank and drives one device; a search or a step built on a
mesh is called by every rank of it, each with its own block of the data.
The production meshes (256 or 512 ranks, ``make_production_mesh``) need a
default group of that size: a deployment's own, or the dry run's fake one
(``start_fake_world``), in which this process plays rank 0 and every
collective returns at once.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import resolve_device

#: the collective backend of each device type
_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_local_mesh(data: int = 1, model: int = 1,
                    device="cuda") -> DeviceMesh:
    """A (data, model) mesh over the ranks of the default process group on
    ``device`` (the card unless the caller asks for the CPU).  Where no
    process group exists, it starts one of a single rank, with an
    in-process store and no network: NCCL on the card, gloo on the CPU.
    As in the reference, a mesh larger than the world shrinks to
    (world, 1)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group(_BACKENDS[dev.type], store=dist.HashStore(),
                                rank=0, world_size=1)
    n = dist.get_world_size()
    if data * model > n:
        data, model = n, 1
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"))


def start_fake_world(world_size: int) -> None:
    """Make this process rank 0 of a default process group of
    ``world_size`` ranks on the fake backend (``torch.testing``'s
    ``FakeProcessGroup``): no peer exists, and every collective returns at
    once without moving data.  The dry run's world; a process can start
    only one default group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu") -> DeviceMesh:
    """16×16 single-pod (256 ranks) or 2×16×16 multi-pod (512 ranks), over
    the default process group, which must have that many ranks.

    Axes: ``pod`` — DP across pods (gradient all-reduce only); ``data`` —
    FSDP + batch DP; ``model`` — tensor parallelism.  ``device_type`` is the
    mesh's ("cpu" on the dry run's fake world, whose tensors live on the
    meta device)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def mesh_axis_sizes(mesh) -> dict:
    """{axis name: size}, in the mesh's axis order."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def batch_axes(mesh) -> tuple:
    """Mesh axes the global batch (and a search's corpus rows) is sharded
    over."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)
