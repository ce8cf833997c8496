"""Device meshes of the port, on ``torch.distributed``.

The counterpart of the JAX package's ``repro.launch.mesh``: a
``DeviceMesh`` over the ranks of the default process group, with the same
axis names (``data`` and ``model``, ``pod`` where a mesh has one).  Each
process is one rank and drives one device; a search or a step built on a
mesh is called by every rank of it, each with its own block of the data.
The production mesh (256 or 512 ranks) is the dry run's and is not ported
yet.
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


def mesh_axis_sizes(mesh) -> dict:
    """{axis name: size}, in the mesh's axis order."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def batch_axes(mesh) -> tuple:
    """Mesh axes the global batch (and a search's corpus rows) is sharded
    over."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)
