"""The Monte-Carlo sweep's mesh on ``torch.distributed``.

Counterpart of the JAX package's ``launch/mesh.make_sweep_mesh``.  There
one controller lays a mesh over the process's devices; here every rank
is its own process (SPMD), and the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
default process group, with the dimension names ``("trials",)`` or
``("trials", "clients")``.  The mesh takes ``prod(shape)`` ranks; a
world larger than that (a multiple of it) holds further replicas of the
mesh, the ranks ``k * prod(shape)`` on, each computing the whole sweep,
so that every rank returns the result.

With no process group the world is one rank: the shapes ``(1,)`` and
``(1, 1)`` are accepted, and a group of one is started in this process
(on an in-process store) for the mesh, as ``DeviceMesh`` would start
the default group.  Any larger shape raises, naming the world size.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

SWEEP_AXES = ("trials", "clients")

# meshes built in this process, by (default group, shape, device type):
# a mesh's groups are made by collective calls of every rank, once
_MESHES: dict = {}


def make_sweep_mesh(shape: Optional[Tuple[int, ...]] = None,
                    device_type: str = "cuda") -> DeviceMesh:
    """Sweep mesh over the world's ranks.

    ``shape=None`` puts every rank on one ``("trials",)`` axis.  A
    1-tuple names the trial axis' rank count; a 2-tuple ``(t_dev,
    c_dev)`` adds a ``"clients"`` axis for the per_client contention
    model.  The product must divide the world size, so a configuration
    validated on a four-rank world fails loudly, naming the world size,
    on a smaller one instead of silently resharding.  ``device_type``
    is the ranks' device type, "cuda" or "cpu".  Every rank of the world
    must call it with the same arguments."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if shape is None:
        shape = (n,)
    shape = tuple(int(s) for s in shape)
    if len(shape) not in (1, 2) or any(s < 1 for s in shape):
        raise ValueError(
            f"sweep mesh shape must be (trials,) or (trials, clients) "
            f"positive rank counts, got {shape!r}")
    total = math.prod(shape)
    if n % total != 0:
        raise ValueError(
            f"sweep mesh shape {shape} needs {total} ranks, which does not "
            f"divide the world size {n}; pick axis sizes whose product "
            f"divides it (or start a world of {total} ranks)")
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    axes = SWEEP_AXES[:len(shape)]
    key = (dist.distributed_c10d._get_default_group(), shape, device_type)
    if key not in _MESHES:
        ranks = torch.arange(n).reshape((n // total,) + shape)
        _MESHES[key] = DeviceMesh(device_type, ranks,
                                  mesh_dim_names=("replicas",) + axes)[axes]
    return _MESHES[key]
