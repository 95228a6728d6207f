"""Meshes on ``torch.distributed``: the Monte-Carlo sweep's and the
LM stack's.  Counterpart of the JAX package's ``launch/mesh.py``.

There one controller lays a mesh over the process's devices; here every
rank is its own process (SPMD), and a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
default process group.  The sweep's dimensions are named ``("trials",)``
or ``("trials", "clients")`` (`make_sweep_mesh`); the LM stack's
``("data", "model")`` or ``("pod", "data", "model")`` (`make_mesh`,
`make_production_mesh`: ``SINGLE_POD`` is 16 x 16 ranks, ``MULTI_POD``
2 x 16 x 16).  A mesh takes ``prod(shape)`` ranks; a world larger than
that (a multiple of it) holds further replicas of the mesh, the ranks
``k * prod(shape)`` on, each computing the whole of it, so that every
rank returns the result.

With no process group the world is one rank: a shape of ones is
accepted, and a group of one is started in this process (on an
in-process store) for the mesh, as ``DeviceMesh`` would start the
default group.  Any larger shape raises, naming the world size.  (The
JAX package's TPU v5e roofline constants stay there: they are not the
card's.)
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

SWEEP_AXES = ("trials", "clients")
SINGLE_POD = (16, 16)
MULTI_POD = (2, 16, 16)

# meshes built in this process, by (default group, shape, dimension
# names, device type): a mesh's groups are made by collective calls of
# every rank, once
_MESHES: dict = {}


def _world_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
                device_type: str, what: str) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the world's
    first ``prod(shape)`` ranks (further replicas of it past them); the
    product must divide the world size.  ``what`` names the mesh in the
    error."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    total = math.prod(shape)
    if n % total != 0:
        raise ValueError(
            f"{what} shape {shape} needs {total} ranks, which does not "
            f"divide the world size {n}; pick axis sizes whose product "
            f"divides it (or start a world of {total} ranks)")
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    key = (dist.distributed_c10d._get_default_group(), shape, axes,
           device_type)
    if key not in _MESHES:
        ranks = torch.arange(n).reshape((n // total,) + shape)
        _MESHES[key] = DeviceMesh(device_type, ranks,
                                  mesh_dim_names=("replicas",) + axes)[axes]
    return _MESHES[key]


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
    return _world_mesh(shape, SWEEP_AXES[:len(shape)], device_type,
                       "sweep mesh")


def lm_axes(ndim: int) -> Tuple[str, ...]:
    """The LM stack's dimension names for a mesh of ``ndim`` dimensions:
    ``("data",)``, ``("data", "model")`` or ``("pod", "data", "model")``
    (the JAX package's ``launch/train.build_mesh``)."""
    if ndim not in (1, 2, 3):
        raise ValueError(f"an LM mesh has 1 to 3 dimensions, not {ndim}")
    return ("data", "model")[:ndim] if ndim <= 2 else ("pod", "data", "model")


def make_mesh(shape: Tuple[int, ...], device_type: str = "cuda"
              ) -> DeviceMesh:
    """An LM mesh of ``shape`` over the world's ranks, its dimensions
    named by `lm_axes`.  Every rank of the world must call it with the
    same arguments."""
    shape = tuple(int(s) for s in shape)
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape!r}: positive rank counts")
    return _world_mesh(shape, lm_axes(len(shape)), device_type, "mesh")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The production mesh: ``("data", "model")`` over `SINGLE_POD`, or
    ``("pod", "data", "model")`` over `MULTI_POD`.  A function, not a
    module constant: a world smaller than `n_chips` raises, naming the
    world size."""
    return make_mesh(MULTI_POD if multi_pod else SINGLE_POD, device_type)


def n_chips(multi_pod: bool = False) -> int:
    """Ranks of the production mesh: 256, or 512 multi-pod."""
    return math.prod(MULTI_POD if multi_pod else SINGLE_POD)
