"""Logical-axis sharding rules: parameters and activations -> specs.

The port's counterpart of the JAX package's ``parallel/sharding.py``.

Mesh contract (`launch.mesh`): single-pod ``("data", "model")`` = (16,
16), multi-pod ``("pod", "data", "model")`` = (2, 16, 16).

Placement strategy, the reference's:

* batch dims of activations        -> ("pod", "data")   (DP)
* weight d_model dims              -> "data"            (FSDP / ZeRO-3)
* weight d_ff / heads / vocab dims -> "model"           (TP)
* optimizer state                  -> the parameter's spec (ZeRO-1)
* a dim not divisible by its mesh axis -> replicated on that axis

A spec is a tuple with one entry per leading tensor dimension: a mesh
dimension's name, a tuple of names (the dimension split over each of
them, the first the major), or None (replicated); dimensions past its
end are replicated, as in a JAX ``PartitionSpec``.  `placements` turns
one into DTensor placements (``Shard(d)`` on each named mesh dimension,
``Replicate()`` on the others).  Parameter specs come from
(name, shape) rules with divisibility guards, so every architecture
(6-head whisper, 4-head xlstm, 40-head llama4) places without
per-architecture tables.  The rules read axis sizes only through
`MeshRules.axis_size`, so they take a `MeshShape` (names and sizes, no
ranks) as well as a ``DeviceMesh``: the production meshes' specs are
computed without 256 ranks.

The port's LM is a ``ModuleList`` of blocks where the JAX package stacks
each group position's layers on a leading, replicated axis: a port
leaf's spec is the reference's spec of that group position with the
leading ``None`` dropped.

Activation constraints (`constrain`, `activations`) are no-ops in the
port: under a mesh the model code runs on plain tensors, each rank on
its slice of the batch (`train.steps.make_sharded_train_step`), so
there is nothing to place.  They check the roles they are given, and
return the tensor.

The model code reads a block's weights (and, at its top, the embedding,
head and final norm) through `at_use`: the module itself, or, under a
sharded step's `gather_at_use`, its weights gathered whole where they
are used (the JAX package's ``gather_weights`` path gathers each weight
at its use, `models.layers.wcast`).

The bound rules, the batch split (`split_batch`) and the gather
(`gather_at_use`) are process-wide, not thread-local as the reference's
rules are: the autograd engine recomputes a remat layer in the backward
pass on its own thread on the card, and that recomputation must see
what the forward pass saw.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, \
    Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import Replicate, Shard

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]


class MeshShape(NamedTuple):
    """A mesh's dimension names and sizes, without ranks: what the rule
    functions read of a ``DeviceMesh`` (its ``mesh_dim_names`` and
    ``shape``)."""

    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class MeshRules:
    mesh: Any                           # a DeviceMesh or a MeshShape
    batch_axes: Tuple[str, ...]         # ("pod","data") or ("data",)
    fsdp_axis: Axis = "data"            # weight d_model dim
    tp_axis: Optional[str] = "model"    # weight ff/head/vocab dim
    seq_axis: Optional[str] = None      # sequence sharding (long-context)

    def axis_size(self, name: Axis) -> int:
        if name is None:
            return 1
        sizes = dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))
        if isinstance(name, tuple):
            return math.prod(sizes[a] for a in name)
        return sizes[name]


_RULES: Optional[MeshRules] = None


def current_rules() -> Optional[MeshRules]:
    return _RULES


@contextlib.contextmanager
def use_mesh_rules(rules: Optional[MeshRules]) -> Iterator:
    global _RULES
    prev, _RULES = _RULES, rules
    try:
        yield rules
    finally:
        _RULES = prev


def make_rules(mesh, seq_axis: Optional[str] = None,
               fsdp_over_pod: bool = False) -> MeshRules:
    axes = tuple(mesh.mesh_dim_names)
    batch = tuple(a for a in ("pod", "data") if a in axes)
    fsdp: Axis = "data" if "data" in axes else None
    if fsdp_over_pod and "pod" in axes:
        fsdp = ("pod", "data")  # ZeRO-3 across pods
    return MeshRules(mesh=mesh, batch_axes=batch, fsdp_axis=fsdp,
                     tp_axis="model" if "model" in axes else None,
                     seq_axis=seq_axis)


# ------------------------------------------------------------- activations

def resolve_roles(shape: Sequence[int], spec_dims: Sequence[Optional[str]],
                  rules: MeshRules) -> Spec:
    """The spec of logical dim roles ("batch", "model", "seq", "fsdp",
    None) under ``rules``: a dim not divisible by its axes is
    replicated."""
    parts = []
    for role in spec_dims:
        if role is None:
            parts.append(None)
        elif role == "batch":
            parts.append(rules.batch_axes if rules.batch_axes else None)
        elif role == "model":
            parts.append(rules.tp_axis)
        elif role == "fsdp":
            parts.append(rules.fsdp_axis)
        elif role == "seq":
            parts.append(rules.seq_axis)
        else:
            raise ValueError(role)
    return tuple(p if p is not None and shape[i] % rules.axis_size(p) == 0
                 else None for i, p in enumerate(parts))


def constrain(x: torch.Tensor, spec_dims: Sequence[Optional[str]]
              ) -> torch.Tensor:
    """The reference's sharding constraint, described with logical dim
    roles.  Returns ``x``: with no rules bound at once, else after
    resolving the roles (an unknown role, or more roles than ``x`` has
    dimensions, raises)."""
    rules = current_rules()
    if rules is None:
        return x
    if len(spec_dims) > x.dim():
        raise ValueError(f"{len(spec_dims)} roles for a tensor of "
                         f"{x.dim()} dimensions")
    resolve_roles(x.shape, spec_dims, rules)
    return x


def activations(x: torch.Tensor) -> torch.Tensor:
    """Standard (B, S, d) activation constraint: batch on DP axes."""
    if x.dim() == 3:
        return constrain(x, ["batch", None, None])
    return x


# ------------------------------------------------------------------ params

def _divisible(dim: int, rules: MeshRules, axis) -> bool:
    return axis is not None and dim % rules.axis_size(axis) == 0


def _spec_for(path: str, shape: Tuple[int, ...], rules: MeshRules) -> Spec:
    """Name-rule parameter spec with divisibility fallbacks; ``path`` is
    the leaf's name with "/" between its parts."""
    fsdp, tp = rules.fsdp_axis, rules.tp_axis
    name = path.rsplit("/", 1)[-1]

    def d2(a_axis, b_axis, off=0):
        """Spec for the trailing 2 dims, leading dims replicated."""
        a = a_axis if _divisible(shape[off + 0], rules, a_axis) else None
        b = b_axis if _divisible(shape[off + 1], rules, b_axis) else None
        return (None,) * off + (a, b)

    if name in ("table",):                       # embedding (V, d)
        return d2(tp, fsdp)
    if name == "w" and len(shape) == 2 and "head" in path:  # lm head (d, V)
        return d2(fsdp, tp)
    if name in ("wq", "wk", "wv", "w_gate", "w_in", "in_proj", "x_proj",
                "up_proj", "ff_in", "dt_proj", "w") and len(shape) == 2:
        return d2(fsdp, tp)
    if name in ("wo", "w_out", "out_proj", "down_proj", "ff_out") \
            and len(shape) == 2:
        return d2(tp, fsdp)
    if len(shape) == 3 and name in ("w_in", "w_gate"):   # MoE (E, d, ff)
        return d2(fsdp, tp, off=1)
    if len(shape) == 3 and name == "w_out":              # MoE (E, ff, d)
        return d2(tp, fsdp, off=1)
    if len(shape) == 3 and name in ("wq", "wk", "wv", "r"):  # per-head blocks
        return d2(fsdp, tp, off=1)
    if name == "router":
        return d2(fsdp, None)
    if name in ("A_log", "conv_w"):
        a = tp if _divisible(shape[-1], rules, tp) else None
        return (None,) * (len(shape) - 1) + (a,)
    if len(shape) == 1:
        # big 1-D vectors (biases over ff/heads) shard on tp when divisible
        if name in ("bq", "bk", "bv", "D", "dt_bias", "ln_scale") \
                and _divisible(shape[0], rules, tp):
            return (tp,)
        return ()
    if len(shape) == 2:
        return d2(fsdp, tp)
    return (None,) * len(shape)


def _named(params) -> Dict[str, torch.Tensor]:
    """A module's ``state_dict`` names and tensors, or a mapping's."""
    if isinstance(params, nn.Module):
        return dict(params.state_dict(keep_vars=True))
    return dict(params)


def param_specs(params, rules: MeshRules) -> Dict[str, Spec]:
    """The spec of every parameter, by ``state_dict`` name: ``params`` is
    an `LM` or `EncDec` (on any device, ``meta`` included) or a mapping
    from such names to tensors."""
    return {k: _spec_for(k.replace(".", "/"), tuple(t.shape), rules)
            for k, t in _named(params).items()}


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dimension named at tensor dim ``d``, ``Replicate()`` on the
    rest."""
    out = [Replicate()] * len(mesh.mesh_dim_names)
    index = {a: i for i, a in enumerate(mesh.mesh_dim_names)}
    for d, axis in enumerate(spec):
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            if a is not None:
                out[index[a]] = Shard(d)
    return tuple(out)


def named_placements(params, rules: MeshRules) -> Dict[str, tuple]:
    """`placements` of every parameter's spec (the reference's
    ``named_shardings``)."""
    return {k: placements(s, rules.mesh)
            for k, s in param_specs(params, rules).items()}


def spec_bytes_per_device(shape: Tuple[int, ...], dtype: torch.dtype,
                          spec: Spec, rules: MeshRules) -> int:
    """Napkin-math per-device bytes of a tensor under a spec."""
    n = math.prod(shape) if shape else 1
    denom = 1
    for p in spec:
        denom *= rules.axis_size(p)
    return n * dtype.itemsize // max(denom, 1)


# ------------------------------------------------------------ batch split

class BatchSplit(NamedTuple):
    """This rank computes slice ``index`` of ``n`` equal slices of the
    batch; ``groups`` are the process groups (one per batch mesh
    dimension) whose sums give the whole batch's."""

    groups: Tuple[Any, ...]
    n: int
    index: int


_SPLIT: Optional[BatchSplit] = None


def split_ranks() -> int:
    """The number of batch slices the active split computes (1 with
    none)."""
    return 1 if _SPLIT is None else _SPLIT.n


@contextlib.contextmanager
def split_batch(split: Optional[BatchSplit]) -> Iterator:
    """Bind ``split`` while this rank computes its slice: sums over the
    whole batch (`split_sum`) then reach the other slices' ranks."""
    global _SPLIT
    prev, _SPLIT = _SPLIT, split
    try:
        yield split
    finally:
        _SPLIT = prev


def _stage(t: torch.Tensor, group) -> bool:
    """gloo's support of CUDA tensors differs between builds: a gloo
    group always takes them through host memory."""
    return t.device.type != "cpu" and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None
               ) -> torch.Tensor:
    """``dist.all_reduce`` of ``t`` in place over ``group``, through host
    memory on a gloo group holding a CUDA tensor; returns ``t``.  Every
    rank receives the same bits (the backend's ring hands each reduced
    chunk to every rank)."""
    if _stage(t, group):
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """``dist.broadcast`` of ``t`` in place from global rank ``src``,
    through host memory on a gloo group holding a CUDA tensor."""
    if _stage(t, group):
        host = t.cpu()
        dist.broadcast(host, src=src, group=group)
        t.copy_(host)
    else:
        dist.broadcast(t, src=src, group=group)
    return t


def reduce_scatter(out: torch.Tensor, t: torch.Tensor, group=None
                   ) -> torch.Tensor:
    """``dist.reduce_scatter_tensor``: ``t``'s equal chunks, one for each
    rank of ``group`` in its rank order, summed over the group, this
    rank's into ``out``; through host memory on a gloo group holding a
    CUDA tensor.  Returns ``out``."""
    if _stage(t, group):
        host = out.new_empty(out.shape, device="cpu")
        dist.reduce_scatter_tensor(host, t.cpu(), group=group)
        out.copy_(host)
    else:
        dist.reduce_scatter_tensor(out, t, group=group)
    return out


def reduce_over(t: torch.Tensor, groups: Sequence[Any],
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced in place over each group of ``groups`` in turn (a
    reduction over the product of their ranks), skipping groups of one
    rank; returns ``t``."""
    for g in groups:
        if dist.get_world_size(g) > 1:
            all_reduce(t, op=op, group=g)
    return t


def split_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the active split's slices, detached (a new
    tensor); ``x`` itself with no split or a split of one."""
    if _SPLIT is None or _SPLIT.n == 1:
        return x
    return reduce_over(x.detach().clone(), _SPLIT.groups)


# ---------------------------------------------------------- gather at use

_AT_USE: Optional[Callable[[nn.Module], Any]] = None


@contextlib.contextmanager
def gather_at_use(gather: Callable[[nn.Module], Any]) -> Iterator:
    """Bind ``gather`` while a sharded step runs the model: `at_use` then
    hands the model code ``gather(module)``."""
    global _AT_USE
    prev, _AT_USE = _AT_USE, gather
    try:
        yield gather
    finally:
        _AT_USE = prev


def at_use(module: nn.Module) -> Any:
    """The weights of ``module`` (a block, or a model's top level) as the
    model code reads them where it uses them: ``module`` itself, or under
    `gather_at_use` the bound gather's view of it, its weights whole (a
    view it handed out before is returned as it is)."""
    if _AT_USE is None or not isinstance(module, nn.Module):
        return module
    return _AT_USE(module)
