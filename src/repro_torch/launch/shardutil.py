"""Sharding-resolution helpers for the launchers: the port's counterpart of
the JAX package's ``launch/shardutil.py``.

A `Sharding` is a spec on a mesh (the JAX package's ``NamedSharding``):
`parallel.sharding.placements` turns it into DTensor placements.  The
mesh may be a `sharding.MeshShape`, so the production meshes' shardings
are computed without their ranks.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.parallel import sharding as PS
from repro_torch.train.optimizer import OptState
from repro_torch.train.steps import TrainState


class Sharding(NamedTuple):
    mesh: Any              # a DeviceMesh or a sharding.MeshShape
    spec: PS.Spec

    @property
    def placements(self) -> tuple:
        return PS.placements(self.spec, self.mesh)


def _resolve_role(role, dim: int, rules: PS.MeshRules):
    if role is None:
        return None
    if role == "batch":
        ax = rules.batch_axes
    elif role in ("model", "seq_model"):
        ax = rules.tp_axis
    elif role == "fsdp":
        ax = rules.fsdp_axis
    else:
        raise ValueError(role)
    if ax is None or dim % rules.axis_size(ax) != 0:
        return None
    # a tuple of one name is the name, as a JAX PartitionSpec keeps it
    return ax[0] if isinstance(ax, tuple) and len(ax) == 1 else ax


def roles_to_shardings(args_abs, roles, rules: PS.MeshRules):
    """`configs.shapes.input_specs`' role trees (a list per leaf, or
    None: replicated) -> `Sharding` trees shaped as ``args_abs``."""
    if isinstance(args_abs, torch.Tensor):
        if roles is None:
            return Sharding(rules.mesh, ())
        return Sharding(rules.mesh, tuple(
            _resolve_role(r, args_abs.shape[i], rules)
            for i, r in enumerate(roles)))
    if isinstance(args_abs, dict):
        return {k: roles_to_shardings(v, roles[k], rules)
                for k, v in args_abs.items()}
    return type(args_abs)(roles_to_shardings(v, r, rules)
                          for v, r in zip(args_abs, roles, strict=True))


def param_shardings(params_abs, rules: PS.MeshRules):
    """Every parameter's `Sharding`, by ``state_dict`` name."""
    return {k: Sharding(rules.mesh, s)
            for k, s in PS.param_specs(params_abs, rules).items()}


def state_shardings(state_abs: TrainState, rules: PS.MeshRules
                    ) -> TrainState:
    """TrainState shardings: the parameters by the rule table, m and v as
    their parameters, the counters replicated (ZeRO-1 falls out of the
    matching specs)."""
    pspecs = param_shardings(state_abs.params, rules)
    rep = Sharding(rules.mesh, ())
    return TrainState(params=pspecs,
                      opt=OptState(m=dict(pspecs), v=dict(pspecs),
                                   count=rep),
                      step=rep)
