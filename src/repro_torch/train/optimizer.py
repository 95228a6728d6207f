"""AdamW + global-norm clipping + warmup-cosine schedule.

The port's counterpart of the JAX package's ``train/optimizer.py``.
Parameters are an ``nn.Module`` (its ``named_parameters``, which for the
port's `LM` are its ``state_dict`` names) or a mapping from name to
tensor; the Adam moments ``m`` and ``v`` are dicts keyed by the same
names.  `update` writes the parameters and the moments in place (a
gemma-2b train state is 30 GB: a second copy would not fit on one card)
and returns them, with the new step count.

The arithmetic is the JAX package's, in float32 and in its order: the
bias corrections ``1 - b ** count`` as float32 powers, then
``upd = (m / b1c) / (sqrt(v / b2c) + eps)``, ``upd + wd * p`` where the
decay mask allows, ``p - lr * upd`` cast back to the parameter's dtype.
(``torch.optim.AdamW`` decays as ``p * (1 - lr * wd)`` before the step:
the same algebra, other roundings.)  Every division is by a tensor:
PyTorch turns ``number / tensor`` into a reciprocal times the number,
and on the card ``tensor / number`` into the tensor times a reciprocal.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, NamedTuple, Tuple, Union

import torch
from torch import nn

Named = Union[nn.Module, Mapping[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    count: torch.Tensor        # int32, 0-dim


def _named(params: Named) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init(params: Named) -> OptState:
    """Zero float32 moments keyed by the parameters' names, count 0, on
    the parameters' device."""
    named = _named(params)
    dev = next(iter(named.values())).device
    zeros = lambda: {k: torch.zeros_like(p, dtype=torch.float32)
                     for k, p in named.items()}
    return OptState(m=zeros(), v=zeros(),
                    count=torch.zeros((), dtype=torch.int32, device=dev))


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then cosine to ``min_lr_ratio`` of it
    at ``total_steps`` (float32, 0-dim)."""
    step = step.float()
    warm = cfg.peak_lr * step / step.new_tensor(max(cfg.warmup_steps, 1))
    prog = torch.clamp((step - cfg.warmup_steps) / step.new_tensor(
        max(cfg.total_steps - cfg.warmup_steps, 1)), 0.0, 1.0)
    cos = cfg.peak_lr * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The float32 L2 norm over every tensor of ``tree``, summed tensor by
    tensor in its order."""
    sq = sum(torch.sum(torch.square(x.float())) for x in tree.values())
    return torch.sqrt(sq)


@torch.no_grad()
def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float,
                        norm_fn=global_norm
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Scale ``grads`` in place by ``min(1, max_norm / norm)``; returns
    them and the norm before scaling, ``norm_fn(grads)`` (a sharded step
    passes the norm over every rank's shards)."""
    norm = norm_fn(grads)
    scale = torch.clamp(norm.new_tensor(max_norm)
                        / torch.clamp(norm, min=1e-9), max=1.0)
    for g in grads.values():
        g.mul_(scale.to(g.dtype))
    return grads, norm


# the JAX package's names of parameters that take no weight decay
NO_DECAY = ("scale", "bias", "b", "b_i", "b_f", "bq", "bk", "bv", "dt_bias",
            "ln_scale", "D")


def _decay_mask(name: str) -> bool:
    """No weight decay on norms/biases, by the last name of a
    ``state_dict`` key (the JAX package keys on a pytree path's)."""
    return name.rsplit(".", 1)[-1] not in NO_DECAY


@torch.no_grad()
def update(cfg: OptConfig, grads: Mapping[str, torch.Tensor],
           state: OptState, params: Named, norm_fn=global_norm
           ) -> Tuple[Named, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place; returns (params, new_state, metrics).
    ``grads`` maps each parameter's name to its gradient and is clipped
    in place by the norm ``norm_fn`` takes of them."""
    named = _named(params)
    grads, gnorm = clip_by_global_norm({k: grads[k] for k in named},
                                       cfg.clip_norm, norm_fn)
    count = state.count + 1
    lr = lr_at(cfg, count)
    c32 = count.float()
    b1c = 1 - torch.pow(c32.new_tensor(cfg.b1), c32)
    b2c = 1 - torch.pow(c32.new_tensor(cfg.b2), c32)
    for name, p in named.items():
        g32 = grads[name].float()
        m, v = state.m[name], state.v[name]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g32 * g32)
        denom = torch.sqrt(v / b2c).add_(cfg.eps)
        upd = (m / b1c).div_(denom)
        del denom
        p32 = p.float()
        if cfg.weight_decay and _decay_mask(name):
            upd.add_(cfg.weight_decay * p32)
        upd.mul_(lr)
        if p32 is p:
            p.sub_(upd)
        else:
            p.copy_(p32 - upd)
    return params, OptState(m=state.m, v=state.v, count=count), \
        {"grad_norm": gnorm, "lr": lr}
