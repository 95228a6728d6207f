"""Gradient compression: int8 error-feedback all-reduce.

The port's counterpart of the JAX package's ``train/compression.py``.
At 1000+ nodes the data-parallel gradient all-reduce crosses pod
boundaries (slow links).  This module provides a quantized collective
for that axis:

    q = round(g / scale) in int8, scale = max|g + e| / 127 (per leaf)
    sum q over the DP ranks, dequantize, carry the residual e forward

Error feedback keeps the *accumulated* quantization error in the update
path, so SGD-style convergence is preserved (Karimireddy et al., 2019).
An int8 payload would drop the wire bytes 4x against float32; this
collective sums the payload widened to int32 (below), so it sends as
many bytes as a float32 sum, and `wire_bytes` is the reference's
estimate of an int8 payload, not a count of what it sends.

Usable two ways:

* across the ranks of a process group (or a mesh dimension) —
  :func:`compressed_psum`, every rank calling it;
* as a pure single-process transform for tests — :func:`quantize` /
  :func:`dequantize` round-trip with explicit error state.

The arithmetic is the reference's, in float32 and in its order; every
division is by a tensor (PyTorch turns ``tensor / number`` into a
multiplication by the reciprocal on the card).  ``torch.round`` rounds
half to even, as ``jnp.round`` does.  Grads are a mapping from name to
tensor (a ``state_dict``'s names, as the optimizer's).
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel import sharding as PS

Tree = Mapping[str, torch.Tensor]


class EFState(NamedTuple):
    """Per-leaf error-feedback residuals (the grads' names)."""
    residual: Dict[str, torch.Tensor]


def init_ef(grads: Tree) -> EFState:
    return EFState(residual={k: torch.zeros_like(g, dtype=torch.float32)
                             for k, g in grads.items()})


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax / amax.new_tensor(127.0), min=1e-12)


def _round(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def quantize(g: torch.Tensor, e: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(g + e) -> int8 q with per-tensor scale; returns (q, scale, new_e)."""
    x = g.float() + e
    scale = _scale(torch.max(torch.abs(x)))
    q = _round(x, scale)
    new_e = x - q.float() * scale
    return q, scale, new_e


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _group(group):
    """A process group from a group or a one-dimensional ``DeviceMesh``
    (a mesh dimension: ``mesh["data"]``)."""
    if hasattr(group, "get_group"):
        return group.get_group()
    return group


def compressed_psum(grads: Tree, ef: EFState, group=None
                    ) -> Tuple[Dict[str, torch.Tensor], EFState]:
    """Mean-all-reduce of ``grads`` over ``group`` (a process group, a
    mesh dimension, or None: the world) in int8 wire format; every rank
    of the group calls it.

    The shared-scale scheme: the scale is ``max|g + e|`` MAX-reduced over
    the ranks, over 127, so every rank quantizes against the same grid;
    the int8 payloads are widened to int32 and SUM-reduced (integer sums
    are exact, so the order of addition does not matter, and an int8 sum
    of n ranks could overflow: the collective carries 4 bytes an
    element); the mean is ``summed * scale / n`` in float32, cast to the
    grad's dtype."""
    group = _group(group)
    n = dist.get_world_size(group)
    new_g, new_e = {}, {}
    for k, g in grads.items():
        x = g.float() + ef.residual[k]
        gmax = PS.all_reduce(torch.max(torch.abs(x)), dist.ReduceOp.MAX,
                             group)
        scale = _scale(gmax)
        q = _round(x, scale)
        new_e[k] = x - q.float() * scale
        summed = PS.all_reduce(q.to(torch.int32), group=group)
        mean = summed.float() * scale / scale.new_tensor(float(n))
        new_g[k] = mean.to(g.dtype)
    return new_g, EFState(residual=new_e)


def wire_bytes(grads: Tree, compressed: bool) -> int:
    """The JAX package's estimate of the ring-all-reduce wire bytes per
    step for the DP axis (2(n-1)/n ~ 2x payload), 1 byte an element
    compressed: an int8 payload's.  `compressed_psum` sends its payload
    widened to int32, 4 bytes an element, as the uncompressed count."""
    return 2 * sum(g.numel() * (1 if compressed else 4)
                   for g in grads.values())
