"""Dispatch of the threefry hash: the CUDA kernel for a CUDA tensor, the
plain PyTorch version for a CPU tensor.  There is no fallback: a kernel
that cannot build or launch raises.  `threefry_counters_plain` runs the
plain version on whatever device the keys lie on: what the kernel is held
against on the card."""

from __future__ import annotations

import torch

from repro_torch.kernels.threefry.kernel import threefry_counters_call
from repro_torch.kernels.threefry.ref import threefry_counters_ref


def threefry_counters(keys: torch.Tensor, n: int, count_lo: int = 0,
                      xor: bool = False) -> torch.Tensor:
    """For every key of ``keys`` (..., 2) (int64 holding uint32) and every
    ``j < n``, threefry2x32 of the counter pair ``(0, count_lo + j)``:
    (..., n, 2) int64 holding the two words, or (..., n) their xor when
    ``xor``."""
    if keys.ndim < 1 or keys.shape[-1] != 2:
        raise ValueError(f"keys must be (..., 2) threefry keys, got shape "
                         f"{tuple(keys.shape)}")
    if keys.device.type == "cuda":
        return threefry_counters_call(keys.contiguous(), n, count_lo, xor)
    if keys.device.type == "cpu":
        return threefry_counters_ref(keys, n, count_lo, xor)
    raise ValueError(f"no threefry implementation for {keys.device}")


def threefry_counters_plain(keys: torch.Tensor, n: int, count_lo: int = 0,
                            xor: bool = False) -> torch.Tensor:
    """The plain version on the keys' own device."""
    return threefry_counters_ref(keys, n, count_lo, xor)
