"""The threefry2x32 hash: CUDA kernel, launch wrapper, plain PyTorch
version and dispatch."""

from repro_torch.kernels.threefry.ops import (threefry_counters,
                                              threefry_counters_plain)
from repro_torch.kernels.threefry.ref import threefry2x32

__all__ = ["threefry_counters", "threefry_counters_plain", "threefry2x32"]
