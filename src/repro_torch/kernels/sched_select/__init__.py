"""The trial-grid stream scheduling kernel: CUDA kernel, launch wrapper,
plain PyTorch version and dispatch."""

from repro_torch.kernels.sched_select.ops import (POLICIES,
                                                  sched_stream_batch,
                                                  sched_stream_batch_plain)
from repro_torch.kernels.sched_select.ref import sched_stream_batch_ref

__all__ = ["POLICIES", "sched_stream_batch", "sched_stream_batch_plain",
           "sched_stream_batch_ref"]
