"""The stream scheduling kernels: CUDA kernels, launch wrappers, plain
PyTorch versions and dispatch."""

from repro_torch.kernels.sched_select.ops import (POLICIES, sched_select,
                                                  sched_select_plain,
                                                  sched_stream,
                                                  sched_stream_batch,
                                                  sched_stream_batch_plain,
                                                  sched_stream_grid,
                                                  sched_stream_grid_plain)
from repro_torch.kernels.sched_select.ref import (sched_stream_batch_ref,
                                                  sched_stream_grid_ref)

__all__ = ["POLICIES", "sched_select", "sched_select_plain",
           "sched_stream", "sched_stream_batch",
           "sched_stream_batch_plain", "sched_stream_grid",
           "sched_stream_grid_plain", "sched_stream_batch_ref",
           "sched_stream_grid_ref"]
