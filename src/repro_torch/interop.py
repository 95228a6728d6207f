"""Carry a simulation's prepared inputs across as plain numpy arrays.

The JAX package draws its trial inputs with threefry, which the port does
not reproduce (its own `core.simulate._prep_trials` draws the same
distributions from a ``torch.Generator``).  To hold the port's scheduling
and post stages against the reference on identical inputs, a caller
computes the reference's prep, turns every array into numpy, and hands
them to `from_prep`: the result feeds `core.simulate._sched_trials` and
`_post_trials` directly.  This module takes numpy arrays only and imports
nothing of the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.engine import ClusterTrace, Workload
from repro_torch.core.statlog import SchedState


class PrepInputs(NamedTuple):
    """The (T,)-batched prep outputs in the port's structures."""

    init_loads: torch.Tensor       # (T, M) float32
    straggler_mask: torch.Tensor   # (T, M) bool
    works: Workload                # (T, R) requests
    states: SchedState             # (T, ...) logs and cluster truth
    traces: Optional[ClusterTrace]  # (T, E) times, (T, E, M) rates
    seeds: torch.Tensor            # (T,) or (T, C) int64 holding uint32
    #                                LCG states


def _t(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def from_prep(*, init_loads, straggler_mask, object_ids, lengths, valid,
              log, n_assigned, rates, vclock, free_at, seeds,
              trace_times=None, trace_rates=None,
              device="cpu") -> PrepInputs:
    """Build `PrepInputs` from numpy arrays with a leading trial axis:
    ``init_loads``/``straggler_mask`` (T, M); the workload's
    ``object_ids``/``lengths``/``valid`` (T, R); the state's ``log``
    (T, 4, M), ``n_assigned`` (T, M), ``rates`` (T, M), ``vclock`` (T,)
    and ``free_at`` (T, M); the optional trace's ``trace_times`` (T, E)
    and ``trace_rates`` (T, E, M); and ``seeds`` uint32, (T,) for the
    shared log or (T, C) for per_client (one state per client)."""
    f32, i32 = torch.float32, torch.int32
    works = Workload(object_ids=_t(object_ids, i32, device),
                     lengths=_t(lengths, f32, device),
                     valid=_t(valid, torch.bool, device))
    states = SchedState(log=_t(log, f32, device),
                        n_assigned=_t(n_assigned, i32, device),
                        rates=_t(rates, f32, device),
                        vclock=_t(vclock, f32, device),
                        free_at=_t(free_at, f32, device))
    traces = None
    if trace_times is not None:
        traces = ClusterTrace(times=_t(trace_times, f32, device),
                              rates=_t(trace_rates, f32, device))
    seeds64 = _t(np.asarray(seeds).astype(np.uint32).astype(np.int64),
                 torch.int64, device)
    return PrepInputs(init_loads=_t(init_loads, f32, device),
                      straggler_mask=_t(straggler_mask, torch.bool, device),
                      works=works, states=states, traces=traces,
                      seeds=seeds64)
