"""Window/step scheduling engine, batched kernel form (paper §3.2).

Counterpart of the JAX package's ``core/engine.py``, cut to
`run_stream_batch` in its kernel forms: a ``(T,)`` batch of trials, or a
``(T, C)`` batch of trials × private-log clients (the per_client model).
The request time series is split into fixed-size windows; within a window
same-object requests are grouped into one step (the object is fetched
once, paper Fig. 7); the whole batch of streams is then scheduled in one
launch of the stream kernel (plus, for ``(T, C)``, one launch of the
cross-client merge), and the host-side bookkeeping (redirects, the
step-to-request scatter, per-server counts, probes, the virtual clock)
runs as plain tensor code afterwards.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import policy_core
from repro_torch.core.policies import PolicyConfig, validate_policy
from repro_torch.core.policy_core import F32, f32
from repro_torch.core.statlog import LogConfig, SchedState
from repro_torch.kernels.sched_select import ops as kops
from repro_torch.tune import profile as tune_profile

# Policies the trial-grid kernel schedules (the paper's §3.4 library).
KERNEL_POLICIES = ("ect", "trh", "mlml", "nltr", "rr", "two_choice")

INT32_MAX = 2 ** 31 - 1


class Workload(NamedTuple):
    """A batch of I/O requests (``valid`` marks padding)."""

    object_ids: torch.Tensor  # (..., R) int32
    lengths: torch.Tensor     # (..., R) float32, MB
    valid: torch.Tensor       # (..., R) bool

    @property
    def n_requests(self) -> int:
        return self.object_ids.shape[-1]


class ClusterTrace(NamedTuple):
    """Piecewise-constant service rates: from ``times[e]`` on, server i
    serves at ``rates[e, i]`` MB/s (``times[0] == 0``)."""

    times: torch.Tensor  # (..., E) float32, ascending
    rates: torch.Tensor  # (..., E, M) float32

    @property
    def n_events(self) -> int:
        return self.times.shape[-1]


class ScheduleResult(NamedTuple):
    state: SchedState
    chosen: torch.Tensor        # (..., R) int32 server per request
    probe_msgs: torch.Tensor    # (...) int32 probe messages issued
    redirected: torch.Tensor    # (..., R) bool chosen != default home
    latencies: torch.Tensor     # (..., R) float32 est. completion latency, s
    window_loads: torch.Tensor  # (..., W, M) post-drain load snapshots


class ClientMerge(NamedTuple):
    """Per-trial cross-client aggregates of the ``(T, C)`` form, merged over
    the REAL clients (a client is real iff it scheduled a valid step)."""

    window_loads_mean: torch.Tensor  # (T, W, M) masked client-mean loads
    metrics: torch.Tensor            # (T, N_CMETRICS) merged MET_* rows
    lats: torch.Tensor               # (T, C, N) masked grouped-step latencies
    lats_valid: torch.Tensor         # (T, C, N) 0/1 float32 validity


def rates_at(trace: ClusterTrace, t: torch.Tensor) -> torch.Tensor:
    """Rates in effect at virtual times ``t`` (float32, shape (..., K)):
    returns (..., K, M)."""
    idx = (trace.times[..., None, :] <= t[..., :, None]).sum(dim=-1) - 1
    idx = idx.clamp(0, trace.n_events - 1)
    m = trace.rates.shape[-1]
    gather_idx = idx[..., :, None].expand(*idx.shape, m)
    return torch.gather(trace.rates, -2, gather_idx)


def _window_split(work: Workload, window_size: int):
    """Pad the streams to a multiple of ``window_size`` (padding invalid)
    and reshape to (..., W, window_size)."""
    r = work.n_requests
    n_win = -(-r // window_size)
    pad = n_win * window_size - r

    def pad_to(a):
        if pad:
            a = torch.cat([a, a.new_zeros(a.shape[:-1] + (pad,))], dim=-1)
        return a.reshape(a.shape[:-1] + (n_win, window_size))

    return n_win, pad_to(work.object_ids), pad_to(work.lengths), \
        pad_to(work.valid)


def _window_rates(states: SchedState, traces: Optional[ClusterTrace],
                  n_win: int, window_dt: float) -> torch.Tensor:
    """(T, W, M) rates in effect at each window open; ``f32(w) * f32(dt)``
    against the float32 event times."""
    if traces is not None:
        t_open = (torch.arange(n_win, dtype=F32, device=traces.times.device)
                  * f32(window_dt, traces.times))
        t_open = t_open.expand(traces.times.shape[:-1] + (n_win,))
        return rates_at(traces, t_open)
    return states.rates[..., None, :].expand(
        states.rates.shape[:-1] + (n_win, states.rates.shape[-1]))


def group_by_object_with_map(work: Workload) -> Tuple[Workload, torch.Tensor]:
    """Form steps along the last axis: the first occurrence of each object
    (in stable object-id order) carries the summed length, its duplicates
    become invalid zero-length rows.  Also returns ``req_to_step``: for
    every original request, the row of its aggregated step.

    The duplicate lengths are summed left to right in stable sorted order,
    starting from 0.0 (the reference's segment-sum order), by a chain
    that adds one more duplicate per pass — no atomics, so the sum is the
    same on every run and device."""
    r = work.n_requests
    ids = torch.where(work.valid, work.object_ids.to(torch.int64),
                      torch.full_like(work.object_ids, INT32_MAX,
                                      dtype=torch.int64))
    s_ids, order = torch.sort(ids, dim=-1, stable=True)
    s_len = (torch.gather(work.lengths.to(F32), -1, order)
             * torch.gather(work.valid, -1, order).to(F32))
    is_first = torch.ones_like(s_ids, dtype=torch.bool)
    is_first[..., 1:] = s_ids[..., 1:] != s_ids[..., :-1]
    rows = torch.arange(r, device=ids.device).expand_as(s_ids)
    # rank of each row inside its group, and the longest group
    first_row = torch.cummax(
        torch.where(is_first, rows, torch.zeros_like(rows)), dim=-1).values
    rank_in_group = rows - first_row
    max_group = int(rank_in_group.max().item()) + 1 if r else 1
    run = torch.where(is_first, s_len, torch.zeros_like(s_len))
    for _ in range(max_group - 1):
        prev = torch.cat([torch.zeros_like(run[..., :1]), run[..., :-1]],
                         dim=-1)
        run = torch.where(is_first, s_len, prev + s_len)
    is_last = torch.ones_like(is_first)
    is_last[..., :-1] = is_first[..., 1:]
    # every group's total sits on its last row; move it to the first row
    last_row = torch.flip(torch.cummin(torch.flip(
        torch.where(is_last, rows, torch.full_like(rows, r)), [-1]),
        dim=-1).values, [-1])
    total = torch.gather(run, -1, last_row)
    agg_len = torch.where(is_first, total, torch.zeros_like(total))
    agg_valid = is_first & (s_ids != INT32_MAX)
    grouped = Workload(
        object_ids=torch.where(agg_valid, s_ids,
                               torch.zeros_like(s_ids)).to(torch.int32),
        lengths=agg_len,
        valid=agg_valid)
    inv_order = torch.empty_like(order).scatter_(-1, order, rows)
    req_to_step = torch.gather(first_row, -1, inv_order)
    return grouped, req_to_step


def _kernel_bookkeeping(states: SchedState, choices, lats, tables, wloads,
                        g_obj, g_val, val, req_to_step, rates_last, *,
                        policy: PolicyConfig, window_dt: float, n_win: int,
                        window_size: int, r: int) -> ScheduleResult:
    """The bookkeeping the kernel leaves behind, for a (T,) batch:
    redirects, the grouped-step -> request scatter, per-server counts,
    probe accounting and the virtual-clock replay.  Every op is exact
    (gathers, masks, integer sums) except the clock, a chain of W
    sequential float32 adds as in the reference's ``advance_time``.

    choices/lats: (T, N) over grouped steps; g_obj/g_val/val and
    req_to_step: (T, W, window_size); tables: (T, 4, M); wloads:
    (T, W, M); rates_last: (T, M)."""
    t = choices.shape[0]
    m = tables.shape[-1]
    chosen_w = choices.reshape(t, n_win, window_size).to(torch.int64)
    lat_w = lats.reshape(t, n_win, window_size)
    redir_w = (chosen_w != g_obj.to(torch.int64) % m) & g_val
    chosen_w = torch.gather(chosen_w, -1, req_to_step)
    lat_w = torch.gather(lat_w, -1, req_to_step)
    redir_w = torch.gather(redir_w, -1, req_to_step)
    lat_w = lat_w * val.to(F32)
    redir_w = redir_w & val

    counts = torch.zeros((t, m), dtype=torch.int32, device=choices.device)
    counts.scatter_add_(1, choices.to(torch.int64),
                        g_val.reshape(t, -1).to(torch.int32))
    if window_dt:
        vclock = states.vclock
        dt = f32(window_dt, vclock)
        for _ in range(n_win):
            vclock = vclock + dt
        free_at = vclock[:, None] + (
            tables[:, policy_core.ROW_LOADS]
            / torch.maximum(rates_last, f32(1e-6, rates_last)))
    else:
        vclock, free_at = states.vclock, states.free_at
    fstate = SchedState(log=tables, n_assigned=states.n_assigned + counts,
                        rates=rates_last, vclock=vclock, free_at=free_at)
    probes = (g_val.reshape(t, -1).sum(dim=-1)
              * policy.probes_per_request).to(torch.int32)
    return ScheduleResult(
        state=fstate,
        chosen=chosen_w.reshape(t, -1)[:, :r].to(torch.int32),
        probe_msgs=probes,
        redirected=redir_w.reshape(t, -1)[:, :r],
        latencies=lat_w.reshape(t, -1)[:, :r],
        window_loads=wloads)


def run_stream_batch(states: SchedState, works: Workload, seeds: torch.Tensor,
                     *, policy: PolicyConfig, log_cfg: LogConfig,
                     window_size: int,
                     traces: Optional[ClusterTrace] = None,
                     window_dt: float = 0.0, observe: Optional[bool] = None,
                     trial_tile=None, client_tile=None, ablate: int = 0,
                     stream_batch=kops.sched_stream_batch,
                     stream_grid=kops.sched_stream_grid):
    """A batch of windowed streams scheduled in one kernel launch.

    ``states``/``works``/``seeds`` carry a leading ``(T,)`` trial axis, or
    ``(T, C)`` trials × clients (the per_client model: each client
    schedules its private slice against its own log).  ``seeds`` holds
    uint32 LCG states (any integer dtype); ``traces`` (if given) are
    per-TRIAL `ClusterTrace`s, shared by a trial's clients.  Window ``w``
    opens at virtual time ``w * window_dt``; with a trace its rates are
    looked up there, and after the window the queues drain for
    ``window_dt`` seconds.  ``trial_tile`` is the stream kernel's warps
    per block (a launch shape; None: the kernel's default).
    ``client_tile`` (``(T, C)`` only) is the cross-client merge's
    association width (see `ops.sched_stream_grid`).  ``ablate`` (``(T,)``
    only) drops the kernel's trailing phases for the differential phase
    profile (`repro_torch.tune.profile.kernel_phase_profile`); outputs
    past the dropped phase are zeros, so a nonzero level is for timing.
    The three stages run under `tune.profile.stage` ("engine_prep",
    "kernel", "book"), inert unless a profile is collected.

    ``stream_batch`` / ``stream_grid`` schedule the ``(T,)`` / ``(T, C)``
    forms; the defaults are the kernel dispatch.  Passing
    `ops.sched_stream_batch_plain` / `ops.sched_stream_grid_plain` runs
    the same pipeline through the plain PyTorch version on the same
    device, which is how the kernels are held against it end to end on
    the card.

    Returns ``(result, metrics, merged)``: a `ScheduleResult` with the
    leading batch axes on every field, the kernel's fused
    (..., N_METRICS) per-stream metric rows in `policy_core.MET_*` order,
    and the `ClientMerge` of the ``(T, C)`` form (None for ``(T,)``)."""
    validate_policy(policy, states.n_servers)
    if policy.name not in KERNEL_POLICIES:
        raise ValueError(f"run_stream_batch supports {KERNEL_POLICIES}, "
                         f"got {policy.name!r}")
    batch_shape = tuple(works.object_ids.shape[:-1])
    if len(batch_shape) not in (1, 2) or \
            tuple(states.log.shape[:-2]) != batch_shape:
        raise ValueError(
            f"works carry batch axes {batch_shape} and states "
            f"{tuple(states.log.shape[:-2])}: both must be (T,) or (T, C)")
    two_d = len(batch_shape) == 2
    if ablate and two_d:
        raise ValueError("ablate profiling levels support the trial-grid "
                         "(1-D) form only")
    if observe is None:
        observe = traces is not None
    r = works.object_ids.shape[-1]
    m = states.n_servers
    with tune_profile.stage("engine_prep"):
        n_win, obj, lens, val = _window_split(works, window_size)
        (g_obj, g_lens, g_val), req_to_step = group_by_object_with_map(
            Workload(obj, lens, val))
        # rates are per trial: a trial's clients share its cluster
        rate_states = states._replace(rates=states.rates[:, 0]) if two_d \
            else states
        win_rates = _window_rates(rate_states, traces, n_win, window_dt)
    kw = dict(n_servers=m, window_size=window_size,
              threshold=policy.threshold, lam=log_cfg.lam,
              alpha=log_cfg.ewma_alpha, window_dt=window_dt,
              policy=policy.name, observe=observe, renorm=log_cfg.renorm,
              nltr_n=policy.nltr_n, probe_choices=policy.probe_choices,
              trial_tile=trial_tile)
    steps = lambda x: x.reshape(batch_shape + (-1,))  # noqa: E731
    merged = None
    with tune_profile.stage("kernel"):
        if two_d:
            (choices, lats, tables, wloads, metrics, cm_wl, cm_met, cm_lats,
             cm_lval) = stream_grid(steps(g_obj), steps(g_lens),
                                    steps(g_val), states.log, seeds,
                                    win_rates, client_tile=client_tile, **kw)
            merged = ClientMerge(window_loads_mean=cm_wl, metrics=cm_met,
                                 lats=cm_lats, lats_valid=cm_lval)
        else:
            choices, lats, tables, wloads, metrics = stream_batch(
                steps(g_obj), steps(g_lens), steps(g_val), states.log,
                seeds, win_rates, ablate=ablate, **kw)
    with tune_profile.stage("book"):
        # the bookkeeping runs over the flat T·C streams, each with its
        # trial's last rates
        rates_last = win_rates[:, -1]
        if two_d:
            rates_last = rates_last[:, None].expand(batch_shape + (m,))
        flat = lambda x: x.flatten(0, len(batch_shape) - 1)  # noqa: E731
        res = _kernel_bookkeeping(
            SchedState(*map(flat, states)), flat(choices), flat(lats),
            flat(tables), flat(wloads), flat(g_obj), flat(g_val), flat(val),
            flat(req_to_step), flat(rates_last), policy=policy,
            window_dt=window_dt, n_win=n_win, window_size=window_size, r=r)
        unflat = lambda x: x.unflatten(0, batch_shape)  # noqa: E731
        result = ScheduleResult(SchedState(*map(unflat, res.state)),
                                *map(unflat, res[1:]))
    return result, metrics, merged
