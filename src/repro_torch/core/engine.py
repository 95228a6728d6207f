"""Window/step scheduling engine, trial-batch kernel form (paper §3.2).

Counterpart of the JAX package's ``core/engine.py``, cut to
`run_stream_batch` in its ``(T,)`` kernel form.  The request time series
is split into fixed-size windows; within a window same-object requests
are grouped into one step (the object is fetched once, paper Fig. 7);
the whole batch of streams is then scheduled in one launch of the
trial-grid kernel, and the host-side bookkeeping (redirects, the
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
                     stream_batch=kops.sched_stream_batch):
    """A (T,) batch of windowed streams scheduled in one kernel launch.

    ``states``/``works`` carry a leading trial axis; ``seeds`` is the
    (T,) tensor of uint32 LCG states (any integer dtype); ``traces`` (if
    given) per-trial `ClusterTrace`s.  Window ``w`` opens at virtual time
    ``w * window_dt``; with a trace its rates are looked up there, and
    after the window the queues drain for ``window_dt`` seconds.

    ``stream_batch`` is the scheduling function; the default is the
    kernel dispatch (`ops.sched_stream_batch`).  Passing
    `ops.sched_stream_batch_plain` runs the same pipeline through the
    plain PyTorch version on the same device, which is how the kernel is
    held against it end to end on the card.

    Returns ``(result, metrics)``: a `ScheduleResult` with a leading
    trial axis on every field, and the kernel's fused (T, N_METRICS)
    metric rows in `policy_core.MET_*` order."""
    validate_policy(policy, states.n_servers)
    if policy.name not in KERNEL_POLICIES:
        raise ValueError(f"run_stream_batch supports {KERNEL_POLICIES}, "
                         f"got {policy.name!r}")
    if works.object_ids.ndim != 2:
        raise NotImplementedError(
            "run_stream_batch takes a (T,) trial batch; the (T, C) "
            "per_client form waits for ROADMAP Queue B2")
    if observe is None:
        observe = traces is not None
    t, r = works.object_ids.shape
    m = states.n_servers
    n_win, obj, lens, val = _window_split(works, window_size)
    (g_obj, g_lens, g_val), req_to_step = group_by_object_with_map(
        Workload(obj, lens, val))
    win_rates = _window_rates(states, traces, n_win, window_dt)
    choices, lats, tables, wloads, metrics = stream_batch(
        g_obj.reshape(t, -1), g_lens.reshape(t, -1), g_val.reshape(t, -1),
        states.log, seeds, win_rates, n_servers=m, window_size=window_size,
        threshold=policy.threshold, lam=log_cfg.lam,
        alpha=log_cfg.ewma_alpha, window_dt=window_dt, policy=policy.name,
        observe=observe, renorm=log_cfg.renorm, nltr_n=policy.nltr_n,
        probe_choices=policy.probe_choices)
    result = _kernel_bookkeeping(
        states, choices, lats, tables, wloads, g_obj, g_val, val,
        req_to_step, win_rates[:, -1], policy=policy, window_dt=window_dt,
        n_win=n_win, window_size=window_size, r=r)
    return result, metrics
