"""Window/step scheduling engine (paper §3.2).

Counterpart of the JAX package's ``core/engine.py``.  The request time
series is split into fixed-size windows; within a window same-object
requests are grouped into one step (the object is fetched once, paper
Fig. 7) and the steps are scheduled one after another against the
client-side log.  Two backends run it:

* ``"kernel"`` — the stream kernel: `run_stream_batch` schedules a
  ``(T,)`` batch of trials, or a ``(T, C)`` batch of trials × private-log
  clients (the per_client model), in one launch (plus, for ``(T, C)``,
  one launch of the cross-client merge); `run_stream(backend="kernel")`
  one stream per launch.  The bookkeeping the kernel leaves behind
  (redirects, the step-to-request scatter, per-server counts, probes,
  the virtual clock) runs as plain tensor code afterwards.
* ``"jax"`` — the eager engine, named after the reference's backend (its
  ``lax.scan``): `run_window` composes `policies.plan_window`,
  `select_target_rng`, `apply_threshold` and the `statlog` updates, one
  request position at a time, each step one batch of tensor ops over
  every stream; `run_stream` loops over the windows.  It runs no kernel
  of its own but the threefry hash of its keys, and reads nothing back
  to the host inside its loops.  The randomized policies draw from the
  reference's threefry keys (``PolicyConfig(rng="jax")``, the default:
  `split(key, n_windows)` per stream, `split(window_key, r)` per request
  in plan order, every draw of a stream made before its first window)
  or from the stream kernel's LCG (``rng="lcg"``), with which the eager
  engine is bit-exact with the kernel path on every output.

Every entry takes threefry keys (`repro_torch.random`, int64
``(..., 2)``) where the reference does; a stream's LCG seed is
``random.bits(key)``, as there.

`run_stream_jit` of the reference is a ``jax.jit`` wrapper with no
counterpart here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import random
from repro_torch.core import policies as P
from repro_torch.core import policy_core, statlog
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
    rng: Optional[torch.Tensor] = None  # (...) final LCG state of the
    #                             eager engine (None on the kernel path)


class ClientMerge(NamedTuple):
    """Per-trial cross-client aggregates of the ``(T, C)`` form, merged over
    the REAL clients (a client is real iff it scheduled a valid step)."""

    window_loads_mean: torch.Tensor  # (T, W, M) masked client-mean loads
    #   (the raw masked client sums under merge_mean=False)
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
    # contract-ok: CC-SORT engine-side step grouping keeps backend argsort (§10)
    s_ids, order = torch.sort(ids, dim=-1, stable=True)
    s_len = (torch.gather(work.lengths.to(F32), -1, order)
             * torch.gather(work.valid, -1, order).to(F32))
    is_first = torch.ones_like(s_ids, dtype=torch.bool)
    is_first[..., 1:] = s_ids[..., 1:] != s_ids[..., :-1]
    rows = torch.arange(r, device=ids.device).expand_as(s_ids)
    # rank of each row inside its group, and the longest group
    # contract-ok: CC-CUMSUM integer prefix max of row indices — association-free (§9)
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
    # contract-ok: CC-CUMSUM integer prefix min of row indices — association-free (§9)
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


def group_by_object(work: Workload) -> Workload:
    return group_by_object_with_map(work)[0]


def _prep_streams(works: Workload, window_size: int, group_steps: bool):
    """The window split and step grouping both backends share: returns
    ``(n_win, steps, val, req_to_step)`` — the grouped steps and the
    original validity as (..., W, window_size), and for every original
    request the row of its step (the identity without grouping)."""
    n_win, obj, lens, val = _window_split(works, window_size)
    if group_steps:
        steps, req_to_step = group_by_object_with_map(
            Workload(obj, lens, val))
    else:
        steps = Workload(obj, lens, val)
        req_to_step = torch.arange(window_size, device=obj.device).expand(
            obj.shape)
    return n_win, steps, val, req_to_step


def _where_state(v: torch.Tensor, new: SchedState,
                 old: SchedState) -> SchedState:
    """Per stream, ``new`` where ``v`` holds and ``old`` elsewhere; a field
    that is one tensor in both is kept as it is."""
    def pick(a, b):
        if a is b:
            return a
        return torch.where(v.reshape(v.shape + (1,) * (a.ndim - v.ndim)),
                           a, b)
    return SchedState(*map(pick, new, old))


def _jax_draws(policy: PolicyConfig, keys: torch.Tensor, r: int,
               n_servers: int) -> Optional[torch.Tensor]:
    """A randomized policy's ``rng="jax"`` draws for windows of ``r``
    requests: the window keys ``keys`` (..., 2) split into one key per
    request position (plan order), each drawn as the reference's
    ``select_target`` draws it; (..., r, n_draws) int64.  None for a
    policy that draws nothing from keys."""
    if policy.name not in P.RANDOM_POLICIES or policy.rng != "jax":
        return None
    return P.draw_candidates(policy, random.split(keys, r), n_servers)


def _schedule_window(state: SchedState, work: Workload, rng: torch.Tensor,
                     *, policy: PolicyConfig, log_cfg: LogConfig,
                     observe: bool, drawn: Optional[torch.Tensor] = None):
    """The per-request loop of one window over grouped steps (..., R):
    the plan, then per position the target, the redirect guard, Eq.
    (1)-(3), the latency and the completion feedback; padding rows leave
    the state as it was (the LCG advances on them too).  ``drawn``
    (..., R, n_draws) holds a randomized policy's ``rng="jax"`` draws by
    plan position (`_jax_draws`).  Returns ``(state, rng, chosen int64,
    redirected, latencies)`` in step order, before the window's
    renormalisation."""
    r = work.n_requests
    m = state.n_servers
    plan = P.plan_window(policy, state, work.object_ids, work.lengths,
                         work.valid)
    sort = policy.name in ("mlml", "nltr")
    if sort:
        obj, lens, val = (torch.gather(x, -1, plan.order) for x in work)
    else:
        obj, lens, val = work
    defaults = obj.to(torch.int64) % m
    zero = policy_core.const(0.0, lens)
    eps9 = policy_core.const(1e-9, lens)
    chosen_at, lat_at = [], []
    for pos in range(r):
        ln, v = lens[..., pos], val[..., pos]
        if drawn is None:
            target, rng = P.select_target_rng(policy, plan, state, pos,
                                              obj[..., pos], ln, rng)
        else:
            target = P.select_drawn(policy, plan, state, pos, obj[..., pos],
                                    drawn[..., pos, :].unbind(-1))
        chosen = P.apply_threshold(policy, state, defaults[..., pos],
                                   target, ln)
        new = statlog.apply_assignment(state, chosen, ln, log_cfg)
        lat = statlog.estimated_latency(new, chosen)
        if observe:
            new = statlog.observe_completion(
                new, chosen, ln / torch.maximum(lat, eps9), log_cfg)
        state = _where_state(v, new, state)
        chosen_at.append(chosen)
        lat_at.append(torch.where(v, lat, zero))
    chosen = torch.stack(chosen_at, dim=-1)
    lat = torch.stack(lat_at, dim=-1)
    if sort:
        # plan order -> step order
        rank = torch.empty_like(plan.order).scatter_(
            -1, plan.order, policy_core.lanes(r, lat).expand(lat.shape))
        chosen, lat = (torch.gather(x, -1, rank) for x in (chosen, lat))
    redirected = (chosen != work.object_ids.to(torch.int64) % m) & work.valid
    return state, rng, chosen, redirected, lat * work.valid


def _initial_rng(seed, lead, device) -> torch.Tensor:
    """The LCG states as int64 holding uint32 (zeros without a seed)."""
    if seed is None:
        return torch.zeros(lead, dtype=torch.int64, device=device)
    return seed.to(torch.int64) & 0xFFFFFFFF


def run_window(state: SchedState, work: Workload, key: torch.Tensor, *,
               policy: PolicyConfig, log_cfg: LogConfig,
               group_steps: bool = True, observe: bool = False,
               rng0=None) -> ScheduleResult:
    """Schedule one time window's requests (..., R) against the log on the
    eager engine; ``chosen``/``redirected``/``latencies`` come back in the
    original request order (a step's requests share its decision).

    ``key`` (..., 2) is the window's threefry key: under ``rng="jax"`` a
    randomized policy draws from ``split(key, R)``, one key per request
    position in plan order, as the reference does.  ``observe`` folds
    each request's effective MB/s into the EWMA row right after its
    assignment.  ``rng0`` (...) seeds the LCG of the randomized policies
    under ``rng="lcg"``; its final state is ``ScheduleResult.rng``.
    ``window_loads`` is the (..., 1, M) final load row.  Grouping reads the longest object group back to the host
    once; the per-request loop reads nothing back."""
    validate_policy(policy, state.n_servers)
    orig = work
    req_to_step = None
    if group_steps:
        work, req_to_step = group_by_object_with_map(work)
    rng = _initial_rng(rng0, tuple(state.log.shape[:-2]), state.log.device)
    drawn = _jax_draws(policy, key, work.n_requests, state.n_servers)
    state, rng, chosen, redirected, latencies = _schedule_window(
        state, work, rng, policy=policy, log_cfg=log_cfg, observe=observe,
        drawn=drawn)
    if log_cfg.renorm:
        state = statlog.renormalize(state)
    if req_to_step is not None:
        chosen = torch.gather(chosen, -1, req_to_step)
        redirected = torch.gather(redirected, -1, req_to_step) & orig.valid
        latencies = torch.gather(latencies, -1, req_to_step) * orig.valid
    probes = (work.valid.sum(dim=-1)
              * policy.probes_per_request).to(torch.int32)
    return ScheduleResult(state=state, chosen=chosen.to(torch.int32),
                          probe_msgs=probes, redirected=redirected,
                          latencies=latencies,
                          window_loads=state.loads.unsqueeze(-2), rng=rng)


def _eager_streams(state: SchedState, steps: Workload, val: torch.Tensor,
                   req_to_step: torch.Tensor, win_rates: torch.Tensor,
                   keys: torch.Tensor, *, policy: PolicyConfig,
                   log_cfg: LogConfig, window_dt: float, observe: bool, r: int
                   ) -> ScheduleResult:
    """The eager engine over windowed streams: ``steps``, ``val`` and
    ``req_to_step`` as `_prep_streams` gives them, ``win_rates``
    (..., W, M) broadcasting against the states' leading shape (per-trial
    rates carry a client axis of 1), ``keys`` (..., 2) one per stream.
    Per window: the rates in effect, `_schedule_window`, the
    renormalisation, then the drain by the window's precomputed
    decrements; one LCG state per stream, ``bits(key)``, carries across
    the windows, and the ``rng="jax"`` draws of every window come from
    ``split(key, W)`` before the first."""
    n_win, window_size = steps.object_ids.shape[-2:]
    win_dec = policy_core.window_decrements(win_rates, window_dt)
    rng = random.bits(keys)
    drawn = _jax_draws(policy, random.split(keys, n_win), window_size,
                       state.n_servers)
    chosen, redirected, lats, wloads = [], [], [], []
    for w in range(n_win):
        state = state._replace(
            rates=win_rates[..., w, :].expand(state.rates.shape))
        state, rng, ch, rd, lat = _schedule_window(
            state, Workload(*(x[..., w, :] for x in steps)), rng,
            policy=policy, log_cfg=log_cfg, observe=observe,
            drawn=None if drawn is None else drawn[..., w, :, :])
        if log_cfg.renorm:
            state = statlog.renormalize(state)
        if window_dt:
            state = statlog.advance_time(state, window_dt,
                                         win_dec[..., w, :])
        chosen.append(ch)
        redirected.append(rd)
        lats.append(lat)
        wloads.append(state.loads)
    # step order -> original request order
    back = lambda x: torch.gather(torch.stack(x, dim=-2), -1,  # noqa: E731
                                  req_to_step)
    first = lambda x: x.flatten(-2)[..., :r]  # noqa: E731
    probes = (steps.valid.sum(dim=(-2, -1))
              * policy.probes_per_request).to(torch.int32)
    return ScheduleResult(
        state=state, chosen=first(back(chosen)).to(torch.int32),
        probe_msgs=probes, redirected=first(back(redirected) & val),
        latencies=first(back(lats) * val),
        window_loads=torch.stack(wloads, dim=-2), rng=rng)


def grouped_latency_block(works: Workload, latencies: torch.Tensor,
                          window_size: int, group_steps: bool = True):
    """The kernel's grouped-step latency block recovered from per-request
    latencies (..., R): the same window split and grouping, each step's
    latency the min over its requests (a step's requests share its bits,
    so this only selects).  Returns ``(lats, valid)`` (..., N) with
    ``N = W * window_size``, invalid steps 0.0."""
    n_win, steps, val, req_to_step = _prep_streams(works, window_size,
                                                   group_steps)
    pad = n_win * window_size - latencies.shape[-1]
    if pad:
        latencies = torch.cat(
            [latencies, latencies.new_zeros(latencies.shape[:-1] + (pad,))],
            dim=-1)
    lat_w = latencies.reshape(val.shape).to(F32)
    zero = f32(0.0, lat_w)
    if not group_steps:
        return torch.where(val, lat_w, zero).flatten(-2), val.flatten(-2)
    inf = torch.full_like(lat_w, float("inf"))
    g_lat = inf.scatter_reduce(-1, req_to_step, torch.where(val, lat_w, inf),
                               reduce="amin")
    g_lat = torch.where(steps.valid, g_lat, zero)
    return g_lat.flatten(-2), steps.valid.flatten(-2)


def run_stream(state: SchedState, work: Workload, key: torch.Tensor, *,
               policy: PolicyConfig, log_cfg: LogConfig, window_size: int,
               group_steps: bool = True,
               trace: Optional[ClusterTrace] = None, window_dt: float = 0.0,
               observe: Optional[bool] = None,
               backend: str = "jax") -> ScheduleResult:
    """Split a request stream (..., R) into windows and schedule each
    (§3.2); padding is invalid.  Window ``w`` opens at virtual time
    ``w * window_dt``: with a ``trace`` its rates are looked up there, and
    after the window the queues drain for ``window_dt`` seconds.
    ``observe`` defaults to on exactly when a trace is given.  ``key``
    (..., 2) holds each stream's threefry key; the stream's LCG seed is
    ``random.bits(key)``, on both backends.

    ``backend="jax"`` (as in the reference, the default here) runs the
    eager engine over any leading batch axes; ``"kernel"`` runs the
    stream kernel, one launch per call, for one stream or a (T,) batch
    (`ops.sched_stream`).  The two agree bit for bit, the randomized
    policies under ``PolicyConfig(rng="lcg")``.  The kernel takes any
    window and padded server count: a stream past a block's shared
    memory runs in its global-memory instance
    (`kernels.sched_select.kernel.check_stream_domain`)."""
    validate_policy(policy, state.n_servers)
    if observe is None:
        observe = trace is not None
    if backend == "kernel":
        return _run_stream_kernel(state, work, key, policy=policy,
                                  log_cfg=log_cfg, window_size=window_size,
                                  group_steps=group_steps, trace=trace,
                                  window_dt=window_dt, observe=observe)
    if backend != "jax":
        raise ValueError(f"backend must be 'jax' or 'kernel', got {backend!r}")
    n_win, steps, val, req_to_step = _prep_streams(work, window_size,
                                                   group_steps)
    win_rates = _window_rates(state, trace, n_win, window_dt)
    return _eager_streams(state, steps, val, req_to_step, win_rates, key,
                          policy=policy, log_cfg=log_cfg,
                          window_dt=window_dt, observe=observe,
                          r=work.n_requests)


def _run_stream_kernel(state: SchedState, work: Workload, key: torch.Tensor,
                       *,
                       policy: PolicyConfig, log_cfg: LogConfig,
                       window_size: int, group_steps: bool,
                       trace: Optional[ClusterTrace], window_dt: float,
                       observe: bool) -> ScheduleResult:
    """The sequential kernel path: the same window split and grouping as
    the eager engine, one launch of the stream kernel for the stream (or
    a (T,) batch), then `_kernel_bookkeeping`."""
    if policy.name not in KERNEL_POLICIES:
        raise ValueError(f"backend='kernel' supports {KERNEL_POLICIES}, "
                         f"got {policy.name!r}")
    lead = tuple(state.log.shape[:-2])
    if len(lead) > 1:
        raise ValueError(
            f"run_stream(backend='kernel') takes one stream or a (T,) batch, "
            f"got states {lead}; a (T, C) batch goes through run_stream_batch")
    r = work.n_requests
    n_win, steps, val, req_to_step = _prep_streams(work, window_size,
                                                   group_steps)
    win_rates = _window_rates(state, trace, n_win, window_dt)
    flat = lambda x: x.reshape(lead + (-1,))  # noqa: E731
    choices, lats, table, wloads = kops.sched_stream(
        flat(steps.object_ids), flat(steps.lengths), flat(steps.valid),
        state.log, random.bits(key), win_rates, n_servers=state.n_servers,
        window_size=window_size, threshold=policy.threshold,
        lam=log_cfg.lam, alpha=log_cfg.ewma_alpha, window_dt=window_dt,
        policy=policy.name, observe=observe, renorm=log_cfg.renorm,
        nltr_n=policy.nltr_n, probe_choices=policy.probe_choices)
    one = (lambda x: x) if lead else (lambda x: x.unsqueeze(0))
    res = _kernel_bookkeeping(
        SchedState(*map(one, state)), one(choices), one(lats), one(table),
        one(wloads), one(steps.object_ids), one(steps.valid), one(val),
        one(req_to_step), one(win_rates[..., -1, :]), policy=policy,
        window_dt=window_dt, n_win=n_win, window_size=window_size, r=r)
    if lead:
        return res
    return ScheduleResult(SchedState(*(x[0] for x in res.state)),
                          *(x[0] for x in res[1:6]))


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


def run_stream_batch(states: SchedState, works: Workload, keys: torch.Tensor,
                     *, policy: PolicyConfig, log_cfg: LogConfig,
                     window_size: int,
                     traces: Optional[ClusterTrace] = None,
                     window_dt: float = 0.0, observe: Optional[bool] = None,
                     trial_tile=None, client_tile=None,
                     merge_mean: bool = True, ablate: int = 0,
                     backend: str = "kernel",
                     stream_batch=kops.sched_stream_batch,
                     stream_grid=kops.sched_stream_grid):
    """A batch of windowed streams scheduled in one kernel launch, or on
    the eager engine.

    ``states``/``works``/``keys`` carry a leading ``(T,)`` trial axis, or
    ``(T, C)`` trials × clients (the per_client model: each client
    schedules its private slice against its own log).  ``keys`` (...,
    2) are the streams' threefry keys; the kernel's LCG seeds are their
    ``random.bits``, as in the reference; ``traces`` (if given) are
    per-TRIAL `ClusterTrace`s, shared by a trial's clients.  Window ``w``
    opens at virtual time ``w * window_dt``; with a trace its rates are
    looked up there, and after the window the queues drain for
    ``window_dt`` seconds.  ``trial_tile`` is the stream kernel's warps
    per block (a launch shape; None: the kernel's default).
    ``client_tile`` (``(T, C)`` only) is the cross-client merge's
    association width (see `ops.sched_stream_grid`); ``merge_mean=False``
    has the merge return its raw masked client sums, the input of the
    sharded sweep (`repro_torch.parallel.sweep`), since a mean does not
    compose across ranks.  ``ablate`` (``(T,)``
    only) drops the kernel's trailing phases for the differential phase
    profile (`repro_torch.tune.profile.kernel_phase_profile`); outputs
    past the dropped phase are zeros, so a nonzero level is for timing.
    The stages run under `tune.profile.stage` ("engine_prep", then
    "kernel" and "book", or "eager" on the eager engine), inert unless a
    profile is collected.

    ``stream_batch`` / ``stream_grid`` schedule the ``(T,)`` / ``(T, C)``
    forms; the defaults are the kernel dispatch.  Passing
    `ops.sched_stream_batch_plain` / `ops.sched_stream_grid_plain` runs
    the same pipeline through the plain PyTorch version on the same
    device, which is how the kernels are held against it end to end on
    the card.

    ``backend="jax"`` schedules the same batch on the eager engine
    (`run_stream`'s jax path over the batch axes), bit-exact per stream
    with the kernel path (the randomized policies under
    ``PolicyConfig(rng="lcg")``), and returns ``(result, None, None)``:
    no fused metric rows and no merge.

    Returns ``(result, metrics, merged)``: a `ScheduleResult` with the
    leading batch axes on every field, the kernel's fused
    (..., N_METRICS) per-stream metric rows in `policy_core.MET_*` order,
    and the `ClientMerge` of the ``(T, C)`` form (None for ``(T,)``)."""
    validate_policy(policy, states.n_servers)
    if backend not in ("jax", "kernel"):
        raise ValueError(f"backend={backend!r} must be 'jax' or 'kernel'")
    if ablate and backend != "kernel":
        raise ValueError("ablate profiling levels need backend='kernel'")
    if backend == "kernel" and policy.name not in KERNEL_POLICIES:
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
        n_win, (g_obj, g_lens, g_val), val, req_to_step = _prep_streams(
            works, window_size, True)
        if backend == "jax" and traces is None:
            # each stream at its own state's rates
            win_rates = _window_rates(states, None, n_win, window_dt)
        else:
            # rates are per trial: a trial's clients share its cluster
            rate_states = states._replace(rates=states.rates[:, 0]) \
                if two_d else states
            win_rates = _window_rates(rate_states, traces, n_win, window_dt)
            if backend == "jax" and two_d:
                win_rates = win_rates[:, None]
        if backend == "kernel":
            seeds = random.bits(keys)
    if backend == "jax":
        with tune_profile.stage("eager"):
            res = _eager_streams(
                states, Workload(g_obj, g_lens, g_val), val, req_to_step,
                win_rates, keys, policy=policy, log_cfg=log_cfg,
                window_dt=window_dt, observe=observe, r=r)
        return res, None, None
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
                                    win_rates, client_tile=client_tile,
                                    merge_mean=merge_mean, **kw)
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
                                *map(unflat, res[1:6]))
    return result, metrics, merged
