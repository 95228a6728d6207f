"""Paper §4 simulation harness — the Monte-Carlo sweep.

Counterpart of the JAX package's ``core/simulate.py``: 100 object
storage servers, 2,000 I/O requests per trial in three size classes,
Normal initial loads, 100 trials, optional straggler injection and
temporal straggler scenarios, under one of two client models:

* ``shared_log`` — one log schedules each trial's whole stream (the
  paper's §4 setting);
* ``per_client`` — the contention study: each trial's stream is split
  over ``n_clients`` private logs that share the trial's initial loads
  and trace but never see each other's decisions; the window clamps to
  the per-client slice, and the cross-client aggregates (window-load
  mean, probe sum, makespan) are merged over the real clients.

`run_trials` composes three (T,)-batched stages:

* `_prep_trials`  — workloads, initial loads, the absorbed ``(4, M)`` log
  tables, the scenario rate traces and the scheduler keys, drawn from
  the trials' threefry keys (`repro_torch.random`) as the reference
  draws them, so one seed gives the reference's trials;
* `_sched_trials` — every stream in ONE launch of the stream kernel, plus
  one of the cross-client merge under per_client
  (`engine.run_stream_batch`), with the tiles resolved once by
  `repro_torch.tune.table.resolve_sim_tiles`; or, under
  ``SimConfig(backend="jax")``, on the eager engine, with the
  cross-client fold as tensor code at the same resolved client tile;
  under ``SimConfig(mesh_shape=...)`` sharded over the ranks of a
  ``torch.distributed`` world (`repro_torch.parallel.sweep`), every rank
  calling `run_trials` alike and receiving the whole result;
* `_post_trials`  — the per-trial `TrialResult` bookkeeping.

The port's default backend is ``"kernel"``; the reference's is ``"jax"``.
Both give the same `TrialResult` bit for bit (the randomized policies
under ``PolicyConfig(rng="lcg")``).  `run_one_trial` is the reference's
sequential single-trial oracle; `run_scenario_eval` and `run_paper_eval`
are its evaluation entry points, with its labels and defaults.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import warnings
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import random
from repro_torch.core import engine, policies, policy_core, statlog
from repro_torch.core.engine import ClusterTrace, Workload
from repro_torch.core.policies import PolicyConfig
from repro_torch.core.policy_core import F32, f32
from repro_torch.core.statlog import LogConfig, SchedState
from repro_torch.device import resolve_device
from repro_torch.kernels.sched_select import ops as kops
from repro_torch.parallel import sweep
from repro_torch.tune import profile as tune_profile
from repro_torch.tune import table as tune_table

SIZE_CLASSES = ("small", "medium", "large", "mixed")
SCENARIOS = ("static", "permanent_slow", "transient", "flapping",
             "correlated_rack")
# the policies of the temporal sweep: the paper's log-assisted ones and ect
SWEEP_POLICIES = ("rr", "mlml", "trh", "nltr", "ect")


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """Temporal straggler scenario: a per-trial `ClusterTrace` with a
    random straggler subset (or rack) slowed to ``base / slow_factor``."""

    name: str = "static"
    base_rate_mb_s: float = 200.0
    slow_factor: float = 8.0
    straggler_frac: float = 0.10
    # None -> the time in which the healthy cluster drains one window
    window_dt: Optional[float] = None
    onset: float = 0.25
    recover: float = 0.65
    n_flaps: int = 8
    rack_size: int = 8

    def __post_init__(self):
        if self.name not in SCENARIOS:
            raise ValueError(
                f"unknown scenario {self.name!r}; choose from {SCENARIOS}")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Paper §4 simulation parameters (defaults = the paper's numbers).

    ``client_tile`` is the association width of the per_client
    cross-client merge (None = `policy_core.DEFAULT_CLIENT_TILE`).
    ``trial_tile`` is the stream kernel's warps per block, a launch shape
    on which no result depends (None = the kernel's default).  ``tiles``
    picks how the pair resolves: "default" (the static resolvers),
    "fused" (the reference's fused client block: the same client tile)
    or "tuned" (the `repro_torch.tune` table's winner; a miss degrades to
    "fused"); explicit tiles always win (`tune.table.resolve_sim_tiles`).
    ``backend`` is "kernel" (the stream kernel, the port's default) or
    "jax" (the eager engine, the reference's default; its randomized
    policies draw from threefry keys under ``PolicyConfig(rng="jax")``
    and from the kernel's LCG under ``rng="lcg"``).  ``prep`` is
    "batched" (`_trial_setup` over the key batch) or "sequential" (one
    trial at a time: the parity oracle).  ``mesh_shape`` is None (one
    device) or ``(trials,)`` / ``(trials, clients)`` rank counts of the
    sharded sweep (`repro_torch.launch.mesh.make_sweep_mesh`), a client
    axis only under per_client; every rank of the world runs the same
    `run_trials` and gets the same result."""

    n_servers: int = 100
    n_clients: int = 200
    n_requests: int = 2000
    n_trials: int = 100
    workload: str = "mixed"
    window_size: int = 100
    init_load_mean: float = 50.0
    init_load_std: float = 5.0
    straggler_frac: float = 0.0
    straggler_factor: float = 5.0
    client_model: str = "shared_log"
    scenario: Optional[ScenarioConfig] = None
    backend: str = "kernel"
    trial_tile: Optional[int] = None
    client_tile: Optional[int] = None
    tiles: str = "default"
    prep: str = "batched"
    mesh_shape: Optional[Tuple[int, ...]] = None
    small_lo: float = 0.25
    small_hi: float = 4.0
    medium_hi: float = 10.0
    large_hi: float = 1024.0

    def __post_init__(self):
        if self.workload not in SIZE_CLASSES:
            raise ValueError(
                f"workload={self.workload!r} is not one of {SIZE_CLASSES}")
        if self.client_model not in ("shared_log", "per_client"):
            raise ValueError(
                f"client_model={self.client_model!r} must be 'shared_log' "
                "or 'per_client'")
        if self.backend not in ("jax", "kernel"):
            raise ValueError(
                f"backend={self.backend!r} must be 'jax' or 'kernel'")
        if self.n_clients < 1:
            raise ValueError(
                f"n_clients={self.n_clients!r} must be >= 1 (the "
                "per_client contention model partitions n_requests="
                f"{self.n_requests} over the clients)")
        if self.client_tile is not None and self.client_tile < 1:
            raise ValueError(
                f"client_tile={self.client_tile!r} must be a positive "
                "client count per merge block (or None for the default)")
        if self.trial_tile is not None and self.trial_tile < 1:
            raise ValueError(
                f"trial_tile={self.trial_tile!r} must be a positive count "
                "of warps per block (or None for the kernel's default)")
        if self.tiles not in tune_table.TILE_MODES:
            raise ValueError(
                f"tiles={self.tiles!r} must be one of "
                f"{tune_table.TILE_MODES}")
        if self.prep not in ("batched", "sequential"):
            raise ValueError(
                f"prep={self.prep!r} must be 'batched' (the trial prep over "
                "the key batch) or 'sequential' (one trial at a time, the "
                "parity oracle)")
        if self.mesh_shape is not None:
            try:
                ms = tuple(int(s) for s in self.mesh_shape)
            except (TypeError, ValueError):
                raise ValueError(
                    f"mesh_shape={self.mesh_shape!r} must be a tuple of 1 "
                    "or 2 positive rank counts ((trials,) or (trials, "
                    "clients)), or None for the single-device dispatch"
                ) from None
            object.__setattr__(self, "mesh_shape", ms)
            if len(ms) not in (1, 2) or any(s < 1 for s in ms):
                raise ValueError(
                    f"mesh_shape={ms!r} must be (trials,) or (trials, "
                    "clients) positive rank counts (or None for the "
                    "single-device dispatch)")
            if len(ms) == 2 and ms[1] > 1 \
                    and self.client_model != "per_client":
                raise ValueError(
                    f"mesh_shape={ms} shards a client axis but "
                    f"client_model={self.client_model!r} has none: use "
                    "client_model='per_client' or a (trials,) mesh")

    @property
    def n_windows(self) -> int:
        return -(-self.n_requests // self.window_size)


class TrialResult(NamedTuple):
    """Per-trial outputs, with a leading trial axis."""

    server_loads: torch.Tensor     # (T, M) final true load per server, MB
    n_assigned: torch.Tensor       # (T, M) int32 requests per server
    chosen: torch.Tensor           # (T, R) int32 server per request
    probe_msgs: torch.Tensor       # (T,) int32 probe messages issued
    straggler_hits: torch.Tensor   # (T,) int32 requests on stragglers
    redirected: torch.Tensor       # (T,) int32 requests redirected
    init_loads: torch.Tensor       # (T, M) initial loads
    straggler_mask: torch.Tensor   # (T, M) bool load-injected or slowed
    latencies: torch.Tensor        # (T, R) est. completion latency, s
    phase_time: torch.Tensor       # (T,) makespan, s
    window_loads: torch.Tensor     # (T, W, M) post-drain load snapshots
    #   (per_client: masked mean over the real clients' private views)
    window_size_eff: torch.Tensor  # (T,) int32 window size scheduled with
    #   (per_client: min(window_size, ceil(R / n_clients)))


def mean_request_mb(cfg: SimConfig) -> float:
    """Expected request size per workload class (MB)."""
    return {
        "small": (cfg.small_lo + cfg.small_hi) / 2,
        "medium": (cfg.small_hi + cfg.medium_hi) / 2,
        "large": (cfg.medium_hi + cfg.large_hi) / 2,
        "mixed": ((cfg.small_lo + cfg.small_hi) / 2
                  + (cfg.small_hi + cfg.medium_hi) / 2
                  + (cfg.medium_hi + cfg.large_hi) / 2) / 3,
    }[cfg.workload]


def expected_server_load_mb(cfg: SimConfig) -> float:
    """Expected final average per-server load from scheduling alone."""
    return cfg.n_requests * mean_request_mb(cfg) / cfg.n_servers


def _lead(keys: torch.Tensor) -> tuple:
    return tuple(keys.shape[:-1])


def _chosen_mask(idx: torch.Tensor, m: int) -> torch.Tensor:
    """(..., m) bool, true at the (..., k) indices ``idx``."""
    mask = torch.zeros(idx.shape[:-1] + (m,), dtype=torch.bool,
                       device=idx.device)
    return mask.scatter_(-1, idx, True)


def sample_workload(keys: torch.Tensor, cfg: SimConfig) -> Workload:
    """(..., R) synthetic request streams per §4's three size classes,
    one stream per key (..., 2): object ids uniform in ``[0, 8 M)``,
    lengths uniform in their class, drawn as the reference draws them
    (``split(key, 5)``: object ids, class, small, medium, large)."""
    r = cfg.n_requests
    k = random.split(keys, 5)
    key_of = lambda i: k[..., i, :]  # noqa: E731
    object_ids = random.randint(key_of(0), (r,), 0, 8 * cfg.n_servers)
    bounds = {"small": (2, cfg.small_lo, cfg.small_hi),
              "medium": (3, cfg.small_hi, cfg.medium_hi),
              "large": (4, cfg.medium_hi, cfg.large_hi)}
    draw = lambda c: random.uniform(  # noqa: E731
        key_of(bounds[c][0]), (r,), bounds[c][1], bounds[c][2])
    if cfg.workload != "mixed":
        lengths = draw(cfg.workload)
    else:
        cls = random.randint(key_of(1), (r,), 0, 3)
        lengths = torch.where(cls == 0, draw("small"),
                              torch.where(cls == 1, draw("medium"),
                                          draw("large")))
    return Workload(object_ids=object_ids, lengths=lengths,
                    valid=torch.ones(lengths.shape, dtype=torch.bool,
                                     device=keys.device))


def initial_loads(keys: torch.Tensor,
                  cfg: SimConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., M) Normal initial loads plus optional straggler injection, one
    row per key (..., 2) (``split(key)``: the normal, then the
    stragglers, ``choice`` without replacement): the stragglers carry
    ``straggler_factor`` times the run's expected per-server load on
    top."""
    m = cfg.n_servers
    k = random.split(keys)
    # the reference's ``std * normal``, the two constants folded as XLA
    # folds them
    noise = random.normal(k[..., 0, :], (m,), scale=cfg.init_load_std)
    big = f32(policy_core.BIG, noise)
    # the clamp keeps the add's operand from being a product, as in the
    # reference (no backend may contract it into a multiply-add)
    loads = f32(cfg.init_load_mean, noise) + torch.minimum(
        torch.maximum(noise, -big), big)
    loads = torch.clamp_min(loads, 0.0)
    n_strag = int(round(cfg.straggler_frac * m))
    if n_strag == 0:
        return loads, torch.zeros(loads.shape, dtype=torch.bool,
                                  device=keys.device)
    mask = _chosen_mask(random.choice(k[..., 1, :], m, (n_strag,)), m)
    extra = f32(cfg.straggler_factor * expected_server_load_mb(cfg), loads)
    return loads + torch.clamp_min(mask.to(F32) * extra, 0.0), mask


def absorb_initial_loads(state: SchedState, loads: torch.Tensor,
                         log_cfg: LogConfig) -> SchedState:
    """Fold known initial loads into the log: ``p_i ∝ (1/M) e^{-l_i/λ}``."""
    probs = policy_core.absorb_probs(loads, log_cfg.lam, state.n_servers)
    return state.with_rows(loads=loads.to(F32), probs=probs.to(F32))


def resolve_window_dt(cfg: SimConfig, scn: ScenarioConfig) -> float:
    """Virtual seconds per window; by default the time in which the
    healthy cluster drains one window's expected bytes."""
    if scn.window_dt is not None:
        return float(scn.window_dt)
    if scn.name == "static":
        return 0.0
    per_window_mb = cfg.window_size * mean_request_mb(cfg)
    return per_window_mb / (cfg.n_servers * scn.base_rate_mb_s)


def make_trace(keys: torch.Tensor, cfg: SimConfig,
               scn: ScenarioConfig) -> ClusterTrace:
    """Rate-event schedules, one per key (..., 2): the slow subset is
    ``choice(key, M, (n,), replace=False)``, or a rack at
    ``randint(key, (), 0, M - rack + 1)``, as in the reference; event
    times are fractions of the stream horizon ``n_windows * window_dt``.
    The event times are filled on the device, with no element written
    from the host."""
    m = cfg.n_servers
    lead = _lead(keys)
    dev = keys.device
    base = scn.base_rate_mb_s
    horizon = max(cfg.n_windows * resolve_window_dt(cfg, scn), 1e-6)
    base_row = torch.full(lead + (m,), base, dtype=F32, device=dev)

    def times_of(values):
        return torch.stack([torch.full(lead, v, dtype=F32, device=dev)
                            for v in values], dim=-1)

    if scn.name == "static":
        return ClusterTrace(times=times_of([0.0]),
                            rates=base_row.unsqueeze(-2))
    if scn.name == "correlated_rack":
        rack = min(scn.rack_size, m)
        start = random.randint(keys, (), 0, m - rack + 1,
                               dtype=torch.int64).unsqueeze(-1)
        idx = torch.arange(m, device=dev)
        mask = (idx >= start) & (idx < start + rack)
    else:
        n_strag = max(int(round(scn.straggler_frac * m)), 1)
        mask = _chosen_mask(random.choice(keys, m, (n_strag,)), m)
    slow_row = torch.where(mask, f32(base / scn.slow_factor, base_row),
                           base_row)
    if scn.name == "permanent_slow":
        return ClusterTrace(times=times_of([0.0]),
                            rates=slow_row.unsqueeze(-2))
    if scn.name == "transient":
        return ClusterTrace(
            times=times_of([0.0, scn.onset * horizon, scn.recover * horizon]),
            rates=torch.stack([base_row, slow_row, base_row], dim=-2))
    if scn.name == "flapping":
        n_ev = max(scn.n_flaps, 2)
        times = (torch.arange(n_ev, dtype=F32, device=dev)
                 * f32(horizon / n_ev, base_row)).expand(lead + (n_ev,))
        rows = torch.stack([base_row if e % 2 == 0 else slow_row
                            for e in range(n_ev)], dim=-2)
        return ClusterTrace(times=times, rates=rows)
    return ClusterTrace(times=times_of([0.0, scn.onset * horizon]),
                        rates=torch.stack([base_row, slow_row], dim=-2))


def trace_straggler_mask(trace: ClusterTrace,
                         scn: ScenarioConfig) -> torch.Tensor:
    """(T, M) bool: servers slow at any point of the trace."""
    thr = f32(scn.base_rate_mb_s * (1.0 - 1e-6), trace.rates)
    return (trace.rates < thr).any(dim=-2)


def _window_dt(cfg: SimConfig) -> float:
    return (resolve_window_dt(cfg, cfg.scenario)
            if cfg.scenario is not None else 0.0)


def _observe(cfg: SimConfig) -> bool:
    # the degenerate static scenario never observes (static-model parity)
    return cfg.scenario is not None and cfg.scenario.name != "static"


def _trial_setup(keys: torch.Tensor, cfg: SimConfig, log_cfg: LogConfig):
    """Per-trial simulation inputs for a key (2,), or a (T,) batch of
    keys (T, 2): ``(init_loads, straggler_mask, work, state, trace,
    k_sched)``, the reference's ``_trial_setup``: ``split(key, 3)`` into
    the loads', the workload's and the scheduler's keys, and the trace
    from ``fold_in(key, 0x7e3)`` (so the 3-way split stays that of the
    static path)."""
    k = random.split(keys, 3)
    init, strag_mask = initial_loads(k[..., 0, :], cfg)
    work = sample_workload(k[..., 1, :], cfg)
    lead = _lead(keys)
    state = statlog.init_state(log_cfg, batch=lead[0] if lead else None,
                               device=keys.device)
    state = absorb_initial_loads(state, init, log_cfg)
    trace = None
    if cfg.scenario is not None:
        trace = make_trace(random.fold_in(keys, 0x7e3), cfg, cfg.scenario)
        state = state._replace(rates=trace.rates[..., 0, :].contiguous())
    return init, strag_mask, work, state, trace, k[..., 2, :]


def _stack(parts):
    """Stack per-trial outputs (tensors, or named tuples of them, or
    None) along a new leading trial axis."""
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(parts)
    items = [_stack(list(x)) for x in zip(*parts)]
    return type(first)(*items) if hasattr(first, "_fields") else tuple(items)


def _prep_trials(keys: torch.Tensor, cfg: SimConfig, log_cfg: LogConfig):
    """Stage 1: ``(init_loads, straggler_mask, works, states, traces,
    k_sched)`` for the (T, 2) trial keys.  ``cfg.prep == "batched"`` runs
    `_trial_setup` once over the whole key batch; ``"sequential"`` runs
    it one trial at a time at unbatched shapes and stacks the trials —
    the reference's per-trial prep oracle, bit-identical to the batched
    prep (every op here is elementwise or per row, and the Eq. (2)
    normaliser goes through the pinned `policy_core.lane_sum`)."""
    if cfg.prep == "sequential":
        return _stack([_trial_setup(k, cfg, log_cfg) for k in keys])
    return _trial_setup(keys, cfg, log_cfg)


def _client_split_shape(cfg: SimConfig) -> Tuple[int, int, int, int]:
    """(n_clients, per-client slice length, tail padding, effective
    window size) of the per_client request partition."""
    c = cfg.n_clients
    per = -(-cfg.n_requests // c)
    pad = c * per - cfg.n_requests
    return c, per, pad, min(cfg.window_size, per)


def _split_clients(works: Workload, c: int, per: int, pad: int) -> Workload:
    """Partition (T, R) request streams into (T, C, per) client slices
    (tail padding invalid; trailing clients may be whole phantoms that
    schedule nothing when n_clients > n_requests)."""
    def sp(a):
        if pad:
            a = torch.cat([a, a.new_zeros(a.shape[:-1] + (pad,))], dim=-1)
        return a.reshape(a.shape[:-1] + (c, per))

    return Workload(*map(sp, works))


def _sched_trials(cfg: SimConfig, policy: PolicyConfig, log_cfg: LogConfig,
                  works: Workload, states: SchedState, k_sched: torch.Tensor,
                  traces: Optional[ClusterTrace],
                  stream_batch=kops.sched_stream_batch,
                  stream_grid=kops.sched_stream_grid):
    """Stage 2: every stream in one kernel launch (plus the cross-client
    merge under per_client), or on the eager engine under
    ``cfg.backend == "jax"``.  ``k_sched`` (T, 2) are the trials'
    scheduler keys; under per_client each trial's are ``split(k_sched,
    n_clients)``, one per client, as in the reference.  Returns
    ``(chosen, probes, redirected,
    latencies, window_loads, phase)`` per trial in original request
    order; ``phase`` is the kernel's fused makespan (merged over the real
    clients under per_client), the masked max of window-open time plus
    latency on the eager per_client path, and None on the eager shared
    log (`_post_trials` reduces it).  ``stream_batch``/``stream_grid``
    as in `engine.run_stream_batch`.

    per_client: the window clamps to the per-client slice (a warning
    names both sizes), while the window timing (``window_dt``) keeps the
    configured window size; the probe sum is an integer sum over the
    real clients; on the eager engine the window loads are
    `policy_core.masked_client_mean` at the resolved client tile, the
    association the merge kernel keeps.

    With ``cfg.mesh_shape`` the same dispatch runs sharded
    (`parallel.sweep.run_sweep`), and the per_client fold takes its
    `parallel.sweep.SweepMerge` rows."""
    window_dt = _window_dt(cfg)
    per_client = cfg.client_model == "per_client"
    # THE tile resolution point: the pair is resolved once, whichever mode
    # cfg.tiles selects, and threaded through every layer below
    trial_tile, client_tile = tune_table.resolve_sim_tiles(
        mode=cfg.tiles, policy=policy.name, backend=cfg.backend,
        n_servers=cfg.n_servers, n_requests=cfg.n_requests,
        n_clients=(cfg.n_clients if per_client else 1),
        n_trials=cfg.n_trials, window_size=cfg.window_size,
        device_count=math.prod(cfg.mesh_shape or (1,)),
        form=("grid" if per_client else "batch"),
        trial_tile=cfg.trial_tile, client_tile=cfg.client_tile)
    run = dict(policy=policy, log_cfg=log_cfg, traces=traces,
               window_dt=window_dt, observe=_observe(cfg),
               trial_tile=trial_tile, backend=cfg.backend,
               stream_batch=stream_batch, stream_grid=stream_grid)
    dispatch = engine.run_stream_batch
    if cfg.mesh_shape is not None:
        dispatch = functools.partial(sweep.run_sweep,
                                     mesh_shape=cfg.mesh_shape)
    eager = cfg.backend == "jax"
    if not per_client:
        res, metrics, _ = dispatch(
            states, works, k_sched, window_size=cfg.window_size, **run)
        phase = None if eager else metrics[:, policy_core.MET_MAKESPAN]
        return (res.chosen, res.probe_msgs, res.redirected, res.latencies,
                res.window_loads, phase)
    c, per, pad, win = _client_split_shape(cfg)
    if win < cfg.window_size:
        warnings.warn(
            f"per_client window clamp: window_size={cfg.window_size} "
            f"exceeds the per-client slice (n_requests={cfg.n_requests} "
            f"over n_clients={c} -> {per}/client); scheduling with "
            f"window_size_eff={win} — sweeps comparing window sizes across "
            "client counts are comparing different windows", stacklevel=2)
    t, r = works.object_ids.shape
    run_works = _split_clients(works, c, per, pad)
    run_states = SchedState(*(x[:, None].expand((t, c) + x.shape[1:])
                              for x in states))
    res, _, merged = dispatch(
        run_states, run_works, random.split(k_sched, c), window_size=win,
        client_tile=client_tile, **run)
    cvalid = run_works.valid.any(dim=-1)                      # (T, C)
    probes = torch.where(cvalid, res.probe_msgs, 0).sum(
        dim=-1, dtype=torch.int32)
    first = lambda x: x.reshape(t, c * per)[:, :r]  # noqa: E731
    if cfg.mesh_shape is not None:
        # the sharded sweep's collective merge, alike on both backends
        wl, phase, probes = (merged.window_loads_mean, merged.phase_time,
                             merged.probe_msgs)
    elif eager:
        # the cross-client fold the merge kernel makes, as tensor code
        wl = policy_core.masked_client_mean(
            res.window_loads.movedim(1, 0), cvalid.T, client_tile)
        w_open = ((torch.arange(per, device=k_sched.device) // win).to(F32)
                  * f32(window_dt, res.latencies))
        comp = torch.where(run_works.valid, w_open + res.latencies,
                           f32(0.0, res.latencies))
        phase = comp.amax(dim=(1, 2))
    else:
        wl = merged.window_loads_mean
        phase = merged.metrics[:, policy_core.MET_MAKESPAN]
    return (first(res.chosen), probes, first(res.redirected),
            first(res.latencies), wl, phase)


def _post_trials(cfg: SimConfig, init, strag_mask, works: Workload, traces,
                 chosen, probe_msgs, redirected, latencies, window_loads,
                 phase_time) -> TrialResult:
    """Stage 3: fold the scheduled streams into the (T,) `TrialResult`
    stack — the reference's vmapped ``_trial_result``.  The float
    per-server sum keeps the pinned `server_segment_sum` association; the
    integer counts are exact under any order.  ``phase_time=None``
    reduces the makespan here: the max over requests of the window-open
    time ``max(f32(w) * f32(window_dt), 0)`` plus the latency, as the
    kernel's fused metric and the reference's ``_trial_result`` do."""
    m = cfg.n_servers
    t = chosen.shape[0]
    if phase_time is None:
        w_open = torch.clamp_min(
            (torch.arange(cfg.n_requests, device=chosen.device)
             // cfg.window_size).to(F32)
            * f32(_window_dt(cfg), latencies), 0.0)
        phase_time = (w_open + latencies).amax(dim=-1)
    win = (_client_split_shape(cfg)[3] if cfg.client_model == "per_client"
           else cfg.window_size)
    chosen64 = chosen.to(torch.int64)
    written = policy_core.server_segment_sum(works.lengths, chosen64, m)
    n_assigned = torch.zeros((t, m), dtype=torch.int32, device=chosen.device)
    n_assigned.scatter_add_(1, chosen64, torch.ones_like(chosen))
    if cfg.scenario is not None:
        strag_mask = strag_mask | trace_straggler_mask(traces, cfg.scenario)
    hits = torch.gather(strag_mask, 1, chosen64).to(torch.int32).sum(
        dim=-1, dtype=torch.int32)
    return TrialResult(
        server_loads=init + written, n_assigned=n_assigned, chosen=chosen,
        probe_msgs=probe_msgs, straggler_hits=hits,
        redirected=redirected.to(torch.int32).sum(dim=-1, dtype=torch.int32),
        init_loads=init, straggler_mask=strag_mask, latencies=latencies,
        phase_time=phase_time, window_loads=window_loads,
        window_size_eff=torch.full((t,), win, dtype=torch.int32,
                                   device=chosen.device))


def _as_key(key_or_seed, device: torch.device) -> torch.Tensor:
    """An int seed as ``random.key(seed)``; a key (2,) moved to
    ``device``."""
    if isinstance(key_or_seed, torch.Tensor):
        return key_or_seed.to(device=device, dtype=torch.int64)
    return random.key(int(key_or_seed), device)


def trial_keys(key_or_seed, cfg: SimConfig, device) -> torch.Tensor:
    """The (T, 2) keys of `run_trials`' trials: ``split(key, n_trials)``
    of a key, or of ``random.key(seed)`` for an int seed."""
    return random.split(_as_key(key_or_seed, resolve_device(device)),
                        cfg.n_trials)


def run_trials(key_or_seed, cfg: SimConfig, policy: PolicyConfig,
               log_cfg: LogConfig, device="cuda") -> TrialResult:
    """Run ``cfg.n_trials`` independent trials: prep, one kernel launch
    for the whole sweep (and one of the cross-client merge under
    per_client) or the eager engine (``cfg.backend == "jax"``), post.
    The stages run under `tune.profile.stage` ("prep", "sched", "post"),
    inert unless a profile is collected.

    ``key_or_seed`` is a threefry key (`repro_torch.random`, int64 (2,))
    or an int seed for ``random.key(seed)``; the trials' keys are
    ``split(key, n_trials)``, so a seed gives the reference's trials.
    ``device`` defaults to the card and raises if none is visible;
    ``device="cpu"`` runs the plain PyTorch versions."""
    policies.validate_policy(policy, cfg.n_servers)
    dev = resolve_device(device)
    with tune_profile.stage("prep"):
        init, strag_mask, works, states, traces, k_sched = _prep_trials(
            trial_keys(key_or_seed, cfg, dev), cfg, log_cfg)
    with tune_profile.stage("sched"):
        sched = _sched_trials(cfg, policy, log_cfg, works, states, k_sched,
                              traces)
    with tune_profile.stage("post"):
        return _post_trials(cfg, init, strag_mask, works, traces, *sched)


def run_one_trial(key_or_seed, cfg: SimConfig, policy: PolicyConfig,
                  log_cfg: LogConfig, device="cuda") -> TrialResult:
    """One trial at unbatched shapes: `_trial_setup`, one
    `engine.run_stream` (on the kernel backend one launch of the stream
    kernel) and the post step — the reference's sequential parity
    oracle, which `run_trials` never calls.  ``key_or_seed`` is the
    trial's key (a row of ``split(key, n_trials)`` gives that trial of
    `run_trials`) or an int seed.  shared_log only, as in the reference.
    Returns a `TrialResult` without the trial axis."""
    if cfg.client_model != "shared_log":
        raise ValueError(
            "run_one_trial is the shared_log sequential reference; got "
            f"client_model={cfg.client_model!r} (use backend='jax' "
            "run_trials as the per_client comparator)")
    policies.validate_policy(policy, cfg.n_servers)
    dev = resolve_device(device)
    init, strag_mask, work, state, trace, k_sched = _trial_setup(
        _as_key(key_or_seed, dev), cfg, log_cfg)
    res = engine.run_stream(state, work, k_sched, policy=policy,
                            log_cfg=log_cfg, window_size=cfg.window_size,
                            group_steps=True, trace=trace,
                            window_dt=_window_dt(cfg), observe=_observe(cfg),
                            backend=cfg.backend)
    one = lambda x: None if x is None else type(x)(  # noqa: E731
        *(a.unsqueeze(0) for a in x))
    out = _post_trials(cfg, init.unsqueeze(0), strag_mask.unsqueeze(0),
                       one(work), one(trace), res.chosen.unsqueeze(0),
                       res.probe_msgs.unsqueeze(0),
                       res.redirected.unsqueeze(0),
                       res.latencies.unsqueeze(0),
                       res.window_loads.unsqueeze(0), None)
    return TrialResult(*(x[0] for x in out))


def default_log_cfg(cfg: SimConfig, lam: Optional[float] = None) -> LogConfig:
    """λ on the order of the expected per-server load, so Eq. (2)'s
    exponential stays resolvable over the whole run."""
    if lam is None:
        lam = max(4.0 * mean_request_mb(cfg), expected_server_load_mb(cfg))
    return LogConfig(n_servers=cfg.n_servers, lam=lam)


def run_scenario_eval(seed: int = 0, cfg: Optional[SimConfig] = None,
                      scenario_names: Tuple[str, ...] = SCENARIOS,
                      policy_names: Tuple[str, ...] = SWEEP_POLICIES,
                      threshold: float = 5.0,
                      ect_threshold: float = 0.05,
                      scenario: Optional[ScenarioConfig] = None,
                      device="cuda") -> dict:
    """The temporal sweep: {scenario: {policy: TrialResult}}, every run on
    ``random.key(seed)``.  ``threshold`` is in MB for the paper's
    policies and ``ect_threshold`` in expected seconds for ect;
    ``scenario`` overrides the per-name defaults' common knobs."""
    cfg = cfg or SimConfig()
    base_scn = scenario or ScenarioConfig()
    key = random.key(seed, resolve_device(device))
    out: dict = {}
    for scn_name in scenario_names:
        s_cfg = dataclasses.replace(
            cfg, scenario=dataclasses.replace(base_scn, name=scn_name))
        log_cfg = default_log_cfg(s_cfg)
        out[scn_name] = {
            name: run_trials(key, s_cfg, PolicyConfig(
                name=name,
                threshold=ect_threshold if name == "ect" else threshold),
                log_cfg, device)
            for name in policy_names}
    return out


def run_paper_eval(seed: int = 0, cfg: Optional[SimConfig] = None,
                   policy_names: Tuple[str, ...] = ("rr", "mlml", "trh",
                                                    "nltr", "two_choice"),
                   threshold: float = 5.0,
                   nltr_ns: Tuple[int, ...] = (1, 2),
                   device="cuda") -> dict:
    """The paper's §4 evaluation: {label: TrialResult}, nltr once per
    ``n`` of ``nltr_ns`` under the labels ``"1ltr"``, ``"2ltr"``, every
    run on ``random.key(seed)``."""
    cfg = cfg or SimConfig()
    log_cfg = default_log_cfg(cfg)
    key = random.key(seed, resolve_device(device))
    out = {}
    for name in policy_names:
        if name == "nltr":
            for n in nltr_ns:
                pol = PolicyConfig(name="nltr", threshold=threshold, nltr_n=n)
                out[f"{n}ltr"] = run_trials(key, cfg, pol, log_cfg, device)
        else:
            pol = PolicyConfig(name=name, threshold=threshold)
            out[name] = run_trials(key, cfg, pol, log_cfg, device)
    return out
