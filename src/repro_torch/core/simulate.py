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
  tables, the scenario rate traces and the LCG seeds ((T,) or (T, C)),
  drawn from one ``torch.Generator``;
* `_sched_trials` — every stream in ONE launch of the stream kernel, plus
  one of the cross-client merge under per_client
  (`engine.run_stream_batch`), with the tiles resolved once by
  `repro_torch.tune.table.resolve_sim_tiles`; or, under
  ``SimConfig(backend="jax")``, on the eager engine, with the
  cross-client fold as tensor code at the same resolved client tile;
* `_post_trials`  — the per-trial `TrialResult` bookkeeping.

The port's default backend is ``"kernel"``; the reference's is ``"jax"``.
Both give the same `TrialResult` bit for bit (the randomized policies
under ``PolicyConfig(rng="lcg")``).

The draws follow the reference's distributions, not its bits (the JAX
package draws with threefry, which is not ported); `repro_torch.interop`
carries the reference's prep across when a test needs identical inputs.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import engine, policies, policy_core, statlog
from repro_torch.core.engine import ClusterTrace, Workload
from repro_torch.core.policies import PolicyConfig
from repro_torch.core.policy_core import F32, f32
from repro_torch.core.statlog import LogConfig, SchedState
from repro_torch.device import resolve_device
from repro_torch.kernels.sched_select import ops as kops
from repro_torch.tune import profile as tune_profile
from repro_torch.tune import table as tune_table

SIZE_CLASSES = ("small", "medium", "large", "mixed")
SCENARIOS = ("static", "permanent_slow", "transient", "flapping",
             "correlated_rack")


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
    "jax" (the eager engine, the reference's default; it needs
    ``PolicyConfig(rng="lcg")`` for the randomized policies).
    ``mesh_shape`` and ``prep`` raise until their slice lands."""

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
        if self.mesh_shape is not None:
            raise NotImplementedError(
                f"mesh_shape={self.mesh_shape!r}: the sharded sweep waits "
                "for ROADMAP Queue A10")
        if self.prep != "batched":
            raise NotImplementedError(
                f"prep={self.prep!r}: the sequential prep oracle waits for "
                "ROADMAP Queue A10")

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


def _uniform(gen: torch.Generator, shape, lo: float, hi: float,
             device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, dtype=F32, device=device)
    return f32(lo, u) + f32(hi - lo, u) * u


def _choose_mask(gen: torch.Generator, batch: int, m: int, k: int,
                 device) -> torch.Tensor:
    """(batch, m) bool with ``k`` distinct servers per row, uniformly
    chosen without replacement."""
    keys = torch.rand((batch, m), generator=gen, device=device)
    idx = torch.argsort(keys, dim=-1)[:, :k]
    mask = torch.zeros((batch, m), dtype=torch.bool, device=device)
    return mask.scatter_(1, idx, True)


def sample_workload(gen: torch.Generator, cfg: SimConfig, batch: int,
                    device) -> Workload:
    """(T, R) synthetic request streams per §4's three size classes:
    object ids uniform in ``[0, 8 M)``, lengths uniform in their class."""
    r = cfg.n_requests
    shape = (batch, r)
    object_ids = torch.randint(0, 8 * cfg.n_servers, shape, generator=gen,
                               dtype=torch.int32, device=device)
    small = _uniform(gen, shape, cfg.small_lo, cfg.small_hi, device)
    med = _uniform(gen, shape, cfg.small_hi, cfg.medium_hi, device)
    large = _uniform(gen, shape, cfg.medium_hi, cfg.large_hi, device)
    if cfg.workload == "small":
        lengths = small
    elif cfg.workload == "medium":
        lengths = med
    elif cfg.workload == "large":
        lengths = large
    else:
        cls = torch.randint(0, 3, shape, generator=gen, device=device)
        lengths = torch.where(cls == 0, small, torch.where(cls == 1, med,
                                                           large))
    return Workload(object_ids=object_ids, lengths=lengths,
                    valid=torch.ones(shape, dtype=torch.bool, device=device))


def initial_loads(gen: torch.Generator, cfg: SimConfig, batch: int,
                  device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, M) Normal initial loads plus optional straggler injection: the
    stragglers carry ``straggler_factor`` times the run's expected
    per-server load on top."""
    m = cfg.n_servers
    noise = torch.randn((batch, m), generator=gen, dtype=F32, device=device)
    noise = f32(cfg.init_load_std, noise) * noise
    big = f32(policy_core.BIG, noise)
    loads = f32(cfg.init_load_mean, noise) + torch.minimum(
        torch.maximum(noise, -big), big)
    loads = torch.clamp_min(loads, 0.0)
    n_strag = int(round(cfg.straggler_frac * m))
    mask = torch.zeros((batch, m), dtype=torch.bool, device=device)
    if n_strag > 0:
        mask = _choose_mask(gen, batch, m, n_strag, device)
        extra = f32(cfg.straggler_factor * expected_server_load_mb(cfg),
                    loads)
        loads = loads + torch.clamp_min(mask.to(F32) * extra, 0.0)
    return loads, mask


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


def make_trace(gen: torch.Generator, cfg: SimConfig, scn: ScenarioConfig,
               batch: int, device) -> ClusterTrace:
    """(T,)-batched rate-event schedules; event times are fractions of
    the stream horizon ``n_windows * window_dt``."""
    m = cfg.n_servers
    base = scn.base_rate_mb_s
    horizon = max(cfg.n_windows * resolve_window_dt(cfg, scn), 1e-6)
    base_row = torch.full((batch, m), base, dtype=F32, device=device)

    def times_of(values):
        return torch.tensor(values, dtype=F32, device=device).expand(
            batch, len(values))

    if scn.name == "static":
        return ClusterTrace(times=times_of([0.0]), rates=base_row[:, None])
    if scn.name == "correlated_rack":
        rack = min(scn.rack_size, m)
        start = torch.randint(0, m - rack + 1, (batch, 1), generator=gen,
                              device=device)
        idx = torch.arange(m, device=device)
        mask = (idx >= start) & (idx < start + rack)
    else:
        n_strag = max(int(round(scn.straggler_frac * m)), 1)
        mask = _choose_mask(gen, batch, m, n_strag, device)
    slow_row = torch.where(mask, f32(base / scn.slow_factor, base_row),
                           base_row)
    if scn.name == "permanent_slow":
        return ClusterTrace(times=times_of([0.0]), rates=slow_row[:, None])
    if scn.name == "transient":
        return ClusterTrace(
            times=times_of([0.0, scn.onset * horizon, scn.recover * horizon]),
            rates=torch.stack([base_row, slow_row, base_row], dim=1))
    if scn.name == "flapping":
        n_ev = max(scn.n_flaps, 2)
        times = (torch.arange(n_ev, dtype=F32, device=device)
                 * f32(horizon / n_ev, base_row)).expand(batch, n_ev)
        rows = torch.stack([base_row if e % 2 == 0 else slow_row
                            for e in range(n_ev)], dim=1)
        return ClusterTrace(times=times, rates=rows)
    return ClusterTrace(times=times_of([0.0, scn.onset * horizon]),
                        rates=torch.stack([base_row, slow_row], dim=1))


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


def _prep_trials(gen: torch.Generator, cfg: SimConfig, log_cfg: LogConfig,
                 device):
    """Stage 1: ``(init_loads, straggler_mask, works, states, traces,
    seeds)`` for the whole (T,) batch — the reference's vmapped
    ``_trial_setup``, drawn batch-wide."""
    t = cfg.n_trials
    init, strag_mask = initial_loads(gen, cfg, t, device)
    works = sample_workload(gen, cfg, t, device)
    state = statlog.init_state(log_cfg, batch=t, device=device)
    state = absorb_initial_loads(state, init, log_cfg)
    traces = None
    if cfg.scenario is not None:
        traces = make_trace(gen, cfg, cfg.scenario, t, device)
        state = state._replace(rates=traces.rates[:, 0].contiguous())
    lead = (t, cfg.n_clients) if cfg.client_model == "per_client" else (t,)
    seeds = torch.randint(0, 2 ** 32, lead, generator=gen,
                          dtype=torch.int64, device=device)
    return init, strag_mask, works, state, traces, seeds


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
                  works: Workload, states: SchedState, seeds: torch.Tensor,
                  traces: Optional[ClusterTrace],
                  stream_batch=kops.sched_stream_batch,
                  stream_grid=kops.sched_stream_grid):
    """Stage 2: every stream in one kernel launch (plus the cross-client
    merge under per_client), or on the eager engine under
    ``cfg.backend == "jax"``.  Returns ``(chosen, probes, redirected,
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
    association the merge kernel keeps."""
    window_dt = _window_dt(cfg)
    per_client = cfg.client_model == "per_client"
    # THE tile resolution point: the pair is resolved once, whichever mode
    # cfg.tiles selects, and threaded through every layer below
    trial_tile, client_tile = tune_table.resolve_sim_tiles(
        mode=cfg.tiles, policy=policy.name, backend=cfg.backend,
        n_servers=cfg.n_servers, n_requests=cfg.n_requests,
        n_clients=(cfg.n_clients if per_client else 1),
        n_trials=cfg.n_trials, window_size=cfg.window_size,
        form=("grid" if per_client else "batch"),
        trial_tile=cfg.trial_tile, client_tile=cfg.client_tile)
    run = dict(policy=policy, log_cfg=log_cfg, traces=traces,
               window_dt=window_dt, observe=_observe(cfg),
               trial_tile=trial_tile, backend=cfg.backend,
               stream_batch=stream_batch, stream_grid=stream_grid)
    eager = cfg.backend == "jax"
    if not per_client:
        res, metrics, _ = engine.run_stream_batch(
            states, works, seeds, window_size=cfg.window_size, **run)
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
    res, _, merged = engine.run_stream_batch(
        run_states, run_works, seeds, window_size=win,
        client_tile=client_tile, **run)
    cvalid = run_works.valid.any(dim=-1)                      # (T, C)
    probes = torch.where(cvalid, res.probe_msgs, 0).sum(
        dim=-1, dtype=torch.int32)
    first = lambda x: x.reshape(t, c * per)[:, :r]  # noqa: E731
    if eager:
        # the cross-client fold the merge kernel makes, as tensor code
        wl = policy_core.masked_client_mean(
            res.window_loads.movedim(1, 0), cvalid.T, client_tile)
        w_open = ((torch.arange(per, device=seeds.device) // win).to(F32)
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


def run_trials(generator_or_seed, cfg: SimConfig, policy: PolicyConfig,
               log_cfg: LogConfig, device="cuda") -> TrialResult:
    """Run ``cfg.n_trials`` independent trials: prep, one kernel launch
    for the whole sweep (and one of the cross-client merge under
    per_client) or the eager engine (``cfg.backend == "jax"``), post.
    The stages run under `tune.profile.stage` ("prep", "sched", "post"),
    inert unless a profile is collected.

    ``generator_or_seed`` is a ``torch.Generator`` on ``device`` or an int
    seed for a fresh one.  ``device`` defaults to the card and raises if
    none is visible; ``device="cpu"`` runs the plain PyTorch version."""
    policies.validate_policy(policy, cfg.n_servers)
    if cfg.backend == "jax":
        policies.check_eager_rng(policy)
    dev = resolve_device(device)
    if isinstance(generator_or_seed, torch.Generator):
        gen = generator_or_seed
    else:
        gen = torch.Generator(device=dev).manual_seed(int(generator_or_seed))
    with tune_profile.stage("prep"):
        init, strag_mask, works, states, traces, seeds = _prep_trials(
            gen, cfg, log_cfg, dev)
    with tune_profile.stage("sched"):
        sched = _sched_trials(cfg, policy, log_cfg, works, states, seeds,
                              traces)
    with tune_profile.stage("post"):
        return _post_trials(cfg, init, strag_mask, works, traces, *sched)


def default_log_cfg(cfg: SimConfig, lam: Optional[float] = None) -> LogConfig:
    """λ on the order of the expected per-server load, so Eq. (2)'s
    exponential stays resolvable over the whole run."""
    if lam is None:
        lam = max(4.0 * mean_request_mb(cfg), expected_server_load_mb(cfg))
    return LogConfig(n_servers=cfg.n_servers, lam=lam)
