"""Wall-clock stage hooks and the differential kernel phase profiler.

Counterpart of the JAX package's ``tune/profile.py``:

* STAGE HOOKS — `simulate.run_trials` and `engine.run_stream_batch` wrap
  their stages in :func:`stage`.  Outside a :func:`collect` block a hook
  is a no-op: no clock, no synchronize, so the main path runs as without
  it.  Inside one it synchronizes the card (when CUDA is in use) at both
  ends of the stage and accumulates the host clock between, so a stage's
  figure includes its kernels.  A stage opened inside a timed stage stays
  inert: its synchronizes would stop the host queueing ahead of the card
  and so lengthen the outer figure (``run_trials`` under `collect` times
  prep, sched and post; the engine's own stages are timed only when
  `engine.run_stream_batch` is called outside a stage).
* KERNEL PHASE PROFILER — :func:`kernel_phase_profile` attributes the
  1-D stream kernel's time to its window phases by timing its cumulative
  ``ablate`` levels (0 = full, 1 = no fused metrics, 2 = also no step
  loop, 3 = also no window-start plan): ``metrics_s = t0 - t1``,
  ``steps_s = t1 - t2``, ``plan_s = t2 - t3`` and ``dispatch_s = t3``
  (the launch and the per-window renorm/drain bookkeeping).  A clock
  inside the kernel's body would stall its chain, so ablation is the
  per-phase attribution.

The timers end each run with ``torch.cuda.synchronize`` on a CUDA device,
where the reference calls ``jax.block_until_ready``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Iterator, List, Optional

import torch

_ACTIVE: Optional[Dict[str, float]] = None
_OPEN = 0  # timed stages open


def _sync(device=None) -> None:
    """Wait for the card: ``device`` when it is a CUDA device, or (with
    ``device`` None) the current one once CUDA has been used."""
    if device is None:
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def collect() -> Iterator[Dict[str, float]]:
    """Activate the stage hooks; yields the {stage: seconds} dict they
    accumulate into (re-entrant: nested collects see their own dict)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, {}
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = prev


@contextlib.contextmanager
def stage(name: str) -> Iterator[None]:
    """Accumulate the block's wall time under ``name`` when a collect()
    is active and no other stage is being timed, the card synchronized at
    both ends; otherwise a no-op."""
    global _OPEN
    if _ACTIVE is None or _OPEN:
        yield
        return
    acc = _ACTIVE
    _sync()
    t0 = time.perf_counter()
    _OPEN += 1
    try:
        yield
    finally:
        _OPEN -= 1
        _sync()
        acc[name] = acc.get(name, 0.0) + time.perf_counter() - t0


def _timed(run: Callable[[], object], device) -> float:
    _sync(device)
    t0 = time.perf_counter()
    run()
    _sync(device)
    return time.perf_counter() - t0


def median_time(run: Callable[[], object], reps: int = 3,
                device="cuda") -> float:
    """Median wall seconds of ``run()`` over ``reps`` timed calls after
    one untimed warmup (kernel builds, caches), each ended by a
    synchronize of ``device``."""
    _timed(run, device)
    times = sorted(_timed(run, device) for _ in range(max(reps, 1)))
    return times[len(times) // 2]


def device_times(run: Callable[[], object], reps: int = 3,
                 device="cuda") -> List[float]:
    """Seconds of one call of ``run()``, one per rep after an untimed
    warmup, sorted.  On a CUDA device: the summed time of the kernels the
    call launches, by torch.profiler (the card's own clock, without the
    host's gaps between launches); elsewhere the host wall of the call."""
    dev = torch.device(device)
    if dev.type != "cuda":
        _timed(run, dev)
        return sorted(_timed(run, dev) for _ in range(max(reps, 1)))
    run()
    _sync(dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    times = []
    for _ in range(max(reps, 1)):
        with torch.profiler.profile(activities=acts) as prof:
            run()
            _sync(dev)
        # the kernels' own entries: an operator's entry repeats the
        # device time of the kernels it launched
        times.append(sum(e.self_device_time_total
                         for e in prof.key_averages()
                         if e.device_type == torch.autograd.DeviceType.CUDA)
                     / 1e6)
    return sorted(times)


def kernel_phase_profile(*, n_servers: int = 100, n_requests: int = 2000,
                         window_size: int = 100, n_trials: int = 100,
                         policy: str = "ect", threshold: float = 0.05,
                         trial_tile: Optional[int] = None, reps: int = 3,
                         seed: int = 0, device="cuda") -> Dict[str, float]:
    """Per-window-phase wall-time attribution of the 1-D stream kernel
    (differential over its ``ablate`` levels; see the module docstring),
    on the card unless ``device="cpu"`` (the plain version's levels).

    Returns ``{"total_s", "metrics_s", "steps_s", "plan_s",
    "dispatch_s"}``: the last four clamped at 0, the deltas taken on one
    shared prep, so the engine's own costs cancel out of every phase but
    the ``dispatch_s`` floor."""
    from repro_torch.core import engine, simulate
    from repro_torch.core.policies import PolicyConfig
    from repro_torch.core.statlog import LogConfig
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    cfg = simulate.SimConfig(n_servers=n_servers, n_requests=n_requests,
                             window_size=window_size, n_trials=n_trials,
                             backend="kernel", trial_tile=trial_tile)
    pol = PolicyConfig(name=policy, threshold=threshold)
    log_cfg = LogConfig(n_servers=n_servers,
                        lam=simulate.default_log_cfg(cfg).lam)
    _, _, works, states, traces, k_sched = simulate._prep_trials(
        simulate.trial_keys(seed, cfg, dev), cfg, log_cfg)

    def runner(level: int) -> Callable[[], object]:
        return lambda: engine.run_stream_batch(
            states, works, k_sched, policy=pol, log_cfg=log_cfg,
            window_size=cfg.window_size, traces=traces, window_dt=0.0,
            observe=False, trial_tile=cfg.trial_tile, ablate=level)

    t = [median_time(runner(level), reps=reps, device=dev)
         for level in range(4)]
    return {
        "total_s": t[0],
        "metrics_s": max(t[0] - t[1], 0.0),
        "steps_s": max(t[1] - t[2], 0.0),
        "plan_s": max(t[2] - t[3], 0.0),
        "dispatch_s": t[3],
    }


def pipeline_stage_profile(cfg, policy, log_cfg, *, reps: int = 3,
                           seed: int = 0, device="cuda") -> Dict[str, float]:
    """Per-stage wall times of `simulate.run_trials`: prep, sched and post
    once each under `collect`, then the dominant sched stage again as the
    median of ``reps`` (its first call includes the kernels' build)."""
    from repro_torch.core import simulate
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    with collect() as stages:
        with stage("prep"):
            prep = simulate._prep_trials(
                simulate.trial_keys(seed, cfg, dev), cfg, log_cfg)
        init, strag_mask, works, states, traces, k_sched = prep
        with stage("sched"):
            sched = simulate._sched_trials(cfg, policy, log_cfg, works,
                                           states, k_sched, traces)
        with stage("post"):
            simulate._post_trials(cfg, init, strag_mask, works, traces,
                                  *sched)
    return {
        "prep_s": stages["prep"],
        "post_s": stages["post"],
        "sched_s": median_time(lambda: simulate._sched_trials(
            cfg, policy, log_cfg, works, states, k_sched, traces), reps=reps,
            device=dev),
    }
