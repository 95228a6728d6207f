"""The launch-shape autotuner: sweep tile candidates, cache the winner.

Counterpart of the JAX package's ``tune/autotune.py``.  For one
simulation configuration the tuner prepares the trial batch once
(`simulate._prep_trials`), then times the scheduling stage
(`simulate._sched_trials`) for every candidate (trial_tile, client_tile)
shape and stores the fastest under the configuration's
`repro_torch.tune.table.config_key`.  Only the scheduling stage is
timed: prep and post do not depend on the tiles.  On the card a
candidate's time is the device time of the kernels the stage launches
(`profile.device_times`): the stage's host work, which no tile changes,
would bury the kernels' differences in the host's spread.  A candidate
whose least time reaches the fastest one's largest ties it.  Ties break
toward the configuration's own client tile (a tie is no reason to move
the merge's association, and with it the results), then toward the
smaller shape.  The entry keeps the winner's spread, the tied shapes and
every candidate's median.

``trial_tile`` is the stream kernel's warps per block (a launch shape);
``client_tile`` the per_client merge's association width, so a candidate
runs through the same `simulate` dispatch as production and a tuned run
is one of the results the contract already pins, the fastest one.
"""

from __future__ import annotations

import dataclasses
import subprocess
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.core.policy_core import resolve_client_tile
from repro_torch.kernels.sched_select.kernel import clamp_warps
from repro_torch.tune import profile, table

# Candidate warps per block of the stream kernel, and the reference's
# client tiles; every value is clamped to the instance and deduplicated.
TRIAL_TILE_CANDIDATES = (1, 2, 4, 8)
CLIENT_TILE_CANDIDATES = (8, 16, 32, 64)


def candidate_tiles(n_trials: int, n_clients: int = 1,
                    form: str = "batch") -> List[Tuple[int, int]]:
    """Deduplicated, clamped (trial_tile, client_tile) candidates.
    ``n_trials`` is kept for the reference's signature: the warps per
    block clamp to the kernel's limit, not to the trials."""
    tts = sorted({clamp_warps(tt) for tt in TRIAL_TILE_CANDIDATES})
    if form == "batch":
        return [(tt, 1) for tt in tts]
    cts = sorted({resolve_client_tile(n_clients, ct)
                  for ct in CLIENT_TILE_CANDIDATES + (n_clients,)})
    return [(tt, ct) for tt in tts for ct in cts]


def _device_count(cfg) -> int:
    if cfg.mesh_shape is None:
        return 1
    n = 1
    for s in cfg.mesh_shape:
        n *= int(s)
    return n


def card(device) -> dict:
    """The card a timing was taken on: its name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit`` gives them (None where it
    cannot be read); on the CPU, ``{"card": "cpu", "power_limit": None}``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"card": "cpu", "power_limit": None}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = None
    return {"card": torch.cuda.get_device_name(index),
            "power_limit": out or None}


def tune_config(cfg, policy, log_cfg=None, *, reps: int = 3, seed: int = 0,
                path: Optional[str] = None,
                timer: Optional[Callable[[Callable[[], object]], float]]
                = None, device="cuda") -> Tuple[str, dict]:
    """Time every candidate tile shape for ``(cfg, policy)`` on ``device``
    (the card unless ``device="cpu"``) and cache the winner; returns
    ``(key, entry)``.

    ``timer`` (tests) overrides the measurement: it receives an argless
    runnable for one candidate and returns its cost in seconds.  With a
    deterministic timer the sweep, the winner and the written table bytes
    are all reproducible."""
    from repro_torch.core import simulate
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    if log_cfg is None:
        log_cfg = simulate.default_log_cfg(cfg)
    if timer is None:
        def measure(run):
            return profile.device_times(run, reps=reps, device=dev)
    else:
        def measure(run):
            return [float(timer(run))]
    form = "grid" if cfg.client_model == "per_client" else "batch"

    _, _, works, states, traces, k_sched = simulate._prep_trials(
        simulate.trial_keys(seed, cfg, dev), cfg, log_cfg)

    results = []
    for tt, ct in candidate_tiles(cfg.n_trials, cfg.n_clients, form):
        cand = dataclasses.replace(cfg, trial_tile=tt, client_tile=ct,
                                   tiles="default")
        times = measure(lambda: simulate._sched_trials(
            cand, policy, log_cfg, works, states, k_sched, traces))
        results.append((times, tt, ct))

    def median(r):
        return r[0][len(r[0]) // 2]

    fastest = min(results, key=median)[0]
    tied = [r for r in results if r[0][0] <= fastest[-1]]
    own_ct = (resolve_client_tile(cfg.n_clients, cfg.client_tile)
              if form == "grid" else 1)
    times, tt, ct = min(tied, key=lambda r: (r[2] != own_ct, r[1], r[2]))
    secs = times[len(times) // 2]
    total_req = cfg.n_trials * cfg.n_requests
    entry = {"trial_tile": tt, "client_tile": ct, "sched_s": secs,
             "spread_s": [times[0], times[-1]],
             "ties": [[t, c] for _, t, c in tied],
             "candidates_s": [[r[1], r[2], median(r)] for r in results],
             "req_s": total_req / max(secs, 1e-12), **card(dev)}
    key = table.config_key(
        policy=policy.name, backend=cfg.backend, n_servers=cfg.n_servers,
        n_requests=cfg.n_requests,
        n_clients=(cfg.n_clients if form == "grid" else 1),
        n_trials=cfg.n_trials, window_size=cfg.window_size,
        device_count=_device_count(cfg), form=form)
    table.store(key, entry, path)
    return key, entry
