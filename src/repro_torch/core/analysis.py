"""Balance, straggler and latency metrics of a sweep, on the host.

Counterpart of the JAX package's ``core/analysis.py``: the paper's §4
figures (load balance, Fig. 18 straggler avoidance, probe overhead) and
the temporal metrics (latency percentiles, makespan, straggler hits over
time, slowdown against a baseline).

Every function takes torch tensors from either device (or numpy arrays),
with an optional leading trial axis, copies each input to the host once
and returns plain floats or numpy arrays.  The nearest-rank p99 is the
port's `policy_core.nearest_rank_p99`, the same float32 bisection the
kernel runs on its latency block.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import policy_core


def _np(a) -> np.ndarray:
    """One copy to the host."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def load_balance_stats(server_loads) -> Dict[str, float]:
    """max / min / mean / std / CV / Jain fairness / spread of per-server
    loads (T, M) or (M,); a trial axis is averaged first, as the paper
    averages each server's load over its runs."""
    loads = mean_server_loads(server_loads)
    mean = float(loads.mean())
    std = float(loads.std())
    jain = float(loads.sum() ** 2 / (len(loads) * (loads ** 2).sum()))
    return {
        "max": float(loads.max()),
        "min": float(loads.min()),
        "mean": mean,
        "std": std,
        "cv": std / mean if mean else float("inf"),
        "jain": jain,
        "spread": float(loads.max() - loads.min()),
    }


def mean_server_loads(server_loads) -> np.ndarray:
    """(M,) per-server load averaged over trials (Figs. 12-17's y-axis)."""
    loads = _np(server_loads).astype(np.float64)
    return loads.mean(axis=0) if loads.ndim == 2 else loads


def fig18_curve(server_loads, n_assigned, n_bins: int = 30,
                lo: Optional[float] = None,
                hi: Optional[float] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Paper Fig. 18: x a post-scheduling load bucket, y the largest number
    of requests on any server with a load in it; the buckets are shared
    across trials so policies overlay on one axis."""
    loads = _np(server_loads).astype(np.float64).reshape(-1)
    reqs = _np(n_assigned).astype(np.float64).reshape(-1)
    lo = float(loads.min()) if lo is None else lo
    hi = float(loads.max()) if hi is None else hi
    if hi <= lo:
        hi = lo + 1.0
    edges = np.linspace(lo, hi, n_bins + 1)
    centers = 0.5 * (edges[:-1] + edges[1:])
    which = np.clip(np.digitize(loads, edges) - 1, 0, n_bins - 1)
    ymax = np.zeros(n_bins)
    np.maximum.at(ymax, which, reqs)
    return centers, ymax


def straggler_summary(result) -> Dict[str, float]:
    """Straggler-avoidance metrics of a `TrialResult`: mean hits, the
    fraction of requests that hit a straggler, the MB the stragglers
    gained (mean over trials with any straggler) and the mean max load."""
    hits = _np(result.straggler_hits).astype(np.float64)
    loads = _np(result.server_loads).astype(np.float64)
    mask = _np(result.straggler_mask).astype(bool)
    init = _np(result.init_loads)
    n_req = result.chosen.shape[-1]
    if loads.ndim == 1:
        loads, mask = loads[None], mask[None]
    growth = []
    for t in range(loads.shape[0]):
        init_t = init[t] if init.ndim == 2 else init
        if mask[t].any():
            growth.append(float((loads[t] - init_t)[mask[t]].mean()))
    return {
        "mean_straggler_hits": float(hits.mean()),
        "hit_fraction": float(hits.mean()) / n_req,
        "mean_bytes_added_to_stragglers_mb":
            float(np.mean(growth)) if growth else 0.0,
        "max_load": float(loads.max(axis=1).mean()),
    }


def latency_stats(latencies) -> Dict[str, float]:
    """p50/p95/p99/mean/max of per-request latencies (R,) or (T, R),
    pooled over trials.  Two p99s: ``p99`` is ``np.percentile``'s linear
    interpolation (the figures' definition); ``p99_nearest`` the
    nearest-rank one (the smallest value with at least ``ceil(0.99·n)``
    values at or below it) by `policy_core.nearest_rank_p99`, which
    matches the kernel's fused ``MET_P99`` bit for bit."""
    lat = _np(latencies).astype(np.float64).reshape(-1)
    lat32 = torch.from_numpy(lat.astype(np.float32))
    p99_nr = policy_core.nearest_rank_p99(
        lat32, torch.ones(lat32.shape, dtype=torch.bool))
    return {
        "p50": float(np.percentile(lat, 50)),
        "p95": float(np.percentile(lat, 95)),
        "p99": float(np.percentile(lat, 99)),
        "p99_nearest": float(p99_nr.reshape(-1)[0]),
        "mean": float(lat.mean()),
        "max": float(lat.max()),
    }


def makespan(result) -> float:
    """Mean over trials of the I/O-phase makespan
    (``TrialResult.phase_time``)."""
    return float(_np(result.phase_time).astype(np.float64).mean())


def latency_cdf(latencies, n_points: int = 64
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Empirical CDF of request latencies: (latency grid, P[lat <= x])."""
    lat = np.sort(_np(latencies).astype(np.float64).reshape(-1))
    xs = np.linspace(lat[0], lat[-1] if lat[-1] > lat[0] else lat[0] + 1.0,
                     n_points)
    ys = np.searchsorted(lat, xs, side="right") / len(lat)
    return xs, ys


def straggler_hits_over_time(chosen, straggler_mask,
                             window_size: int) -> np.ndarray:
    """Fraction of each window's requests that land on stragglers,
    averaged over trials: ``chosen`` (T, R) or (R,), ``straggler_mask``
    (T, M) or (M,) (one mask for every trial)."""
    ch = _np(chosen)
    mask = _np(straggler_mask).astype(bool)
    if ch.ndim == 1:
        ch = ch[None]
    if mask.ndim == 1:
        mask = np.broadcast_to(mask, (ch.shape[0], mask.shape[0]))
    t, r = ch.shape
    n_win = -(-r // window_size)
    pad = n_win * window_size - r
    hit = np.take_along_axis(mask, ch.astype(np.int64), axis=1).astype(
        np.float64)
    if pad:
        hit = np.concatenate([hit, np.full((t, pad), np.nan)], axis=1)
    per_win = np.nanmean(hit.reshape(t, n_win, window_size), axis=2)
    return per_win.mean(axis=0)


def slowdown_vs_baseline(results: Dict[str, object],
                         baseline: str = "rr") -> Dict[str, Dict[str, float]]:
    """Per-policy p99-latency and makespan ratios against a baseline
    policy (below 1: better than the baseline)."""
    p99 = {name: latency_stats(res.latencies)["p99"]
           for name, res in results.items()}
    span = {name: makespan(res) for name, res in results.items()}
    return {name: {
        "p99_vs_" + baseline: p99[name] / max(p99[baseline], 1e-12),
        "makespan_vs_" + baseline: span[name] / max(span[baseline], 1e-12)}
        for name in results}


def probe_overhead(results: Dict[str, object],
                   n_requests: int) -> Dict[str, float]:
    """Probe messages per request per policy (the cost the log removes)."""
    return {name: float(_np(r.probe_msgs).mean()) / n_requests
            for name, r in results.items()}


def ascii_plot(ys, width: int = 72, height: int = 12,
               label: str = "") -> str:
    """A small line plot for a benchmark's standard output."""
    ys = _np(ys).astype(np.float64)
    if len(ys) > width:
        idx = np.linspace(0, len(ys) - 1, width).astype(int)
        ys = ys[idx]
    lo, hi = float(ys.min()), float(ys.max())
    span = (hi - lo) or 1.0
    q = np.clip(((ys - lo) / span * (height - 1)).round().astype(int), 0,
                height - 1)
    rows = []
    for r in range(height - 1, -1, -1):
        line = "".join("█" if q[c] >= r else " " for c in range(len(ys)))
        rows.append(f"{(lo + span * r / (height - 1)):10.1f} |{line}")
    rows.append(" " * 11 + "+" + "-" * len(ys))
    if label:
        rows.insert(0, f"  {label}  [min={lo:.2f} max={hi:.2f}]")
    return "\n".join(rows)
