"""Client-side server statistic log — the engine half.

Counterpart of the JAX package's ``core/statlog.py``: the scheduling
state (the packed ``(4, M)`` log plus the simulator's true-cluster
fields), its configuration, and the Eq. (1)-(3) log maintenance the eager
engine composes.  The state carries any number of leading batch axes;
the trial sweep uses ``(T,)`` or ``(T, C)``.

Every update is functional: it builds new tensors and never writes into
the state's.  Under per_client the clients' states are ``expand``ed
views of one trial's state, so an in-place write would reach every
client at once.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import policy_core
from repro_torch.core.policy_core import (ROW_EST, ROW_EWMA, ROW_LOADS,
                                          ROW_PROBS)
from repro_torch.device import resolve_device


class SchedState(NamedTuple):
    """The packed log tensor plus the simulator's ground truth (true
    ``rates``, virtual clock, per-server completion clock), which no
    scheduling decision reads."""

    log: torch.Tensor         # (..., 4, M) float32 packed table
    n_assigned: torch.Tensor  # (..., M) int32 requests scheduled per server
    rates: torch.Tensor       # (..., M) float32 true service rate, MB/s
    vclock: torch.Tensor      # (...) float32 virtual time, seconds
    free_at: torch.Tensor     # (..., M) float32 queue-drained time

    @property
    def loads(self) -> torch.Tensor:
        return self.log[..., ROW_LOADS, :]

    @property
    def probs(self) -> torch.Tensor:
        return self.log[..., ROW_PROBS, :]

    @property
    def ewma_lat(self) -> torch.Tensor:
        return self.log[..., ROW_EWMA, :]

    @property
    def est_rates(self) -> torch.Tensor:
        return self.log[..., ROW_EST, :]

    @property
    def n_servers(self) -> int:
        return self.log.shape[-1]

    def with_rows(self, *, loads=None, probs=None, ewma_lat=None,
                  est_rates=None) -> "SchedState":
        """A copy with individual rows of the packed table replaced."""
        log = self.log.clone()
        for row, val in ((ROW_LOADS, loads), (ROW_PROBS, probs),
                         (ROW_EWMA, ewma_lat), (ROW_EST, est_rates)):
            if val is not None:
                log[..., row, :] = val
        return self._replace(log=log)


@dataclasses.dataclass(frozen=True)
class LogConfig:
    """Static knobs of the statistic log."""

    n_servers: int
    lam: float = 32.0          # Eq. (2) normalisation scale, MB
    ewma_alpha: float = 0.25   # ECT extension only
    renorm: bool = True        # re-project probs onto the simplex per window


def init_state(cfg: LogConfig, batch=None, device="cuda") -> SchedState:
    """Fresh log (round-robin prior) with unit true rates.  ``batch``
    adds a leading trial axis.  On the card unless
    ``device="cpu"`` (`resolve_device` raises without one)."""
    device = resolve_device(device)
    m = cfg.n_servers
    lead = () if batch is None else (batch,)
    return SchedState(
        log=policy_core.init_table(m, batch=batch, device=device),
        n_assigned=torch.zeros(lead + (m,), dtype=torch.int32, device=device),
        rates=torch.ones(lead + (m,), dtype=torch.float32, device=device),
        vclock=torch.zeros(lead, dtype=torch.float32, device=device),
        free_at=torch.zeros(lead + (m,), dtype=torch.float32, device=device))


def apply_assignment(state: SchedState, server: torch.Tensor,
                     length: torch.Tensor, cfg: LogConfig) -> SchedState:
    """Book ``length`` MB on ``server`` (one per stream, shape (...)):
    Eq. (1)-(3) through `policy_core.assignment_update`, and one more
    request counted on that server."""
    loads, probs = policy_core.assignment_update(
        state.loads, state.probs, server, length, cfg.lam, state.n_servers)
    n_assigned = state.n_assigned + policy_core.onehot(
        server, state.n_servers).to(state.n_assigned.dtype)
    return state._replace(
        log=policy_core.pack(loads, probs, state.ewma_lat, state.est_rates),
        n_assigned=n_assigned)


def observe_completion(state: SchedState, server: torch.Tensor,
                       mb_per_s: torch.Tensor, cfg: LogConfig) -> SchedState:
    """Fold an observed service rate into the EWMA row and re-derive the
    estimated rates — the one path that writes the ``est_rates`` row."""
    ewma, est = policy_core.observe_update(state.ewma_lat, server, mb_per_s,
                                           cfg.ewma_alpha)
    return state._replace(
        log=policy_core.pack(state.loads, state.probs, ewma, est))


def advance_time(state: SchedState, dt: float, dec: torch.Tensor
                 ) -> SchedState:
    """Advance the virtual clock by ``dt`` seconds: drain every queue by
    the precomputed `policy_core.window_decrements` row ``dec`` (a bare
    subtract, clipped at empty) and re-derive ``free_at`` from the
    residual queue at the current true rates."""
    loads = policy_core.drain_loads(state.loads, state.rates, dt, dec=dec)
    vclock = state.vclock + policy_core.const(dt, state.vclock)
    free_at = vclock.unsqueeze(-1) + loads / torch.maximum(
        state.rates, policy_core.const(1e-6, state.rates))
    return state._replace(
        log=policy_core.pack(loads, state.probs, state.ewma_lat,
                             state.est_rates),
        vclock=vclock, free_at=free_at)


def estimated_latency(state: SchedState, server: torch.Tensor
                      ) -> torch.Tensor:
    """Seconds until a request just queued on ``server`` completes: its
    whole queue (Eq. (1) already applied) over the true rate."""
    return policy_core.estimated_latency(state.loads, state.rates, server)


def renormalize(state: SchedState) -> SchedState:
    """Re-project the probabilities onto the simplex (`lane_sum`)."""
    return state._replace(log=policy_core.pack(
        state.loads, policy_core.renormalize_probs(state.probs),
        state.ewma_lat, state.est_rates))
