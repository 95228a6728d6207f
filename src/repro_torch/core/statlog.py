"""Client-side server statistic log — the engine half.

Counterpart of the JAX package's ``core/statlog.py``: the scheduling
state (the packed ``(4, M)`` log plus the simulator's true-cluster
fields) and its configuration.  The state carries any number of leading
batch axes; the trial sweep uses ``(T,)``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import policy_core
from repro_torch.core.policy_core import (ROW_EST, ROW_EWMA, ROW_LOADS,
                                          ROW_PROBS)


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


def init_state(cfg: LogConfig, batch=None, device="cpu") -> SchedState:
    """Fresh log (round-robin prior) with unit true rates.  ``batch``
    adds a leading trial axis."""
    m = cfg.n_servers
    lead = () if batch is None else (batch,)
    return SchedState(
        log=policy_core.init_table(m, batch=batch, device=device),
        n_assigned=torch.zeros(lead + (m,), dtype=torch.int32, device=device),
        rates=torch.ones(lead + (m,), dtype=torch.float32, device=device),
        vclock=torch.zeros(lead, dtype=torch.float32, device=device),
        free_at=torch.zeros(lead + (m,), dtype=torch.float32, device=device))
