"""Scheduling policies — the engine half.

Counterpart of the JAX package's ``core/policies.py``.  The per-request
selection rules themselves live in the trial-grid kernel
(`repro_torch.kernels.sched_select`), which draws all randomness from its
own uint32 LCG; this module holds the policy configuration and its
cross-field validation.

* ``rr``         — round-robin baseline: ``object_id mod M``.
* ``mlml``       — Max Length - Min Load (paper Alg. 1).
* ``trh``        — Two Random from Top Half (paper Alg. 2).
* ``nltr``       — n-Level Two Random (paper Alg. 3).
* ``two_choice`` — the SC'14 probing baseline (2 probes per request).
* ``ect``        — argmin of expected completion time on estimated rates.
"""

from __future__ import annotations

import dataclasses

POLICIES = ("rr", "mlml", "trh", "nltr", "two_choice", "ect")

# Probe RPCs per scheduled request — what the paper's log removes.
PROBES_PER_REQUEST = {
    "rr": 0,
    "mlml": 0,
    "trh": 0,
    "nltr": 0,
    "ect": 0,
    "two_choice": 2,
}


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Static configuration of a scheduling policy."""

    name: str = "trh"
    threshold: float = 0.0      # benefit required to redirect (MB; s for ect)
    nltr_n: int = 2             # n of nLTR; K = 2**n sections
    probe_choices: int = 2      # two_choice only: candidates probed

    def __post_init__(self):
        if self.name not in POLICIES:
            raise ValueError(
                f"unknown policy {self.name!r}; choose from {POLICIES}")
        if self.name == "nltr" and not (1 <= self.nltr_n <= 6):
            raise ValueError("nltr_n must be in [1, 6]")

    @property
    def k_sections(self) -> int:
        return 2 ** self.nltr_n

    @property
    def probes_per_request(self) -> int:
        """One probe per candidate server, for two_choice only."""
        return self.probe_choices if self.name == "two_choice" else 0


def validate_policy(cfg: PolicyConfig, n_servers: int) -> None:
    """nLTR needs ``2**nltr_n <= n_servers``: with more sections than
    servers every section collapses onto the same server range."""
    if cfg.name == "nltr" and cfg.k_sections > n_servers:
        raise ValueError(
            f"nltr needs 2**nltr_n <= n_servers: nltr_n={cfg.nltr_n} gives "
            f"K={cfg.k_sections} sections for n_servers={n_servers} "
            "(sections would collapse onto the same server range)")
