"""Client-side server statistic log.

Counterpart of the JAX package's ``core/statlog.py``: the scheduling
state (the packed ``(4, M)`` log plus the simulator's true-cluster
fields), its configuration, and the Eq. (1)-(3) log maintenance the eager
engine composes.  The state carries any number of leading batch axes;
the trial sweep uses ``(T,)`` or ``(T, C)``.  `HostStatLog` is the real
I/O client's log: the same table in float64 on the CPU, maintained by the
float64 host arms at the end of this module.

Every update is functional: it builds new tensors and never writes into
the state's.  Under per_client the clients' states are ``expand``ed
views of one trial's state, so an in-place write would reach every
client at once.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Sequence, Tuple

import torch

from repro_torch.core import policy_core
from repro_torch.core.policy_core import (N_ROWS, ROW_EST, ROW_EWMA,
                                          ROW_LOADS, ROW_PROBS)
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


# ---------------------------------------------------------------------------
# The host log: float64 on the CPU, for the real I/O client's hot path
# ---------------------------------------------------------------------------
#
# The float64 host arms of `policy_core`: the reference's numpy branches
# (``xp is np``), which differ from the float32 forms above (scalar index
# updates, not one-hot selects; a plain sum, not `lane_sum`).  They never
# go through `policy_core.const`, `f32` or `lane_sum`, whose roundings are
# pinned to the stream kernel's.

F64 = torch.float64


def host_sum(row) -> float:
    """Sum of a float64 row in numpy's association (pairwise: eight
    accumulators up to 128 elements, halves above), so every host row
    that goes through a sum is bit-equal with the reference's."""
    x = row.tolist() if isinstance(row, torch.Tensor) else list(row)

    def pairwise(lo: int, n: int) -> float:
        if n < 8:
            acc = 0.0
            for v in x[lo:lo + n]:
                acc += v
            return acc
        if n <= 128:
            r = x[lo:lo + 8]
            i = 8
            while i < n - n % 8:
                for j in range(8):
                    r[j] += x[lo + i + j]
                i += 8
            acc = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5])
                                                     + (r[6] + r[7]))
            for v in x[lo + i:lo + n]:
                acc += v
            return acc
        half = n // 2
        half -= half % 8
        return pairwise(lo, half) + pairwise(lo + half, n - half)

    return pairwise(0, len(x))


def host_exp(x: float) -> float:
    """``exp`` of one float64 through torch's kernel (the one the rows
    use), not the C library's."""
    return torch.exp(torch.tensor(x, dtype=F64)).item()


def host_ect_rates(ewma_lat: torch.Tensor) -> torch.Tensor:
    """Estimated rates from the observation EWMA: unobserved servers get
    the best seen rate, an empty log 1 MB/s everywhere."""
    default = max(ewma_lat.max().item(), 1.0)
    return torch.where(ewma_lat > 0, ewma_lat,
                       torch.tensor(default, dtype=F64))


def host_ect_scores(loads: torch.Tensor, est_rates: torch.Tensor,
                    length: float) -> torch.Tensor:
    """Expected completion time per server on the estimated rates."""
    return (loads + length) / est_rates


def host_redirect_benefit(policy_name: str, loads: Sequence[float],
                          est_rates: Sequence[float], default: int,
                          target: int, length: float) -> float:
    """The redirect guard's benefit on host rows (Python lists): MB of
    load, or expected seconds for ect."""
    if policy_name == "ect":
        return ((loads[default] + length) / est_rates[default]
                - (loads[target] + length) / est_rates[target])
    return loads[default] - loads[target]


def host_recursive_average_bounds(sorted_len: Sequence[float],
                                  n_levels: int) -> List[int]:
    """nLTR's request sections on a descending length list, every row
    valid: the ``2**n_levels - 1`` boundary indices in tree order, a
    section mean being the `host_sum` of the whole row masked to the
    section over its count (the reference's numpy arm)."""
    r = len(sorted_len)
    starts, ends, bounds = [0], [r], []
    for _ in range(n_levels):
        new_starts, new_ends = [], []
        for s, e in zip(starts, ends):
            cnt = max(min(e, r) - max(s, 0), 1)
            mean = host_sum([v if s <= p < e else 0.0
                             for p, v in enumerate(sorted_len)]) / cnt
            b = s + sum(1 for p, v in enumerate(sorted_len)
                        if s <= p < e and v > mean)
            b = min(max(b, s + int(e > s + 1)), max(e - 1, s + 1))
            bounds.append(b)
            new_starts.extend([s, b])
            new_ends.extend([b, e])
        starts, ends = new_starts, new_ends
    return bounds


def host_drain_loads(loads: torch.Tensor, rates: torch.Tensor,
                     dt: float) -> torch.Tensor:
    """Drain each queue at its true rate for ``dt`` seconds, clipped at
    empty."""
    dec = torch.clamp_min(torch.clamp_min(rates, 1e-6) * dt, 0.0)
    return torch.clamp_min(loads - dec, 0.0)


class HostStatLog:
    """The client's statistic log on the real I/O path (`repro_torch.io`).

    The packed ``(4, M)`` table is a float64 tensor on the CPU, whose
    ``loads``/``probs``/``ewma_lat``/``est_rates`` are row views
    (``log.loads[s] = x`` lands in the table).  It lives on the CPU by
    the paper's design, not as a fallback: the client's scheduling state
    is a few KB resident in local memory, read and written once per
    request with no device round trip.  `snapshot` copies it into a
    `SchedState` on the card for the stream kernel.
    """

    def __init__(self, cfg: LogConfig, init_loads=None):
        self.cfg = cfg
        m = cfg.n_servers
        self.table = torch.zeros((N_ROWS, m), dtype=F64)
        self.table[ROW_PROBS] = 1.0 / m
        self.table[ROW_EST] = 1.0
        if init_loads is not None:
            self.table[ROW_LOADS] = torch.as_tensor(init_loads, dtype=F64)
        self.n_assigned = torch.zeros(m, dtype=torch.int64)
        self.rates = torch.ones(m, dtype=F64)   # true MB per virtual s
        self.vclock = 0.0
        self.free_at = torch.zeros(m, dtype=F64)
        # the I/O request table (Fig. 8, left): (object, offset, MB) rows
        self.request_log: List[Tuple[int, int, float]] = []

    def _set_row(self, row: int, v) -> None:
        self.table[row] = torch.as_tensor(v, dtype=F64)

    loads = property(lambda self: self.table[ROW_LOADS],
                     lambda self, v: self._set_row(ROW_LOADS, v))
    probs = property(lambda self: self.table[ROW_PROBS],
                     lambda self, v: self._set_row(ROW_PROBS, v))
    ewma_lat = property(lambda self: self.table[ROW_EWMA],
                        lambda self, v: self._set_row(ROW_EWMA, v))
    est_rates = property(lambda self: self.table[ROW_EST],
                         lambda self, v: self._set_row(ROW_EST, v),
                         doc="Estimated rates: observations only.")

    @property
    def n_servers(self) -> int:
        return self.cfg.n_servers

    def record_request(self, object_id: int, offset: int,
                       length_mb: float) -> None:
        self.request_log.append((object_id, offset, length_mb))

    def apply_assignment(self, server: int, length_mb: float) -> None:
        """Eq. (1)-(3) on the table's rows in place: book the MB, decay
        the server's probability, spread the lost mass over the others."""
        loads, probs = self.loads, self.probs
        loads[server] += length_mb                          # Eq. (1)
        p_i = probs[server].item()
        e = host_exp(-loads[server].item() / self.cfg.lam)
        probs += p_i * (1.0 - e) / (self.cfg.n_servers - 1)  # Eq. (3)
        probs[server] = p_i * e                             # Eq. (2)
        self.n_assigned[server] += 1

    def observe_completion(self, server: int, mb_per_s: float) -> None:
        """Fold an observed rate into the EWMA and re-derive the estimated
        rates: the one path that writes the est row."""
        ewma = self.ewma_lat
        old = ewma[server].item()
        a = self.cfg.ewma_alpha
        ewma[server] = (mb_per_s if old == 0.0
                        else (1 - a) * old + a * mb_per_s)
        self.table[ROW_EST] = host_ect_rates(ewma)

    def complete(self, server: int, length_mb: float) -> None:
        """Bytes drained from a server's queue (a write finished)."""
        self.loads[server] = max(0.0, self.loads[server].item() - length_mb)

    def set_rates(self, rates) -> None:
        self.rates = torch.as_tensor(rates, dtype=F64).clone()

    def advance_time(self, dt: float) -> None:
        """Drain the queues at the true rates and advance the clock."""
        self.table[ROW_LOADS] = host_drain_loads(self.loads, self.rates, dt)
        self.vclock += dt
        self.free_at = self.vclock + self.loads / torch.clamp_min(
            self.rates, 1e-6)

    def estimated_latency(self, server: int) -> float:
        return self.loads[server].item() / max(self.rates[server].item(),
                                               1e-6)

    def renormalize(self) -> None:
        p = torch.clamp_min(self.probs, 0.0)
        self.table[ROW_PROBS] = p / host_sum(p)

    def absorb_loads(self, loads=None) -> None:
        """Seed the probabilities from known loads, ``p_i ∝ e^{-l_i/λ}``
        (the vectorised fixed point of Eq. (2))."""
        if loads is not None:
            self._set_row(ROW_LOADS, loads)
        p = torch.exp(-self.loads / self.cfg.lam)
        self.table[ROW_PROBS] = p / host_sum(p)

    def snapshot(self, device="cuda") -> SchedState:
        """The log as the engine's `SchedState`, float32/int32 on
        ``device`` (the card unless ``device="cpu"``; `resolve_device`
        raises without one), so `engine.run_stream` schedules from it."""
        dev = resolve_device(device)
        return SchedState(
            log=self.table.to(dev, torch.float32),
            n_assigned=self.n_assigned.to(dev, torch.int32),
            rates=self.rates.to(dev, torch.float32),
            vclock=torch.tensor(self.vclock, dtype=torch.float32,
                                device=dev),
            free_at=self.free_at.to(dev, torch.float32))
