"""Scheduling policies — the engine half.

Counterpart of the JAX package's ``core/policies.py``: the policy
configuration and its validation, and the rules the eager engine
(`core/engine.py`, ``backend="jax"``) composes — the window-start plan
(`plan_window`), the per-request target (`select_target`,
`select_target_rng`, from the draws of `draw_candidates` or the LCG
through `select_drawn`) and the redirect guard (`apply_threshold`).  The
stream kernel (`repro_torch.kernels.sched_select`) runs the same rules in
its own body.  Every function takes any leading batch axes: a state's
rows are (..., M), a window's requests (..., R), per-stream scalars (...).

* ``rr``         — round-robin baseline: ``object_id mod M``.
* ``mlml``       — Max Length - Min Load (paper Alg. 1).
* ``trh``        — Two Random from Top Half (paper Alg. 2).
* ``nltr``       — n-Level Two Random (paper Alg. 3).
* ``two_choice`` — the SC'14 probing baseline (2 probes per request).
* ``ect``        — argmin of expected completion time on estimated rates.

`HostScheduler` runs the same rules one request at a time on a
`statlog.HostStatLog`, for the real I/O client (`repro_torch.io`).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import random
from repro_torch.core import policy_core, statlog
from repro_torch.core.statlog import SchedState

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


RNG_IMPLS = ("jax", "lcg")
# Policies that draw random candidates.
RANDOM_POLICIES = ("trh", "nltr", "two_choice")


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Static configuration of a scheduling policy.

    ``rng`` is the eager engine's randomness source for the randomized
    policies: ``"jax"`` (the reference's threefry keys, drawn by
    `repro_torch.random` key for key as the reference draws them, the
    default) or ``"lcg"`` (the stream kernel's uint32 LCG, drawn from the
    stream's seed exactly as the kernel draws it — the parity setting with
    the kernel backend).  Deterministic policies and the kernel backend
    ignore it."""

    name: str = "trh"
    threshold: float = 0.0      # benefit required to redirect (MB; s for ect)
    nltr_n: int = 2             # n of nLTR; K = 2**n sections
    probe_choices: int = 2      # two_choice only: candidates probed
    rng: str = "jax"

    def __post_init__(self):
        if self.name not in POLICIES:
            raise ValueError(
                f"unknown policy {self.name!r}; choose from {POLICIES}")
        if self.name == "nltr" and not (1 <= self.nltr_n <= 6):
            raise ValueError("nltr_n must be in [1, 6]")
        if self.rng not in RNG_IMPLS:
            raise ValueError(f"rng must be one of {RNG_IMPLS}")

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


class WindowPlan(NamedTuple):
    """Window-start snapshot read by the per-request selection: the
    servers (and, for mlml/nltr, the requests) are sorted once per
    window, while the loads read inside the window are live."""

    order: torch.Tensor           # (..., R) int64 request processing order
    sorted_servers: torch.Tensor  # (..., M) int64 ids, highest prob first
    req_section: torch.Tensor     # (..., R) int64 nLTR section per position
    sec_size: int                 # servers per nLTR section (M otherwise)


def _recursive_average_boundaries(sorted_len: torch.Tensor,
                                  valid: torch.Tensor,
                                  n_levels: int) -> torch.Tensor:
    """nLTR's request sections on a desc-sorted length list: the (..., K-1)
    boundary indices of `policy_core.recursive_average_bounds`; the
    section of position ``p`` is ``sum(bounds <= p)``."""
    nvalid = valid.sum(dim=-1, keepdim=True)
    return policy_core.recursive_average_bounds(sorted_len, nvalid, n_levels)


def plan_window(cfg: PolicyConfig, state: SchedState,
                object_ids: torch.Tensor, lengths: torch.Tensor,
                valid: torch.Tensor) -> WindowPlan:
    """The window-start plan: servers by probability descending, and for
    mlml/nltr the requests by length descending (invalid rows last), as
    stable argsorts.  Both orders are ``(key desc, index asc)``, a strict
    total order, so they equal the stream kernel's all-pairs ranks
    (`policy_core.rank_desc`) by construction."""
    r = object_ids.shape[-1]
    m = state.n_servers
    sorted_servers = torch.argsort(-state.probs, dim=-1, stable=True)
    if cfg.name in ("mlml", "nltr"):
        key_len = torch.where(valid, lengths,
                              policy_core.const(float("-inf"), lengths))
        order = torch.argsort(-key_len, dim=-1, stable=True)
    else:
        order = policy_core.lanes(r, lengths).expand(lengths.shape)
    if cfg.name == "nltr":
        k = cfg.k_sections
        sorted_len = torch.gather(lengths, -1, order)
        sorted_valid = torch.gather(valid, -1, order)
        bounds = _recursive_average_boundaries(sorted_len, sorted_valid,
                                               cfg.nltr_n)
        pos = policy_core.lanes(r, lengths)
        req_section = (pos[:, None] >= bounds.unsqueeze(-2)).sum(dim=-1)
        req_section = req_section.clamp(0, k - 1)
        sec_size = max(m // k, 1)
    else:
        req_section = torch.zeros_like(order)
        sec_size = m
    return WindowPlan(order=order, sorted_servers=sorted_servers,
                      req_section=req_section, sec_size=sec_size)


def _two_random_min_load(state: SchedState, sorted_servers: torch.Tensor,
                         p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """The servers at positions ``p1`` and ``p2`` of the sorted list; the
    one with the smaller live load (the first on a tie)."""
    s1 = policy_core.take(sorted_servers, p1)
    s2 = policy_core.take(sorted_servers, p2)
    return torch.where(policy_core.take(state.loads, s1)
                       <= policy_core.take(state.loads, s2), s1, s2)


def draw_candidates(cfg: PolicyConfig, keys: torch.Tensor,
                    n_servers: int) -> torch.Tensor:
    """The random draws of a randomized policy under ``rng="jax"``, one
    request key per leading position: ``keys`` (..., 2) -> (...,
    n_draws) int64, the reference's ``select_target`` draws key for key.
    trh draws two positions in the lightest half and nltr two in a
    section (``split(key)``, one ``randint`` each; nltr's section start
    is added by `select_drawn`); two_choice draws ``probe_choices - 1``
    servers (``split(key, probe_choices - 1)``).  No draw reads the
    state, so the engine draws a whole window's, or stream's, at once."""
    m = n_servers
    if cfg.name == "two_choice":
        return random.randint(random.split(keys, cfg.probe_choices - 1), (),
                              0, m, dtype=torch.int64)
    size = max(m // 2, 1) if cfg.name == "trh" else max(m // cfg.k_sections,
                                                        1)
    return random.randint(random.split(keys), (), 0, size,
                          dtype=torch.int64)


def select_drawn(cfg: PolicyConfig, plan: WindowPlan, state: SchedState,
                 pos: int, object_id: torch.Tensor,
                 drawn: Sequence[torch.Tensor]) -> torch.Tensor:
    """A randomized policy's target from its draws, one (...) tensor each
    (a row of `draw_candidates` unbound, or `lcg_draws`): trh the lighter
    of the two drawn positions of the sorted list, nltr the same inside
    the request's section, two_choice the lightest of the default home
    and the drawn servers (the first on a tie).  Returns (...) int64."""
    if cfg.name == "trh":
        return _two_random_min_load(state, plan.sorted_servers, *drawn)
    if cfg.name == "nltr":
        lo = plan.req_section[..., pos] * plan.sec_size
        return _two_random_min_load(state, plan.sorted_servers,
                                    lo + drawn[0], lo + drawn[1])
    m = state.n_servers
    cand = torch.stack([object_id.to(torch.int64) % m, *drawn], dim=-1)
    best = torch.argmin(torch.gather(state.loads, -1, cand), dim=-1)
    return policy_core.take(cand, best)


def select_target(cfg: PolicyConfig, plan: WindowPlan, state: SchedState,
                  pos: int, object_id: torch.Tensor, length: torch.Tensor,
                  key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-request target server (before the redirect guard); ``pos`` is
    the request's position in the window's processing order.  A
    randomized policy draws its candidates from the request's threefry
    ``key`` (..., 2) as the reference does; the others ignore it.
    Returns (...) int64."""
    m = state.n_servers
    if cfg.name == "rr":
        return object_id.to(torch.int64) % m
    if cfg.name == "mlml":
        # k-th longest request -> k-th lightest server, circularly (Alg. 1)
        return plan.sorted_servers[..., pos % m]
    if cfg.name == "ect":
        return torch.argmin(policy_core.ect_scores(
            state.loads, state.est_rates, length), dim=-1)
    if key is None:
        raise ValueError(f"{cfg.name} draws its candidates from a request "
                         "key: pass key=")
    return select_drawn(cfg, plan, state, pos, object_id,
                        draw_candidates(cfg, key, m).unbind(-1))


def lcg_draws(cfg: PolicyConfig, rng: torch.Tensor, n_servers: int):
    """The stream kernel's draws of a randomized policy from the uint32
    LCG state ``rng`` (int64 holding uint32, (...)): trh and nltr one
    `policy_core.two_random_draws`, two_choice ``probe_choices - 1``
    single steps.  Returns ``(draws, rng)``, the draws a list of (...)
    int64 tensors."""
    m = n_servers
    if cfg.name == "two_choice":
        drawn = []
        for _ in range(cfg.probe_choices - 1):
            rng = policy_core.lcg_step(rng)
            drawn.append(policy_core.lcg_mod(rng, m))
        return drawn, rng
    size = max(m // 2, 1) if cfg.name == "trh" else max(m // cfg.k_sections,
                                                        1)
    i1, i2, rng = policy_core.two_random_draws(rng, size)
    return [i1, i2], rng


def select_target_rng(cfg: PolicyConfig, plan: WindowPlan, state: SchedState,
                      pos: int, object_id: torch.Tensor,
                      length: torch.Tensor, rng: torch.Tensor):
    """`select_target` threading the uint32 LCG state ``rng`` (int64
    tensor, (...)): under ``rng="lcg"`` a randomized policy takes
    `lcg_draws` exactly as the stream kernel does, on padding rows too; a
    deterministic policy passes ``rng`` through.  (Under ``rng="jax"`` a
    randomized policy draws from keys: `select_target`, or
    `draw_candidates` and `select_drawn`.)  Returns ``(target, rng)``."""
    if cfg.name in RANDOM_POLICIES and cfg.rng == "lcg":
        drawn, rng = lcg_draws(cfg, rng, state.n_servers)
        return select_drawn(cfg, plan, state, pos, object_id, drawn), rng
    return select_target(cfg, plan, state, pos, object_id, length), rng


def apply_threshold(cfg: PolicyConfig, state: SchedState,
                    default: torch.Tensor, target: torch.Tensor,
                    length: torch.Tensor) -> torch.Tensor:
    """The paper's redirect guard: take ``target`` only where its benefit
    (`policy_core.redirect_benefit`, on the estimated rates for ect)
    exceeds the threshold; rr always keeps ``default``."""
    if cfg.name == "rr":
        return default
    benefit = policy_core.redirect_benefit(cfg.name, state.loads,
                                           state.est_rates, default, target,
                                           length)
    return torch.where(benefit > policy_core.const(cfg.threshold, benefit),
                       target, default)


# ---------------------------------------------------------------------------
# The host scheduler: the real I/O client's hot path
# ---------------------------------------------------------------------------


class HostScheduler:
    """`plan_window`, `select_target` and `apply_threshold` one request at
    a time on a `statlog.HostStatLog` (float64, on the CPU).

    A window is opened by `begin_window`, which sorts the servers once;
    `schedule` then places one request and books it in the log.

    The two-random draws come from numpy's seeded ``default_rng(seed)``
    (PCG64), as in the reference: torch has no PCG64, and a
    ``torch.Generator`` would place requests elsewhere.
    """

    def __init__(self, cfg: PolicyConfig, log: statlog.HostStatLog,
                 seed: int = 0):
        validate_policy(cfg, log.n_servers)
        self.cfg = cfg
        self.log = log
        self.rng = np.random.default_rng(seed)
        self.probe_messages = 0
        self._sorted_servers: Optional[List[int]] = None
        self._masked: set = set()

    # -- failure handling (the client's retry path) --------------------------
    def mask_server(self, server: int) -> None:
        """Exclude a failed server from future targets (until unmasked)."""
        self._masked.add(int(server))

    def unmask_server(self, server: int) -> None:
        self._masked.discard(int(server))

    @property
    def masked_servers(self) -> frozenset:
        return frozenset(self._masked)

    # -- window machinery ------------------------------------------------------
    def begin_window(self, lengths: Optional[Sequence[float]] = None) -> None:
        """Sort the servers by probability, highest first (a stable sort:
        ties to the lowest index, the stream kernel's all-pairs rank).
        nLTR sections the window's queued ``lengths`` here."""
        self._sorted_servers = torch.argsort(
            -self.log.probs, stable=True).tolist()
        self._pos = 0
        if self.cfg.name == "nltr" and lengths is not None and len(lengths):
            self._req_bounds = statlog.host_recursive_average_bounds(
                sorted((float(v) for v in lengths), reverse=True),
                self.cfg.nltr_n)
        else:
            self._req_bounds = None

    def _alive_lightest(self, loads: List[float]) -> int:
        alive = [s for s in range(len(loads)) if s not in self._masked]
        return min(alive, key=loads.__getitem__)

    def _two_random(self, lo: int, size: int, loads: List[float]) -> int:
        size = max(size, 1)
        ss = self._sorted_servers
        m = len(ss)
        cands = []
        for _ in range(8):  # rejection-sample around masked servers
            i1 = lo + int(self.rng.integers(0, size))
            i2 = lo + int(self.rng.integers(0, size))
            cands = [c for c in (ss[i1 % m], ss[i2 % m])
                     if c not in self._masked]
            if cands:
                break
        if not cands:  # the whole section masked: the global lightest
            return self._alive_lightest(loads)
        return min(cands, key=loads.__getitem__)

    def schedule(self, object_id: int, length_mb: float,
                 offset: int = 0) -> int:
        """Place one request; returns the chosen server and books it in
        the log (Eqs. (1)-(3))."""
        if self._sorted_servers is None:
            self.begin_window()
        cfg, log = self.cfg, self.log
        m = log.n_servers
        default = int(object_id) % m
        pos = self._pos
        self._pos += 1
        log.record_request(object_id, offset, length_mb)
        loads = log.loads.tolist()

        if cfg.name == "rr":
            target = default
        elif cfg.name == "mlml":
            target = self._sorted_servers[pos % m]
        elif cfg.name == "trh":
            target = self._two_random(0, max(m // 2, 1), loads)
        elif cfg.name == "nltr":
            k = cfg.k_sections
            sec = 0 if self._req_bounds is None else sum(
                b <= pos for b in self._req_bounds)
            sec = min(sec, k - 1)
            sec_size = max(m // k, 1)
            target = self._two_random(sec * sec_size, sec_size, loads)
        elif cfg.name == "two_choice":
            cand = [default] + [int(self.rng.integers(0, m))
                                for _ in range(cfg.probe_choices - 1)]
            self.probe_messages += cfg.probe_choices
            cand = [c for c in cand if c not in self._masked] or cand
            target = min(cand, key=loads.__getitem__)
        elif cfg.name == "ect":
            ect = statlog.host_ect_scores(log.loads, log.est_rates,
                                          length_mb)
            if self._masked:
                ect[list(self._masked)] = float("inf")
            target = int(torch.argmin(ect))
        else:  # pragma: no cover
            raise AssertionError(cfg.name)

        if target in self._masked:
            target = self._alive_lightest(loads)
        if cfg.name != "rr" and default not in self._masked:
            benefit = statlog.host_redirect_benefit(
                cfg.name, loads, log.est_rates.tolist(), default, target,
                length_mb)
            chosen = target if benefit > cfg.threshold else default
        else:
            chosen = target
        log.apply_assignment(chosen, length_mb)
        return chosen
