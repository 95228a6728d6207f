"""Port parity of the per_client contention sweep (the slice as a whole).

The reference's per_client ``_prep_trials`` runs at a small `SimConfig`;
its outputs are carried across with `repro_torch.interop`, with the
(T, C) LCG seeds derived as the reference derives them (each trial's
scheduling key split over the clients, then ``jax.random.bits``).  The
port's ``_sched_trials`` + ``_post_trials`` (CPU, plain kernel versions)
are held field by field against the reference's own stages on that prep:
its kernel backend (the 2-D Pallas grid, interpret mode) for ect and
mlml, and its jax backend (pinned bit-exact to the kernel backend by the
reference's own tests; randomised policies replay the kernel's LCG) for
the other policies.

Tolerance: every `TrialResult` field bit-exact.  (The probs and ewma/est
rows, held to 1e-6 and 1e-6 relative elsewhere, are not `TrialResult`
fields: only the decisions they drive are, and those agree exactly.)
"""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import simulate as jsim
from repro.core.policies import PolicyConfig as JPolicyConfig
from repro_torch import interop
from repro_torch.core import simulate as tsim
from repro_torch.core import statlog as tstatlog
from repro_torch.core.policies import PolicyConfig

KEY = jax.random.key(2024)

# (17 servers, 5 clients, 60 requests, 2 trials, window 16 -> 12)
CONTENTION = dict(n_servers=17, n_clients=5, n_requests=60, n_trials=2,
                  window_size=16)
# whole phantom clients (7 clients over 5 requests) and C not a multiple
# of the client tile
PHANTOM = dict(n_servers=11, n_clients=7, n_requests=5, n_trials=2,
               window_size=4, client_tile=2)
# the paper's 100 servers, 16 clients of 25 requests (window 100 -> 25)
WIDE = dict(n_servers=100, n_clients=16, n_requests=400, n_trials=2,
            window_size=100)
SLICE_CASES = [
    (CONTENTION, "ect", "kernel"),
    (CONTENTION, "mlml", "kernel"),
    (CONTENTION, "trh", "jax"),
    (CONTENTION, "nltr", "jax"),
    (CONTENTION, "rr", "jax"),
    (CONTENTION, "two_choice", "jax"),
    (PHANTOM, "two_choice", "jax"),
    (PHANTOM, "ect", "kernel"),
    (WIDE, "ect", "kernel"),
]


def _cfg_j(fields, backend="kernel"):
    return jsim.SimConfig(**fields, backend=backend,
                          client_model="per_client",
                          scenario=jsim.ScenarioConfig("transient"))


@functools.lru_cache(maxsize=None)
def _reference_prep(items):
    """The reference's prep for one config (shared by its policies)."""
    cfg_j = _cfg_j(dict(items))
    log_j = jsim.default_log_cfg(cfg_j)
    keys = jax.random.split(KEY, cfg_j.n_trials)
    return jax.jit(lambda ks: jsim._prep_trials(ks, cfg_j, log_j))(keys)


def _port_from_reference(fields):
    init, mask, works, states, traces, k_sched = _reference_prep(
        tuple(sorted(fields.items())))
    c = fields["n_clients"]
    client_keys = jax.vmap(lambda k: jax.random.split(k, c))(k_sched)
    seeds = jax.vmap(jax.vmap(
        lambda k: jax.random.bits(k, dtype=jnp.uint32)))(client_keys)
    assert seeds.shape == (fields["n_trials"], c)
    return interop.from_prep(
        init_loads=np.asarray(init), straggler_mask=np.asarray(mask),
        object_ids=np.asarray(works.object_ids),
        lengths=np.asarray(works.lengths), valid=np.asarray(works.valid),
        log=np.asarray(states.log), n_assigned=np.asarray(states.n_assigned),
        rates=np.asarray(states.rates), vclock=np.asarray(states.vclock),
        free_at=np.asarray(states.free_at), seeds=np.asarray(seeds),
        trace_times=np.asarray(traces.times),
        trace_rates=np.asarray(traces.rates), device="cpu")


@pytest.mark.filterwarnings("ignore:per_client window clamp")
@pytest.mark.parametrize(
    "case", SLICE_CASES,
    ids=lambda c: f"M{c[0]['n_servers']}-C{c[0]['n_clients']}-{c[1]}-{c[2]}")
def test_per_client_slice_matches_reference(case):
    fields, policy, backend = case
    cfg_j = _cfg_j(fields, backend)
    cfg_t = tsim.SimConfig(**fields, client_model="per_client",
                           scenario=tsim.ScenarioConfig("transient"))
    log_j = jsim.default_log_cfg(cfg_j)
    log_t = tsim.default_log_cfg(cfg_t)
    assert log_t == type(log_t)(**dataclasses.asdict(log_j))
    thr = 0.05 if policy == "ect" else 5.0
    rng = "lcg" if policy in ("trh", "nltr", "two_choice") else "jax"
    pol_j = JPolicyConfig(name=policy, threshold=thr, rng=rng)
    init, mask, works, states, traces, k_sched = _reference_prep(
        tuple(sorted(fields.items())))
    ref = jax.jit(lambda *a: jsim._post_trials(
        cfg_j, a[0], a[1], a[2], a[4], *jsim._sched_trials(
            cfg_j, pol_j, log_j, a[2], a[3], a[5], a[4])))(
        init, mask, works, states, traces, k_sched)
    prep = _port_from_reference(fields)
    pol = PolicyConfig(name=policy, threshold=thr)
    sched = tsim._sched_trials(cfg_t, pol, log_t, prep.works, prep.states,
                               prep.seeds, prep.traces)
    got = tsim._post_trials(cfg_t, prep.init_loads, prep.straggler_mask,
                            prep.works, prep.traces, *sched)
    assert got._fields == ref._fields
    for f in got._fields:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        bad = np.argwhere(a != b)
        where = f" at trial {bad[0][0]}" if bad.size else ""
        assert bad.size == 0 and a.shape == b.shape, (
            f"{policy}/{backend}: first diverging field {f}{where}")
    if fields is PHANTOM:
        np.testing.assert_array_equal(got.window_size_eff.numpy(), 1)
        if policy == "two_choice":
            np.testing.assert_array_equal(got.probe_msgs.numpy(),
                                          2 * cfg_t.n_requests)


def test_per_client_window_clamp_warns_and_records():
    """The clamp ``win = min(window_size, ceil(R / C))`` warns, naming
    both sizes, and lands in ``window_size_eff``; an unclamped run and
    the shared log stay silent and record the configured size."""
    cfg = tsim.SimConfig(n_servers=6, n_clients=4, n_requests=12,
                         n_trials=2, window_size=9, client_model="per_client")
    log = tsim.default_log_cfg(cfg)
    with pytest.warns(UserWarning, match="window_size=9.*window_size_eff=3"):
        res = tsim.run_trials(0, cfg, PolicyConfig(name="rr"), log,
                              device="cpu")
    np.testing.assert_array_equal(res.window_size_eff.numpy(), 3)
    for cfg2 in (dataclasses.replace(cfg, window_size=3),
                 dataclasses.replace(cfg, client_model="shared_log",
                                     window_size=4)):
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*window clamp.*")
            res2 = tsim.run_trials(0, cfg2, PolicyConfig(name="rr"),
                                   tsim.default_log_cfg(cfg2), device="cpu")
        np.testing.assert_array_equal(res2.window_size_eff.numpy(),
                                      cfg2.window_size)


def test_per_client_port_prep_shapes():
    """The port's own per_client prep draws one LCG state per client."""
    cfg = tsim.SimConfig(**CONTENTION, client_model="per_client")
    gen = torch.Generator().manual_seed(3)
    *_, seeds = tsim._prep_trials(gen, cfg, tsim.default_log_cfg(cfg),
                                  torch.device("cpu"))
    assert seeds.shape == (2, 5)
    assert int(seeds.min()) >= 0 and int(seeds.max()) < 2 ** 32


def test_init_state_defaults_to_cuda_and_never_falls_back(monkeypatch):
    """`init_state` and `init_table` run on the card unless the caller
    names the CPU, and raise where no card is visible."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tstatlog.LogConfig(n_servers=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tstatlog.init_state(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tstatlog.init_state(cfg, batch=3)
    assert tstatlog.init_state(cfg, batch=3, device="cpu").log.shape == \
        (3, 4, 8)


def test_per_client_run_trials_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tsim.SimConfig(n_servers=8, n_clients=2, n_requests=16,
                         n_trials=2, window_size=8,
                         client_model="per_client")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsim.run_trials(0, cfg, PolicyConfig(name="rr"),
                        tsim.default_log_cfg(cfg))
