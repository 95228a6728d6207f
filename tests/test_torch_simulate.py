"""Port parity of the paper's §4 sweep (the slice as a whole), the port's
own prep, and the port's isolation and device rules.

The reference's ``_prep_trials`` runs at a small `SimConfig`; its outputs
are carried across as numpy arrays with `repro_torch.interop`; the port's
``_sched_trials`` + ``_post_trials`` (CPU, plain kernel version) are then
held field by field against the reference's own ``_sched_trials`` +
``_post_trials`` on that same prep (what its jitted ``run_trials`` runs,
stage for stage): its kernel backend for ect and mlml, and its jax backend
(pinned bit-exact to the kernel backend by the reference's own tests,
randomised policies replaying the kernel's LCG) for the rest of the policy
sweep."""

import dataclasses
import functools
import inspect
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import simulate as jsim
from repro.core.policies import PolicyConfig as JPolicyConfig
from repro_torch import interop
from repro_torch.core import simulate as tsim
from repro_torch.core.policies import PolicyConfig

ROOT = Path(__file__).resolve().parents[1]
KEY = jax.random.key(2024)

SMALL = dict(n_servers=37, n_requests=250, n_trials=5, window_size=60)
WIDE = dict(n_servers=100, n_requests=400, n_trials=3, window_size=100)
# (config, policy, reference backend)
SLICE_CASES = [
    (SMALL, "ect", "kernel"),
    (SMALL, "mlml", "kernel"),
    (WIDE, "ect", "kernel"),
    (SMALL, "trh", "jax"),
    (SMALL, "nltr", "jax"),
    (SMALL, "rr", "jax"),
    (SMALL, "two_choice", "jax"),
]


@functools.lru_cache(maxsize=None)
def _reference_prep(fields, scenario):
    """The reference's prep for one config (shared by its policies; the
    prep does not depend on the policy or the scheduling backend)."""
    cfg_j = jsim.SimConfig(**dict(fields),
                           scenario=jsim.ScenarioConfig(scenario))
    log_j = jsim.default_log_cfg(cfg_j)
    keys = jax.random.split(KEY, cfg_j.n_trials)
    return jax.jit(lambda ks: jsim._prep_trials(ks, cfg_j, log_j))(keys)


def _port_from_reference(fields, scenario):
    init, mask, works, states, traces, k_sched = _reference_prep(
        tuple(sorted(fields.items())), scenario)
    return interop.from_prep(
        init_loads=np.asarray(init), straggler_mask=np.asarray(mask),
        object_ids=np.asarray(works.object_ids),
        lengths=np.asarray(works.lengths), valid=np.asarray(works.valid),
        log=np.asarray(states.log), n_assigned=np.asarray(states.n_assigned),
        rates=np.asarray(states.rates), vclock=np.asarray(states.vclock),
        free_at=np.asarray(states.free_at),
        keys=np.asarray(jax.random.key_data(k_sched)),
        trace_times=np.asarray(traces.times),
        trace_rates=np.asarray(traces.rates), device="cpu")


@pytest.mark.parametrize("case", SLICE_CASES,
                         ids=lambda c: f"M{c[0]['n_servers']}-{c[1]}-{c[2]}")
def test_slice_matches_reference(case):
    fields, policy, backend = case
    scenario = "transient"
    cfg_j = jsim.SimConfig(**fields, backend=backend,
                           scenario=jsim.ScenarioConfig(scenario))
    cfg_t = tsim.SimConfig(**fields, scenario=tsim.ScenarioConfig(scenario))
    log_j = jsim.default_log_cfg(cfg_j)
    log_t = tsim.default_log_cfg(cfg_t)
    assert log_t == type(log_t)(**dataclasses.asdict(log_j))
    thr = 0.05 if policy == "ect" else 5.0
    rng = "lcg" if policy in ("trh", "nltr", "two_choice") else "jax"
    pol_j = JPolicyConfig(name=policy, threshold=thr, rng=rng)
    init, mask, works, states, traces, k_sched = _reference_prep(
        tuple(sorted(fields.items())), scenario)
    ref = jax.jit(lambda *a: jsim._post_trials(
        cfg_j, a[0], a[1], a[2], a[4], *jsim._sched_trials(
            cfg_j, pol_j, log_j, a[2], a[3], a[5], a[4])))(
        init, mask, works, states, traces, k_sched)
    prep = _port_from_reference(fields, scenario)
    pol = PolicyConfig(name=policy, threshold=thr)
    sched = tsim._sched_trials(cfg_t, pol, log_t, prep.works, prep.states,
                               prep.keys, prep.traces)
    got = tsim._post_trials(cfg_t, prep.init_loads, prep.straggler_mask,
                            prep.works, prep.traces, *sched)
    assert got._fields == ref._fields
    for f in got._fields:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        bad = np.argwhere(a != b)
        where = ""
        if bad.size and f in ("chosen", "latencies"):
            where = (f" at trial {bad[0][0]}, window "
                     f"{bad[0][1] // cfg_t.window_size}")
        elif bad.size:
            where = f" at trial {bad[0][0]}"
        assert bad.size == 0 and a.shape == b.shape, (
            f"{policy}/{backend}: first diverging field {f}{where}")


def test_port_prep_distributions():
    cfg = tsim.SimConfig(**SMALL, straggler_frac=0.1,
                         scenario=tsim.ScenarioConfig("transient"))
    log = tsim.default_log_cfg(cfg)
    init, mask, works, states, traces, k_sched = tsim._prep_trials(
        tsim.trial_keys(11, cfg, "cpu"), cfg, log)
    t, m, r = cfg.n_trials, cfg.n_servers, cfg.n_requests
    assert init.shape == (t, m) and init.dtype == torch.float32
    assert mask.shape == (t, m) and mask.dtype == torch.bool
    assert works.object_ids.shape == (t, r)
    assert works.object_ids.dtype == torch.int32
    assert works.lengths.dtype == torch.float32 and bool(works.valid.all())
    assert states.log.shape == (t, 4, m) and states.n_assigned.shape == (t, m)
    assert k_sched.shape == (t, 2) and int(k_sched.min()) >= 0
    assert int(k_sched.max()) < 2 ** 32
    assert int(works.object_ids.min()) >= 0
    assert int(works.object_ids.max()) < 8 * m
    ln = works.lengths
    in_class = (((ln >= cfg.small_lo) & (ln <= cfg.small_hi))
                | ((ln >= cfg.small_hi) & (ln <= cfg.medium_hi))
                | ((ln >= cfg.medium_hi) & (ln <= cfg.large_hi)))
    assert bool(in_class.all())
    n_strag = int(round(0.1 * m))
    assert (mask.sum(dim=-1) == n_strag).all()
    assert bool((init[~mask] >= 0).all())
    scn = cfg.scenario
    slow = scn.base_rate_mb_s / scn.slow_factor
    vals = traces.rates.unique().tolist()
    assert set(vals) <= {scn.base_rate_mb_s, np.float32(slow).item()}
    assert ((traces.rates[:, 1] < scn.base_rate_mb_s).sum(dim=-1)
            == n_strag).all()
    sums = states.log[:, 1].double().sum(dim=-1)
    np.testing.assert_allclose(sums.numpy(), 1.0, atol=1e-6)
    again = tsim._prep_trials(tsim.trial_keys(11, cfg, "cpu"), cfg, log)
    for a, b in zip(jax.tree_util.tree_leaves(
            (init, mask, works, states, traces, k_sched)),
            jax.tree_util.tree_leaves(again)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("scenario", tsim.SCENARIOS)
def test_port_scenario_traces(scenario):
    """Every scenario's trace against the reference's `make_trace` on the
    same keys: the event times and rate rows bit for bit (base/slow rows
    with as many slow servers, a contiguous rack for correlated_rack),
    and `trace_straggler_mask` on the port's trace."""
    fields = dict(n_servers=37, n_requests=250, n_trials=4, window_size=60)
    cfg_t = tsim.SimConfig(**fields, scenario=tsim.ScenarioConfig(scenario))
    cfg_j = jsim.SimConfig(**fields, scenario=jsim.ScenarioConfig(scenario))
    assert tsim.resolve_window_dt(cfg_t, cfg_t.scenario) == \
        jsim.resolve_window_dt(cfg_j, cfg_j.scenario)
    keys = jax.random.split(KEY, 4)
    got = tsim.make_trace(torch.from_numpy(np.asarray(
        jax.random.key_data(keys)).astype(np.int64)), cfg_t, cfg_t.scenario)
    full = jax.vmap(lambda k: jsim.make_trace(k, cfg_j, cfg_j.scenario))(keys)
    np.testing.assert_array_equal(got.times.numpy(), np.asarray(full.times))
    np.testing.assert_array_equal(got.rates.numpy(), np.asarray(full.rates))
    want = jsim.make_trace(KEY, cfg_j, cfg_j.scenario)
    times, rates = got.times.numpy(), got.rates.numpy()
    assert times.shape == (4,) + want.times.shape
    assert rates.shape == (4,) + want.rates.shape
    np.testing.assert_array_equal(times, np.broadcast_to(
        np.asarray(want.times), times.shape))
    base = np.float32(cfg_t.scenario.base_rate_mb_s)
    slow = np.float32(base / cfg_t.scenario.slow_factor)
    assert set(np.unique(rates)) <= {base, slow}
    want_slow = (np.asarray(want.rates) == slow).sum(axis=-1)
    np.testing.assert_array_equal((rates == slow).sum(axis=-1),
                                  np.broadcast_to(want_slow, rates.shape[:2]))
    mask = tsim.trace_straggler_mask(got, cfg_t.scenario).numpy()
    for t in range(4):
        np.testing.assert_array_equal(mask[t], np.asarray(
            jsim.trace_straggler_mask(
                want._replace(times=jnp.asarray(times[t]),
                              rates=jnp.asarray(rates[t])),
                cfg_j.scenario)))
        if scenario == "correlated_rack":
            slow_ids = np.flatnonzero(mask[t])
            assert slow_ids.size == cfg_t.scenario.rack_size
            assert slow_ids[-1] - slow_ids[0] == slow_ids.size - 1


@pytest.mark.parametrize("workload", ["small", "medium", "large"])
def test_port_run_trials_on_cpu(workload):
    cfg = tsim.SimConfig(n_servers=24, n_requests=120, n_trials=3,
                         window_size=40, workload=workload)
    lo, hi = {"small": (0.25, 4.0), "medium": (4.0, 10.0),
              "large": (10.0, 1024.0)}[workload]
    log = tsim.default_log_cfg(cfg)
    works = tsim._prep_trials(tsim.trial_keys(5, cfg, "cpu"), cfg, log)[2]
    assert bool(((works.lengths >= lo) & (works.lengths <= hi)).all())
    res = tsim.run_trials(5, cfg, PolicyConfig(name="mlml", threshold=5.0),
                          log, device="cpu")
    again = tsim.run_trials(5, cfg, PolicyConfig(name="mlml", threshold=5.0),
                            log, device="cpu")
    for a, b in zip(res, again):
        assert torch.equal(a, b)
    assert res.chosen.shape == (3, 120) and res.phase_time.shape == (3,)
    assert bool(torch.isfinite(res.latencies).all())
    np.testing.assert_array_equal(res.n_assigned.sum(dim=-1).numpy(), 120)


def test_port_sources_import_no_jax_or_reference():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)",
                         re.MULTILINE)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        hits = pattern.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


def test_run_trials_defaults_to_cuda_and_never_falls_back(monkeypatch):
    assert inspect.signature(tsim.run_trials).parameters[
        "device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tsim.SimConfig(n_servers=8, n_requests=16, n_trials=2,
                         window_size=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsim.run_trials(0, cfg, PolicyConfig(name="rr"),
                        tsim.default_log_cfg(cfg))


@pytest.mark.parametrize("fields,match", [
    (dict(mesh_shape=(1, 2)), "shards a client axis but client_model="),
    (dict(mesh_shape=(0,)), "positive rank counts"),
    (dict(mesh_shape=(1, 2, 3)), "positive rank counts"),
    (dict(mesh_shape="2x2"), "tuple of 1 or 2 positive rank counts"),
    (dict(mesh_shape=[2, 2], client_model="per_client"), None),
    (dict(tiles="tuned", trial_tile=4, mesh_shape=(4,)), None),
])
def test_mesh_shape_validation(fields, match):
    """`SimConfig.mesh_shape` is validated as the reference validates it
    (repro.core.simulate.SimConfig): a client axis on the shared log, a
    rank count below 1 or a third axis raise; a list normalizes to a
    tuple, and the tile knobs combine with a mesh."""
    if match is not None:
        with pytest.raises(ValueError, match=match):
            tsim.SimConfig(**fields)
        return
    cfg = tsim.SimConfig(**fields)
    assert cfg.mesh_shape == tuple(fields["mesh_shape"])
    assert dataclasses.replace(cfg).mesh_shape == cfg.mesh_shape


@pytest.mark.parametrize("mesh_shape", [(2,), (1, 4)])
def test_mesh_larger_than_world_raises_naming_world_size(mesh_shape):
    """Without a process group the world is one rank: a larger mesh raises
    naming the world size, before any group starts."""
    cfg = tsim.SimConfig(n_servers=8, n_requests=16, n_trials=2,
                         window_size=8, client_model="per_client",
                         n_clients=4, mesh_shape=mesh_shape)
    with pytest.raises(ValueError, match="does not divide the world size 1"):
        tsim.run_trials(0, cfg, PolicyConfig(name="rr"),
                        tsim.default_log_cfg(cfg), device="cpu")
    assert not torch.distributed.is_initialized()


def test_paper_field_errors():
    for fields in (dict(workload="huge"), dict(client_model="x"),
                   dict(backend="tpu"), dict(n_clients=0),
                   dict(client_model="per_client", client_tile=0)):
        with pytest.raises(ValueError):
            tsim.SimConfig(**fields)
    with pytest.raises(ValueError, match="scenario"):
        tsim.ScenarioConfig("meteor")
