"""Key-for-key parity of the port's trials with repro's: one seed, the
same trials.

* `run_trials(seed)` against ``repro.core.simulate.run_trials(
  jax.random.key(seed))`` at a small size, six policies × both client
  models × both backends (repro on the same backend; the randomized
  policies under the default ``rng="jax"``, drawn from threefry keys on
  the eager engine and from the kernels' LCG on the kernel backend):
  every `TrialResult` field bit for bit at ``init_load_std=0.0``, where
  no normal reaches the loads.
* At the defaults and the paper's widths (100 servers, 2,000 requests,
  20 trials): the choices, counts, masks, probes and initial loads bit
  for bit, every other float field within 1e-6 relative (the EWMA rows
  are not contracted as XLA contracts them, ROADMAP Queue C).
* The §4 prep against repro's ``_prep_trials`` at full size (T=100,
  R=2,000, M=100) for the shared log, per_client 200 and every scenario:
  every field bit for bit, the initial loads and the log's loads row that
  holds them included (`random.normal` is jax's bit for bit).
* ``SimConfig(prep="sequential")`` equal to ``"batched"``;
  `run_one_trial`, `run_scenario_eval` and `run_paper_eval` against
  repro's."""

import dataclasses
import functools
import inspect
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.core import simulate as jsim
from repro.core.policies import PolicyConfig as JPolicyConfig
from repro_torch import random
from repro_torch.core import simulate as tsim
from repro_torch.core.policies import PolicyConfig

POLICIES = ("rr", "mlml", "trh", "nltr", "two_choice", "ect")
SMALL = dict(n_servers=37, n_requests=250, n_trials=4, window_size=60,
             n_clients=9, init_load_std=0.0)


def _thr(name):
    return 0.05 if name == "ect" else 5.0


def _cfgs(fields, scenario="transient"):
    """The reference's and the port's `SimConfig` of ``fields``."""
    def scn(mod):
        return None if scenario is None else mod.ScenarioConfig(scenario)
    return (jsim.SimConfig(**fields, scenario=scn(jsim)),
            tsim.SimConfig(**fields, scenario=scn(tsim)))


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _assert_exact(got, ref, ctx):
    for f in got._fields:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        assert a.shape == b.shape, f"{ctx}: {f} shape {a.shape} {b.shape}"
        bad = np.argwhere(a != b)
        assert bad.size == 0, f"{ctx}: first divergence in {f} at {bad[0]}"


@pytest.mark.filterwarnings("ignore:per_client window clamp")
@pytest.mark.parametrize("backend", ["jax", "kernel"])
@pytest.mark.parametrize("client_model", ["shared_log", "per_client"])
@pytest.mark.parametrize("name", POLICIES)
def test_run_trials_key_for_key(name, client_model, backend):
    cfg_j, cfg_t = _cfgs(dict(SMALL, client_model=client_model,
                              backend=backend))
    ref = jsim.run_trials(jax.random.key(3), cfg_j,
                          JPolicyConfig(name=name, threshold=_thr(name)),
                          jsim.default_log_cfg(cfg_j))
    pol = PolicyConfig(name=name, threshold=_thr(name))
    got = tsim.run_trials(3, cfg_t, pol, tsim.default_log_cfg(cfg_t),
                          device="cpu")
    _assert_exact(got, ref, f"{name} {client_model} {backend}")
    # a key gives the same trials as its seed
    again = tsim.run_trials(random.key(3, device="cpu"), cfg_t, pol,
                            tsim.default_log_cfg(cfg_t), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(got, again))


PAPER_FIELDS = dict(n_trials=20)
EXACT_FIELDS = ("n_assigned", "chosen", "probe_msgs", "straggler_hits",
                "redirected", "straggler_mask", "window_size_eff")


@pytest.mark.parametrize("backend", ["jax", "kernel"])
@pytest.mark.parametrize("name", ["trh", "ect"])
def test_run_trials_at_defaults_measured_agreement(name, backend):
    cfg_j, cfg_t = _cfgs(dict(PAPER_FIELDS, backend=backend))
    ref = jsim.run_trials(jax.random.key(0), cfg_j,
                          JPolicyConfig(name=name, threshold=_thr(name)),
                          jsim.default_log_cfg(cfg_j))
    got = tsim.run_trials(0, cfg_t, PolicyConfig(name=name,
                                                 threshold=_thr(name)),
                          tsim.default_log_cfg(cfg_t), device="cpu")
    for f in EXACT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)
    init, rinit = got.init_loads.numpy(), np.asarray(ref.init_loads)
    assert _ulps(init, rinit).max() == 0
    for f in ("server_loads", "latencies", "phase_time", "window_loads"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-6,
                                   atol=0, err_msg=f)


@functools.lru_cache(maxsize=None)
def _reference_prep(items, scenario):
    cfg_j, _ = _cfgs(dict(items), scenario)
    keys = jax.random.split(jax.random.key(0), cfg_j.n_trials)
    log_j = jsim.default_log_cfg(cfg_j)
    return jax.jit(lambda ks: jsim._prep_trials(ks, cfg_j, log_j))(keys)


PREP_CASES = ([("shared_log", None, 0.0)]
              + [("shared_log", s, 0.0) for s in tsim.SCENARIOS]
              + [("shared_log", "static", 0.1),
                 ("per_client", "transient", 0.0)])


@pytest.mark.parametrize("client_model,scenario,straggler_frac", PREP_CASES)
def test_prep_matches_reference_at_paper_size(client_model, scenario,
                                              straggler_frac):
    fields = dict(client_model=client_model, straggler_frac=straggler_frac)
    _, cfg_t = _cfgs(fields, scenario)
    ref = _reference_prep(tuple(sorted(fields.items())), scenario)
    got = tsim._prep_trials(tsim.trial_keys(0, cfg_t, "cpu"), cfg_t,
                            tsim.default_log_cfg(cfg_t))
    init, rinit = got[0].numpy(), np.asarray(ref[0])
    assert init.shape == (100, 100)
    assert _ulps(init, rinit).max() == 0
    log, rlog = got[3].log.numpy(), np.asarray(ref[3].log)
    np.testing.assert_array_equal(log[:, 0], init)
    np.testing.assert_array_equal(log[:, 1:], rlog[:, 1:])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    for a, b in zip(got[2], ref[2]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for f in ("n_assigned", "rates", "vclock", "free_at"):
        np.testing.assert_array_equal(getattr(got[3], f).numpy(),
                                      np.asarray(getattr(ref[3], f)))
    if scenario is None:
        assert got[4] is None and ref[4] is None
    else:
        for a, b in zip(got[4], ref[4]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got[5].numpy(),
                                  np.asarray(jax.random.key_data(ref[5])))


@pytest.mark.filterwarnings("ignore:per_client window clamp")
@pytest.mark.parametrize("client_model", ["shared_log", "per_client"])
def test_prep_sequential_equals_batched(client_model):
    """One trial at a time at unbatched shapes gives the batched prep bit
    for bit, and so the same `TrialResult`."""
    fields = dict(SMALL, init_load_std=5.0, straggler_frac=0.1,
                  client_model=client_model)
    _, cfg = _cfgs(fields, "correlated_rack")
    seq = dataclasses.replace(cfg, prep="sequential")
    log = tsim.default_log_cfg(cfg)
    keys = tsim.trial_keys(5, cfg, "cpu")
    a = tsim._prep_trials(keys, cfg, log)
    b = tsim._prep_trials(keys, seq, log)
    flat = lambda p: [x for part in p for x in (  # noqa: E731
        part if isinstance(part, tuple) else (part,))]
    for x, y in zip(flat(a), flat(b)):
        assert x.shape == y.shape and torch.equal(x, y)
    pol = PolicyConfig(name="trh", threshold=5.0)
    ra = tsim.run_trials(5, cfg, pol, log, device="cpu")
    rb = tsim.run_trials(5, seq, pol, log, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(ra, rb))
    with pytest.raises(ValueError, match="prep"):
        tsim.SimConfig(prep="lax.map")


@functools.lru_cache(maxsize=None)
def _ref_one_trial(key_data, fields, name):
    cfg_j, _ = _cfgs(dict(fields))
    pol = JPolicyConfig(name=name, threshold=_thr(name))
    fn = jax.jit(lambda k: jsim.run_one_trial(k, cfg_j, pol,
                                              jsim.default_log_cfg(cfg_j)))
    return fn(jax.random.wrap_key_data(np.asarray(key_data, np.uint32)))


@pytest.mark.parametrize("backend", ["jax", "kernel"])
@pytest.mark.parametrize("name", ["mlml", "nltr", "two_choice"])
def test_run_one_trial_matches_reference(name, backend):
    fields = dict(SMALL, init_load_std=5.0, backend=backend)
    _, cfg_t = _cfgs(fields)
    log = tsim.default_log_cfg(cfg_t)
    pol = PolicyConfig(name=name, threshold=_thr(name))
    keys = tsim.trial_keys(3, cfg_t, "cpu")
    rows = tsim.run_trials(3, cfg_t, pol, log, device="cpu")
    for i in (0, cfg_t.n_trials - 1):
        got = tsim.run_one_trial(keys[i], cfg_t, pol, log, device="cpu")
        ref = _ref_one_trial(tuple(keys[i].tolist()),
                             tuple(sorted(fields.items())), name)
        _assert_exact(got, ref, f"{name} {backend} trial {i}")
        for f, a, b in zip(got._fields, got, rows):
            assert torch.equal(a, b[i]), f"{f}: run_one_trial vs row {i}"
    with pytest.raises(ValueError, match="shared_log"):
        tsim.run_one_trial(0, dataclasses.replace(
            cfg_t, client_model="per_client"), pol, log, device="cpu")


EVAL = dict(n_servers=24, n_requests=120, n_trials=3, window_size=40,
            init_load_std=0.0, backend="jax")


def test_run_scenario_eval_matches_reference():
    cfg_j, cfg_t = jsim.SimConfig(**EVAL), tsim.SimConfig(**EVAL)
    kw = dict(seed=4, scenario_names=("static", "transient",
                                      "correlated_rack"),
              policy_names=("rr", "trh", "ect"))
    ref = jsim.run_scenario_eval(cfg=cfg_j, **kw)
    got = tsim.run_scenario_eval(cfg=cfg_t, device="cpu", **kw)
    assert list(got) == list(ref)
    for scn in ref:
        assert list(got[scn]) == list(ref[scn])
        for name in ref[scn]:
            _assert_exact(got[scn][name], ref[scn][name], f"{scn} {name}")


def test_run_paper_eval_matches_reference():
    cfg_j, cfg_t = jsim.SimConfig(**EVAL), tsim.SimConfig(**EVAL)
    ref = jsim.run_paper_eval(seed=2, cfg=cfg_j)
    got = tsim.run_paper_eval(seed=2, cfg=cfg_t, device="cpu")
    assert list(got) == list(ref) == ["rr", "mlml", "trh", "1ltr", "2ltr",
                                      "two_choice"]
    for label in ref:
        _assert_exact(got[label], ref[label], label)


def test_eval_signatures_match_reference(monkeypatch):
    assert tsim.SWEEP_POLICIES == jsim.SWEEP_POLICIES
    assert tsim.SCENARIOS == jsim.SCENARIOS
    for fn in ("run_scenario_eval", "run_paper_eval", "run_one_trial",
               "run_trials"):
        pj = inspect.signature(getattr(jsim, fn)).parameters
        pt = inspect.signature(getattr(tsim, fn)).parameters
        assert list(pt)[:len(pj)] == [
            "key_or_seed" if n == "key" else n for n in pj], fn
        assert all(pt[n].default == pj[n].default for n in pj
                   if n not in ("key", "cfg")), fn
        assert pt["device"].default == "cuda", fn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for fn in (tsim.run_scenario_eval, tsim.run_paper_eval):
            with pytest.raises(RuntimeError, match="CUDA"):
                fn(cfg=tsim.SimConfig(**EVAL))
