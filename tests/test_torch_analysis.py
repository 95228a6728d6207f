"""Port parity of the sweep analysis: every function of
repro_torch.core.analysis against repro.core.analysis on the same
arrays — a port `run_trials` result (CPU) as torch tensors for the port
and as numpy arrays for the reference.  Floats to 1e-6 relative; the
nearest-rank p99 bit for bit."""

import numpy as np
import pytest
import torch

from repro.core import analysis as janalysis
from repro_torch.core import analysis as tanalysis
from repro_torch.core import simulate as tsim
from repro_torch.core.policies import PolicyConfig

POLICIES = ("rr", "ect", "trh")


@pytest.fixture(scope="module")
def results():
    cfg = tsim.SimConfig(n_servers=37, n_requests=250, n_trials=4,
                         window_size=60, straggler_frac=0.1,
                         scenario=tsim.ScenarioConfig("transient"))
    log = tsim.default_log_cfg(cfg)
    return {p: tsim.run_trials(3, cfg, PolicyConfig(
        name=p, threshold=0.05 if p == "ect" else 5.0), log, device="cpu")
        for p in POLICIES}


def _numpy(res):
    return type(res)(*(x.numpy() for x in res))


def _same_dict(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert isinstance(got[k], float), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("policy", POLICIES)
def test_trial_metrics_match_reference(results, policy):
    res = results[policy]
    ref = _numpy(res)
    _same_dict(tanalysis.load_balance_stats(res.server_loads),
               janalysis.load_balance_stats(ref.server_loads))
    _same_dict(tanalysis.load_balance_stats(res.server_loads[0]),
               janalysis.load_balance_stats(ref.server_loads[0]))
    np.testing.assert_allclose(tanalysis.mean_server_loads(res.server_loads),
                               janalysis.mean_server_loads(ref.server_loads),
                               rtol=1e-6)
    for kw in ({}, dict(n_bins=12, lo=0.0, hi=500.0), dict(lo=5.0, hi=5.0)):
        for a, b in zip(tanalysis.fig18_curve(res.server_loads,
                                              res.n_assigned, **kw),
                        janalysis.fig18_curve(ref.server_loads,
                                              ref.n_assigned, **kw)):
            np.testing.assert_allclose(a, b, rtol=1e-6)
    _same_dict(tanalysis.straggler_summary(res),
               janalysis.straggler_summary(ref))
    got, want = (tanalysis.latency_stats(res.latencies),
                 janalysis.latency_stats(ref.latencies))
    _same_dict(got, want)
    assert got["p99_nearest"] == want["p99_nearest"]
    assert tanalysis.makespan(res) == pytest.approx(janalysis.makespan(ref),
                                                    rel=1e-6)
    for a, b in zip(tanalysis.latency_cdf(res.latencies, 32),
                    janalysis.latency_cdf(ref.latencies, 32)):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    for ws in (60, 64):
        np.testing.assert_allclose(
            tanalysis.straggler_hits_over_time(res.chosen,
                                               res.straggler_mask, ws),
            janalysis.straggler_hits_over_time(ref.chosen,
                                               ref.straggler_mask, ws),
            rtol=1e-6)
    np.testing.assert_allclose(
        tanalysis.straggler_hits_over_time(res.chosen[0],
                                           res.straggler_mask[0], 60),
        janalysis.straggler_hits_over_time(ref.chosen[0],
                                           ref.straggler_mask[0], 60),
        rtol=1e-6)


def test_cross_policy_metrics_match_reference(results):
    refs = {k: _numpy(v) for k, v in results.items()}
    for base in ("rr", "ect"):
        got = tanalysis.slowdown_vs_baseline(results, base)
        want = janalysis.slowdown_vs_baseline(refs, base)
        assert got.keys() == want.keys()
        for k in want:
            _same_dict(got[k], want[k])
    _same_dict(tanalysis.probe_overhead(results, 250),
               janalysis.probe_overhead(refs, 250))
    ys = results["ect"].latencies.double().mean(dim=0)
    for kw in ({}, dict(width=20, height=5, label="p99")):
        assert tanalysis.ascii_plot(ys, **kw) == janalysis.ascii_plot(
            ys.numpy(), **kw)
    flat = torch.zeros(10)
    assert tanalysis.ascii_plot(flat) == janalysis.ascii_plot(flat.numpy())


@pytest.mark.parametrize("n", [1, 99, 100, 101, 199, 2000])
def test_both_p99_definitions_match_reference(n):
    """The nearest-rank p99 bit for bit and the interpolated one to 1e-6
    relative, at sizes where 0.99·n falls on and between order
    statistics, with ties."""
    rng = np.random.default_rng(n)
    lat = rng.choice(np.linspace(0.0, 5.0, max(n // 3, 2)), n).astype(
        np.float32)
    got = tanalysis.latency_stats(torch.from_numpy(lat))
    want = janalysis.latency_stats(lat)
    assert got["p99_nearest"] == want["p99_nearest"]
    _same_dict(got, want)
    k = int(np.ceil(0.99 * n))
    assert got["p99_nearest"] == np.sort(lat)[k - 1]
