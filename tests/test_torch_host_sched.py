"""Port parity of the host log and the host scheduler: repro_torch's
`HostStatLog` / `HostScheduler` (float64 tensors on the CPU) against
repro's numpy twins on the same operations.

Every decision and every exact quantity is bit-equal: chosen servers,
probe messages, the loads row, ``n_assigned``, the Fig. 8 request table,
``vclock`` and ``free_at``.  The float64 rows that go through ``exp`` or a
sum (probs, and the ewma/est rows) are held to 1e-12 relative; the port
sums them in numpy's pairwise association (`statlog.host_sum`).  The
cases mirror tests/test_statlog.py and tests/test_policies.py where they
touch the host twins; the hypothesis streams run under the ``ci``
profile."""

import numpy as np
import pytest
import torch
from hypothesis import given, strategies as st

from repro.core import policies as jpol
from repro.core import statlog as jstatlog
from repro_torch import random
from repro_torch.core import engine as tengine
from repro_torch.core import policies as tpol
from repro_torch.core import statlog as tstatlog
from repro_torch.core.policy_core import N_ROWS, ROW_LOADS

POLICIES = ("rr", "mlml", "trh", "nltr", "two_choice", "ect")


def _logs(m, lam=32.0, alpha=0.25, init_loads=None):
    ref = jstatlog.HostStatLog(jstatlog.LogConfig(n_servers=m, lam=lam,
                                                  ewma_alpha=alpha),
                               init_loads)
    port = tstatlog.HostStatLog(tstatlog.LogConfig(n_servers=m, lam=lam,
                                                   ewma_alpha=alpha),
                                init_loads)
    return ref, port


def assert_logs_equal(ref, port):
    """Loads, counts, clock and the request table bit-equal; probs and
    the ewma/est rows to 1e-12 relative."""
    assert port.table.dtype == torch.float64 and port.table.device.type \
        == "cpu"
    np.testing.assert_array_equal(port.loads.numpy(), ref.loads)
    np.testing.assert_array_equal(port.n_assigned.numpy(), ref.n_assigned)
    assert port.vclock == ref.vclock
    np.testing.assert_array_equal(port.free_at.numpy(), ref.free_at)
    np.testing.assert_array_equal(port.rates.numpy(), ref.rates)
    assert port.request_log == ref.request_log
    for row in ("probs", "ewma_lat", "est_rates"):
        np.testing.assert_allclose(getattr(port, row).numpy(),
                                   getattr(ref, row), rtol=1e-12, atol=0,
                                   err_msg=row)


# ---------------------------------------------------------------------------
# HostStatLog (tests/test_statlog.py)
# ---------------------------------------------------------------------------


@given(m=st.integers(2, 64),
       seq=st.lists(st.tuples(st.integers(0, 63), st.floats(0.01, 500.0)),
                    min_size=1, max_size=60))
def test_assignments_match_reference_and_stay_simplex(m, seq):
    ref, port = _logs(m)
    for srv, ln in seq:
        ref.apply_assignment(srv % m, ln)
        port.apply_assignment(srv % m, ln)
    assert_logs_equal(ref, port)
    assert abs(tstatlog.host_sum(port.probs) - 1.0) < 1e-6
    assert bool((port.probs >= -1e-12).all())


@given(m=st.integers(2, 32), srv=st.integers(0, 31),
       ln=st.floats(0.01, 100.0))
def test_eq123_single_assignment(m, srv, ln):
    ref, port = _logs(m, lam=16.0)
    ref.apply_assignment(srv % m, ln)
    port.apply_assignment(srv % m, ln)
    assert_logs_equal(ref, port)
    assert port.loads[srv % m].item() == ln                      # Eq. 1


@given(m=st.integers(2, 16),
       seq=st.lists(st.tuples(st.integers(0, 4), st.integers(0, 15),
                              st.floats(0.1, 50.0)),
                    min_size=1, max_size=40))
def test_op_streams_match_reference(m, seq):
    """Assignments, observations, drains, completions, renormalisation and
    absorption, interleaved; est_rates stays ect_rates(ewma) throughout."""
    ref, port = _logs(m, lam=24.0, alpha=0.3)
    rates = np.linspace(20.0, 200.0, m)
    ref.set_rates(rates)
    port.set_rates(rates)
    for kind, srv, val in seq:
        srv = srv % m
        for log in (ref, port):
            if kind == 0:
                log.apply_assignment(srv, val)
            elif kind == 1:
                log.observe_completion(srv, val)
            elif kind == 2:
                log.advance_time(val / 100.0)
            elif kind == 3:
                log.complete(srv, val)
                log.renormalize()
            else:
                log.absorb_loads()
        assert port.estimated_latency(srv) == ref.estimated_latency(srv)
    assert_logs_equal(ref, port)
    np.testing.assert_array_equal(
        port.est_rates.numpy(),
        tstatlog.host_ect_rates(port.ewma_lat).numpy())


def test_heavier_server_has_lower_prob():
    ref, port = _logs(4, lam=10.0)
    for log in (ref, port):
        log.apply_assignment(0, 50.0)
        log.apply_assignment(1, 5.0)
    assert port.probs[0] < port.probs[1] < port.probs[2]
    assert port.probs[2] == port.probs[3]
    assert_logs_equal(ref, port)


def test_ewma_observation_and_complete():
    ref, port = _logs(3, alpha=0.5)
    for log in (ref, port):
        log.observe_completion(1, 100.0)
        log.observe_completion(1, 50.0)
        log.apply_assignment(0, 10.0)
        log.complete(0, 4.0)
    assert port.ewma_lat[1].item() == 75.0
    assert port.loads[0].item() == 6.0
    port.complete(0, 100.0)                      # never negative
    ref.complete(0, 100.0)
    assert port.loads[0].item() == 0.0
    assert_logs_equal(ref, port)


def test_renormalize_and_absorb_match_reference():
    ref, port = _logs(5)
    ref.probs = ref.probs * 1.1
    port.probs = port.probs * 1.1
    ref.renormalize()
    port.renormalize()
    assert abs(tstatlog.host_sum(port.probs) - 1.0) < 1e-12
    loads = np.asarray([3.0, 50.0, 0.0, 120.5, 7.25])
    ref.absorb_loads(loads)
    port.absorb_loads(loads)
    assert_logs_equal(ref, port)


@pytest.mark.parametrize("n", [1, 5, 8, 9, 100, 128, 129, 300, 1000])
def test_host_sum_is_numpys_association(n):
    """Bit-equal with numpy's pairwise sum on awkward magnitudes (where
    torch.sum's association differs)."""
    rng = np.random.default_rng(n)
    for _ in range(20):
        v = rng.uniform(0, 1, n) * 10.0 ** rng.uniform(-6, 6, n)
        assert tstatlog.host_sum(torch.from_numpy(v)) == \
            v.sum(axis=-1, keepdims=True)[0]


def test_request_log_and_row_views():
    """The Fig. 8 request table, and rows that alias the packed table."""
    ref, port = _logs(4)
    for log in (ref, port):
        log.record_request(12, 4096, 2.0)
        log.record_request(99, 0, 0.5)
    assert port.request_log == [(12, 4096, 2.0), (99, 0, 0.5)]
    port.loads[2] = 7.5
    assert port.table[ROW_LOADS, 2].item() == 7.5
    assert tuple(port.table.shape) == (N_ROWS, 4)
    port.est_rates = [1.0, 2.0, 3.0, 4.0]
    assert port.table[3].tolist() == [1.0, 2.0, 3.0, 4.0]


def test_est_rates_never_reads_true_rates():
    seq = [(0, 1, 10.0), (1, 1, 80.0), (0, 3, 4.0), (2, 0, 30.0),
           (1, 3, 15.0), (2, 0, 10.0), (1, 1, 60.0)]
    outs = []
    for rates in (np.ones(5), np.asarray([1e-3, 500.0, 7.0, 1e4, 0.5])):
        ref, port = _logs(5)
        for log in (ref, port):
            log.set_rates(rates)
            for kind, srv, val in seq:
                if kind == 0:
                    log.apply_assignment(srv, val)
                elif kind == 1:
                    log.observe_completion(srv, val)
                else:
                    log.advance_time(val / 100.0)
        assert_logs_equal(ref, port)
        outs.append((port.est_rates.clone(), port.loads.clone()))
    assert torch.equal(outs[0][0], outs[1][0])
    assert not torch.equal(outs[0][1], outs[1][1])


def test_snapshot_matches_reference_and_feeds_the_engine():
    """`snapshot(device="cpu")` equals the reference's `SchedState` (cast
    to float32/int32), and the engine schedules a window from it on both
    backends' plain form, bit for bit."""
    m = 24
    ref, port = _logs(m, lam=64.0)
    rates = np.linspace(50.0, 200.0, m)
    rng = np.random.default_rng(4)
    for log in (ref, port):
        log.set_rates(rates)
    for _ in range(30):
        srv, ln = int(rng.integers(0, m)), float(rng.uniform(1, 16))
        for log in (ref, port):
            log.apply_assignment(srv, ln)
            log.observe_completion(srv, float(rates[srv]))
        if rng.random() < 0.3:
            ref.advance_time(0.05)
            port.advance_time(0.05)
    want = ref.snapshot()
    got = port.snapshot(device="cpu")
    for name in got._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.device.type == "cpu"
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)

    work = tengine.Workload(
        torch.from_numpy(rng.integers(0, 1000, 40).astype(np.int32)),
        torch.from_numpy(rng.uniform(1, 16, 40).astype(np.float32)),
        torch.ones(40, dtype=torch.bool))
    kw = dict(policy=tpol.PolicyConfig(name="ect", threshold=0.05),
              log_cfg=tstatlog.LogConfig(n_servers=m, lam=64.0),
              window_size=20, window_dt=0.1, observe=True)
    key = random.key(0, "cpu")
    eager = tengine.run_stream(got, work, key, backend="jax", **kw)
    assert eager.chosen.shape == (40,)
    assert bool(((eager.chosen >= 0) & (eager.chosen < m)).all())
    assert torch.isfinite(eager.state.log).all()


def test_snapshot_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, port = _logs(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.snapshot()


# ---------------------------------------------------------------------------
# HostScheduler (tests/test_policies.py)
# ---------------------------------------------------------------------------


def _scheds(name, m, threshold=2.0, seed=0, lam=32.0, init_loads=None,
            **kw):
    ref_log, port_log = _logs(m, lam=lam, init_loads=init_loads)
    return (jpol.HostScheduler(jpol.PolicyConfig(name=name,
                                                 threshold=threshold, **kw),
                               ref_log, seed=seed),
            tpol.HostScheduler(tpol.PolicyConfig(name=name,
                                                 threshold=threshold, **kw),
                               port_log, seed=seed))


def _drive(scheds, windows, observe=None, mask=()):
    """Schedule the same windows of (object, MB) requests on both; returns
    the chosen servers of each."""
    out = ([], [])
    for srv in mask:
        for s in scheds:
            s.mask_server(srv)
    for win in windows:
        lens = [ln for _, ln in win]
        for s, got in zip(scheds, out):
            s.begin_window(lens)
            for oid, ln in win:
                c = s.schedule(oid, ln, offset=oid % 7)
                got.append(c)
                if observe is not None:
                    s.log.observe_completion(c, observe[c])
    return out


def _assert_scheds_equal(scheds, chosen):
    ref, port = scheds
    assert chosen[0] == chosen[1]
    assert port.probe_messages == ref.probe_messages
    assert port.masked_servers == ref.masked_servers
    assert_logs_equal(ref.log, port.log)


@pytest.mark.parametrize("policy", POLICIES)
@given(m=st.integers(4, 40), seed=st.integers(0, 2 ** 16),
       threshold=st.sampled_from([0.0, 2.0, 8.0]),
       windows=st.lists(st.lists(st.tuples(st.integers(0, 10 ** 6),
                                           st.floats(0.25, 64.0)),
                                 min_size=1, max_size=12),
                        min_size=1, max_size=4))
def test_six_policies_match_reference(policy, m, seed, threshold, windows):
    kw = {"nltr_n": 2} if policy == "nltr" else {}
    scheds = _scheds(policy, m, threshold=threshold, seed=seed, **kw)
    observe = np.linspace(40.0, 200.0, m) if policy == "ect" else None
    _assert_scheds_equal(scheds, _drive(scheds, windows, observe))


@pytest.mark.parametrize("policy", POLICIES)
def test_masked_servers_match_reference(policy):
    """Failed servers masked: the rejection draws, the global-lightest
    fallback (nltr's first section wholly masked) and the alive-lightest
    retarget agree with the reference."""
    m = 16
    rng = np.random.default_rng(11)
    init = rng.uniform(0.0, 40.0, m)
    kw = {"nltr_n": 2} if policy == "nltr" else {}
    scheds = _scheds(policy, m, threshold=0.5, seed=3, init_loads=init, **kw)
    for s in scheds:
        s.log.absorb_loads()
    # the four most probable servers: nltr's section 0
    mask = np.argsort(-scheds[0].log.probs, kind="stable")[:4].tolist()
    windows = [[(int(rng.integers(0, 10 ** 6)), float(rng.uniform(1, 60)))
                for _ in range(10)] for _ in range(3)]
    observe = np.linspace(40.0, 200.0, m)
    chosen = _drive(scheds, windows, observe, mask=mask + [mask[0]])
    _assert_scheds_equal(scheds, chosen)
    assert not set(chosen[1]) & set(mask)
    scheds[1].unmask_server(mask[0])
    assert mask[0] not in scheds[1].masked_servers


def test_trh_all_masked_but_two():
    host = tpol.HostScheduler(tpol.PolicyConfig(name="trh", threshold=0.0),
                              tstatlog.HostStatLog(
                                  tstatlog.LogConfig(n_servers=4)))
    host.mask_server(0)
    host.mask_server(1)
    host.begin_window()
    assert {host.schedule(i, 1.0) for i in range(20)} <= {2, 3}


@given(lens=st.lists(st.floats(0.01, 1000.0), min_size=1, max_size=40),
       n=st.integers(1, 4))
def test_nltr_sections_match_reference(lens, n):
    desc = sorted(lens, reverse=True)
    want = jpol.HostScheduler._recursive_average_bounds(
        np.sort(np.asarray(lens, np.float64))[::-1], n)
    got = tstatlog.host_recursive_average_bounds(desc, n)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_probe_accounting_and_validation():
    for k in (2, 3, 5):
        scheds = _scheds("two_choice", 8, probe_choices=k)
        chosen = _drive(scheds, [[(o, 1.0) for o in range(10)]])
        _assert_scheds_equal(scheds, chosen)
        assert scheds[1].probe_messages == 10 * k
    with pytest.raises(ValueError, match="nltr needs"):
        tpol.HostScheduler(tpol.PolicyConfig(name="nltr", nltr_n=3),
                           tstatlog.HostStatLog(
                               tstatlog.LogConfig(n_servers=4)))


@pytest.mark.parametrize("policy", ["rr", "mlml"])
def test_host_scheduler_matches_the_ports_engine(policy):
    """Deterministic policies: the host scheduler places a window as the
    port's eager engine does (replayed in the engine's processing
    order)."""
    m, n = 6, 24
    rng = np.random.default_rng(0)
    obj = rng.integers(0, 100, n).tolist()
    lens = rng.uniform(1, 30, n).astype(np.float32).astype(
        np.float64).tolist()
    cfg = tstatlog.LogConfig(n_servers=m, lam=32.0)
    pol = tpol.PolicyConfig(name=policy, threshold=2.0)
    res = tengine.run_window(
        tstatlog.init_state(cfg, device="cpu"),
        tengine.Workload(torch.tensor(obj, dtype=torch.int32),
                         torch.tensor(lens, dtype=torch.float32),
                         torch.ones(n, dtype=torch.bool)),
        random.key(0, "cpu"),
        policy=pol, log_cfg=cfg, group_steps=False)
    host = tpol.HostScheduler(pol, tstatlog.HostStatLog(cfg))
    host.begin_window(lens)
    order = (np.argsort([-v for v in lens], kind="stable")
             if policy == "mlml" else np.arange(n))
    got = np.empty(n, np.int64)
    for idx in order:
        got[idx] = host.schedule(obj[idx], lens[idx])
    np.testing.assert_array_equal(res.chosen.numpy(), got)
