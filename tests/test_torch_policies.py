"""Port parity of the eager engine's policy rules: `plan_window`,
`select_target_rng` and `apply_threshold` of repro_torch against
repro's, for the six engine policies, on a (T,) batch of states against
the reference's unbatched functions under ``jax.vmap``; and the ``rng``
knob: its validation, and the randomized policies under ``rng="jax"``
(the reference's default), drawn from the same threefry keys.

The LCG parity runs under ``rng="lcg"`` on both sides: the draws come
from the same uint32 LCG states, so targets and the advanced states agree
bit for bit; under ``rng="jax"`` the draws come from the same keys, so
the targets and the window's decisions agree bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import policies as jpol
from repro.core import statlog as jstatlog
from repro_torch import random
from repro_torch.core import engine as tengine
from repro_torch.core import policies as tpol
from repro_torch.core import simulate as tsim
from repro_torch.core import statlog as tstatlog

T, R = 5, 60
POLICIES = ("rr", "mlml", "trh", "nltr", "two_choice", "ect")
# (policy, nltr_n, probe_choices)
CASES = [("rr", 2, 2), ("mlml", 2, 2), ("trh", 2, 2), ("nltr", 1, 2),
         ("nltr", 2, 2), ("nltr", 3, 2), ("two_choice", 2, 2),
         ("two_choice", 2, 3), ("ect", 2, 2)]


def _inputs(m, seed):
    rng = np.random.default_rng(seed)
    loads = rng.uniform(0.0, 300.0, (T, m)).astype(np.float32)
    loads[:, 3] = loads[:, 5]                      # a tied pair
    probs = rng.uniform(0.1, 1.0, (T, m)).astype(np.float32)
    probs[:, 2] = probs[:, 7]                      # tied probabilities
    probs = (probs / probs.sum(-1, keepdims=True)).astype(np.float32)
    ewma = rng.uniform(20.0, 400.0, (T, m)).astype(np.float32)
    ewma[:, ::3] = 0.0
    est = np.where(ewma > 0, ewma, np.maximum(ewma.max(-1, keepdims=True),
                                              1.0)).astype(np.float32)
    st = dict(log=np.stack([loads, probs, ewma, est], axis=1),
              n_assigned=np.zeros((T, m), np.int32),
              rates=rng.uniform(25.0, 200.0, (T, m)).astype(np.float32),
              vclock=np.zeros((T,), np.float32),
              free_at=np.zeros((T, m), np.float32))
    obj = rng.integers(0, 8 * m, (T, R)).astype(np.int32)
    lens = rng.uniform(0.25, 40.0, (T, R)).astype(np.float32)
    lens[:, 10] = lens[:, 20]                      # tied lengths
    valid = rng.random((T, R)) > 0.2
    valid[0] = False                               # an all-invalid window
    seeds = rng.integers(0, 2 ** 32, (T,), dtype=np.uint64).astype(
        np.uint32)
    return st, obj, lens, valid, seeds


def _j(st):
    return jstatlog.SchedState(**{k: jnp.asarray(v) for k, v in st.items()})


def _t(st):
    return tstatlog.SchedState(**{k: torch.from_numpy(v)
                                  for k, v in st.items()})


@pytest.mark.parametrize("m", [17, 37])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plan_and_selection_match_reference(case, m):
    name, nltr_n, pc = case
    st, obj, lens, valid, seeds = _inputs(m, seed=m * 10 + len(name))
    thr = 0.05 if name == "ect" else 4.0
    jp = jpol.PolicyConfig(name=name, threshold=thr, nltr_n=nltr_n,
                           probe_choices=pc, rng="lcg")
    tp = tpol.PolicyConfig(name=name, threshold=thr, nltr_n=nltr_n,
                           probe_choices=pc, rng="lcg")
    js, ts = _j(st), _t(st)
    jplan = jax.vmap(lambda s, o, ln, v: jpol.plan_window(jp, s, o, ln, v))(
        js, jnp.asarray(obj), jnp.asarray(lens), jnp.asarray(valid))
    tplan = tpol.plan_window(tp, ts, torch.from_numpy(obj),
                             torch.from_numpy(lens), torch.from_numpy(valid))
    for f in ("order", "sorted_servers", "req_section"):
        np.testing.assert_array_equal(getattr(tplan, f).numpy(),
                                      np.asarray(getattr(jplan, f)),
                                      err_msg=f)
    assert (np.asarray(jplan.sec_size) == tplan.sec_size).all()
    # the plan's orders equal the kernel's all-pairs ranks
    rank, _ = tpol.policy_core.rank_desc(ts.probs)
    inv = torch.empty_like(rank).scatter_(
        -1, tplan.sorted_servers, torch.arange(m).expand(T, m))
    assert torch.equal(rank, inv)

    key = jax.random.key(0)
    rng_t = torch.from_numpy(seeds.astype(np.int64))
    rng_j = jnp.asarray(seeds)
    for pos in (0, 1, 17, R - 1):
        o = obj[:, pos]
        ln = lens[:, pos]
        tgt, nrng = tpol.select_target_rng(tp, tplan, ts, pos,
                                           torch.from_numpy(o),
                                           torch.from_numpy(ln), rng_t)
        jtgt, jrng = jax.vmap(
            lambda pl, s, oo, ll, r: jpol.select_target_rng(
                jp, pl, s, jnp.int32(pos), oo, ll, key, r))(
            jplan, js, jnp.asarray(o), jnp.asarray(ln), rng_j)
        np.testing.assert_array_equal(tgt.numpy(), np.asarray(jtgt),
                                      err_msg=f"target at {pos}")
        np.testing.assert_array_equal(nrng.numpy().astype(np.uint32),
                                      np.asarray(jrng))
        default = o.astype(np.int64) % m
        ch = tpol.apply_threshold(tp, ts, torch.from_numpy(default), tgt,
                                  torch.from_numpy(ln))
        jch = jax.vmap(lambda s, d, tg, ll: jpol.apply_threshold(
            jp, s, d, tg, ll))(js, jnp.asarray(default, jnp.int32),
                               jtgt, jnp.asarray(ln))
        np.testing.assert_array_equal(ch.numpy(), np.asarray(jch),
                                      err_msg=f"chosen at {pos}")
        rng_t, rng_j = nrng, jrng


@pytest.mark.parametrize("thr", [0.0, 1e9])
def test_threshold_keeps_default_when_benefit_is_small(thr):
    """With a threshold no benefit reaches, every policy keeps the default
    home; with 0 any positive benefit redirects."""
    st, obj, lens, _, _ = _inputs(37, seed=2)
    ts = _t(st)
    default = torch.from_numpy(obj[:, 0].astype(np.int64) % 37)
    target = torch.argmin(ts.loads, dim=-1)
    for name in POLICIES:
        tp = tpol.PolicyConfig(name=name, threshold=thr, rng="lcg")
        ch = tpol.apply_threshold(tp, ts, default, target,
                                  torch.from_numpy(lens[:, 0]))
        if name == "rr" or thr > 0:
            assert torch.equal(ch, default)
        elif name != "ect":
            gain = ts.loads.gather(-1, default[:, None])[:, 0] > \
                ts.loads.gather(-1, target[:, None])[:, 0]
            assert torch.equal(ch, torch.where(gain, target, default))


def test_rng_is_validated():
    with pytest.raises(ValueError, match="rng"):
        tpol.PolicyConfig(rng="x")
    for rng in tpol.RNG_IMPLS:
        assert tpol.PolicyConfig(rng=rng).rng == rng
    assert tpol.PolicyConfig().rng == jpol.PolicyConfig().rng == "jax"
    assert tpol.RNG_IMPLS == jpol.RNG_IMPLS
    fields = {f.name for f in dataclasses.fields(tpol.PolicyConfig)}
    assert fields == {f.name for f in dataclasses.fields(jpol.PolicyConfig)}


@pytest.mark.parametrize("name", ["trh", "nltr", "two_choice"])
def test_eager_engine_refuses_threefry_keys(name):
    """Once a refusal (threefry was not ported), now the parity of a
    randomized policy under ``rng="jax"``: `select_target` with a key and
    `draw_candidates` against the reference's ``select_target`` (vmapped
    over the trials, every request position), and `run_window` against
    the reference's, on the same keys.  No entry point raises, on either
    backend."""
    m = 37
    st, obj, lens, valid, _ = _inputs(m, seed=3 + len(name))
    cases = [(2, 2), (1, 2), (3, 2)] if name == "nltr" else \
        [(2, 2), (2, 3)] if name == "two_choice" else [(2, 2)]
    keys = jax.random.split(jax.random.key(7), T)
    tkeys = torch.from_numpy(np.asarray(jax.random.key_data(keys)).astype(
        np.int64))
    for nltr_n, pc in cases:
        kw = dict(name=name, threshold=4.0, nltr_n=nltr_n, probe_choices=pc)
        jp, tp = jpol.PolicyConfig(**kw), tpol.PolicyConfig(**kw)
        js, ts = _j(st), _t(st)
        jplan = jax.vmap(lambda s, o, ln, v: jpol.plan_window(
            jp, s, o, ln, v))(js, jnp.asarray(obj), jnp.asarray(lens),
                              jnp.asarray(valid))
        tplan = tpol.plan_window(tp, ts, torch.from_numpy(obj),
                                 torch.from_numpy(lens),
                                 torch.from_numpy(valid))
        jreq = jax.vmap(lambda k: jax.random.split(k, R))(keys)
        treq = random.split(tkeys, R)
        np.testing.assert_array_equal(
            treq.numpy(), np.asarray(jax.random.key_data(jreq)))
        drawn = tpol.draw_candidates(tp, treq, m)
        for pos in (0, 1, 17, R - 1):
            want = jax.vmap(lambda pl, s, oo, ll, k: jpol.select_target(
                jp, pl, s, jnp.int32(pos), oo, ll, k))(
                jplan, js, jnp.asarray(obj[:, pos]), jnp.asarray(lens[:, pos]),
                jreq[:, pos])
            got = tpol.select_target(tp, tplan, ts, pos,
                                     torch.from_numpy(obj[:, pos]),
                                     torch.from_numpy(lens[:, pos]),
                                     treq[:, pos])
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"{kw} at {pos}")
            pre = tpol.select_drawn(tp, tplan, ts, pos,
                                    torch.from_numpy(obj[:, pos]),
                                    drawn[:, pos].unbind(-1))
            assert torch.equal(pre, got)
        # run_window on the same keys, grouped, observing
        jlog = jstatlog.LogConfig(n_servers=m, lam=50.0)
        tlog = tstatlog.LogConfig(n_servers=m, lam=50.0)
        ref = jax.jit(jax.vmap(lambda s, w, k: jengine.run_window(
            s, w, k, policy=jp, log_cfg=jlog, observe=True)))(
            js, jengine.Workload(jnp.asarray(obj), jnp.asarray(lens),
                                 jnp.asarray(valid)), keys)
        res = tengine.run_window(ts, tengine.Workload(
            torch.from_numpy(obj), torch.from_numpy(lens),
            torch.from_numpy(valid)), tkeys, policy=tp, log_cfg=tlog,
            observe=True)
        for f in ("chosen", "redirected", "latencies", "probe_msgs"):
            np.testing.assert_array_equal(getattr(res, f).numpy(),
                                          np.asarray(getattr(ref, f)),
                                          err_msg=f"{kw} run_window {f}")
        np.testing.assert_array_equal(res.state.loads.numpy(),
                                      np.asarray(ref.state.loads))
    # no entry point refuses rng="jax", on either backend
    pol = tpol.PolicyConfig(name=name)
    cfg = tsim.SimConfig(n_servers=17, n_requests=40, n_trials=2,
                         window_size=20, backend="jax")
    for backend in ("jax", "kernel"):
        res = tsim.run_trials(0, dataclasses.replace(cfg, backend=backend),
                              pol, tsim.default_log_cfg(cfg), device="cpu")
        assert res.chosen.shape == (2, 40)
    st2 = tstatlog.init_state(tstatlog.LogConfig(n_servers=17), batch=2,
                              device="cpu")
    work = tengine.Workload(torch.zeros((2, 20), dtype=torch.int32),
                            torch.ones((2, 20)),
                            torch.ones((2, 20), dtype=torch.bool))
    kw = dict(policy=pol, log_cfg=tstatlog.LogConfig(n_servers=17),
              window_size=10)
    keys2 = random.split(random.key(0, device="cpu"), 2)
    for backend in ("jax", "kernel"):
        res, _, _ = tengine.run_stream_batch(st2, work, keys2,
                                             backend=backend, **kw)
        assert res.chosen.shape == (2, 20)
        assert tengine.run_stream(st2, work, keys2, backend=backend,
                                  **kw).chosen.shape == (2, 20)


def test_deterministic_policies_ignore_rng(monkeypatch):
    """ect, mlml and rr take either rng on the eager engine; without a
    card the default device raises as it always does."""
    cfg = tsim.SimConfig(n_servers=17, n_requests=40, n_trials=2,
                         window_size=20, backend="jax")
    log = tsim.default_log_cfg(cfg)
    for name in ("ect", "mlml", "rr"):
        a = tsim.run_trials(0, cfg, tpol.PolicyConfig(name=name), log,
                            device="cpu")
        b = tsim.run_trials(0, cfg, tpol.PolicyConfig(name=name, rng="lcg"),
                            log, device="cpu")
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsim.run_trials(0, cfg, tpol.PolicyConfig(name="ect"), log)
