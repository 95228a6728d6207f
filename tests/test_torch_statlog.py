"""Port parity of the eager engine's decision core: the `policy_core` and
`statlog` functions of repro_torch against repro's, batched and
unbatched.

The same rows, made with numpy from a seed, go through the reference's
function (unbatched, and under ``jax.vmap`` for a batch) and the port's
(whose functions take the batch axes directly).  Loads, latencies,
scores, benefits and est rows from an unchanged EWMA are bit-exact;
probs are held to 1e-6 and the EWMA/est rows of an observation to 1e-6
relative (XLA contracts the EWMA blend into an FMA on the CPU and its
``exp`` may differ by an ulp; ROADMAP Queue C, "Observed").  The bitonic
network forms equal the port's `rank_desc` and a stable argsort.  The
hypothesis cases mirror tests/test_statlog.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import policy_core as jpc
from repro.core import statlog as jstatlog
from repro_torch.core import policy_core as tpc
from repro_torch.core import statlog as tstatlog
from torch_jax_release import release_compiled_programs  # noqa: F401

M_SIZES = (17, 37)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rows(rng, lead, m):
    """loads, probs (on the simplex), ewma (a third unobserved), est,
    rates, server, length."""
    shape = lead + (m,)
    loads = rng.uniform(0.0, 300.0, shape).astype(np.float32)
    probs = rng.uniform(0.1, 1.0, shape).astype(np.float32)
    probs = (probs / probs.sum(axis=-1, keepdims=True)).astype(np.float32)
    ewma = rng.uniform(20.0, 400.0, shape).astype(np.float32)
    ewma[rng.random(shape) < 0.33] = 0.0
    est = np.asarray(jnp.vectorize(jpc.ect_rates, signature="(m)->(m)")(
        jnp.asarray(ewma)))
    rates = rng.uniform(25.0, 200.0, shape).astype(np.float32)
    server = rng.integers(0, m, lead).astype(np.int32)
    length = rng.uniform(0.25, 1024.0, lead).astype(np.float32)
    return loads, probs, ewma, est, rates, server, length


def _vmapped(fn, n_lead):
    for _ in range(n_lead):
        fn = jax.vmap(fn)
    return fn


def _close(got, want, rel=False, msg=""):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape, msg
    if rel:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=msg)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=msg)


def _same(got, want, msg=""):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape, msg
    np.testing.assert_array_equal(got, want, err_msg=msg)


@pytest.mark.parametrize("m", M_SIZES)
@pytest.mark.parametrize("lead", [(), (4,), (2, 3)])
def test_decision_core_matches_reference(m, lead):
    rng = np.random.default_rng(m + len(lead))
    loads, probs, ewma, est, rates, server, length = _rows(rng, lead, m)
    n = len(lead)
    target = rng.integers(0, m, lead).astype(np.int32)
    mbps = rng.uniform(5.0, 500.0, lead).astype(np.float32)
    j = lambda *a: tuple(jnp.asarray(x) for x in a)  # noqa: E731

    _same(tpc.ect_rates(_t(ewma)),
          _vmapped(jpc.ect_rates, n)(jnp.asarray(ewma)), "ect_rates")
    _same(tpc.ect_scores(_t(loads), _t(est), _t(length)),
          _vmapped(jpc.ect_scores, n)(*j(loads, est, length)), "ect_scores")
    for name in ("ect", "trh"):
        got = tpc.redirect_benefit(name, _t(loads), _t(est), _t(server),
                                   _t(target), _t(length))
        want = _vmapped(lambda lo, e, d, tg, ln, name=name:
                        jpc.redirect_benefit(name, lo, e, d, tg, ln), n)(
            *j(loads, est, server, target, length))
        _same(got, want, f"redirect_benefit {name}")
    _same(tpc.estimated_latency(_t(loads), _t(rates), _t(server)),
          _vmapped(jpc.estimated_latency, n)(*j(loads, rates, server)),
          "estimated_latency")

    lam = 48.0
    got_l, got_p = tpc.assignment_update(_t(loads), _t(probs), _t(server),
                                         _t(length), lam, m)
    want_l, want_p = _vmapped(
        lambda lo, p, s, ln: jpc.assignment_update(lo, p, s, ln, lam, m),
        n)(*j(loads, probs, server, length))
    _same(got_l, want_l, "assignment loads")
    _close(got_p, want_p, msg="assignment probs")

    got_e, got_s = tpc.observe_update(_t(ewma), _t(server), _t(mbps), 0.25)
    want_e, want_s = _vmapped(
        lambda e, s, v: jpc.observe_update(e, s, v, 0.25), n)(
        *j(ewma, server, mbps))
    _close(got_e, want_e, rel=True, msg="observe ewma")
    _close(got_s, want_s, rel=True, msg="observe est")

    _same(tpc.pack(*map(_t, (loads, probs, ewma, est))),
          _vmapped(jpc.pack, n)(*j(loads, probs, ewma, est)), "pack")


def test_two_random_draws_match_reference():
    seeds = np.array([0, 1, 12345, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1],
                     np.uint32)
    for n in (1, 2, 8, 18, 50):
        d1, d2, nxt = tpc.two_random_draws(_t(seeds.astype(np.int64)), n)
        w1, w2, wn = jax.vmap(lambda s: jpc.two_random_draws(s, n))(
            jnp.asarray(seeds))
        _same(d1, w1, f"d1 n={n}")
        _same(d2, w2, f"d2 n={n}")
        np.testing.assert_array_equal(nxt.numpy().astype(np.uint32),
                                      np.asarray(wn))


def _state(rng, lead, m):
    loads, probs, ewma, est, rates, server, length = _rows(rng, lead, m)
    log = np.stack([loads, probs, ewma, est], axis=-2)
    st = dict(log=log,
              n_assigned=rng.integers(0, 5, lead + (m,)).astype(np.int32),
              rates=rates, vclock=rng.uniform(0.0, 2.0, lead).astype(
                  np.float32),
              free_at=np.zeros(lead + (m,), np.float32))
    return st, server, length


def _jstate(st):
    return jstatlog.SchedState(**{k: jnp.asarray(v) for k, v in st.items()})


def _tstate(st):
    return tstatlog.SchedState(**{k: _t(v) for k, v in st.items()})


def _assert_state(got, want, ctx):
    """loads and every non-log field bit for bit, probs to 1e-6, ewma/est
    to 1e-6 relative."""
    for f in ("n_assigned", "rates", "vclock", "free_at"):
        _same(getattr(got, f), getattr(want, f), f"{ctx}: {f}")
    _same(got.loads, want.loads, f"{ctx}: loads")
    _close(got.probs, want.probs, msg=f"{ctx}: probs")
    _close(got.ewma_lat, want.ewma_lat, rel=True, msg=f"{ctx}: ewma")
    _close(got.est_rates, want.est_rates, rel=True, msg=f"{ctx}: est")


@pytest.mark.parametrize("m", M_SIZES)
@pytest.mark.parametrize("lead", [(), (5,)])
def test_statlog_updates_match_reference(m, lead):
    rng = np.random.default_rng(7 * m + len(lead))
    st, server, length = _state(rng, lead, m)
    cfg = dict(n_servers=m, lam=40.0, ewma_alpha=0.25)
    jcfg, tcfg = jstatlog.LogConfig(**cfg), tstatlog.LogConfig(**cfg)
    n = len(lead)
    js, ts = _jstate(st), _tstate(st)
    mbps = rng.uniform(5.0, 500.0, lead).astype(np.float32)
    dt = 0.04

    _assert_state(
        tstatlog.apply_assignment(ts, _t(server), _t(length), tcfg),
        _vmapped(lambda s, sv, ln: jstatlog.apply_assignment(s, sv, ln,
                                                             jcfg), n)(
            js, jnp.asarray(server), jnp.asarray(length)), "apply")
    _assert_state(
        tstatlog.observe_completion(ts, _t(server), _t(mbps), tcfg),
        _vmapped(lambda s, sv, v: jstatlog.observe_completion(s, sv, v,
                                                              jcfg), n)(
            js, jnp.asarray(server), jnp.asarray(mbps)), "observe")
    dec = tpc.window_decrements(ts.rates, dt)
    jdec = jpc.window_decrements(js.rates, dt)
    _same(dec, jdec, "window_decrements")
    _assert_state(
        tstatlog.advance_time(ts, dt, dec),
        _vmapped(lambda s, d: jstatlog.advance_time(s, jnp.float32(dt),
                                                    dec=d), n)(js, jdec),
        "advance_time")
    _same(tstatlog.estimated_latency(ts, _t(server)),
          _vmapped(jstatlog.estimated_latency, n)(js, jnp.asarray(server)),
          "estimated_latency")
    got, want = tstatlog.renormalize(ts), _vmapped(jstatlog.renormalize,
                                                   n)(js)
    _same(got.probs, want.probs, "renormalize")


def test_updates_never_write_into_the_state():
    """Under per_client the states are expanded views of one trial's
    state: every update builds new tensors and leaves its input as it
    was."""
    rng = np.random.default_rng(3)
    st, server, length = _state(rng, (2,), 17)
    base = _tstate(st)
    ts = tstatlog.SchedState(*(x[:, None].expand((2, 3) + x.shape[1:])
                               for x in base))
    before = [x.clone() for x in ts]
    cfg = tstatlog.LogConfig(n_servers=17)
    srv = _t(server)[:, None].expand(2, 3).contiguous()
    srv[:, 1] = (srv[:, 1] + 1) % 17
    ln = _t(length)[:, None].expand(2, 3)
    out = tstatlog.apply_assignment(ts, srv, ln, cfg)
    out = tstatlog.observe_completion(out, srv, ln, cfg)
    out = tstatlog.advance_time(out, 0.1, tpc.window_decrements(
        out.rates, 0.1))
    tstatlog.renormalize(out)
    for a, b in zip(ts, before):
        assert torch.equal(a, b)
    # the clients diverge: client 1 booked another server
    assert not torch.equal(out.loads[:, 0], out.loads[:, 1])


@pytest.mark.parametrize("r", [1, 2, 3, 17, 37, 64, 100, 128])
def test_bitonic_forms_equal_rank_desc_and_stable_argsort(r):
    """The bitonic network orders by (key desc, index asc), a strict total
    order: its permutation is the stable argsort's and the inverse of the
    port's `rank_desc`, batched, with heavy ties and invalid rows; the
    payloads are relocated untouched and the inverse apply puts them
    back."""
    rng = np.random.default_rng(r)
    for tie_pool in (None, 3):
        shape = (4, r)
        if tie_pool is None:
            keys = rng.uniform(0.0, 50.0, shape).astype(np.float32)
        else:
            keys = rng.choice(np.linspace(0, 2, tie_pool),
                              shape).astype(np.float32)
        obj = rng.integers(0, 997, shape).astype(np.int32)
        for valid in (rng.random(shape) > 0.3, np.zeros(shape, bool)):
            masked = np.where(valid, keys, -np.inf)
            want = np.argsort(-masked, axis=-1, kind="stable")
            order, skeys, (pobj, pkeys) = tpc.bitonic_sort_with_payload(
                _t(keys), (_t(obj), _t(keys)), valid=_t(valid))
            np.testing.assert_array_equal(order[:, :r].numpy(), want)
            np.testing.assert_array_equal(
                skeys[:, :r].numpy(), np.take_along_axis(masked, want, -1))
            np.testing.assert_array_equal(
                pobj[:, :r].numpy(), np.take_along_axis(obj, want, -1))
            np.testing.assert_array_equal(
                pkeys[:, :r].numpy(), np.take_along_axis(keys, want, -1))
            assert not pobj[:, r:].any()
            stable = torch.argsort(-torch.from_numpy(masked), dim=-1,
                                   stable=True)
            np.testing.assert_array_equal(stable.numpy(), want)
            rank, _ = tpc.rank_desc(_t(keys), valid=_t(valid))
            inv = torch.empty_like(rank).scatter_(
                -1, order[:, :r], torch.arange(r).expand(4, r))
            assert torch.equal(rank, inv)
            order2, _ = tpc.bitonic_argsort_desc(_t(keys), valid=_t(valid))
            assert torch.equal(order2, order)
            # and the reference's network agrees
            jorder, _ = jpc.bitonic_argsort_desc(jnp.asarray(keys),
                                                 valid=jnp.asarray(valid))
            np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
            back_obj, back_keys = tpc.bitonic_apply_inverse(order,
                                                            (pobj, pkeys))
            np.testing.assert_array_equal(back_obj[:, :r].numpy(), obj)
            np.testing.assert_array_equal(back_keys[:, :r].numpy(), keys)


# -- hypothesis cases, as tests/test_statlog.py's on the host twin --------


def _book(m, seq, lam=32.0):
    st = tstatlog.init_state(tstatlog.LogConfig(n_servers=m, lam=lam),
                             device="cpu")
    cfg = tstatlog.LogConfig(n_servers=m, lam=lam)
    for srv, ln in seq:
        st = tstatlog.apply_assignment(st, torch.tensor(srv % m),
                                       torch.tensor(ln, dtype=torch.float32),
                                       cfg)
    return st


@settings(max_examples=40, deadline=None)
@given(m=st.integers(2, 64),
       seq=st.lists(st.tuples(st.integers(0, 63), st.floats(0.01, 500.0)),
                    min_size=1, max_size=60))
def test_probs_stay_simplex(m, seq):
    """After any assignment sequence: sum(p) == 1 to float32 drift,
    p >= 0, loads >= 0, one request counted per booking."""
    st_ = _book(m, seq)
    assert abs(st_.probs.double().sum().item() - 1.0) < 1e-5
    assert bool((st_.probs >= 0).all()) and bool((st_.loads >= 0).all())
    assert int(st_.n_assigned.sum()) == len(seq)


@settings(max_examples=40, deadline=None)
@given(m=st.integers(2, 32), srv=st.integers(0, 31),
       ln=st.floats(0.01, 100.0))
def test_eq123_formulas(m, srv, ln):
    """One assignment matches the closed-form Eqs. (1)-(3)."""
    srv = srv % m
    lam = 16.0
    st_ = _book(m, [(srv, ln)], lam=lam)
    p0 = 1.0 / m
    ln32 = float(np.float32(ln))
    assert st_.loads[srv].item() == pytest.approx(ln32)
    decayed = p0 * np.exp(-ln32 / lam)
    assert st_.probs[srv].item() == pytest.approx(decayed, rel=1e-5)
    others = [j for j in range(m) if j != srv]
    expect = p0 + (p0 - decayed) / (m - 1)
    np.testing.assert_allclose(st_.probs[others].numpy(), expect, rtol=1e-5)


@settings(max_examples=25, deadline=None)
@given(m=st.integers(2, 16),
       seq=st.lists(st.tuples(st.integers(0, 15), st.floats(0.01, 200.0)),
                    min_size=1, max_size=30))
def test_port_and_reference_agree(m, seq):
    """The port's functional log and the reference's, one booking after
    another: loads bit for bit, probs to 1e-6."""
    cfg = dict(n_servers=m, lam=32.0)
    ts = tstatlog.init_state(tstatlog.LogConfig(**cfg), device="cpu")
    js = jstatlog.init_state(jstatlog.LogConfig(**cfg))
    upd = jax.jit(lambda s, sv, ln: jstatlog.apply_assignment(
        s, sv, ln, jstatlog.LogConfig(**cfg)))
    for srv, ln in seq:
        ln32 = np.float32(ln)
        ts = tstatlog.apply_assignment(ts, torch.tensor(srv % m),
                                       torch.tensor(ln32),
                                       tstatlog.LogConfig(**cfg))
        js = upd(js, jnp.int32(srv % m), jnp.float32(ln32))
    _same(ts.loads, js.loads)
    _same(ts.n_assigned, js.n_assigned)
    _close(ts.probs, js.probs)


@settings(max_examples=25, deadline=None)
@given(m=st.integers(2, 16),
       seq=st.lists(st.tuples(st.integers(0, 15), st.floats(0.1, 400.0)),
                    min_size=1, max_size=20))
def test_est_rates_is_pure_function_of_observations(m, seq):
    """The est row after any observation sequence is `ect_rates` of the
    EWMA row, and never reads the true rates."""
    cfg = tstatlog.LogConfig(n_servers=m)
    st_ = tstatlog.init_state(cfg, device="cpu")
    st_ = st_._replace(rates=torch.full((m,), 7.0))
    for srv, v in seq:
        st_ = tstatlog.observe_completion(st_, torch.tensor(srv % m),
                                          torch.tensor(np.float32(v)), cfg)
    assert torch.equal(st_.est_rates, tpc.ect_rates(st_.ewma_lat))
    assert torch.equal(st_.rates, torch.full((m,), 7.0))
