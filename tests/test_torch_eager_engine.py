"""Port parity of the eager engine (``backend="jax"``): repro_torch's
`run_window`, `run_stream` (both backends), `run_stream_batch(backend=
"jax")` in its (T,) and (T, C) forms and `grouped_latency_block` against
repro's jax backend; and the port's `run_trials(backend="jax")` against
its own kernel path.

Inputs are made with numpy from a seed: object ids from a narrow range
(windows hold duplicate objects, triples included), about a tenth of the
requests invalid, a padded last window (R = 250 over windows of 60), and
a trace with an event exactly at a window's open.  Both sides take the
same threefry keys (the port derives the LCG seeds from them with
`repro_torch.random.bits`, as the reference does); the randomized
policies run under ``PolicyConfig(rng="lcg")`` on both sides here
(``rng="jax"`` is held in tests/test_torch_policies.py).

Against the reference: choices, redirected, latencies, window loads,
loads, ``n_assigned``, ``vclock``, ``free_at``, probe counts and the LCG
state bit for bit; probs to 1e-6; ewma and est to 1e-6 relative (XLA
contracts the EWMA blend into an FMA on the CPU; ROADMAP Queue C,
"Observed").  Against the port's kernel path: every field bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import policy_core as jpc
from repro.core import statlog as jstatlog
from repro.core.policies import PolicyConfig as JPolicyConfig
from repro_torch.core import engine as tengine
from repro_torch.core import simulate as tsim
from repro_torch.core import statlog as tstatlog
from repro_torch.core.policies import PolicyConfig
from repro_torch.kernels.sched_select import ops as tops

T, M, R, WIN, DT = 3, 37, 250, 60, 0.04
# (policy, observe, renorm, threshold, nltr_n, probe_choices, trace)
STREAM_CASES = [
    ("rr", True, True, 0.0, 2, 2, True),
    ("mlml", True, False, 4.0, 2, 2, True),
    ("mlml", False, True, 0.0, 2, 2, False),
    ("trh", False, True, 4.0, 2, 2, True),
    ("trh", True, True, 0.0, 2, 2, True),
    ("nltr", True, True, 0.0, 1, 2, True),
    ("nltr", False, False, 4.0, 2, 2, True),
    ("nltr", True, True, 4.0, 3, 2, False),
    ("two_choice", True, True, 0.0, 2, 2, True),
    ("two_choice", False, False, 4.0, 2, 3, True),
    ("ect", True, True, 0.05, 2, 2, True),
    ("ect", False, False, 0.0, 2, 2, False),
]


def _case_id(c):
    name, obs, renorm, thr, n, pc, trace = c
    return (f"{name}-obs{int(obs)}-renorm{int(renorm)}-thr{thr}-n{n}-pc{pc}"
            f"-{'trace' if trace else 'static'}")


def _inputs(seed, lead, m=M, r=R):
    rng = np.random.default_rng(seed)
    shape = lead + (r,)
    obj = rng.integers(0, 40, shape).astype(np.int32)
    lens = rng.uniform(1.0, 20.0, shape).astype(np.float32)
    valid = rng.random(shape) > 0.1
    loads = rng.normal(50.0, 5.0, lead + (m,)).astype(np.float32)
    log = np.broadcast_to(np.asarray(jpc.init_table(m)),
                          lead + (4, m)).copy()
    log[..., 0, :] = loads
    log[..., 1, :] = np.asarray(jpc.absorb_probs(jnp.asarray(loads), 50.0,
                                                 m))
    base = np.full(lead + (m,), 200.0, np.float32)
    state = dict(log=log,
                 n_assigned=rng.integers(0, 5, lead + (m,)).astype(np.int32),
                 rates=base, vclock=np.full(lead, 0.5, np.float32),
                 free_at=np.zeros(lead + (m,), np.float32))
    t = lead[0]
    slow = np.full((t, m), 200.0, np.float32)
    for i in range(t):
        slow[i, rng.choice(m, 4, replace=False)] = 25.0
    times = np.tile(np.array([0.0, 0.06, 0.13], np.float32), (t, 1))
    times[-1, 1] = 0.04                    # an event exactly at a window
    trace_rates = np.stack([base.reshape(-1, m)[:t], slow,
                            base.reshape(-1, m)[:t]], axis=1)
    keys = jax.random.split(jax.random.key(seed), int(np.prod(lead))
                            ).reshape(lead)
    seeds = np.asarray(jax.vmap(lambda k: jax.random.bits(
        k, dtype=jnp.uint32))(keys.reshape(-1))).reshape(lead)
    return (obj, lens, valid), state, (times, trace_rates), keys, seeds


def _pols(case):
    name, _, _, thr, n, pc, _ = case
    kw = dict(name=name, threshold=thr, nltr_n=n, probe_choices=pc,
              rng="lcg")
    return JPolicyConfig(**kw), PolicyConfig(**kw)


def _logs(renorm, m=M):
    kw = dict(n_servers=m, lam=50.0, renorm=renorm)
    return jstatlog.LogConfig(**kw), tstatlog.LogConfig(**kw)


def _tk(keys):
    """The reference's keys as the port's int64 (..., 2) key tensor."""
    return torch.from_numpy(np.asarray(jax.random.key_data(keys)).astype(
        np.int64))


def _jw(w):
    return jengine.Workload(*map(jnp.asarray, w))


def _tw(w):
    return tengine.Workload(*map(torch.from_numpy, w))


def _js(st):
    return jstatlog.SchedState(**{k: jnp.asarray(v) for k, v in st.items()})


def _ts(st):
    return tstatlog.SchedState(**{k: torch.from_numpy(np.array(v))
                                  for k, v in st.items()})


def assert_result(got, want, ctx, rng=True):
    """A port `ScheduleResult` against the reference's (numpy-able)."""
    for f in ("chosen", "redirected", "latencies", "probe_msgs",
              "window_loads"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.shape == b.shape, f"{ctx}: {f} shape {a.shape} {b.shape}"
        bad = np.argwhere(a != b)
        assert bad.size == 0, f"{ctx}: first divergence in {f} at {bad[0]}"
    for f in ("n_assigned", "rates", "vclock", "free_at", "loads"):
        np.testing.assert_array_equal(getattr(got.state, f).numpy(),
                                      np.asarray(getattr(want.state, f)),
                                      err_msg=f"{ctx}: {f}")
    np.testing.assert_allclose(got.state.probs.numpy(),
                               np.asarray(want.state.probs), rtol=0,
                               atol=1e-6, err_msg=f"{ctx}: probs")
    for f in ("ewma_lat", "est_rates"):
        np.testing.assert_allclose(getattr(got.state, f).numpy(),
                                   np.asarray(getattr(want.state, f)),
                                   rtol=1e-6, atol=1e-6,
                                   err_msg=f"{ctx}: {f}")
    if rng:
        np.testing.assert_array_equal(got.rng.numpy().astype(np.uint32),
                                      np.asarray(want.rng),
                                      err_msg=f"{ctx}: rng")


def _row(res, i):
    """Trial ``i`` of a batched result."""
    take = lambda x: None if x is None else x[i]  # noqa: E731
    return type(res)(type(res.state)(*map(take, res.state)),
                     *map(take, res[1:]))


@pytest.mark.parametrize("case", STREAM_CASES, ids=_case_id)
def test_run_stream_matches_reference(case):
    """run_stream (T,) batched and unbatched, both backends, and
    run_stream_batch(backend="jax") against the reference's jax backend."""
    name, observe, renorm, _, _, _, with_trace = case
    work, st, (times, trates), keys, seeds = _inputs(seed=len(_case_id(case)),
                                                     lead=(T,))
    jp, tp = _pols(case)
    jlog, tlog = _logs(renorm)
    trace_j = jengine.ClusterTrace(jnp.asarray(times), jnp.asarray(trates)) \
        if with_trace else None
    trace_t = tengine.ClusterTrace(torch.from_numpy(times),
                                   torch.from_numpy(trates)) \
        if with_trace else None
    dt = DT if with_trace else 0.0
    run1 = lambda s, w, k, tr: jengine.run_stream(  # noqa: E731
        s, w, k, policy=jp, log_cfg=jlog, window_size=WIN, trace=tr,
        window_dt=dt, observe=observe, backend="jax")
    ref = jax.jit(jax.vmap(run1, in_axes=(0, 0, 0, 0 if with_trace else None))
                  )(_js(st), _jw(work), keys, trace_j)
    kw = dict(policy=tp, log_cfg=tlog, window_size=WIN, window_dt=dt,
              observe=observe)
    got = tengine.run_stream(_ts(st), _tw(work), _tk(keys), trace=trace_t,
                             **kw)
    assert_result(got, ref, f"{name} run_stream (T,)")
    batch, met, merged = tengine.run_stream_batch(
        _ts(st), _tw(work), _tk(keys), traces=trace_t, backend="jax", **kw)
    assert met is None and merged is None
    assert_result(batch, ref, f"{name} run_stream_batch jax (T,)")
    # unbatched, eager and through the sequential kernel path
    i = T - 1
    one = lambda a: a[i]  # noqa: E731
    st1 = {k: v[i] for k, v in st.items()}
    tr1 = tengine.ClusterTrace(*map(torch.from_numpy, (times[i], trates[i]))) \
        if with_trace else None
    for backend in ("jax", "kernel"):
        got1 = tengine.run_stream(
            _ts(st1), _tw(tuple(map(one, work))), _tk(keys)[i], trace=tr1,
            backend=backend, **kw)
        assert_result(got1, _row(ref, i), f"{name} run_stream {backend}",
                      rng=backend == "jax")


@pytest.mark.parametrize("name", ["ect", "nltr", "two_choice", "mlml"])
def test_run_stream_batch_clients_matches_reference(name):
    """The (T, C) form: each client's private log, a trial's clients on
    its trace, against the reference's jax backend (vmap over both
    axes)."""
    c, win, r = 4, 16, 40
    work, st, (times, trates), keys, seeds = _inputs(seed=77, lead=(T, c),
                                                     r=r)
    case = (name, True, True, 0.05 if name == "ect" else 4.0, 2, 3, True)
    jp, tp = _pols(case)
    jlog, tlog = _logs(True)
    ref, _, _ = jax.jit(lambda s, w, k, tr: jengine.run_stream_batch(
        s, w, k, policy=jp, log_cfg=jlog, window_size=win, traces=tr,
        window_dt=DT, observe=True, backend="jax"))(
        _js(st), _jw(work), keys,
        jengine.ClusterTrace(jnp.asarray(times), jnp.asarray(trates)))
    got, met, merged = tengine.run_stream_batch(
        _ts(st), _tw(work), _tk(keys), policy=tp, log_cfg=tlog,
        window_size=win,
        traces=tengine.ClusterTrace(torch.from_numpy(times),
                                    torch.from_numpy(trates)),
        window_dt=DT, observe=True, backend="jax")
    assert met is None and merged is None
    assert_result(got, ref, f"{name} (T, C)")


@pytest.mark.parametrize("group_steps", [True, False])
@pytest.mark.parametrize("name", ["ect", "mlml", "nltr", "trh",
                                  "two_choice", "rr"])
def test_run_window_matches_reference(name, group_steps):
    work, st, _, keys, seeds = _inputs(seed=5, lead=(T,), r=WIN)
    case = (name, True, True, 0.05 if name == "ect" else 4.0, 2, 2, False)
    jp, tp = _pols(case)
    jlog, tlog = _logs(True)
    ref = jax.jit(jax.vmap(lambda s, w, k, r0: jengine.run_window(
        s, w, k, policy=jp, log_cfg=jlog, group_steps=group_steps,
        observe=True, rng0=r0)))(_js(st), _jw(work), keys,
                                 jnp.asarray(seeds))
    got = tengine.run_window(_ts(st), _tw(work), _tk(keys), policy=tp,
                             log_cfg=tlog, group_steps=group_steps,
                             observe=True,
                             rng0=torch.from_numpy(seeds.astype(np.int64)))
    assert_result(got, ref, f"{name} run_window")
    got0 = tengine.run_window(
        _ts({k: v[0] for k, v in st.items()}),
        _tw(tuple(x[0] for x in work)), _tk(keys)[0], policy=tp,
        log_cfg=tlog, group_steps=group_steps, observe=True,
        rng0=torch.tensor(int(seeds[0])))
    assert_result(got0, _row(ref, 0), f"{name} run_window unbatched")


@pytest.mark.parametrize("group_steps", [True, False])
def test_grouped_latency_block_matches_reference(group_steps):
    work, st, (times, trates), keys, seeds = _inputs(seed=9, lead=(T,))
    lats = np.random.default_rng(1).uniform(0.0, 3.0, (T, R)).astype(
        np.float32)
    jl, jv = jengine.grouped_latency_block(_jw(work), jnp.asarray(lats), WIN,
                                           group_steps=group_steps)
    tl, tv = tengine.grouped_latency_block(_tw(work), torch.from_numpy(lats),
                                           WIN, group_steps=group_steps)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # on a scheduled stream the block is the kernel's latency block
    tp = PolicyConfig(name="ect", threshold=0.05)
    _, tlog = _logs(True)
    trace = tengine.ClusterTrace(torch.from_numpy(times),
                                 torch.from_numpy(trates))
    seeds_t = torch.from_numpy(seeds.astype(np.int64))
    res, met, _ = tengine.run_stream_batch(
        _ts(st), _tw(work), _tk(keys), policy=tp, log_cfg=tlog,
        window_size=WIN, traces=trace, window_dt=DT)
    if group_steps:
        bl, bv = tengine.grouped_latency_block(_tw(work), res.latencies,
                                               WIN)
        _, steps, _, _ = tengine._prep_streams(_tw(work), WIN, True)
        _, klats, _, _, _ = tops.sched_stream_batch(
            steps.object_ids.flatten(1), steps.lengths.flatten(1),
            steps.valid.flatten(1), _ts(st).log, seeds_t,
            tengine._window_rates(None, trace, 5, DT), n_servers=M,
            window_size=WIN, threshold=0.05, lam=50.0, window_dt=DT,
            policy="ect")
        assert torch.equal(bv, steps.valid.flatten(1))
        assert torch.equal(bl, torch.where(bv, klats, 0.0))


def test_sched_stream_is_the_batch_kernel_one_stream_at_a_time():
    """ops.sched_stream on one (N,) stream and on a (C, N) batch equals
    the rows of sched_stream_batch (on the CPU: the plain version)."""
    work, st, (times, trates), _, seeds = _inputs(seed=3, lead=(T,),
                                                  r=4 * WIN)
    trace = tengine.ClusterTrace(torch.from_numpy(times),
                                 torch.from_numpy(trates))
    rates = tengine._window_rates(None, trace, 4, DT)
    args = [*map(torch.from_numpy, work), torch.from_numpy(st["log"]),
            torch.from_numpy(seeds.astype(np.int64)), rates]
    kw = dict(n_servers=M, window_size=WIN, threshold=4.0, lam=50.0,
              window_dt=DT, policy="trh")
    batch = tops.sched_stream_batch(*args, **kw)
    many = tops.sched_stream(*args, **kw)
    for a, b in zip(many, batch[:4]):
        assert torch.equal(a, b)
    for i in range(T):
        one = tops.sched_stream(*(x[i] for x in args), **kw)
        for a, b in zip(one, batch[:4]):
            assert torch.equal(a, b[i])


def test_backend_jax_no_longer_raises():
    cfg = tsim.SimConfig(backend="jax")
    assert cfg.backend == "jax"
    assert tsim.SimConfig().backend == "kernel"
    with pytest.raises(ValueError, match="backend"):
        tsim.SimConfig(backend="tpu")


SIM = dict(n_servers=37, n_requests=250, n_trials=3, window_size=60,
           n_clients=9)


@pytest.mark.filterwarnings("ignore:per_client window clamp")
@pytest.mark.parametrize("scenario", ["static", "transient"])
@pytest.mark.parametrize("client_model", ["shared_log", "per_client"])
@pytest.mark.parametrize("name", ["rr", "mlml", "trh", "nltr", "two_choice",
                                  "ect"])
def test_run_trials_eager_equals_kernel_path(name, client_model, scenario):
    """The port's run_trials on the eager engine against its kernel path
    (the plain version on the CPU) on the same seed: every TrialResult
    field bit for bit.  The prep does not depend on the backend."""
    cfg = tsim.SimConfig(**SIM, client_model=client_model,
                         scenario=tsim.ScenarioConfig(scenario))
    log = tsim.default_log_cfg(cfg)
    pol = PolicyConfig(name=name, threshold=0.05 if name == "ect" else 5.0,
                       rng="lcg")
    kern = tsim.run_trials(11, cfg, pol, log, device="cpu")
    eager = tsim.run_trials(11, dataclasses.replace(cfg, backend="jax"), pol,
                            log, device="cpu")
    for f, a, b in zip(kern._fields, kern, eager):
        assert a.shape == b.shape and a.dtype == b.dtype, f
        assert torch.equal(a, b), f"{name} {client_model} {scenario}: {f}"
