"""Port parity: repro_torch.core.engine against repro.core.engine.

The same states, workloads and traces (made with numpy from a seed) go
through the reference's ``run_stream_batch(backend="kernel")`` — its
Pallas kernel in interpret mode — and the port's ``run_stream_batch`` on
the CPU (its plain kernel version).  Both take the same threefry keys;
the port derives the LCG seeds from them with `repro_torch.random.bits`,
as the reference does with ``jax.random.bits``.
Object ids are drawn from a narrow range so windows hold duplicate
objects, triples included, which exercises the step grouping's float
sums."""

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
from repro_torch.core import statlog as tstatlog
from repro_torch.core.policies import PolicyConfig
from repro_torch.core.policy_core import ROW_EST, ROW_EWMA, ROW_LOADS, \
    ROW_PROBS

T, M, R, WIN, DT = 4, 37, 250, 60, 0.04


def _inputs(seed):
    rng = np.random.default_rng(seed)
    obj = rng.integers(0, 40, (T, R)).astype(np.int32)
    lens = rng.uniform(1.0, 20.0, (T, R)).astype(np.float32)
    valid = rng.random((T, R)) > 0.1
    loads = rng.normal(50.0, 5.0, (T, M)).astype(np.float32)
    log = np.stack([np.asarray(jpc.init_table(M))] * T)
    log[:, ROW_LOADS] = loads
    log[:, ROW_PROBS] = np.asarray(jpc.absorb_probs(jnp.asarray(loads),
                                                    50.0, M))
    base = np.full((T, M), 200.0, np.float32)
    slow = base.copy()
    for t in range(T):
        slow[t, rng.choice(M, 4, replace=False)] = 25.0
    times = np.tile(np.array([0.0, 0.06, 0.13], np.float32), (T, 1))
    times[1, 1] = 0.04                      # an event exactly at a window
    trace_rates = np.stack([base, slow, base], axis=1)
    state = dict(log=log,
                 n_assigned=rng.integers(0, 5, (T, M)).astype(np.int32),
                 rates=base, vclock=np.full((T,), 0.5, np.float32),
                 free_at=np.zeros((T, M), np.float32))
    return obj, lens, valid, state, times, trace_rates


def test_group_by_object_with_map_triples():
    rng = np.random.default_rng(4)
    obj = rng.integers(0, 12, (3, 5, 30)).astype(np.int32)
    lens = rng.uniform(0.25, 1024.0, (3, 5, 30)).astype(np.float32)
    valid = rng.random((3, 5, 30)) > 0.15
    counts = np.apply_along_axis(np.bincount, -1, obj.reshape(-1, 30),
                                 minlength=12)
    assert counts.max() >= 3                # triples present
    fn = jax.vmap(jax.vmap(jengine.group_by_object_with_map))
    jg, jmap = fn(jengine.Workload(jnp.asarray(obj), jnp.asarray(lens),
                                   jnp.asarray(valid)))
    tg, tmap = tengine.group_by_object_with_map(tengine.Workload(
        torch.from_numpy(obj), torch.from_numpy(lens),
        torch.from_numpy(valid)))
    for a, b in zip(tg, jg):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tmap.numpy(), np.asarray(jmap))


@pytest.mark.parametrize("policy", tengine.KERNEL_POLICIES)
def test_run_stream_batch_matches_reference(policy):
    obj, lens, valid, st, times, trace_rates = _inputs(seed=21)
    thr = 0.05 if policy == "ect" else 4.0
    keys = jax.random.split(jax.random.key(5), T)
    log_cfg = dict(n_servers=M, lam=50.0)
    ref, ref_met, _ = jengine.run_stream_batch(
        jstatlog.SchedState(**{k: jnp.asarray(v) for k, v in st.items()}),
        jengine.Workload(jnp.asarray(obj), jnp.asarray(lens),
                         jnp.asarray(valid)),
        keys, policy=JPolicyConfig(name=policy, threshold=thr),
        log_cfg=jstatlog.LogConfig(**log_cfg), window_size=WIN,
        traces=jengine.ClusterTrace(jnp.asarray(times),
                                    jnp.asarray(trace_rates)),
        window_dt=DT, observe=True)
    got, met, merged = tengine.run_stream_batch(
        tstatlog.SchedState(**{k: torch.from_numpy(v)
                               for k, v in st.items()}),
        tengine.Workload(torch.from_numpy(obj), torch.from_numpy(lens),
                         torch.from_numpy(valid)),
        torch.from_numpy(np.asarray(jax.random.key_data(keys)).astype(
            np.int64)),
        policy=PolicyConfig(name=policy, threshold=thr),
        log_cfg=tstatlog.LogConfig(**log_cfg), window_size=WIN,
        traces=tengine.ClusterTrace(torch.from_numpy(times),
                                    torch.from_numpy(trace_rates)),
        window_dt=DT, observe=True)
    for f in ("chosen", "latencies", "redirected", "probe_msgs",
              "window_loads"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        bad = np.argwhere(a != b)
        assert bad.size == 0, (
            f"{policy}: first divergence in {f} at trial {bad[0][0]}"
            + (f", window {bad[0][1] // WIN}" if a.ndim == 2 else ""))
    np.testing.assert_array_equal(met.numpy(), np.asarray(ref_met))
    assert merged is None
    for f in ("n_assigned", "rates", "vclock", "free_at"):
        np.testing.assert_array_equal(getattr(got.state, f).numpy(),
                                      np.asarray(getattr(ref.state, f)),
                                      err_msg=f"{policy}/{f}")
    tab, rtab = got.state.log.numpy(), np.asarray(ref.state.log)
    np.testing.assert_array_equal(tab[:, ROW_LOADS], rtab[:, ROW_LOADS])
    np.testing.assert_allclose(tab[:, ROW_PROBS], rtab[:, ROW_PROBS],
                               rtol=0, atol=1e-6)
    # rates in MB/s: exp / EWMA-FMA ulps, held to 1e-6 relative
    for row in (ROW_EWMA, ROW_EST):
        np.testing.assert_allclose(tab[:, row], rtab[:, row], rtol=1e-6,
                                   atol=1e-6)


def test_rates_at_event_boundaries():
    times = torch.tensor([[0.0, 0.04, 0.13]])
    rates = torch.arange(3 * 4, dtype=torch.float32).reshape(1, 3, 4)
    got = tengine.rates_at(tengine.ClusterTrace(times, rates),
                           torch.tensor([[0.0, 0.04, 0.08, 0.2]]))
    want = jax.vmap(lambda t: jengine.rates_at(
        jengine.ClusterTrace(jnp.asarray(times[0].numpy()),
                             jnp.asarray(rates[0].numpy())), t))(
        jnp.asarray([0.0, 0.04, 0.08, 0.2], jnp.float32))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


def test_run_stream_batch_rejects_client_axis():
    """A client axis on the workload that the states do not carry."""
    st = tstatlog.init_state(tstatlog.LogConfig(n_servers=8), batch=2,
                             device="cpu")
    works = tengine.Workload(torch.zeros((2, 3, 10), dtype=torch.int32),
                             torch.ones((2, 3, 10)),
                             torch.ones((2, 3, 10), dtype=torch.bool))
    with pytest.raises(ValueError, match=r"\(T,\) or \(T, C\)"):
        tengine.run_stream_batch(st, works,
                                 torch.zeros((2, 2), dtype=torch.long),
                                 policy=PolicyConfig(name="rr"),
                                 log_cfg=tstatlog.LogConfig(n_servers=8),
                                 window_size=5)
