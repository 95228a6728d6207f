"""Port parity of the stream kernel's ablate levels and the phase profile.

On the CPU: the port's plain version at ``ablate`` 0-3
(`sched_stream_batch_ref`, through `ops.sched_stream_batch` on CPU
tensors) against the JAX package's Pallas kernel at the same level, run in
interpret mode as its own tests run it.  The reference writes only part
of its outputs at a level above 0 (interpret mode fills the rest with
whatever its buffers held), so the comparison covers what it writes: the
final tables and window loads at every level (loads, window loads bit for
bit; probs, ewma and est to the contract's 1e-6), the choices and
latencies at levels 0 and 1, the metric row bit for bit at level 0 and
its zeros at levels 1-3.  Where the reference writes nothing the port's
outputs are held to zeros.

The CUDA kernel's levels against the plain version on the card are in
tests/test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sched_select import ops as jops
from repro_torch import random
from repro_torch.core import engine as tengine
from repro_torch.core import statlog as tstatlog
from repro_torch.core.policies import PolicyConfig
from repro_torch.core.policy_core import (ROW_EST, ROW_EWMA, ROW_LOADS,
                                          ROW_PROBS)
from repro_torch.kernels.sched_select import kernel as tkernel
from repro_torch.kernels.sched_select import ops as tops
from repro_torch.tune import profile
from torch_parity import KW, batch_case, grid_case, port_batch

POLICIES = tuple(tkernel.POLICY_CODES)
LEVELS = tkernel.ABLATE_LEVELS
# T <= 4, M <= 16, two windows of 8: a padded last window (about a fifth
# of the requests invalid), nLTR's four sections over 16 servers
T, M, N_WIN, WIN = 3, 16, 2, 8


def _tables_close(tab, rtab, ctx):
    np.testing.assert_array_equal(tab[:, ROW_LOADS], rtab[:, ROW_LOADS],
                                  err_msg=f"{ctx}: loads")
    np.testing.assert_allclose(tab[:, ROW_PROBS], rtab[:, ROW_PROBS],
                               rtol=0, atol=1e-6, err_msg=f"{ctx}: probs")
    for row, name in ((ROW_EWMA, "ewma"), (ROW_EST, "est")):
        np.testing.assert_allclose(tab[:, row], rtab[:, row], rtol=1e-6,
                                   atol=1e-6, err_msg=f"{ctx}: {name}")


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("policy", POLICIES)
def test_ablate_level_matches_pallas_interpret(policy, level):
    arrays = batch_case(T, M, N_WIN, WIN, seed=500 + POLICIES.index(policy))
    kw = dict(KW, n_servers=M, window_size=WIN, policy=policy)
    ch, lat, tab, wl, met = port_batch(arrays, ablate=level, **kw)
    want = jops.sched_stream_batch(*(jnp.asarray(a) for a in arrays),
                                   ablate=level, interpret=True, **kw)
    rch, rlat, rtab, rwl, rmet = (np.asarray(x) for x in want)
    ctx = f"{policy} ablate={level}"
    _tables_close(tab, rtab, ctx)
    np.testing.assert_array_equal(wl, rwl, err_msg=f"{ctx}: window_loads")
    if level < 2:
        np.testing.assert_array_equal(ch, rch, err_msg=f"{ctx}: choices")
        np.testing.assert_array_equal(lat, rlat, err_msg=f"{ctx}: latencies")
    else:
        assert not ch.any() and not lat.any(), ctx
    np.testing.assert_array_equal(met, rmet, err_msg=f"{ctx}: metrics")
    assert level == 0 or not met.any(), ctx


@pytest.mark.parametrize("policy", ["ect", "mlml", "nltr", "two_choice"])
def test_level_zero_is_the_unablated_call(policy):
    arrays = batch_case(T, M, N_WIN, WIN, seed=7)
    kw = dict(KW, n_servers=M, window_size=WIN, policy=policy)
    for a, b in zip(port_batch(arrays, ablate=0, **kw),
                    port_batch(arrays, **kw)):
        np.testing.assert_array_equal(a, b)


def test_no_step_loop_keeps_renorm_and_drain():
    """Without the step loop (levels 2 and 3) each window still
    renormalises and drains: the window loads fall by the decrements from
    the initial loads, and the tables are those of levels 2 and 3 alike."""
    arrays = batch_case(T, M, N_WIN, WIN, seed=11)
    loads = np.random.default_rng(11).uniform(0.0, 60.0, (T, M))
    arrays[3][:, ROW_LOADS] = loads
    kw = dict(KW, n_servers=M, window_size=WIN, policy="trh")
    two = port_batch(arrays, ablate=2, **kw)
    three = port_batch(arrays, ablate=3, **kw)
    for a, b in zip(two, three):
        np.testing.assert_array_equal(a, b)
    wl, tab = two[3], two[2]
    assert (wl[:, 0] < loads).any() and (wl[:, 0] <= loads).all()
    assert (wl[:, 1] <= wl[:, 0]).all()
    np.testing.assert_array_equal(tab[:, ROW_LOADS], wl[:, -1])
    np.testing.assert_allclose(tab[:, ROW_PROBS].sum(-1), 1.0, atol=1e-6)


def _grid_operands():
    arrays = grid_case(2, 3, M, N_WIN, WIN, 1, seed=3)
    return [torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                             else a) for a in arrays]


def test_two_d_form_refuses_ablate():
    """As in the reference, the levels exist for the 1-D form only: the
    grid dispatch, the 2-D launch wrapper and the engine's (T, C) batch
    raise, and a level outside 0-3 is refused before any launch."""
    obj, lens, valid, tables, seeds, rates = _grid_operands()
    kw = dict(KW, n_servers=M, window_size=WIN, policy="ect")
    with pytest.raises(ValueError, match="1-D"):
        tops.sched_stream_grid(obj, lens, valid, tables, seeds, rates,
                               ablate=1, **kw)
    with pytest.raises(ValueError, match="1-D"):
        tkernel.sched_stream_grid_streams(
            obj.int(), lens, valid.int(), tables, seeds, rates, ablate=2,
            alpha=0.25, **kw)
    log = tstatlog.LogConfig(n_servers=M)
    st = tstatlog.init_state(log, batch=2, device="cpu")
    st = tstatlog.SchedState(*(x[:, None].expand((2, 3) + x.shape[1:])
                               for x in st))
    with pytest.raises(ValueError, match="1-D"):
        tengine.run_stream_batch(
            st, tengine.Workload(obj.int(), lens, valid), seeds,
            policy=PolicyConfig(name="ect"), log_cfg=log, window_size=WIN,
            ablate=1)
    arrays = batch_case(2, M, 1, WIN, seed=1)
    with pytest.raises(ValueError, match="ablate"):
        port_batch(arrays, ablate=4, **kw)
    with pytest.raises(ValueError, match="ablate=4"):
        tkernel.sched_stream_call(
            *(torch.from_numpy(a) for a in arrays[:3]),
            torch.from_numpy(arrays[3]), torch.from_numpy(
                arrays[4].astype(np.int64)), torch.from_numpy(arrays[5]),
            ablate=4, alpha=0.25, **kw)


def test_engine_ablate_levels_on_cpu():
    """The engine at each level: level 0 is the unablated run; above it
    the metric rows are zeros, and from level 2 on every latency too."""
    arrays = batch_case(T, M, N_WIN, WIN, seed=13)
    obj, lens, valid, tables, seeds, _ = (torch.from_numpy(
        a.astype(np.int64) if a.dtype == np.uint32 else a) for a in arrays)
    log = tstatlog.LogConfig(n_servers=M)
    st = tstatlog.init_state(log, batch=T, device="cpu")
    keys = random.split(random.key(13, device="cpu"), T)
    run = lambda **kw: tengine.run_stream_batch(  # noqa: E731
        st, tengine.Workload(obj, lens, valid), keys,
        policy=PolicyConfig(name="nltr"), log_cfg=log,
        window_size=WIN, **kw)
    base, base_met, _ = run()
    for level in LEVELS:
        res, met, _ = run(ablate=level)
        if level == 0:
            for a, b in zip(res[1:], base[1:]):
                # the kernel path leaves the eager engine's rng field None
                assert a is b is None or torch.equal(a, b)
            assert torch.equal(met, base_met)
            continue
        assert not met.any()
        assert level < 2 or not res.latencies.any()


def test_kernel_phase_profile_on_cpu():
    got = profile.kernel_phase_profile(
        n_servers=8, n_requests=32, window_size=8, n_trials=2,
        policy="nltr", threshold=5.0, reps=1, device="cpu")
    assert set(got) == {"total_s", "metrics_s", "steps_s", "plan_s",
                        "dispatch_s"}
    assert all(v >= 0.0 for v in got.values())
    assert got["total_s"] > 0.0 and got["dispatch_s"] > 0.0
