"""Port parity of the 2-D (trials × clients) stream kernel, its
cross-client merge, and the legacy single-window entry.

On the CPU: the port's merge twins (`policy_core.masked_client_*`,
`client_stream_metrics`) against the JAX package's on seeded numpy
inputs, bit-exact; the port's plain 2-D version (`sched_stream_grid_ref`,
reached through `ops.sched_stream_grid` on CPU tensors) against the JAX
package's ``ops.sched_stream_grid`` run as its own CPU tests run it
(Pallas interpret mode), for all eight body policies on the shape cases
of `torch_parity.GRID_CASES`; and `ops.sched_select` against the JAX
package's ``ops.sched_select`` (interpret).

Tolerance: choices, latencies, the loads row, window loads, per-stream
metrics, cm_wloads, cm_metrics, cm_lats and cm_lval bit-exact; probs to
1e-6; ewma/est to 1e-6 relative (XLA may contract the EWMA blend into an
FMA where the port never does, ROADMAP Queue C).  The CUDA kernels
against the plain versions on the card are in tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy_core as jpc
from repro.kernels.sched_select import ops as jops
from repro_torch.core import policy_core as tpc
from repro_torch.kernels.sched_select import kernel as tkernel
from repro_torch.kernels.sched_select import ops as tops
from torch_parity import KW, GRID_CASES, assert_grid_outputs, grid_case, \
    port_batch


@pytest.mark.parametrize("c,ct", [(5, 5), (7, 2), (40, 32), (64, 32)])
def test_merge_twins_match_reference(c, ct):
    rng = np.random.default_rng(100 * c + ct)
    x = rng.uniform(0.0, 300.0, (c, 3, 11)).astype(np.float32)
    cvalid = rng.random(c) > 0.3
    cvalid[-1] = False                         # a phantom client
    metrics = rng.uniform(0.0, 9.0, (c, tpc.N_METRICS)).astype(np.float32)
    lats = rng.exponential(2.0, (c, 17)).astype(np.float32)
    lvalid = rng.random((c, 17)) > 0.25
    lvalid[~cvalid] = False
    lats = np.where(lvalid, lats, 0.0).astype(np.float32)
    assert tpc.resolve_client_tile(c, ct) == jpc.resolve_client_tile(c, ct)
    assert tpc.resolve_client_tile(c) == jpc.resolve_client_tile(c)
    tx, tv = torch.from_numpy(x), torch.from_numpy(cvalid)
    jx, jv = jnp.asarray(x), jnp.asarray(cvalid)
    for name in ("masked_client_sum", "masked_client_mean"):
        np.testing.assert_array_equal(
            getattr(tpc, name)(tx, tv, ct).numpy(),
            np.asarray(getattr(jpc, name)(jx, jv, ct)), err_msg=name)
    np.testing.assert_array_equal(tpc.masked_client_max(tx, tv).numpy(),
                                  np.asarray(jpc.masked_client_max(jx, jv)))
    tm, jm = torch.from_numpy(metrics), jnp.asarray(metrics)
    np.testing.assert_array_equal(
        tpc.client_stream_metrics(tm, tv, ct).numpy(),
        np.asarray(jpc.client_stream_metrics(jm, jv, ct)))
    np.testing.assert_array_equal(
        tpc.client_stream_metrics(
            tm, tv, ct, merged_lats=torch.from_numpy(lats),
            merged_valid=torch.from_numpy(lvalid)).numpy(),
        np.asarray(jpc.client_stream_metrics(
            jm, jv, ct, merged_lats=jnp.asarray(lats),
            merged_valid=jnp.asarray(lvalid))))


@pytest.mark.parametrize("policy", tops.POLICIES)
@pytest.mark.parametrize("case", enumerate(GRID_CASES),
                         ids=lambda c: "-".join(map(str, c[1])))
def test_grid_plain_version_matches_pallas_interpret(case, policy):
    idx, (t, c, m, n_win, win, ct, merge_mean, n_phantom) = case
    arrays = grid_case(t, c, m, n_win, win, n_phantom, seed=idx)
    kw = dict(KW, n_servers=m, window_size=win, policy=policy,
              client_tile=ct, merge_mean=merge_mean)
    got = port_batch(arrays, fn=tops.sched_stream_grid, **kw)
    want = jops.sched_stream_grid(*(jnp.asarray(a) for a in arrays),
                                  interpret=True, **kw)
    assert_grid_outputs(got, want, win, f"grid {policy} {case[1]}")
    # the phantom clients really scheduled nothing and counted for nothing
    n_clients = got[6][:, tpc.MET_N_CLIENTS]
    np.testing.assert_array_equal(n_clients, c - n_phantom)


@pytest.mark.parametrize("policy", ["minload", "two_random"])
def test_sched_select_matches_reference(policy):
    rng = np.random.default_rng(7)
    c, n, m = 3, 40, 37
    obj = rng.integers(0, 8 * m, (c, n)).astype(np.int32)
    lens = rng.uniform(1.0, 20.0, (c, n)).astype(np.float32)
    loads = rng.uniform(0.0, 60.0, (c, m)).astype(np.float32)
    seeds = rng.integers(0, 2 ** 32, (c,)).astype(np.uint32)
    kw = dict(n_servers=m, threshold=2.0, lam=50.0, policy=policy)
    got = tops.sched_select(torch.from_numpy(obj), torch.from_numpy(lens),
                            torch.from_numpy(loads),
                            torch.from_numpy(seeds.astype(np.int64)), **kw)
    want = jops.sched_select(jnp.asarray(obj), jnp.asarray(lens),
                             jnp.asarray(loads), jnp.asarray(seeds),
                             interpret=True, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sched_select_checks():
    """A window of more than 1,024 requests runs (the plain version has no
    cap; on the card the stream kernel's shared-memory budget decides,
    `kernel.check_stream_domain`), and a dynamic policy raises."""
    m = 8
    obj = torch.arange(2 * 1025, dtype=torch.int32).reshape(2, 1025) % m
    lens = torch.ones(obj.shape)
    loads, seeds = torch.zeros((2, m)), torch.zeros(2, dtype=torch.long)
    choices, final = tops.sched_select(obj, lens, loads, seeds, n_servers=m)
    assert choices.shape == (2, 1025) and final.shape == (2, m)
    # minload with no threshold spreads unit lengths evenly
    assert torch.equal(final.sum(-1), torch.full((2,), 1025.0))
    with pytest.raises(ValueError, match="kernel policy"):
        tops.sched_select(obj[:, :8], lens[:, :8], loads, seeds,
                          n_servers=m, policy="ect")


def test_grid_dispatch_checks():
    t, c, m, n_win, win, ct, _, _ = GRID_CASES[0]
    arrays = grid_case(t, c, m, n_win, win, 0, seed=3)
    with pytest.raises(ValueError, match="nltr needs"):
        port_batch(arrays, fn=tops.sched_stream_grid,
                   **dict(KW, n_servers=m, window_size=win, policy="nltr",
                          nltr_n=6))
    # the launch wrappers take CUDA tensors only: no CPU path inside them
    padded = tops.pad_operands(*(torch.from_numpy(a) for a in arrays))
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.sched_stream_grid_call(
            *padded, client_tile=ct, n_servers=m, window_size=win,
            threshold=2.0, lam=50.0, alpha=0.25, window_dt=0.02,
            policy="ect", observe=True, renorm=True)
    lats = torch.zeros((t, c, n_win * win))
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.client_merge_call(
            torch.zeros((t, c, tpc.MET_PAD)), torch.zeros((t, c, n_win, 128)),
            lats, lats.to(torch.int32), client_tile=ct, merge_mean=True)
