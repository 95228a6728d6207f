"""Shared helpers of the port's parity tests (imports torch and numpy
only, so the tests that run on the card can use it too)."""

import numpy as np
import torch

from repro_torch.core.policy_core import (ROW_EST, ROW_EWMA, ROW_LOADS,
                                          ROW_PROBS, init_table)
from repro_torch.kernels.sched_select import ops as tops

# (T, M, W, window, policy): tests/test_kernels.py's BATCH_CASES (odd M,
# M=130, M=300 so M_pad=384, partly invalid windows) plus the two
# body policies no engine policy reaches
BATCH_CASES = [
    (5, 37, 4, 32, "ect"),
    (5, 37, 4, 32, "trh"),
    (10, 100, 5, 40, "ect"),
    (16, 130, 4, 50, "trh"),
    (3, 24, 4, 30, "ect"),
    (4, 300, 3, 32, "trh"),
    (5, 37, 4, 32, "mlml"),
    (5, 37, 4, 32, "nltr"),
    (6, 24, 4, 30, "nltr"),
    (3, 24, 3, 30, "rr"),
    (3, 24, 3, 30, "two_choice"),
    (5, 37, 4, 32, "minload"),
    (5, 37, 4, 32, "two_random"),
]
KW = dict(threshold=2.0, lam=50.0, window_dt=0.02, observe=True, renorm=True)


def batch_case(t, m, n_win, win, seed):
    """Numpy operands of one trial-grid call: (obj, lens, valid, tables,
    seeds, rates), about a fifth of the requests invalid."""
    rng = np.random.default_rng(seed)
    n = n_win * win
    table = init_table(m, device="cpu").numpy()
    return (rng.integers(0, 8 * m, (t, n)).astype(np.int32),
            rng.uniform(1.0, 20.0, (t, n)).astype(np.float32),
            rng.random((t, n)) > 0.2,
            np.stack([table] * t),
            rng.integers(0, 2 ** 31, (t,)).astype(np.uint32),
            rng.uniform(50.0, 300.0, (t, n_win, m)).astype(np.float32))


def port_batch(arrays, device="cpu", fn=tops.sched_stream_batch, **kw):
    """Run the port's dispatch ``fn`` on ``device``; numpy outputs."""
    obj, lens, valid, tables, seeds, rates = arrays
    out = fn(torch.from_numpy(obj).to(device),
             torch.from_numpy(lens).to(device),
             torch.from_numpy(valid).to(device),
             torch.from_numpy(tables).to(device),
             torch.from_numpy(seeds.astype(np.int64)).to(device),
             torch.from_numpy(rates).to(device), **kw)
    return [x.cpu().numpy() for x in out]


def assert_stream_outputs(got, want, window_size, ctx):
    """Contract fields bit-exact, naming the first trial/window/field that
    differs; probs atol 1e-6, ewma/est 1e-6 relative."""
    ch, lat, tab, wl, met = got
    rch, rlat, rtab, rwl, rmet = [np.asarray(x) for x in want]
    for name, a, b in (("choices", ch, rch), ("latencies", lat, rlat)):
        bad = np.argwhere(a != b)
        assert bad.size == 0, (
            f"{ctx}: first divergence in {name} at trial {bad[0][0]}, "
            f"window {bad[0][1] // window_size}: {a[tuple(bad[0])]} vs "
            f"{b[tuple(bad[0])]}")
    for name, a, b in (("loads", tab[:, ROW_LOADS], rtab[:, ROW_LOADS]),
                       ("window_loads", wl, rwl), ("metrics", met, rmet)):
        np.testing.assert_array_equal(a, b, err_msg=f"{ctx}: {name}")
    np.testing.assert_allclose(tab[:, ROW_PROBS], rtab[:, ROW_PROBS],
                               rtol=0, atol=1e-6, err_msg=f"{ctx}: probs")
    for row, name in ((ROW_EWMA, "ewma"), (ROW_EST, "est")):
        np.testing.assert_allclose(tab[:, row], rtab[:, row], rtol=1e-6,
                                   atol=1e-6, err_msg=f"{ctx}: {name}")


# (T, C, M, W, window, client_tile, merge_mean, phantom clients): odd M,
# M=130, C not a multiple of client_tile, whole phantom clients (no valid
# request), a padded last window, the merge as mean and as raw sum
GRID_CASES = [
    (2, 5, 37, 2, 8, 2, True, 1),
    (3, 7, 130, 2, 6, 4, False, 2),
]


def grid_case(t, c, m, n_win, win, n_phantom, seed):
    """Numpy operands of one 2-D call: (obj, lens, valid (T, C, N),
    tables (T, C, 4, M) with random loads, seeds (T, C), rates (T, W, M)
    per trial); about a fifth of the requests invalid, the last third of
    the last window invalid, and the last ``n_phantom`` clients of every
    trial without a valid request."""
    rng = np.random.default_rng(seed)
    n = n_win * win
    valid = rng.random((t, c, n)) > 0.2
    valid[..., n - win // 3:] = False
    if n_phantom:
        valid[:, c - n_phantom:] = False
    tables = np.broadcast_to(init_table(m, device="cpu").numpy(),
                             (t, c, 4, m)).copy()
    tables[:, :, ROW_LOADS] = rng.uniform(0.0, 60.0, (t, c, m))
    return (rng.integers(0, 8 * m, (t, c, n)).astype(np.int32),
            rng.uniform(1.0, 20.0, (t, c, n)).astype(np.float32),
            valid, tables.astype(np.float32),
            rng.integers(0, 2 ** 32, (t, c)).astype(np.uint32),
            rng.uniform(50.0, 300.0, (t, n_win, m)).astype(np.float32))


def assert_grid_outputs(got, want, window_size, ctx):
    """`assert_stream_outputs` per client stream, then the merged outputs
    (cm_wloads, cm_metrics, cm_lats, cm_lval) bit-exact."""
    flat = [np.asarray(x).reshape((-1,) + np.asarray(x).shape[2:])
            for x in got[:5]]
    want_flat = [np.asarray(x).reshape((-1,) + np.asarray(x).shape[2:])
                 for x in want[:5]]
    assert_stream_outputs(flat, want_flat, window_size, ctx)
    for name, a, b in zip(("cm_wloads", "cm_metrics", "cm_lats", "cm_lval"),
                          got[5:], want[5:]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"{ctx}: {name}")
