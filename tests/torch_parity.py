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
    table = init_table(m).numpy()
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
