"""Shared helpers of the port's parity tests (imports torch and numpy
only, so the tests that run on the card can use it too)."""

import numpy as np
import torch

from repro_torch.core.policy_core import (BIG, MET_N_VALID, MET_PAD,
                                          N_METRICS, ROW_EST, ROW_EWMA,
                                          ROW_LOADS, ROW_PROBS, init_table)
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


def table_variant(tables, kind, m):
    """A copy of numpy initial tables (..., 4, M_pad) of kind "signed_zeros"
    (loads of -0.0 and +0.0 in turns and a tied pair of 5.0: every score
    ties exactly with another), "warm" (ewma 2.5 on every third server,
    est 1.5 elsewhere: an est row that is not est's function of ewma) or
    "pad_wins" (loads at BIG and est 0.5 on every server: ect's first
    scores overflow and a padding lane wins the argmin)."""
    tables = tables.copy()
    if kind == "signed_zeros":
        tables[..., ROW_LOADS, :m] = 0.0
        tables[..., ROW_LOADS, :m:2] = -0.0
        tables[..., ROW_LOADS, m // 2:m // 2 + 2] = 5.0
    elif kind == "warm":
        tables[..., ROW_EWMA, :m:3] = 2.5
        tables[..., ROW_EST, :m] = np.where(tables[..., ROW_EWMA, :m] > 0,
                                            tables[..., ROW_EWMA, :m], 1.5)
    elif kind == "pad_wins":
        tables[..., ROW_LOADS, :m] = BIG
        tables[..., ROW_EST, :m] = 0.5
    else:
        raise ValueError(f"unknown table kind {kind!r}")
    return tables


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


# The cross-client merge on operands made directly (not by the stream
# kernel): (T, C, N, W, M_pad, client_tile, kind).  The per_client main
# path's shapes (200 x 10 and 64 x 32); C·N past the kernel's shared-memory
# staging of 8,192 latencies; ct not dividing C; ct above 32 (the fold
# outside registers, P = 64 and 128); ct = 1 (many rounds of client
# blocks); W·M_pad = 30, so the merged row's lanes straddle two column
# blocks; one client.  Kinds: "spread" (wide magnitudes, so the float
# association shows), "phantom_trial" (trial 0 has no real client),
# "far_max" (latencies near 1 beside one near 3e38: 48 halvings leave lo
# at -1, and the p99 is the least valid latency, below the k-th),
# "ties" (latencies from four values and zeros of both signs).
MERGE_CASES = [
    (3, 200, 10, 1, 128, 32, "spread"),
    (2, 64, 32, 1, 128, 32, "spread"),
    (2, 300, 50, 1, 128, 32, "spread"),
    (2, 201, 7, 2, 128, 8, "spread"),
    (2, 150, 5, 1, 128, 64, "spread"),
    (2, 130, 6, 1, 128, 100, "spread"),
    (2, 37, 4, 1, 128, 1, "spread"),
    (2, 9, 3, 3, 10, 4, "spread"),
    (2, 1, 16, 1, 128, 1, "spread"),
    (3, 40, 10, 1, 128, 32, "phantom_trial"),
    (2, 200, 10, 1, 128, 32, "far_max"),
    (2, 300, 50, 1, 128, 32, "far_max"),
    (2, 64, 32, 1, 128, 32, "ties"),
]


def merge_case(t, c, n, n_win, m_pad, kind, seed):
    """Numpy operands of one `client_merge_call`: (metrics (T, C, MET_PAD),
    wloads (T, C, W, M_pad), lats (T, C, N), valid (T, C, N) int32), a
    client real iff its n_valid lane (its count of valid steps) is
    positive; about one client in eight has no valid step."""
    rng = np.random.default_rng(seed)
    valid = rng.random((t, c, n)) > 0.25
    valid[:, rng.random(c) < 0.125] = False
    if kind == "phantom_trial":
        valid[0] = False
    lats = rng.lognormal(-2.0, 1.0, (t, c, n)).astype(np.float32)
    if kind == "far_max":
        lats = (1.0 + rng.random((t, c, n)) * 1e-3).astype(np.float32)
        for i in range(t):
            ci, si = np.argwhere(valid[i])[0]
            lats[i, ci, si] = 3.0e38
    elif kind == "ties":
        lats = rng.choice(np.array([0.5, 0.25, -0.0, 0.0], np.float32),
                          (t, c, n))
    lats[~valid] = rng.lognormal(0.0, 1.0, int((~valid).sum()))
    wloads = (rng.lognormal(2.0, 2.5, (t, c, n_win, m_pad))
              * rng.choice([1.0, 1.0, -1.0], (t, c, n_win, m_pad))).astype(
                  np.float32)
    metrics = np.zeros((t, c, MET_PAD), np.float32)
    metrics[..., :N_METRICS] = rng.lognormal(0.0, 1.5, (t, c, N_METRICS))
    metrics[..., MET_N_VALID] = valid.sum(axis=-1)
    return metrics, wloads, lats, valid.astype(np.int32)
