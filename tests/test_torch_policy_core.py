"""Port parity: repro_torch.core.policy_core against repro.core.policy_core.

Inputs are made with numpy from a seed and handed to both; the port runs
on the CPU.  Integer results and every float result whose association the
reference pins are held bit for bit.  `absorb_probs` is held to 1e-6:
its ``exp`` is XLA's on one side and PyTorch's on the other, and the two
may differ by an ulp."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy_core as jpc
from repro_torch.core import policy_core as tpc


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


RANK_SHAPES = [(1, 7), (3, 37), (2, 100), (4, 130), (2, 300)]


@pytest.mark.parametrize("shape", RANK_SHAPES)
def test_rank_and_permute_pair(shape):
    rng = np.random.default_rng(sum(shape))
    # duplicate keys, -inf keys, and one all-invalid row
    keys = rng.integers(0, 6, shape).astype(np.float32)
    keys[rng.random(shape) < 0.1] = -np.inf
    valid = rng.random(shape) > 0.3
    valid[0] = False
    payload = rng.uniform(0, 50, shape).astype(np.float32)
    ids = rng.integers(0, 1000, shape).astype(np.int32)

    jr, jk = jpc.rank_desc(jnp.asarray(keys), valid=jnp.asarray(valid))
    tr, tk = tpc.rank_desc(torch.from_numpy(keys),
                           valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(_np(tr), np.asarray(jr))
    np.testing.assert_array_equal(_np(tk), np.asarray(jk))

    jp = jpc.permute_to_sorted(jr, (jnp.asarray(payload), jnp.asarray(ids)))
    tp = tpc.permute_to_sorted(tr, (torch.from_numpy(payload),
                                    torch.from_numpy(ids)))
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    jb = jpc.permute_from_sorted(jr, jp)
    tb = tpc.permute_from_sorted(tr, tp)
    for a, b, orig in zip(tb, jb, (payload, ids)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
        np.testing.assert_array_equal(_np(a), orig)


@pytest.mark.parametrize("width", [1, 5, 37, 100, 128, 300, 384])
def test_lane_sum_and_tree_sum(width):
    rng = np.random.default_rng(width)
    x = rng.uniform(-3, 7, (3, width)).astype(np.float32)
    np.testing.assert_array_equal(_np(tpc.lane_sum(torch.from_numpy(x))),
                                  np.asarray(jpc.lane_sum(jnp.asarray(x))))
    y = rng.uniform(0, 1, (width, 4, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(tpc.tree_sum(torch.from_numpy(y), axis=0)),
        np.asarray(jpc.tree_sum(jnp.asarray(y), axis=0)))


@pytest.mark.parametrize("n_levels", [1, 2, 3])
def test_recursive_average_bounds(n_levels):
    rng = np.random.default_rng(7 + n_levels)
    rows, width = 6, 45
    lens = -np.sort(-rng.uniform(0.25, 1024, (rows, width)).astype(
        np.float32), axis=-1)
    nvalid = np.array([[45], [40], [9], [1], [0], [2]], np.int32)
    pos = np.arange(width)
    lens = np.where(pos < nvalid, lens, -np.inf).astype(np.float32)
    jb = jpc.recursive_average_bounds(jnp.asarray(lens), jnp.asarray(nvalid),
                                      n_levels)
    tb = tpc.recursive_average_bounds(torch.from_numpy(lens),
                                      torch.from_numpy(nvalid).long(),
                                      n_levels)
    np.testing.assert_array_equal(_np(tb), np.asarray(jb))


def test_window_decrements_and_drain():
    rng = np.random.default_rng(3)
    rates = rng.uniform(0, 300, (4, 5, 37)).astype(np.float32)
    rates[0, 0, :3] = 0.0
    loads = rng.uniform(0, 80, (4, 5, 37)).astype(np.float32)
    for dt in (0.0, 0.0173, 1.5):
        jd = jpc.window_decrements(jnp.asarray(rates), dt)
        td = tpc.window_decrements(torch.from_numpy(rates), dt)
        np.testing.assert_array_equal(_np(td), np.asarray(jd))
        np.testing.assert_array_equal(
            _np(tpc.drain_loads(torch.from_numpy(loads),
                                torch.from_numpy(rates), dt, dec=td)),
            np.asarray(jpc.drain_loads(jnp.asarray(loads),
                                       jnp.asarray(rates), dt, dec=jd)))


@pytest.mark.parametrize("r", [60, 250, 300])
def test_server_segment_sum(r):
    rng = np.random.default_rng(r)
    vals = rng.uniform(0.25, 1024, (3, r)).astype(np.float32)
    idx = rng.integers(0, 37, (3, r)).astype(np.int32)
    np.testing.assert_array_equal(
        _np(tpc.server_segment_sum(torch.from_numpy(vals),
                                   torch.from_numpy(idx).long(), 37)),
        np.asarray(jpc.server_segment_sum(jnp.asarray(vals),
                                          jnp.asarray(idx), 37)))


def test_nearest_rank_p99_and_stream_metrics():
    rng = np.random.default_rng(11)
    lats = rng.exponential(2.0, (5, 160)).astype(np.float32)
    lats[1, 5:9] = lats[1, 0]                     # ties
    valid = rng.random((5, 160)) > 0.25
    valid[2] = False                              # all invalid
    valid[3] = False
    valid[3, 17] = True                           # one valid
    lats = np.where(valid, lats, 0.0).astype(np.float32)
    np.testing.assert_array_equal(
        _np(tpc.nearest_rank_p99(torch.from_numpy(lats),
                                 torch.from_numpy(valid))),
        np.asarray(jpc.nearest_rank_p99(jnp.asarray(lats),
                                        jnp.asarray(valid))))
    for dt, ws in ((0.0, 40), (0.0213, 32)):
        np.testing.assert_array_equal(
            _np(tpc.stream_metrics(torch.from_numpy(lats),
                                   torch.from_numpy(valid), dt, ws)),
            np.asarray(jpc.stream_metrics(jnp.asarray(lats),
                                          jnp.asarray(valid), dt, ws)))


def test_absorb_probs_and_init_table():
    rng = np.random.default_rng(5)
    loads = rng.normal(50, 5, (4, 37)).astype(np.float32)
    got = _np(tpc.absorb_probs(torch.from_numpy(loads), 300.0, 37))
    want = np.asarray(jpc.absorb_probs(jnp.asarray(loads), 300.0, 37))
    # exp: XLA's and PyTorch's may differ by an ulp
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(_np(tpc.init_table(37, batch=2,
                                                     device="cpu")),
                                  np.asarray(jpc.init_table(37, batch=2)))


def test_lcg():
    rng = np.random.default_rng(9)
    states = rng.integers(0, 2 ** 32, 64, dtype=np.uint64).astype(np.uint32)
    j = jnp.asarray(states)
    t = torch.from_numpy(states.astype(np.int64))
    for _ in range(5):
        j = jpc.lcg_step(j)
        t = tpc.lcg_step(t)
        np.testing.assert_array_equal(_np(t), np.asarray(j).astype(np.int64))
        for n in (1, 7, 50, 100):
            np.testing.assert_array_equal(_np(tpc.lcg_mod(t, n)),
                                          np.asarray(jpc.lcg_mod(j, n)))
