"""The cross-client merge kernel's new arithmetic, written out in numpy as
twins of ``client_merge_kernel`` in ``csrc/sched_stream.cu`` and held bit
for bit on the CPU against what it replaces: the JAX package's
``nearest_rank_p99`` and ``masked_client_sum`` / ``masked_client_mean``
(``repro.core.policy_core``, with ``xp=np`` and ``jnp``) and the port's
own ``policy_core`` versions.

* the merged p99 (``merge_latencies``): the k-th smallest valid latency
  ``v_k`` by a radix select over order-preserving uint32 keys (four
  passes of 8 bits, integer histograms; invalid steps staged as NaN and
  keyed above every number), the reference's 48 bisection steps as a
  scalar loop whose count test is ``mid >= v_k``, then the least valid
  latency above ``lo``;
* the masked column sums (``merge_columns``): every (column, client
  block) pair folded on its own by the halving tree (in registers for
  ``next_pow2(ct) <= 32``, as a bit-reversed pairwise fold above that),
  the partials added in ascending block order, eight blocks a round; the
  mean divides by the count of real clients.

The numpy twins need no JAX; JAX is used only to run the reference.  The
kernel itself is held against the plain version on the card by
tests/test_torch_gpu.py and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy_core as jpc
from repro_torch.core import policy_core as tpc

F32 = np.float32
NAN_KEY = 0xFFFFFFFF
P99_ITERS = 48
MAX_LEAVES = 32   # a client block folds in registers up to 32 leaves
MERGE_WARPS = 8   # client blocks folded side by side, one per warp
STAGE_MAX = 8192  # latencies the kernel stages in shared memory


def bits(x) -> np.ndarray:
    return np.asarray(x, dtype=F32).view(np.uint32)


# -- the p99 ------------------------------------------------------------------


def lat_key(x):
    """Twin of ``lat_key``: ``order_key`` (-0.0 keyed as +0.0, the sign-flip
    map under which uint32 order is float order) and NaN above every
    number."""
    x = np.asarray(x, dtype=F32)
    u = np.where(x == 0, F32(0.0), x).astype(F32).view(np.uint32)
    key = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)
    return np.where(np.isnan(x), np.uint32(NAN_KEY), key).astype(np.uint32)


def from_key(k):
    """Twin of ``from_key``."""
    k = np.uint32(k)
    u = np.uint32(k & 0x7FFFFFFF) if k & 0x80000000 else np.uint32(~k)
    return u.view(F32)


def radix_select(keys, k):
    """The k-th smallest (1-based) of ``keys`` by four passes of 8 bits,
    most significant first: histogram the byte of the keys that match the
    bytes chosen so far, take the bin where the running count reaches k,
    and carry k on as its rank inside that bin."""
    prefix, pmask = 0, 0
    for shift in (24, 16, 8, 0):
        cand = keys[(keys & np.uint32(pmask)) == np.uint32(prefix)]
        hist = np.bincount((cand >> np.uint32(shift)) & 0xFF, minlength=256)
        run = np.concatenate([[0], np.cumsum(hist)])
        digit = int(np.nonzero((run[:-1] < k) & (k <= run[1:]))[0][0])
        k -= int(run[digit])
        prefix |= digit << shift
        pmask |= 0xFF << shift
    return prefix


def p99_by_selection(lats, valid, return_vk=False):
    """Twin of ``merge_latencies``'s p99 over one trial's merged block."""
    lats = np.asarray(lats, dtype=F32).reshape(-1)
    valid = np.asarray(valid, dtype=bool).reshape(-1)
    staged = np.where(valid, lats, F32(np.nan)).astype(F32)
    nv = int(valid.sum())
    hi = F32(0.0)
    for x in np.where(valid, lats, F32(0.0)):    # fmaxf: NaN is skipped
        hi = hi if np.isnan(x) else max(hi, x)
    if nv == 0:
        return (F32(0.0), None) if return_vk else F32(0.0)
    k = int(np.ceil(F32(0.99) * F32(nv)))
    vk = from_key(radix_select(lat_key(staged), k))
    lo = F32(-1.0)
    for _ in range(P99_ITERS):
        mid = F32(0.5) * F32(lo + hi)
        go_hi = mid >= vk
        lo, hi = (lo, mid) if go_hi else (mid, hi)
    with np.errstate(invalid="ignore"):
        above = staged[staged > lo]
    p99 = F32(above.min()) if above.size else F32(jpc.BIG)
    return (p99, vk) if return_vk else p99


def references(lats, valid):
    """The three reference p99s of one merged block: the JAX package's
    with ``xp=np`` and ``jnp``, and the port's."""
    lats = np.asarray(lats, dtype=F32).reshape(-1)
    valid = np.asarray(valid, dtype=bool).reshape(-1)
    ref_np = jpc.nearest_rank_p99(lats, valid, xp=np)[0]
    ref_jnp = np.asarray(jpc.nearest_rank_p99(jnp.asarray(lats),
                                              jnp.asarray(valid), xp=jnp))[0]
    ref_t = tpc.nearest_rank_p99(torch.from_numpy(lats),
                                 torch.from_numpy(valid)).numpy()[0]
    return ref_np, ref_jnp, ref_t


def assert_p99_exact(lats, valid):
    got = p99_by_selection(lats, valid)
    for name, want in zip(("numpy", "jnp", "port"), references(lats, valid)):
        assert bits(got) == bits(want), (name, got, want)
    return got


def _latencies(rng, n):
    """Latencies of the stream kernel's scale: lognormal around 0.1 s."""
    return rng.lognormal(-2.0, 1.0, n).astype(F32)


@pytest.mark.parametrize("n_lanes", [2000, 2048])
@pytest.mark.parametrize("seed", range(4))
def test_p99_main_path_lanes(n_lanes, seed):
    """The per_client main path's merged blocks: 200 x 10 and 64 x 32."""
    rng = np.random.default_rng(seed)
    lats = _latencies(rng, n_lanes)
    valid = rng.random(n_lanes) > 0.2
    assert_p99_exact(lats, valid)


def test_p99_ties_all_equal():
    lats = np.full(500, 0.0625, dtype=F32)
    valid = np.ones(500, dtype=bool)
    assert assert_p99_exact(lats, valid) == F32(0.0625)


def test_p99_heavy_ties():
    rng = np.random.default_rng(5)
    lats = rng.choice(np.array([0.5, 0.25, 3.0, 7.5], dtype=F32), 2000)
    assert_p99_exact(lats, rng.random(2000) > 0.1)


def test_p99_zeros_of_both_signs():
    """-0.0 keys as +0.0: the select, the steps and the final min read the
    two zeros alike."""
    rng = np.random.default_rng(6)
    lats = rng.choice(np.array([-0.0, 0.0, 0.0, 1.5], dtype=F32), 300)
    assert_p99_exact(lats, np.ones(300, dtype=bool))
    # the p99 on a zero: two hundred zeros of both signs under one value
    lats = np.concatenate([np.where(np.arange(200) % 2, F32(-0.0), F32(0.0)),
                           [F32(2.0)]]).astype(F32)
    assert p99_by_selection(lats, np.ones(201, dtype=bool)) == 0.0
    lats = np.array([-0.0, 0.25, -0.0, 0.5], dtype=F32)
    assert_p99_exact(lats, np.ones(4, dtype=bool))


@pytest.mark.parametrize("nval", [0, 1, 99, 100])
def test_p99_small_valid_counts(nval):
    """nval 0 gives 0; 1 and 99 have k = nval; at 100, 0.99f * 100 rounds
    to 99 in float32, so k = 99 < nval."""
    rng = np.random.default_rng(nval)
    lats = _latencies(rng, 2000)
    valid = np.zeros(2000, dtype=bool)
    valid[rng.choice(2000, nval, replace=False)] = True
    got = assert_p99_exact(lats, valid)
    if nval == 0:
        assert bits(got) == bits(0.0)
    else:
        k = int(np.ceil(F32(0.99) * F32(nval)))
        assert k == (nval if nval < 100 else 99)
        assert got == np.sort(lats[valid])[k - 1]


def test_p99_block_wider_than_the_staging():
    """C·n past STAGE_MAX: the kernel reads device memory again in place
    of shared memory; the arithmetic is the same."""
    rng = np.random.default_rng(8)
    n = 3 * STAGE_MAX + 17
    lats = _latencies(rng, n)
    assert_p99_exact(lats, rng.random(n) > 0.3)


def test_p99_non_converging_range_answers_below_v_k():
    """Values near 1 beside one near 3e38: 48 halvings of [-1, 3e38] leave
    lo at -1, so the reference returns the least valid latency, well below
    the k-th smallest."""
    rng = np.random.default_rng(9)
    lats = (1.0 + rng.random(400) * 1e-3).astype(F32)
    lats[17] = F32(3.0e38)
    valid = np.ones(400, dtype=bool)
    got, vk = p99_by_selection(lats, valid, return_vk=True)
    assert got < vk and got == lats.min()
    assert_p99_exact(lats, valid)


def test_p99_invalid_steps_are_never_chosen():
    """Invalid steps hold large latencies: keyed as NaN they sit above
    every valid one, and the final min skips them."""
    rng = np.random.default_rng(10)
    lats = _latencies(rng, 2000)
    valid = rng.random(2000) > 0.5
    lats[~valid] = F32(1e30)
    got = assert_p99_exact(lats, valid)
    assert got < 1e30


def test_radix_select_against_sort():
    rng = np.random.default_rng(11)
    x = np.concatenate([_latencies(rng, 700), -_latencies(rng, 300),
                        [0.0, -0.0, np.inf, -np.inf, np.nan]]).astype(F32)
    keys = lat_key(x)
    order = np.sort(keys)
    for k in (1, 2, 500, 999, 1000, 1004, 1005):
        assert radix_select(keys, k) == order[k - 1]


# -- the masked column sums ---------------------------------------------------


def fold_registers(leaves, is_max=False):
    """Twin of ``fold_registers``: the halving tree over P <= 32 leaves
    (rows), the levels h = 16 .. 1 taken where h < P."""
    v = [np.asarray(r, dtype=F32) for r in leaves]
    p = len(v)
    h = MAX_LEAVES // 2
    while h >= 1:
        if h < p:
            for i in range(h):
                v[i] = np.maximum(v[i], v[i + h]) if is_max \
                    else (v[i] + v[i + h]).astype(F32)
        h //= 2
    return v[0]


def fold_stack(leaves, is_max=False):
    """Twin of ``fold_stack``: the pairwise fold in bit-reversed order."""
    p = len(leaves)
    nbits = p.bit_length() - 1
    stack = []
    for j in range(p):
        i = int(format(j, f"0{nbits}b")[::-1], 2) if nbits else 0
        v = np.asarray(leaves[i], dtype=F32)
        k = j
        while k & 1:
            left = stack.pop()
            v = np.maximum(left, v) if is_max else (left + v).astype(F32)
            k >>= 1
        stack.append(v)
    return stack[0]


def split_client_sum(x, real, ct, is_max=False):
    """Twin of ``merge_columns`` over every column of x (C, cols) at once:
    each (column, client block) pair folded on its own, partials added in
    ascending block order in rounds of MERGE_WARPS blocks.  Returns (the
    merged columns, the count of real clients)."""
    c = x.shape[0]
    p = 1 << (ct - 1).bit_length()
    n_blocks = -(-c // ct)
    acc, n_real = None, 0
    for r in range(-(-n_blocks // MERGE_WARPS)):
        partials = []
        for b in range(r * MERGE_WARPS, min((r + 1) * MERGE_WARPS, n_blocks)):
            leaves = [np.where(i < ct and b * ct + i < c and real[b * ct + i],
                               x[min(b * ct + i, c - 1)], F32(0.0))
                      for i in range(p)]
            n_real += sum(1 for i in range(ct)
                          if b * ct + i < c and real[b * ct + i])
            fold = fold_registers if p <= MAX_LEAVES else fold_stack
            partials.append(fold(leaves, is_max))
        for part in partials:
            acc = part if acc is None else (
                np.maximum(acc, part) if is_max else (acc + part).astype(F32))
    return acc, n_real


def split_client_mean(x, real, ct):
    total, n_real = split_client_sum(x, real, ct)
    return (total / np.maximum(F32(n_real), F32(1.0))).astype(F32)


def _client_values(rng, c, cols):
    """Window loads over a wide range of magnitudes, so the association
    shows in the low bits, with a few -0.0."""
    x = (rng.lognormal(2.0, 2.5, (c, cols))
         * rng.choice([1.0, 1.0, 1.0, -1.0], (c, cols))).astype(F32)
    x[rng.random((c, cols)) < 0.05] = F32(-0.0)
    return x


@pytest.mark.parametrize("n_clients", [1, 7, 200, 201])
@pytest.mark.parametrize("ct", [1, 3, 8, 32, 64])
def test_split_sum_and_mean_match_the_pinned_association(n_clients, ct):
    rng = np.random.default_rng(100 * ct + n_clients)
    ct = jpc.resolve_client_tile(n_clients, ct)
    x = _client_values(rng, n_clients, 37)
    real = rng.random(n_clients) > 0.15      # phantom clients
    if n_clients > 1:
        real[-1] = False
    got_sum, n_real = split_client_sum(x, real, ct)
    got_mean = split_client_mean(x, real, ct)
    assert n_real == int(real.sum())
    for xp, arr, cv in ((np, x, real), (jnp, jnp.asarray(x),
                                        jnp.asarray(real))):
        want_sum = np.asarray(jpc.masked_client_sum(arr, cv, ct, xp))
        want_mean = np.asarray(jpc.masked_client_mean(arr, cv, ct, xp))
        np.testing.assert_array_equal(bits(got_sum), bits(want_sum))
        np.testing.assert_array_equal(bits(got_mean), bits(want_mean))
    tx, tr = torch.from_numpy(x), torch.from_numpy(real)
    np.testing.assert_array_equal(
        bits(got_sum), bits(tpc.masked_client_sum(tx, tr, ct).numpy()))
    np.testing.assert_array_equal(
        bits(got_mean), bits(tpc.masked_client_mean(tx, tr, ct).numpy()))


def test_the_association_shows():
    """The inputs above tell associations apart: a plain sequential sum of
    the same values differs from the pinned one somewhere."""
    rng = np.random.default_rng(7)
    x = _client_values(rng, 200, 37)
    real = np.ones(200, dtype=bool)
    got, _ = split_client_sum(x, real, 32)
    seq = np.zeros(37, dtype=F32)
    for row in x:
        seq = (seq + row).astype(F32)
    assert not np.array_equal(bits(got), bits(seq))


def test_register_and_stack_folds_agree():
    """The two folds perform the same operations for P <= 32."""
    rng = np.random.default_rng(12)
    for p in (1, 2, 4, 8, 16, 32):
        leaves = list(_client_values(rng, p, 19))
        np.testing.assert_array_equal(bits(fold_registers(leaves)),
                                      bits(fold_stack(leaves)))


@pytest.mark.parametrize("n_clients,ct", [(200, 32), (64, 32), (201, 8),
                                          (7, 3), (150, 64)])
def test_merged_row_matches_client_stream_metrics(n_clients, ct):
    """The merged row's lanes as extra columns: lat_sum and n_valid by the
    split sum, makespan and lat_max by the same split with max, floored
    at 0; n_clients is the count of real clients, which the masked sum of
    ones equals exactly."""
    rng = np.random.default_rng(n_clients + ct)
    met = np.zeros((n_clients, jpc.MET_PAD), dtype=F32)
    met[:, :jpc.N_METRICS] = rng.lognormal(0.0, 1.5, (n_clients,
                                                      jpc.N_METRICS))
    met[:, jpc.MET_N_VALID] = rng.integers(0, 11, n_clients)
    real = met[:, jpc.MET_N_VALID] > 0
    sums, n_real = split_client_sum(met, real, ct)
    maxs, _ = split_client_sum(met, real, ct, is_max=True)
    ones, _ = split_client_sum(np.ones((n_clients, 1), F32), real, ct)
    got = np.array([max(maxs[jpc.MET_MAKESPAN], F32(0.0)), 0.0,
                    sums[jpc.MET_LAT_SUM],
                    max(maxs[jpc.MET_LAT_MAX], F32(0.0)),
                    sums[jpc.MET_N_VALID], F32(n_real)], dtype=F32)
    assert ones[0] == n_real
    for xp, arr, cv in ((np, met, real), (jnp, jnp.asarray(met),
                                          jnp.asarray(real))):
        want = np.asarray(jpc.client_stream_metrics(arr, cv, ct, xp))
        np.testing.assert_array_equal(bits(got), bits(want))
    want_t = tpc.client_stream_metrics(torch.from_numpy(met),
                                       torch.from_numpy(real), ct).numpy()
    np.testing.assert_array_equal(bits(got), bits(want_t))
