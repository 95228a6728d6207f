"""The stream kernel's new arithmetic, written out in numpy / PyTorch as
twins of ``csrc/sched_stream.cu`` and held on the CPU against what it
replaces: `np.argmin`, a full maximum, and the plain version
``ref.sched_stream_batch_ref``.

* the argmin (``sched_stream_kernel``'s target selection): each lane's
  local best, the least order-preserving uint32 key over the lanes
  (``order_key``, ``__reduce_min_sync``), the least index among the lanes
  holding it (a second ``__reduce_min_sync``), and the winning score
  recovered from the key (``from_key``) for the guard;
* ``dfl = max(1, max_i ewma_i)`` kept incrementally across ewma updates,
  with a rescan (``max_floor1``) only when the one maximum falls;
* the est row written once at the end from the final ewma, and the whole
  ect / minload chain with est derived where a score reads it.

Everything is exact: equality of indices, of float bit patterns and of
every contract output.  The kernel itself is held against the plain
version on the card by tests/test_torch_gpu.py and ``chip_smoke.py``.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from repro_torch.core.policy_core import (BIG, ROW_EST, ROW_EWMA, lane_sum,
                                          window_decrements)
from repro_torch.kernels.sched_select import ref
from repro_torch.kernels.sched_select.ops import pad_operands
from torch_parity import KW, batch_case, table_variant

F32 = np.float32


def order_key(x):
    """Twin of ``order_key`` (sched_stream.cu:171-174): -0.0 keyed as
    +0.0, then the sign-flip map under which uint32 order is float
    order."""
    x = np.where(x == 0, F32(0.0), x).astype(F32)
    u = x.view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def from_key(k):
    """Twin of ``from_key`` (sched_stream.cu:176-178)."""
    u = np.where(k & 0x80000000, k & 0x7FFFFFFF, ~k).astype(np.uint32)
    return u.view(F32)


def keyed_argmin(scores, lanes=32):
    """Twin of the minload / ect selection (sched_stream.cu:428-483) on
    rows (T, M_pad) for a stream of ``lanes`` lanes (32, or 16 in the 2-D
    form): lane t scans t, t + lanes, ... keeping the first strict
    minimum, then the stream's least key and the least index holding it.
    Returns (index (T,), winning score recovered from the key (T,))."""
    t, mp = scores.shape
    bv = np.zeros((t, lanes), dtype=F32)
    bi = np.full((t, lanes), -1, dtype=np.int64)
    for k in range(mp // lanes):
        sc = scores[:, lanes * k:lanes * (k + 1)]
        better = (bi < 0) | (sc < bv)
        bv = np.where(better, sc, bv)
        bi = np.where(better, lanes * k + np.arange(lanes), bi)
    key = order_key(bv)
    kmin = key.min(axis=1, keepdims=True)
    idx = np.where(key == kmin, bi, 0xFFFFFFFF).min(axis=1)
    return idx, from_key(kmin[:, 0])


def _tied_scores(rng, t, mp, m):
    """Scores drawn from a handful of values (exact ties across lanes and
    within one lane), zeros of both signs, and BIG on the padding."""
    pool = np.array([-0.0, 0.0, 1.5, 1.5, 2.25, -3.0, 7.0], dtype=F32)
    s = rng.choice(pool, size=(t, mp)).astype(F32)
    s[:, m:] = F32(BIG)
    return s


@pytest.mark.parametrize("lanes", [32, 16])
@pytest.mark.parametrize("mp,m", [(128, 100), (128, 5), (384, 300),
                                  (1024, 1000)])
@pytest.mark.parametrize("kind", ["tied", "signed_zeros", "uniform"])
def test_keyed_argmin_matches_np_argmin(mp, m, kind, lanes):
    rng = np.random.default_rng(mp + m + len(kind))
    t = 64
    if kind == "tied":
        s = _tied_scores(rng, t, mp, m)
    elif kind == "signed_zeros":
        s = np.where(rng.random((t, mp)) < 0.5, F32(-0.0),
                     F32(0.0)).astype(F32)
        s[:, m:] = F32(BIG)
        s[::3, rng.integers(0, m)] = F32(-1.0)   # a strict minimum in some
    else:
        s = rng.uniform(0.0, 50.0, (t, mp)).astype(F32)
        s[:, m:] = F32(BIG)
    idx, val = keyed_argmin(s, lanes)
    want = np.argmin(s, axis=1)
    np.testing.assert_array_equal(idx, want)
    got_min = s[np.arange(t), want]
    # the recovered score equals the winner's, -0.0 read as +0.0
    np.testing.assert_array_equal(val, got_min)
    assert not np.signbit(val[val == 0]).any()


def test_order_key_orders_like_floats():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.standard_normal(500).astype(F32) * 1e3,
                        np.array([-0.0, 0.0, BIG, -BIG, 1e-38, -1e-38,
                                  np.inf, -np.inf], dtype=F32)])
    k = order_key(x)
    a, b = np.meshgrid(x, x)
    ka, kb = np.meshgrid(k, k)
    np.testing.assert_array_equal(a < b, ka < kb)
    np.testing.assert_array_equal(a == b, ka == kb)
    nz = x != 0
    np.testing.assert_array_equal(from_key(k)[nz].view(np.uint32),
                                  x[nz].view(np.uint32))


def max_floor1(ewma):
    """Twin of ``max_floor1`` (sched_stream.cu:226-230): max(1, max_i
    ewma_i) through the bits of values clamped to at least 1."""
    v = np.maximum(ewma, F32(1.0)).astype(F32)
    return v.view(np.uint32).max().view(F32)


@pytest.mark.parametrize("seed", range(6))
def test_incremental_ewma_max_matches_full_max(seed):
    """Twin of the dfl update (sched_stream.cu:587-595): after every step
    of a random update sequence, the kept dfl is max(1, max ewma)."""
    rng = np.random.default_rng(seed)
    mp, m = 128, 37 + seed
    ewma = np.zeros(mp, dtype=F32)
    ewma[:m] = np.where(rng.random(m) < 0.5, F32(0.0),
                        rng.uniform(0.0, 3.0, m).astype(F32))
    dfl = max_floor1(ewma)
    rescans = 0
    for _ in range(2000):
        cur = int(np.argmax(ewma))
        c = cur if rng.random() < 0.4 else int(rng.integers(0, m))
        old = ewma[c]
        r = rng.random()
        if r < 0.2:
            nw = dfl                                  # a tie with the max
        elif r < 0.6:
            nw = F32(old * F32(rng.uniform(0.2, 1.0)))  # a fall
        else:
            nw = F32(rng.uniform(0.0, 6.0))
        v = rng.random() < 0.9
        if v:
            ewma[c] = nw
        rescan = False
        if v:
            if nw >= dfl:
                dfl = nw
            else:
                rescan = old == dfl
        if rescan:
            rescans += 1
            dfl = max_floor1(ewma)
        assert dfl.view(np.uint32) == np.maximum(
            ewma.max(), F32(1.0)).view(np.uint32)
    assert rescans > 0


def _final_est(final_ewma, table_est, observe, n):
    """Twin of the final table's est row (sched_stream.cu:652-661)."""
    if not (observe and n > 0):
        return table_est
    dfl = torch.maximum(final_ewma.amax(dim=-1, keepdim=True),
                        torch.tensor(1.0))
    return torch.where(final_ewma > 0, final_ewma, dfl)


@pytest.mark.parametrize("policy", ["ect", "minload", "trh", "mlml", "rr"])
@pytest.mark.parametrize("observe", [True, False])
def test_est_written_once_matches_ref(policy, observe):
    t, m, n_win, win = 6, 37, 3, 16
    arrays = batch_case(t, m, n_win, win, seed=7)
    obj, lens, valid, tables, seeds, rates = (torch.from_numpy(a)
                                             for a in arrays)
    tables = torch.from_numpy(table_variant(arrays[3], "warm", m))
    kw = dict(KW, n_servers=m, window_size=win, policy=policy,
              observe=observe)
    _, _, final, _, _ = ref.sched_stream_batch_ref(
        obj, lens, valid, tables, seeds.to(torch.int64), rates, **kw)
    want = final[:, ROW_EST]
    got = _final_est(final[:, ROW_EWMA], tables[:, ROW_EST], observe,
                     n_win * win)
    assert torch.equal(got, want)


def _pick(rows, idx):
    return torch.gather(rows, 1, idx[:, None])


def chain_twin(obj, lens, valid, tables, rates, *, n_servers, window_size,
               threshold, lam, alpha, window_dt, policy, observe, renorm):
    """The kernel's minload / ect chain over T streams, vectorised: the
    keyed argmin (ect over the real servers, the padding's one score only
    where it could win), the guard reusing the winning score, est derived from
    ewma and the kept dfl where a score reads it (the table's row before
    the first request), the window close, and the est row written once
    at the end (sched_stream.cu:435-661).  Returns (choices, latencies,
    final tables) as `ref.sched_stream_batch_ref` lays them out."""
    m, ws = n_servers, window_size
    t, n = obj.shape
    mp = tables.shape[-1]
    n_win = rates.shape[1]
    lane = torch.arange(mp)
    lv = (lane < m)[None, :]
    tidx = torch.arange(t)
    f = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    zero, one = f(0.0), f(1.0)
    loads = torch.where(lv, tables[:, 0], f(BIG))
    probs = torch.where(lv, tables[:, 1], zero)
    ewma = torch.where(lv, tables[:, 2], zero)
    est = torch.where(lv, tables[:, 3], one)
    dec = window_decrements(rates, window_dt)
    dfl = torch.from_numpy(np.array([max_floor1(r) for r in ewma.numpy()]))
    est_live = False
    pad_chosen = torch.zeros(t, dtype=torch.bool)
    choices = torch.zeros((t, n), dtype=torch.int32)
    lats = torch.zeros((t, n))
    for w in range(n_win):
        rate = torch.where(lv, rates[:, w], one)
        for j in range(w * ws, (w + 1) * ws):
            ln = lens[:, j:j + 1]
            v = valid[:, j:j + 1] != 0
            dflt = obj[:, j].to(torch.int64) % m
            if policy == "ect":
                e = (torch.where(ewma > 0, ewma, dfl[:, None]) if est_live
                     else est)
                # real servers only; the padding's one score (BIG + ln) / e
                # only where the real winner could reach it
                real = lv | pad_chosen[:, None]
                scores = torch.where(real, (torch.where(real, loads + ln, zero)
                                            / torch.where(real, e, one)),
                                     f(np.inf))
            else:
                scores = loads
            idx, t_score = keyed_argmin(scores.numpy())
            if policy == "ect" and m < mp:
                e_pad = dfl if est_live else torch.ones(t)
                for s in range(t):
                    if pad_chosen[s] or t_score[s] * e_pad[s] < F32(0.5 * BIG):
                        continue
                    pad = (f(BIG) + ln[s, 0]) / e_pad[s]
                    if order_key(pad.numpy()) < order_key(t_score[s]):
                        idx[s], t_score[s] = m, pad
            target = torch.from_numpy(idx.astype(np.int64))
            t_score = torch.from_numpy(t_score)[:, None]
            if policy == "ect":
                e_def = (torch.where(_pick(ewma, dflt) > 0, _pick(ewma, dflt),
                                     dfl[:, None]) if est_live
                         else _pick(est, dflt))
                benefit = (_pick(loads, dflt) + ln) / e_def - t_score
            else:
                benefit = _pick(loads, dflt) - t_score
            choose = torch.where(benefit[:, 0] > f(threshold), target, dflt)
            pad_chosen = pad_chosen | (choose >= m)
            p_i = _pick(probs, choose)
            l_i = torch.where(v, _pick(loads, choose) + ln,
                              _pick(loads, choose))
            ex = torch.exp(-l_i / f(lam))
            delta = p_i * (one - ex) / f(m - 1)
            lat = l_i / torch.maximum(_pick(rate, choose), f(1e-6))
            onehot = lane[None, :] == choose[:, None]
            upd = onehot & v
            new_probs = torch.where(onehot, p_i * ex,
                                    torch.where(lv, probs + delta, zero))
            probs = torch.where(v, new_probs, probs)
            loads = torch.where(upd, l_i, loads)
            if observe:
                mbps = ln / torch.maximum(lat, f(1e-9))
                old = _pick(ewma, choose)
                nw = torch.where(old == 0.0, mbps,
                                 f(1 - alpha) * old + f(alpha) * mbps)
                ewma = torch.where(upd, nw, ewma)
                if policy == "ect":
                    for s in range(t):
                        if not v[s, 0]:
                            continue
                        if nw[s, 0] >= dfl[s]:
                            dfl[s] = nw[s, 0]
                        elif old[s, 0] == dfl[s]:
                            dfl[s] = torch.from_numpy(np.array(
                                max_floor1(ewma[s].numpy())))
                est_live = True
            choices[:, j] = choose.to(torch.int32)
            lats[:, j] = torch.where(v, lat, zero)[:, 0]
        if renorm:
            p = torch.clamp_min(probs, 0.0)
            probs = p / lane_sum(p)
        if window_dt:
            loads = torch.where(lv, torch.clamp_min(
                loads - torch.where(lv, dec[:, w], zero), 0.0), f(BIG))
    est = _final_est(ewma, est, observe, n)
    final = torch.stack([torch.where(lv, r, zero)
                         for r in (loads, probs, ewma, est)], dim=1)
    return choices, lats, final


@pytest.mark.parametrize("policy", ["ect", "minload"])
@pytest.mark.parametrize("observe", [True, False])
@pytest.mark.parametrize("table", ["init", "signed_zeros", "warm",
                                   "pad_wins"])
def test_chain_twin_matches_ref(policy, observe, table):
    """The redesigned chain equals the plain version on every output it
    produces: choices, latencies and the four table rows, bit for bit.
    "warm" starts from an est row that is not the function of ewma, so the
    first request must read the table's row; under "pad_wins" a padding
    lane wins ect's first argmin and is chosen."""
    t, m, n_win, win = 5, 37, 3, 24
    arrays = batch_case(t, m, n_win, win, seed=11)
    tables = torch.from_numpy(arrays[3] if table == "init" else
                              table_variant(arrays[3], table, m))
    # the operands as the kernel takes them: server axis padded to 128
    obj, lens, valid, tables, seeds, rates = pad_operands(
        *(torch.from_numpy(a) for a in arrays[:3]), tables,
        torch.from_numpy(arrays[4]), torch.from_numpy(arrays[5]))
    kw = dict(KW, n_servers=m, window_size=win, policy=policy,
              observe=observe)
    want_ch, want_lat, want_tab, _, _ = ref.sched_stream_batch_ref(
        obj, lens, valid, tables, seeds.to(torch.int64), rates, **kw)
    tw = {k: kw[k] for k in ("n_servers", "window_size", "threshold", "lam",
                             "window_dt", "policy", "observe", "renorm")}
    got_ch, got_lat, got_tab = chain_twin(obj, lens, valid, tables, rates,
                                          alpha=0.25, **tw)
    assert torch.equal(got_ch, want_ch)
    assert torch.equal(got_lat, want_lat)
    assert torch.equal(got_tab.view(torch.int32), want_tab.view(torch.int32))



def rn32(x):
    """An exact rational rounded to float32, to nearest, ties to even
    (normal range only: the fast division's operands stay there)."""
    if x == 0:
        return F32(0.0)
    sign = -1 if x < 0 else 1
    x = abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    while Fraction(2) ** e > x:
        e -= 1
    while Fraction(2) ** (e + 1) <= x:
        e += 1
    scaled = x / Fraction(2) ** (e - 23)
    mant = scaled.numerator // scaled.denominator
    rest = scaled - mant
    if rest > Fraction(1, 2) or (rest == Fraction(1, 2) and mant % 2):
        mant += 1
    return F32(sign * float(mant) * 2.0 ** (e - 23))


def fma32(a, b, c):
    """float32 fused multiply-add, exact then rounded once."""
    return rn32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def div_fast_twin(a, b, r0):
    """Twin of ``rcp_newton`` + ``div_fast`` (sched_stream.cu:190-205)
    from a reciprocal estimate r0: one Newton step, q0 = a * r, one
    correction, every step a float32 FMA."""
    r = fma32(r0, fma32(r0, -b, F32(1.0)), r0)
    q = fma32(a, r, F32(0.0))
    return fma32(r, fma32(q, -b, a), q)


def div_ok(x):
    """Twin of ``div_ok``: normal, unbiased exponent in [-60, 60]."""
    e = (np.asarray(x, dtype=F32).view(np.uint32) >> 23) & 0xFF
    return np.uint32(e - 67) <= 120


@pytest.mark.parametrize("seed", range(4))
def test_fast_division_is_ieee_in_its_range(seed):
    """Where div_ok accepts both operands, the fast path gives the
    correctly rounded quotient from the correctly rounded reciprocal and
    from estimates one ulp either side of it (the hardware's estimate is
    within one ulp)."""
    rng = np.random.default_rng(seed)
    n = 150
    a = (rng.uniform(1.0, 2.0, n) * 2.0 ** rng.integers(-60, 60, n)
         * rng.choice([-1.0, 1.0], n)).astype(F32)
    b = (rng.uniform(1.0, 2.0, n)
         * 2.0 ** rng.integers(-60, 60, n)).astype(F32)
    b[:10] = F32(1.0)                         # mantissa ends
    b[10:20] = np.nextafter(F32(2.0), F32(0.0))
    a[20:30] = np.nextafter(F32(1.0), F32(2.0))
    assert div_ok(a).all() and div_ok(b).all()
    want = a / b
    for x, y, q in zip(a, b, want):
        r0 = rn32(1 / Fraction(float(y)))
        for est in (r0, np.nextafter(r0, F32(0.0)),
                    np.nextafter(r0, F32(4.0))):
            got = div_fast_twin(x, y, est)
            assert got.view(np.uint32) == q.view(np.uint32), (x, y, est)


def test_div_ok_rejects_the_ends_of_the_range():
    bad = np.array([0.0, -0.0, 1e-45, 1e-38, np.inf, -np.inf, np.nan,
                    2.0 ** 61, 2.0 ** -61, 3.4e38], dtype=F32)
    good = np.array([1.0, -1.0, 2.0 ** 60, 2.0 ** -60, 99.0, 1e-6, 1e-9,
                     50.0], dtype=F32)
    assert not div_ok(bad).any()
    assert div_ok(good).all()


def bisect_lo(lat, valid, test, stop_at_fixed_point=False):
    """The kernel's 48-step p99 bisection (sched_stream.cu:676-706)
    with the count test ``test(mid, k)``; returns the final lo, and the
    steps taken when it stops at a fixed point."""
    nval = F32(valid.sum())
    k = np.ceil(F32(0.99) * nval).astype(F32)
    lo, hi = F32(-1.0), F32(np.where(valid, lat, F32(0.0)).max(initial=0.0))
    for it in range(48):
        mid = F32(F32(0.5) * F32(lo + hi))
        nlo, nhi = (lo, mid) if test(mid, k) else (mid, hi)
        if (stop_at_fixed_point and nlo.view(np.uint32) == lo.view(np.uint32)
                and nhi.view(np.uint32) == hi.view(np.uint32)):
            return lo, it
        lo, hi = nlo, nhi
    return lo, 48


def test_p99_rank_is_the_valid_count_up_to_32():
    """k = ceil(0.99 nval) in float32 is nval for every count a stream of
    at most 32 requests can have, so the kernel takes the max compare for
    every such stream (sched_stream.cu:676)."""
    nval = np.arange(33, dtype=F32)
    np.testing.assert_array_equal(np.ceil(F32(0.99) * nval), nval)


@pytest.mark.parametrize("seed", range(8))
def test_p99_max_compare_matches_count(seed):
    """With at most 32 requests k is the valid count, and comparing mid
    with the largest valid latency takes the bisection's every step as
    counting does: the same final lo, so the same p99."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 33))
    lat = rng.choice(rng.uniform(0.0, 2.0, 4).astype(F32), n)   # ties
    lat[rng.random(n) < 0.3] = rng.uniform(0.0, 2.0)
    valid = rng.random(n) < 0.8
    if seed == 0:
        valid[:] = False
    nval = F32(valid.sum())
    assert np.ceil(F32(0.99) * nval) == nval
    vmax = lat[valid].max() if valid.any() else F32(-np.inf)
    count, _ = bisect_lo(lat, valid, lambda mid, k: F32(
        (valid & (lat <= mid)).sum()) >= k)
    by_max, _ = bisect_lo(lat, valid, lambda mid, k: mid >= vmax)
    assert count.view(np.uint32) == by_max.view(np.uint32)


@pytest.mark.parametrize("seed", range(8))
def test_p99_bisection_stops_at_its_fixed_point(seed):
    """Stopping the bisection at the first step that moves neither bound
    gives the 48 steps' final lo (sched_stream.cu, fused metrics), for
    short streams (the max compare) and long ones (the count)."""
    rng = np.random.default_rng(100 + seed)
    n = 20 if seed % 2 else 2000
    lat = rng.choice(rng.uniform(0.0, 3.0, 50).astype(F32), n)
    lat[rng.random(n) < 0.2] = F32(0.0)
    valid = rng.random(n) < 0.85
    count = lambda mid, k: F32((valid & (lat <= mid)).sum()) >= k  # noqa: E731
    full, _ = bisect_lo(lat, valid, count)
    early, steps = bisect_lo(lat, valid, count, stop_at_fixed_point=True)
    assert early.view(np.uint32) == full.view(np.uint32)
    assert steps < 48
