"""The scheduler's decision math on torch tensors.

Counterpart of the JAX package's ``core/policy_core.py``: the decision
core that the eager engine (`core/engine.py` through `core/statlog.py`
and `core/policies.py`) composes and the stream kernel's plain version
mirrors.  Every client schedules against one packed ``(4, M)`` float32
table:

    row 0  ``loads``      expected outstanding MB per server (Eq. 1)
    row 1  ``probs``      selection probability, sums to 1 (Eqs. 2-3)
    row 2  ``ewma_lat``   EWMA of the observed service rate, MB/s (0 = unseen)
    row 3  ``est_rates``  client-estimated rate, derived from row 2 only

Bit-exactness with the reference rests on a few pinned associations that
every function here keeps: float sums run through the explicit halving
trees `lane_sum` / `tree_sum` (never ``torch.sum``, whose reduction order
is a backend choice), argmins break ties to the lowest index, and no
product feeds an add directly where the reference keeps them apart.
Constants enter as float32 tensors so no Python scalar ever widens an
operation.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

# Packed log-tensor rows.
ROW_LOADS, ROW_PROBS, ROW_EWMA, ROW_EST = 0, 1, 2, 3
N_ROWS = 4

# Fused per-trial stream metrics, in the kernel's metrics-row lane order.
MET_MAKESPAN, MET_P99, MET_LAT_SUM, MET_LAT_MAX, MET_N_VALID = 0, 1, 2, 3, 4
N_METRICS = 5
MET_PAD = 128          # width of the kernel's metrics row

# Cross-client merged metrics of the 2-D (trials x clients) form: lanes
# [0, N_METRICS) keep the MET_* meaning merged over the REAL clients (a
# client is real iff it scheduled a valid step), plus the real-client
# count.  `client_stream_metrics` computes the row.
MET_N_CLIENTS = 5
N_CMETRICS = 6

# Clients per block of the cross-client float merge: an ASSOCIATION
# parameter (`masked_client_sum` adds blocks of this width), never a
# launch shape.  Every layer resolves it through `resolve_client_tile`.
DEFAULT_CLIENT_TILE = 32

# The in-kernel LCG (numerical recipes constants).
LCG_A = 1664525
LCG_C = 1013904223
_MASK32 = 0xFFFFFFFF

P99_Q = 0.99           # nearest-rank quantile of the fused metrics
P99_BISECT_ITERS = 48  # float32 bisection steps

BIG = 3.4e38           # padding-lane load: never selected, never drained

F32 = torch.float32
F32_MAX = torch.finfo(F32).max


def f32(x, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar tensor on ``like``'s device (rounded once from the
    Python double, as the reference's weakly typed scalars are).  Filled
    on the device, so a CUDA scalar costs no blocking host copy."""
    v = float(x)
    if math.isfinite(v) and abs(v) > F32_MAX:
        # torch.full refuses a finite double past float32's range, which
        # the cast rounds to the largest float or to inf: round on the host
        v = torch.tensor(v, dtype=F32).item()
    return torch.full((), v, dtype=F32, device=like.device)


@functools.lru_cache(maxsize=256)
def _const(x: float, device: torch.device) -> torch.Tensor:
    return f32(x, torch.empty((), device=device))


def const(x, like: torch.Tensor) -> torch.Tensor:
    """`f32` kept once per value and device: the eager engine's per-request
    functions read their scalars through here, so no step pays a fill."""
    return _const(float(x), like.device)


@functools.lru_cache(maxsize=64)
def _lanes(m: int, device: torch.device) -> torch.Tensor:
    return torch.arange(m, device=device)


def lanes(m: int, like: torch.Tensor) -> torch.Tensor:
    """``arange(m)`` (int64) on ``like``'s device, kept once per size."""
    return _lanes(m, like.device)


def take(row: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``row[..., idx]`` for one index per leading position: ``row``
    (..., M), ``idx`` (...) integer; returns (...)."""
    return torch.gather(row, -1, idx.to(torch.int64).unsqueeze(-1)
                        ).squeeze(-1)


def onehot(idx: torch.Tensor, m: int) -> torch.Tensor:
    """(..., m) bool, true at lane ``idx[...]``."""
    return lanes(m, idx) == idx.unsqueeze(-1)


def pack(loads, probs, ewma_lat, est_rates) -> torch.Tensor:
    """Stack the four rows into one (..., 4, M) table."""
    return torch.stack([loads, probs, ewma_lat, est_rates], dim=-2)


def init_table(m: int, batch=None, device="cuda") -> torch.Tensor:
    """Fresh log: zero loads, round-robin prior ``1/M``, no observations,
    unit estimated rates.  ``batch`` adds a leading trial axis.  On the
    card unless ``device="cpu"`` (`resolve_device` raises without one)."""
    row = (m,) if batch is None else (batch, m)
    dev = resolve_device(device)
    fill = lambda v: torch.full(row, v, dtype=F32, device=dev)  # noqa: E731
    # built from fills, with no element written from the host (a write
    # of a host value into a CUDA tensor waits for the device)
    rows = {ROW_LOADS: 0.0, ROW_PROBS: 1.0 / m, ROW_EWMA: 0.0, ROW_EST: 1.0}
    return torch.stack([fill(rows[r]) for r in range(N_ROWS)], dim=-2)


def resolve_client_tile(n_clients: int, client_tile=None) -> int:
    """Effective width of the cross-client merge's client blocks."""
    ct = DEFAULT_CLIENT_TILE if client_tile is None else client_tile
    return max(min(ct, n_clients), 1)


# ---------------------------------------------------------------------------
# LCG on int64 tensors holding uint32 states
# ---------------------------------------------------------------------------


def lcg_step(rng: torch.Tensor) -> torch.Tensor:
    """One uint32 LCG step (state held in int64, wrapped to 32 bits)."""
    # contract-ok: CC-FMA int64 LCG arithmetic is exact (DESIGN.md §9; ROADMAP parity bar)
    return (rng * LCG_A + LCG_C) & _MASK32


def lcg_mod(rng: torch.Tensor, n) -> torch.Tensor:
    """Map an LCG state to [0, n): drop the low byte, mask to a
    non-negative int32, take the remainder."""
    return ((rng >> 8) & 0x7FFFFFFF) % n


def two_random_draws(rng: torch.Tensor, n: int):
    """Two consecutive LCG draws in [0, n); returns ``(d1, d2, new_rng)``
    — the kernel's draw sequence for trh and nltr."""
    r1 = lcg_step(rng)
    r2 = lcg_step(r1)
    return lcg_mod(r1, n), lcg_mod(r2, n), r2


# ---------------------------------------------------------------------------
# Decision core: scores and the redirect guard's benefit
# ---------------------------------------------------------------------------


def ect_rates(ewma_lat: torch.Tensor) -> torch.Tensor:
    """The estimated-rate row from the observation EWMA alone: unobserved
    servers get the best rate seen (at least 1 MB/s)."""
    default = torch.maximum(ewma_lat.amax(dim=-1, keepdim=True),
                            const(1.0, ewma_lat))
    return torch.where(ewma_lat > 0, ewma_lat, default)


def ect_scores(loads: torch.Tensor, est_rates: torch.Tensor,
               length: torch.Tensor) -> torch.Tensor:
    """Expected completion time per server, ``(load_i + len) / est_i``;
    ``length`` (...) per stream."""
    return (loads + length.unsqueeze(-1)) / est_rates


def redirect_benefit(policy_name: str, loads: torch.Tensor,
                     est_rates: torch.Tensor, default: torch.Tensor,
                     target: torch.Tensor, length: torch.Tensor
                     ) -> torch.Tensor:
    """The redirect guard's benefit: MB of load, or expected seconds on the
    estimated rates for ect.  ``default``/``target``/``length``: (...)."""
    if policy_name == "ect":
        return ((take(loads, default) + length) / take(est_rates, default)
                - (take(loads, target) + length) / take(est_rates, target))
    return take(loads, default) - take(loads, target)


# ---------------------------------------------------------------------------
# All-pairs rank and permutation applies
# ---------------------------------------------------------------------------


def rank_desc(keys: torch.Tensor, valid=None):
    """Rank of every element under ``(key desc, index asc)``:
    ``rank[i] = #{k : key_k > key_i or (key_k == key_i and k < i)}``.

    ``valid`` masks keys to ``-inf`` first, so invalid rows rank after
    every valid one, index-ascending among themselves.  Returns
    ``(rank int64, masked_keys)``."""
    if valid is not None:
        keys = torch.where(valid, keys, f32(float("-inf"), keys))
    r = keys.shape[-1]
    idx = torch.arange(r, device=keys.device)
    a, b = keys[..., :, None], keys[..., None, :]
    before = (b > a) | ((b == a) & (idx[None, :] < idx[:, None]))
    return before.sum(dim=-1), keys


def permute_to_sorted(rank: torch.Tensor, payloads):
    """``out[p] = payload[i]`` where ``rank[i] == p`` — a pure relocation
    (``rank`` is a permutation, so every output lane has one source)."""
    return tuple(torch.empty_like(x).scatter_(-1, rank, x) for x in payloads)


def permute_from_sorted(rank: torch.Tensor, payloads):
    """``out[i] = payload[rank[i]]`` — the inverse relocation."""
    return tuple(torch.gather(x, -1, rank) for x in payloads)


def _bitonic_network(keys, idx, payloads, descending: bool):
    """The textbook bitonic schedule on power-of-two lanes, ordering by
    ``(key desc|asc, index asc)``; the payloads move under the same swap
    masks, so they are only relocated."""
    pos = idx
    rp = keys.shape[-1]
    payloads = list(payloads)

    def partner(x, is_lo, j):
        return torch.where(is_lo, torch.roll(x, -j, dims=-1),
                           torch.roll(x, j, dims=-1))

    k = 2
    while k <= rp:
        asc = (pos & k) == 0
        j = k // 2
        while j >= 1:
            is_lo = (pos & j) == 0
            pk, pi = partner(keys, is_lo, j), partner(idx, is_lo, j)
            ahead = (pk > keys) if descending else (pk < keys)
            p_first = ahead | ((pk == keys) & (pi < idx))
            swap = torch.where(asc == is_lo, p_first, ~p_first)
            keys = torch.where(swap, pk, keys)
            idx = torch.where(swap, pi, idx)
            payloads = [torch.where(swap, partner(p, is_lo, j), p)
                        for p in payloads]
            j //= 2
        k *= 2
    return keys, idx, tuple(payloads)


def bitonic_sort_with_payload(keys: torch.Tensor, payloads=(), valid=None):
    """Stable descending sort as an explicit bitonic network carrying
    ``payloads`` (each of the keys' shape, any dtype).  ``valid`` masks
    keys to ``-inf`` first; the last axis pads to the next power of two
    with ``-inf`` keys and zero payloads.  Returns ``(order int64
    (..., R_pad), sorted_keys, sorted_payloads)``: ``order`` maps sorted
    position to original index, equal to ``argsort(-keys, stable)`` on
    the first R positions."""
    r = keys.shape[-1]
    rp = _next_pow2(r)
    if valid is not None:
        keys = torch.where(valid, keys, f32(float("-inf"), keys))
    if rp != r:
        keys = torch.nn.functional.pad(keys, (0, rp - r),
                                       value=float("-inf"))
        payloads = tuple(torch.nn.functional.pad(p, (0, rp - r))
                         for p in payloads)
    idx = torch.arange(rp, device=keys.device).expand(keys.shape)
    keys, idx, payloads = _bitonic_network(keys, idx, payloads, True)
    return idx, keys, payloads


def bitonic_argsort_desc(keys: torch.Tensor, valid=None):
    """`bitonic_sort_with_payload` with no payloads: ``(order,
    sorted_keys)``."""
    order, skeys, _ = bitonic_sort_with_payload(keys, (), valid=valid)
    return order, skeys


def bitonic_apply_inverse(order: torch.Tensor, payloads):
    """Move sorted payloads back to original-index order,
    ``out[order[p]] = payload[p]``, by one ascending bitonic pass keyed on
    the distinct integers of ``order`` ((..., R_pad), R_pad a power of
    two)."""
    idx = torch.arange(order.shape[-1], device=order.device).expand(
        order.shape)
    _, _, payloads = _bitonic_network(order, idx, payloads, False)
    return payloads


# ---------------------------------------------------------------------------
# Pinned float reductions
# ---------------------------------------------------------------------------


def _next_pow2(n: int) -> int:
    size = 1
    while size < n:
        size *= 2
    return size


def tree_sum(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Sum over ``axis`` by the explicit halving tree: zero-pad to the
    next power of two, then fold the upper half onto the lower until one
    element is left.  Keeps the axis with size 1."""
    axis = axis % x.ndim
    c = x.shape[axis]
    size = _next_pow2(c)
    if size != c:
        pad_shape = list(x.shape)
        pad_shape[axis] = size - c
        x = torch.cat([x, x.new_zeros(pad_shape)], dim=axis)
    while x.shape[axis] > 1:
        h = x.shape[axis] // 2
        x = x.narrow(axis, 0, h) + x.narrow(axis, h, h)
    return x


def lane_sum(x: torch.Tensor) -> torch.Tensor:
    """Last-axis `tree_sum`; returns shape ``(..., 1)``.  Zero-padded
    widths give the same bits, since the leading halvings add zeros."""
    return tree_sum(x, axis=-1)


def recursive_average_bounds(sorted_len: torch.Tensor, nvalid: torch.Tensor,
                             n_levels: int) -> torch.Tensor:
    """nLTR request sectioning on a desc-sorted length list: split
    ``[0, nvalid)`` into ``2**n_levels`` sections by recursive average.

    ``sorted_len``: (..., R) lengths in descending order (``-inf`` past
    ``nvalid``); ``nvalid``: (..., 1) integer count.  Returns (..., K-1)
    int64 bounds in BFS order; the section of position ``p`` is
    ``sum(bounds <= p)``.  Each section mean is a `lane_sum` divided by
    the integer count converted to float32."""
    r = sorted_len.shape[-1]
    pos = torch.arange(r, device=sorted_len.device)
    zero_f = torch.zeros_like(sorted_len)
    starts = [torch.zeros_like(nvalid)]
    ends = [nvalid]
    bounds = []
    for _ in range(n_levels):
        new_starts, new_ends = [], []
        for s, e in zip(starts, ends):
            inside = (pos >= s) & (pos < e)
            cnt = torch.clamp_min(inside.sum(dim=-1, keepdim=True), 1)
            total = lane_sum(torch.where(inside, sorted_len, zero_f))
            mean = total / cnt.to(F32)
            gt = inside & (sorted_len > mean)
            b = s + gt.sum(dim=-1, keepdim=True)
            lo = s + (e > s + 1).to(s.dtype)
            hi = torch.maximum(e - 1, s + 1)
            b = torch.minimum(torch.maximum(b, lo), hi)
            bounds.append(b)
            new_starts.extend([s, b])
            new_ends.extend([b, e])
        starts, ends = new_starts, new_ends
    return torch.cat(bounds, dim=-1)


# ---------------------------------------------------------------------------
# Probability row and queue maintenance
# ---------------------------------------------------------------------------


def renormalize_probs(probs: torch.Tensor) -> torch.Tensor:
    """Re-project the probability row onto the simplex through
    `lane_sum`."""
    p = torch.clamp_min(probs, 0.0)
    return p / lane_sum(p)


def _fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding: the product of two float32
    values is exact in float64, and the float64 sum rounds to float32
    (twice, which differs from once only on a float32 tie)."""
    # contract-ok: CC-FMA XLA's contracted log1p multiply-add, on purpose (DESIGN.md §9; ROADMAP C1)
    return (a.to(torch.float64) * b + c).to(F32)


def _f32_of(x: float) -> float:
    return float(torch.tensor(x, dtype=F32))


def _recip32(x: float) -> float:
    """``1 / x`` in float32 arithmetic on float32 ``x``."""
    one = torch.tensor(1.0, dtype=F32)
    return float(one / torch.tensor(x, dtype=F32))


# Cephes' expf, as the reference's compiler computes a float32 exp over an
# array on the CPU: range reduction by ln 2 in two parts, a degree-5
# polynomial, every multiply-add fused.
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
             4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``exp(x)`` for ``|x| < 88``, bit for bit the reference's
    vectorised CPU exp (tests/test_torch_policy_core.py), and the same on
    the CPU and on the card: every step is an IEEE operation or a
    multiply-add rounded once (`_fma32`), so it does not depend on a
    library's exp."""
    log2e = _f32_of(1.44269504088896341)
    n = torch.floor(_fma32(x, log2e, 0.5))
    r = _fma32(-n, _f32_of(0.693359375), x)
    r = _fma32(-n, _f32_of(-2.12194440e-4), r)
    p = _fma32(torch.full_like(r, _f32_of(_EXP_POLY[0])), r,
               _f32_of(_EXP_POLY[1]))
    for c in _EXP_POLY[2:]:
        p = _fma32(p, r, _f32_of(c))
    y = _fma32(p, (r * r).to(torch.float64), r) + 1.0
    return y * torch.exp2(n)


def absorb_probs(loads: torch.Tensor, lam: float, m: int) -> torch.Tensor:
    """Probability row absorbing known initial loads,
    ``p_i ∝ (1/M) · exp(-l_i / λ)``, normalised through a `lane_sum`
    tree, computed as the reference's compiler computes its row on the
    CPU: the divisions by the constants λ and M are products with their
    float32 reciprocals, the exp is `exp_f32`, and the ``1/M`` product of
    the lower half feeds the tree's first halving add as one multiply-add
    (the upper half is the rounded product).  Bit for bit the reference's
    row for M above 8 (tests/test_torch_policy_core.py)."""
    e = exp_f32(loads.to(F32) * f32(_recip32(-lam), loads))
    inv_m = _recip32(m)
    p = e * f32(inv_m, e)
    size = 1 << max(m - 1, 0).bit_length()
    if size == 1:
        return p / lane_sum(p)
    h = size // 2
    upper = torch.nn.functional.pad(p[..., h:], (0, size - m))
    return p / lane_sum(_fma32(e[..., :h], inv_m, upper))


def assignment_update(loads: torch.Tensor, probs: torch.Tensor,
                      server: torch.Tensor, length: torch.Tensor, lam: float,
                      m: int):
    """Eq. (1)-(3) as one-hot selects: book ``length`` MB on ``server``,
    decay its probability by ``e = exp(-l_i / λ)`` and spread the lost
    mass ``p_i * (1 - e) / (M-1)`` over the other servers (never the
    ``(p_i - p_i*e)`` form: every product feeds a select or a divide).
    ``loads``/``probs`` (..., M); ``server``/``length`` (...)."""
    hot = onehot(server, m)
    loads = torch.where(hot, loads + length.unsqueeze(-1), loads)
    l_i = take(loads, server)
    p_i = take(probs, server)
    e = torch.exp(-l_i / const(lam, loads))
    decayed = p_i * e
    delta = p_i * (const(1.0, e) - e) / const(m - 1, e)
    probs = torch.where(hot, decayed.unsqueeze(-1),
                        probs + delta.unsqueeze(-1))
    return loads, probs


def observe_update(ewma_lat: torch.Tensor, server: torch.Tensor,
                   mb_per_s: torch.Tensor, alpha: float):
    """Fold one observed rate per stream into the EWMA row (the first
    observation replaces the 0) and re-derive the estimated-rate row.
    The blend ``(1-α)·old + α·mbps`` runs as separate multiplies and an
    add.  Returns ``(ewma_lat, est_rates)``."""
    old = take(ewma_lat, server)
    # contract-ok: CC-FMA EWMA row is 1e-6-soft (§9)
    blend = (const(1 - alpha, old) * old
             + const(alpha, old) * mb_per_s)
    new = torch.where(old == 0.0, mb_per_s, blend)
    ewma_lat = torch.where(onehot(server, ewma_lat.shape[-1]),
                           new.unsqueeze(-1), ewma_lat)
    return ewma_lat, ect_rates(ewma_lat)


def estimated_latency(loads: torch.Tensor, rates: torch.Tensor,
                      server: torch.Tensor) -> torch.Tensor:
    """Seconds until a request just queued on ``server`` completes at the
    given true rates: ``loads[server] / max(rates[server], 1e-6)``."""
    return take(loads, server) / torch.maximum(take(rates, server),
                                               const(1e-6, rates))


def server_segment_sum(values: torch.Tensor, idx: torch.Tensor, m: int,
                       block: int = 128) -> torch.Tensor:
    """``out[s] = Σ values[r] · [idx[r] == s]`` with a pinned association:
    sequential over ``block``-request chunks in ascending order, each
    chunk's one-hot contributions folded by `tree_sum` over the request
    axis.  ``values``/``idx``: (..., R); returns (..., m)."""
    r = values.shape[-1]
    n_blocks = max(-(-r // block), 1)
    lane = torch.arange(m, device=values.device)
    out = None
    for b in range(n_blocks):
        v = values[..., b * block:(b + 1) * block]
        i = idx[..., b * block:(b + 1) * block]
        onehot = i[..., :, None] == lane
        contrib = torch.where(onehot, v[..., :, None],
                              torch.zeros_like(v)[..., None])
        blk = tree_sum(contrib, axis=-2)[..., 0, :]
        out = blk if out is None else out + blk
    return out


def window_decrements(rates: torch.Tensor, dt: float) -> torch.Tensor:
    """Per-window drain decrement ``max(max(rates, 1e-6) * dt, 0)``,
    computed once outside the loop that subtracts it, so the subtract's
    operand is never a product."""
    prod = torch.maximum(rates, f32(1e-6, rates)) * f32(dt, rates)
    return torch.clamp_min(prod, 0.0)


def drain_loads(loads: torch.Tensor, rates: torch.Tensor, dt: float,
                dec=None) -> torch.Tensor:
    """Drain each queue for ``dt`` seconds at its true rate, clipped at
    empty."""
    if dec is None:
        dec = window_decrements(rates, dt)
    return torch.clamp_min(loads - dec, 0.0)


# ---------------------------------------------------------------------------
# Fused stream metrics
# ---------------------------------------------------------------------------


def nearest_rank_p99(lats: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Nearest-rank p99 of the valid latencies by float32 value bisection:
    `P99_BISECT_ITERS` halvings of ``[-1, max]`` keeping
    ``count(lats <= lo) < k <= count(lats <= hi)`` with
    ``k = ceil(0.99 · n_valid)``, then the smallest valid latency above
    ``lo``.  Counts are sums of exact 0/1 floats.  Returns (..., 1)."""
    lats = lats.to(F32)
    one, zero = f32(1.0, lats), f32(0.0, lats)
    nval = torch.where(valid, one, zero).sum(dim=-1, keepdim=True)
    k = torch.ceil(f32(P99_Q, lats) * nval)
    lo = torch.full_like(nval, -1.0)
    hi = torch.where(valid, lats, zero).amax(dim=-1, keepdim=True)
    half = f32(0.5, lats)
    for _ in range(P99_BISECT_ITERS):
        mid = half * (lo + hi)
        cnt = torch.where(valid & (lats <= mid), one, zero).sum(
            dim=-1, keepdim=True)
        go_hi = cnt >= k
        lo, hi = torch.where(go_hi, lo, mid), torch.where(go_hi, mid, hi)
    p99 = torch.where(valid & (lats > lo), lats, f32(BIG, lats)).amin(
        dim=-1, keepdim=True)
    return torch.where(nval > 0, p99, zero)


def stream_metrics(lats: torch.Tensor, valid: torch.Tensor, window_dt: float,
                   window_size: int) -> torch.Tensor:
    """Per-trial fused metrics in `MET_*` order: makespan (window-open
    time plus latency, max over valid steps), nearest-rank p99, the
    latency sum as one sequential float32 chain in request order, the
    latency max and the valid count.  ``lats``/``valid``: (..., N);
    returns (..., N_METRICS)."""
    lats = lats.to(F32)
    zero = f32(0.0, lats)
    latv = torch.where(valid, lats, zero)
    n = lats.shape[-1]
    idx = torch.arange(n, device=lats.device)
    w_open = (idx // window_size).to(F32) * f32(window_dt, lats)
    makespan = torch.where(valid, w_open + lats, zero).amax(dim=-1,
                                                            keepdim=True)
    lat_max = latv.amax(dim=-1, keepdim=True)
    n_valid = torch.where(valid, f32(1.0, lats), zero).sum(dim=-1,
                                                          keepdim=True)
    lat_sum = torch.zeros_like(lat_max)
    for i in range(n):
        lat_sum = lat_sum + latv[..., i:i + 1]
    p99 = nearest_rank_p99(lats, valid)
    return torch.cat([makespan, p99, lat_sum, lat_max, n_valid], dim=-1)


# ---------------------------------------------------------------------------
# Cross-client merge of the 2-D (trials x clients) form
# ---------------------------------------------------------------------------


def _mask_clients(x: torch.Tensor, client_valid: torch.Tensor):
    """Zero the rows of phantom clients; ``client_valid``'s shape is a
    prefix of ``x``'s (leading client axis)."""
    cv = client_valid.reshape(client_valid.shape
                              + (1,) * (x.ndim - client_valid.ndim))
    return torch.where(cv, x, torch.zeros_like(x))


def masked_client_sum(x: torch.Tensor, client_valid: torch.Tensor,
                      client_tile: int) -> torch.Tensor:
    """Masked sum over the LEADING client axis with a pinned association:
    ``ceil(C / client_tile)`` client blocks added in ascending order (the
    first block taken as is), each block folded by `tree_sum` (zero-padded
    to ``next_pow2(client_tile)``).  ``client_valid``: bool with ``x``'s
    leading shape, at least (C,); phantom clients add exact zeros.
    Returns ``x.shape[1:]``."""
    c = x.shape[0]
    xm = _mask_clients(x, client_valid)
    n_blocks = -(-c // client_tile)
    if n_blocks * client_tile != c:
        xm = torch.cat([xm, xm.new_zeros((n_blocks * client_tile - c,)
                                         + xm.shape[1:])])
    out = None
    for b in range(n_blocks):
        blk = tree_sum(xm[b * client_tile:(b + 1) * client_tile], 0)[0]
        out = blk if out is None else out + blk
    return out


def masked_client_mean(x: torch.Tensor, client_valid: torch.Tensor,
                       client_tile: int) -> torch.Tensor:
    """`masked_client_sum` divided by the real-client count (at least 1),
    itself a `masked_client_sum` of ones."""
    total = masked_client_sum(x, client_valid, client_tile)
    n_real = masked_client_sum(torch.ones(client_valid.shape, dtype=x.dtype,
                                          device=x.device),
                               client_valid, client_tile)
    denom = torch.clamp_min(n_real, 1.0)
    return total / denom.reshape(denom.shape
                                 + (1,) * (total.ndim - denom.ndim))


def masked_client_max(x: torch.Tensor,
                      client_valid: torch.Tensor) -> torch.Tensor:
    """Masked max over the leading client axis, floored at 0 (every merged
    metric is nonnegative); order-free."""
    return _mask_clients(x, client_valid).amax(dim=0)


def client_stream_metrics(metrics: torch.Tensor, client_valid: torch.Tensor,
                          client_tile: int, merged_lats=None,
                          merged_valid=None) -> torch.Tensor:
    """Merge per-client stream-metric rows into one row in `MET_*` +
    `MET_N_CLIENTS` order: makespan and lat_max by `masked_client_max`,
    lat_sum, n_valid and the real-client count by `masked_client_sum`.

    ``metrics``: (C, ..., >= N_METRICS); ``client_valid``: (C, ...).  With
    ``merged_lats``/``merged_valid`` ((C, ..., N) grouped-step latencies
    and validity) the p99 lane is `nearest_rank_p99` over the C·N merged
    block of each batch index (counts and min/max are order-free, so the
    layout does not matter); without them it is 0.  Returns
    (..., N_CMETRICS)."""
    metrics = metrics.to(F32)
    mx = masked_client_max(metrics, client_valid)
    sm = masked_client_sum(metrics, client_valid, client_tile)
    n_real = masked_client_sum(torch.ones(client_valid.shape, dtype=F32,
                                          device=metrics.device),
                               client_valid, client_tile)
    if merged_lats is None:
        p99 = torch.zeros_like(n_real)
    else:
        lead = merged_lats.shape[1:-1]
        flat = lambda a: a.movedim(0, -2).reshape(lead + (-1,))  # noqa: E731
        p99 = nearest_rank_p99(flat(merged_lats), flat(merged_valid))[..., 0]
    return torch.stack([mx[..., MET_MAKESPAN], p99, sm[..., MET_LAT_SUM],
                        mx[..., MET_LAT_MAX], sm[..., MET_N_VALID], n_real],
                       dim=-1)


# ---------------------------------------------------------------------------
# Sharded cross-client merge: the rank axis as one more association level
# ---------------------------------------------------------------------------


def resolve_shard_width(n_clients: int, n_shards: int) -> int:
    """Clients per contiguous shard of the client axis: the rank-axis
    twin of `resolve_client_tile`, shared by the sharded sweep
    (`repro_torch.parallel.sweep`) and the host oracle
    `sharded_client_sum`, so both pad and split the client axis alike
    (trailing shards fill up with phantom clients)."""
    if n_shards < 1:
        raise ValueError(f"n_shards={n_shards!r} must be >= 1")
    return -(-n_clients // n_shards)


def all_gather_stack(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` from every rank of ``group``, stacked on a new leading axis
    in the group's rank order, on ``x``'s device.  A copy, so exact; a
    gloo group moves CUDA tensors through host memory, and bool tensors
    travel as uint8."""
    stage = x.device.type != "cpu" and dist.get_backend(group) == "gloo"
    src = x.to(torch.uint8) if x.dtype == torch.bool else x
    src = (src.cpu() if stage else src).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.stack(parts).to(device=x.device, dtype=x.dtype)


def psum_tree(x: torch.Tensor, group=None) -> torch.Tensor:
    """Cross-rank sum over ``group`` in a pinned order: the collective
    twin of `tree_sum`.  Every rank gathers every rank's partial in rank
    order and folds the stack by the halving tree, so the result is the
    same on every rank and equal to the host oracle's outer fold
    (`sharded_client_sum`).  Never ``all_reduce``, whose order of
    addition is the backend's choice."""
    return tree_sum(all_gather_stack(x, group), 0)[0]


def sharded_client_sum(x: torch.Tensor, client_valid: torch.Tensor,
                       client_tile, n_shards: int) -> torch.Tensor:
    """Host oracle of the sharded cross-client merge: what the sharded
    sweep computes with the client axis split over ``n_shards`` ranks.
    The client axis (leading) pads with phantoms to ``n_shards`` equal
    contiguous shards of `resolve_shard_width` clients; each shard is a
    `masked_client_sum` with ``client_tile`` resolved against the shard
    width (as each rank's merge resolves it against its local client
    count); `tree_sum` folds the shard partials.  ``n_shards == 1`` is
    `masked_client_sum` with the unsharded tile.  ``client_tile`` may be
    None (the default tile)."""
    c = x.shape[0]
    w = resolve_shard_width(c, n_shards)
    if w * n_shards != c:
        x = torch.cat([x, x.new_zeros((w * n_shards - c,) + x.shape[1:])])
        client_valid = torch.cat([client_valid, client_valid.new_zeros(
            (w * n_shards - c,) + client_valid.shape[1:])])
    ct = resolve_client_tile(w, client_tile)
    parts = torch.stack([
        masked_client_sum(x[s * w:(s + 1) * w],
                          client_valid[s * w:(s + 1) * w], ct)
        for s in range(n_shards)])
    return tree_sum(parts, 0)[0]


def sharded_client_mean(x: torch.Tensor, client_valid: torch.Tensor,
                        client_tile, n_shards: int) -> torch.Tensor:
    """Sharded twin of `masked_client_mean`: the shard-merged sum over the
    shard-merged real-client count (at least 1), divided once after the
    fold, since a mean does not compose across ranks (the merge kernel
    ships raw sums under ``merge_mean=False`` for that reason)."""
    total = sharded_client_sum(x, client_valid, client_tile, n_shards)
    n_real = sharded_client_sum(
        torch.ones(client_valid.shape, dtype=x.dtype, device=x.device),
        client_valid, client_tile, n_shards)
    denom = torch.clamp_min(n_real, 1.0)
    return total / denom.reshape(denom.shape
                                 + (1,) * (total.ndim - denom.ndim))
