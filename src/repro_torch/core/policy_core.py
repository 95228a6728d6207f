"""The scheduler's decision math on torch tensors.

Counterpart of the JAX package's ``core/policy_core.py``, cut to what the
trial-grid kernel and its pipeline use.  Every client schedules against
one packed ``(4, M)`` float32 table:

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

import math

import torch

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


def init_table(m: int, batch=None, device="cuda") -> torch.Tensor:
    """Fresh log: zero loads, round-robin prior ``1/M``, no observations,
    unit estimated rates.  ``batch`` adds a leading trial axis.  On the
    card unless ``device="cpu"`` (`resolve_device` raises without one)."""
    shape = (N_ROWS, m) if batch is None else (batch, N_ROWS, m)
    t = torch.zeros(shape, dtype=F32, device=resolve_device(device))
    t[..., ROW_PROBS, :] = torch.tensor(1.0 / m, dtype=F32)
    t[..., ROW_EST, :] = 1.0
    return t


def resolve_client_tile(n_clients: int, client_tile=None) -> int:
    """Effective width of the cross-client merge's client blocks."""
    ct = DEFAULT_CLIENT_TILE if client_tile is None else client_tile
    return max(min(ct, n_clients), 1)


# ---------------------------------------------------------------------------
# LCG on int64 tensors holding uint32 states
# ---------------------------------------------------------------------------


def lcg_step(rng: torch.Tensor) -> torch.Tensor:
    """One uint32 LCG step (state held in int64, wrapped to 32 bits)."""
    return (rng * LCG_A + LCG_C) & _MASK32


def lcg_mod(rng: torch.Tensor, n) -> torch.Tensor:
    """Map an LCG state to [0, n): drop the low byte, mask to a
    non-negative int32, take the remainder."""
    return ((rng >> 8) & 0x7FFFFFFF) % n


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


def absorb_probs(loads: torch.Tensor, lam: float, m: int) -> torch.Tensor:
    """Probability row absorbing known initial loads,
    ``p_i ∝ (1/M) · exp(-l_i / λ)``, normalised through `lane_sum`."""
    p = torch.exp(-loads / f32(lam, loads)) / f32(m, loads)
    return p / lane_sum(p)


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
