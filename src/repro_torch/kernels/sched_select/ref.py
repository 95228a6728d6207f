"""Plain PyTorch version of the trial-grid stream kernel.

`sched_stream_batch_ref` computes what ``csrc/sched_stream.cu`` computes,
vectorised over the T streams with a Python loop over windows and
requests, in the kernel body's order of operations: the window-start
plan (all-pairs ranks of the server probabilities and, for mlml/nltr, of
the window's request lengths, plus nLTR's section bounds), then per
request the selection, the redirect guard, the Eq. (1)-(3) one-hot
updates, the latency and the EWMA/est feedback, then at window close the
`lane_sum` renormalisation, the drain and the window-load snapshot, and
at the end the fused metrics row.  It mirrors the JAX package's
``kernels/sched_select/ref.py`` and its Pallas kernel body.

The CPU tests hold it against the JAX package; on the card it is what the
kernel is held against, bit for bit on decisions, latencies, loads,
window loads and metrics.
"""

from __future__ import annotations

import torch

from repro_torch.core.policy_core import (BIG, F32, MET_PAD, N_METRICS, f32,
                                          lane_sum, lcg_mod, lcg_step,
                                          permute_from_sorted,
                                          permute_to_sorted, rank_desc,
                                          recursive_average_bounds,
                                          stream_metrics, window_decrements)

SORT_POLICIES = ("mlml", "nltr")
PLAN_POLICIES = ("trh", "mlml", "nltr")


def _pick(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rows[t, idx[t]] as a (T, 1) column."""
    return torch.gather(rows, 1, idx[:, None])


def sched_stream_batch_ref(object_ids: torch.Tensor, lengths: torch.Tensor,
                           valid: torch.Tensor, tables: torch.Tensor,
                           seeds: torch.Tensor, win_rates: torch.Tensor, *,
                           n_servers: int, window_size: int, threshold: float,
                           lam: float, alpha: float = 0.25,
                           window_dt: float = 0.0, policy: str = "ect",
                           observe: bool = True, renorm: bool = True,
                           nltr_n: int = 2, probe_choices: int = 2):
    """Same operands and outputs as `kernel.sched_stream_call`, on any
    device: object_ids/lengths/valid (T, N), tables (T, 4, M_pad), seeds
    (T,) uint32 states in any integer dtype, win_rates (T, W, M_pad).
    Returns (choices (T, N) int32, latencies (T, N), final_tables
    (T, 4, M_pad), window_loads (T, W, M_pad), metrics (T, MET_PAD))."""
    m = n_servers
    t, n = object_ids.shape
    m_pad = tables.shape[-1]
    n_win = win_rates.shape[1]
    ws = window_size
    if n != n_win * ws:
        raise ValueError(f"N={n} is not W*window_size={n_win}*{ws}")
    dev = object_ids.device
    lengths = lengths.to(F32)
    valid_b = valid != 0
    tables = tables.to(F32)
    win_rates = win_rates.to(F32)
    lane = torch.arange(m_pad, device=dev)
    lv = (lane < m)[None, :]                       # (1, M_pad)
    lv_t = lv.expand(t, m_pad)
    lane_t = lane[None, :].expand(t, m_pad)
    tidx = torch.arange(t, device=dev)
    zero, one, big = f32(0.0, lengths), f32(1.0, lengths), f32(BIG, lengths)
    lam_t, m_minus_1 = f32(lam, lengths), f32(m - 1, lengths)
    thr = f32(threshold, lengths)
    a_old, a_new = f32(1 - alpha, lengths), f32(alpha, lengths)
    eps6, eps9 = f32(1e-6, lengths), f32(1e-9, lengths)

    loads = torch.where(lv, tables[:, 0], big)
    probs = torch.where(lv, tables[:, 1], zero)
    ewma = torch.where(lv, tables[:, 2], zero)
    est = torch.where(lv, tables[:, 3], one)
    rng = seeds.to(torch.int64) & 0xFFFFFFFF
    win_dec = window_decrements(win_rates, window_dt)
    sort_policy = policy in SORT_POLICIES
    n_sections = 2 ** nltr_n
    sec_size = max(m // n_sections, 1)

    choices = torch.zeros((t, n), dtype=torch.int32, device=dev)
    lats = torch.zeros((t, n), dtype=F32, device=dev)
    wloads = torch.zeros((t, n_win, m_pad), dtype=F32, device=dev)

    for w in range(n_win):
        cur_rates = torch.where(lv, win_rates[:, w], one)
        start = w * ws
        obj_w = object_ids[:, start:start + ws].to(torch.int64)
        len_w = lengths[:, start:start + ws]
        val_w = valid_b[:, start:start + ws]
        if policy in PLAN_POLICIES:
            rank_srv, _ = rank_desc(probs, valid=lv_t)
            (order_srv,) = permute_to_sorted(rank_srv, (lane_t,))
        if sort_policy:
            rank_req, mkeys = rank_desc(len_w, valid=val_w)
            obj_p, len_p, val_p = permute_to_sorted(rank_req,
                                                    (obj_w, len_w, val_w))
            if policy == "nltr":
                nvalid = val_w.sum(dim=-1, keepdim=True)
                (skeys,) = permute_to_sorted(rank_req, (mkeys,))
                bounds = recursive_average_bounds(skeys, nvalid, nltr_n)
        else:
            obj_p, len_p, val_p = obj_w, len_w, val_w
        ch_acc = torch.zeros((t, ws), dtype=torch.int64, device=dev)
        lat_acc = torch.zeros((t, ws), dtype=F32, device=dev)

        for j in range(ws):
            obj = obj_p[:, j]
            ln = len_p[:, j:j + 1]
            v = val_p[:, j:j + 1]
            default = obj % m

            # -- target selection ------------------------------------------
            if policy == "rr":
                target = default
            elif policy == "minload":
                target = torch.argmin(loads, dim=-1)
            elif policy == "ect":
                target = torch.argmin((loads + ln) / est, dim=-1)
            elif policy == "mlml":
                target = order_srv[:, j % m]
            elif policy == "nltr":
                sec = (j >= bounds).sum(dim=-1).clamp(0, n_sections - 1)
                lo = sec * sec_size
                r1 = lcg_step(rng)
                r2 = lcg_step(r1)
                rng = r2
                c1 = order_srv[tidx, lo + lcg_mod(r1, sec_size)]
                c2 = order_srv[tidx, lo + lcg_mod(r2, sec_size)]
                target = torch.where(loads[tidx, c1] <= loads[tidx, c2],
                                     c1, c2)
            elif policy == "two_choice":
                target = default
                best = loads[tidx, default]
                for _ in range(probe_choices - 1):
                    rng = lcg_step(rng)
                    c = lcg_mod(rng, m)
                    l_c = loads[tidx, c]
                    better = l_c < best
                    target = torch.where(better, c, target)
                    best = torch.where(better, l_c, best)
            elif policy in ("two_random", "trh"):
                r1 = lcg_step(rng)
                r2 = lcg_step(r1)
                rng = r2
                if policy == "two_random":
                    c1, c2 = lcg_mod(r1, m), lcg_mod(r2, m)
                else:
                    half = max(m // 2, 1)
                    c1 = order_srv[tidx, lcg_mod(r1, half)]
                    c2 = order_srv[tidx, lcg_mod(r2, half)]
                target = torch.where(loads[tidx, c1] <= loads[tidx, c2],
                                     c1, c2)
            else:
                raise ValueError(f"unknown kernel policy {policy!r}")

            # -- redirect-threshold guard (rr has none) --------------------
            if policy == "rr":
                choose = default
            else:
                l_def = _pick(loads, default)
                l_tgt = _pick(loads, target)
                if policy == "ect":
                    benefit = ((l_def + ln) / _pick(est, default)
                               - (l_tgt + ln) / _pick(est, target))
                else:
                    benefit = l_def - l_tgt
                choose = torch.where(benefit[:, 0] > thr, target, default)

            # -- Eq. (1)-(3) one-hot updates --------------------------------
            onehot = lane[None, :] == choose[:, None]
            upd = onehot & v
            new_loads = torch.where(upd, loads + ln, loads)
            loads = new_loads
            p_i = _pick(probs, choose)
            l_i = _pick(new_loads, choose)
            e = torch.exp(-l_i / lam_t)
            decayed = p_i * e
            delta = p_i * (one - e) / m_minus_1
            new_probs = torch.where(onehot, decayed,
                                    torch.where(lv, probs + delta, zero))
            probs = torch.where(v, new_probs, probs)

            # -- latency + completion feedback ------------------------------
            lat = l_i / torch.maximum(_pick(cur_rates, choose), eps6)
            latv = torch.where(v, lat, zero)
            if observe:
                mbps = ln / torch.maximum(lat, eps9)
                old = _pick(ewma, choose)
                new = torch.where(old == 0.0, mbps,
                                  a_old * old + a_new * mbps)
                ewma = torch.where(upd, new, ewma)
                dflt = torch.maximum(ewma.amax(dim=-1, keepdim=True), one)
                est = torch.where(ewma > 0, ewma, dflt)
            ch_acc[:, j] = choose
            lat_acc[:, j] = latv[:, 0]

        if sort_policy:
            ch_acc, lat_acc = permute_from_sorted(rank_req, (ch_acc, lat_acc))
        choices[:, start:start + ws] = ch_acc.to(torch.int32)
        lats[:, start:start + ws] = lat_acc

        # -- window close: renormalise, drain, snapshot ----------------------
        if renorm:
            p = torch.clamp_min(probs, 0.0)
            probs = p / lane_sum(p)
        if window_dt:
            dec = torch.where(lv, win_dec[:, w], zero)
            drained = torch.clamp_min(loads - dec, 0.0)
            loads = torch.where(lv, drained, big)
        wloads[:, w] = torch.where(lv, loads, zero)

    final = torch.stack([torch.where(lv, row, zero)
                         for row in (loads, probs, ewma, est)], dim=1)
    metrics = torch.zeros((t, MET_PAD), dtype=F32, device=dev)
    metrics[:, :N_METRICS] = stream_metrics(lats, valid_b, window_dt, ws)
    return choices, lats, final, wloads, metrics
