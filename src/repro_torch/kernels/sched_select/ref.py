"""Plain PyTorch versions of the stream kernels.

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

``ablate`` drops the same trailing phases as the kernel's ablate levels
(1 no fused metrics, 2 also no per-request step loop, 3 also no
window-start plan), with the same zeros past the dropped phase.

`sched_stream_grid_ref` is the 2-D (trials x clients) form: the same
per-stream function over the T·C streams, each reading its trial's rates,
then `client_merge_ref`, the plain version of the ``client_merge`` kernel
(the `policy_core` merge twins over the per-client outputs).

The CPU tests hold them against the JAX package; on the card they are what
the kernels are held against, bit for bit on decisions, latencies, loads,
window loads, metrics and the merged outputs.
"""

from __future__ import annotations

import torch

from repro_torch.core.policy_core import (BIG, F32, MET_N_VALID, MET_PAD,
                                          N_CMETRICS, N_METRICS,
                                          client_stream_metrics, f32,
                                          lane_sum, lcg_mod, lcg_step,
                                          masked_client_mean,
                                          masked_client_sum,
                                          permute_from_sorted,
                                          permute_to_sorted, rank_desc,
                                          recursive_average_bounds,
                                          stream_metrics, window_decrements)
from repro_torch.kernels.sched_select.kernel import ABLATE_LEVELS

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
                           nltr_n: int = 2, probe_choices: int = 2,
                           trial_tile=None, ablate: int = 0):
    """Same operands and outputs as `kernel.sched_stream_call`, on any
    device: object_ids/lengths/valid (T, N), tables (T, 4, M_pad), seeds
    (T,) uint32 states in any integer dtype, win_rates (T, W, M_pad).
    ``trial_tile`` is the kernel's launch shape and changes nothing here;
    ``ablate`` as the kernel's levels: past the dropped phase the metric
    row (level >= 1) and the choices and latencies (level >= 2) are zeros,
    and without the step loop the tables only renormalise and drain.
    Returns (choices (T, N) int32, latencies (T, N), final_tables
    (T, 4, M_pad), window_loads (T, W, M_pad), metrics (T, MET_PAD))."""
    if ablate not in ABLATE_LEVELS:
        raise ValueError(f"ablate={ablate!r} must be one of {ABLATE_LEVELS}")
    do_metrics, do_steps, do_plan = ablate < 1, ablate < 2, ablate < 3
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
        if policy in PLAN_POLICIES and do_plan:
            rank_srv, _ = rank_desc(probs, valid=lv_t)
            (order_srv,) = permute_to_sorted(rank_srv, (lane_t,))
        if sort_policy and do_plan:
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

        for j in range(ws if do_steps else 0):
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
                                  # contract-ok: CC-FMA EWMA row is 1e-6-soft (§9)
                                  a_old * old + a_new * mbps)
                ewma = torch.where(upd, new, ewma)
                dflt = torch.maximum(ewma.amax(dim=-1, keepdim=True), one)
                est = torch.where(ewma > 0, ewma, dflt)
            ch_acc[:, j] = choose
            lat_acc[:, j] = latv[:, 0]

        if sort_policy and do_steps:
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
    if do_metrics:
        metrics[:, :N_METRICS] = stream_metrics(lats, valid_b, window_dt, ws)
    return choices, lats, final, wloads, metrics


def client_merge_ref(metrics: torch.Tensor, wloads: torch.Tensor,
                     lats: torch.Tensor, valid: torch.Tensor, *,
                     client_tile: int, merge_mean: bool = True):
    """Same operands and outputs as `kernel.client_merge_call`: the
    per-trial cross-client merge of metrics (T, C, MET_PAD), wloads
    (T, C, W, M_pad), lats and valid (T, C, N).  A client is real iff its
    n_valid lane is positive."""
    validb = valid != 0
    cvalid = (metrics[..., MET_N_VALID] > 0).T               # (C, T)
    cm_lats = torch.where(validb, lats, f32(0.0, lats))
    cm_lval = validb.to(F32)
    per_client = lambda x: x.movedim(1, 0)  # noqa: E731
    if merge_mean:
        cm_wl = masked_client_mean(per_client(wloads), cvalid, client_tile)
        row = client_stream_metrics(
            per_client(metrics), cvalid, client_tile,
            merged_lats=per_client(cm_lats), merged_valid=per_client(validb))
    else:
        cm_wl = masked_client_sum(per_client(wloads), cvalid, client_tile)
        row = client_stream_metrics(per_client(metrics), cvalid, client_tile)
    cm_met = torch.zeros((lats.shape[0], MET_PAD), dtype=F32,
                         device=lats.device)
    cm_met[:, :N_CMETRICS] = row
    return cm_wl, cm_met, cm_lats, cm_lval


def sched_stream_grid_streams_ref(object_ids: torch.Tensor,
                                  lengths: torch.Tensor, valid: torch.Tensor,
                                  tables: torch.Tensor, seeds: torch.Tensor,
                                  win_rates: torch.Tensor, **kw):
    """Same operands and outputs as `kernel.sched_stream_grid_streams`:
    `sched_stream_batch_ref` over the T·C streams of object_ids/lengths/
    valid (T, C, N), tables (T, C, 4, M_pad) and seeds (T, C), each
    reading its trial's row of win_rates (T, W, M_pad).  Returns the five
    per-stream outputs with leading (T, C)."""
    t, c = object_ids.shape[:2]
    flat = lambda x: x.reshape((t * c,) + x.shape[2:])  # noqa: E731
    rates = win_rates[:, None].expand((t, c) + win_rates.shape[1:])
    out = sched_stream_batch_ref(flat(object_ids), flat(lengths),
                                 flat(valid), flat(tables), flat(seeds),
                                 flat(rates), **kw)
    return tuple(x.reshape((t, c) + x.shape[1:]) for x in out)


def sched_stream_grid_ref(object_ids: torch.Tensor, lengths: torch.Tensor,
                          valid: torch.Tensor, tables: torch.Tensor,
                          seeds: torch.Tensor, win_rates: torch.Tensor, *,
                          client_tile: int, merge_mean: bool = True, **kw):
    """Same operands and outputs as `kernel.sched_stream_grid_call`:
    `sched_stream_grid_streams_ref`, then `client_merge_ref` on its
    outputs."""
    per_stream = sched_stream_grid_streams_ref(
        object_ids, lengths, valid, tables, seeds, win_rates, **kw)
    _, lats, _, wloads, metrics = per_stream
    return per_stream + client_merge_ref(
        metrics, wloads, lats, valid, client_tile=client_tile,
        merge_mean=merge_mean)
