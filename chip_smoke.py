"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

From the root of a checkout, with one CUDA card visible.  It

1. prints the card's name and power limit and the torch/CUDA versions;
2. builds the CUDA kernels with nvcc (one source, one build) and prints
   the ``-Xptxas -v`` register / shared-memory / spill lines;
3. holds each kernel against its plain PyTorch version on the card:
   the stream kernel in its 1-D form for all eight policies at M in
   {37, 130, 300}, with a padded final window and T not a multiple of
   the warps per block; its 2-D (trials x clients) form and the
   cross-client merge for all eight policies at M in {37, 130}, with C
   not a multiple of the client tile, whole phantom clients, a padded
   last window and the merge as mean and as raw sum; and the legacy
   single-window `sched_select` wrapper;
4. drives the two main paths, each with the launch counts set to 0 just
   before and read just after: the paper's §4 Monte-Carlo sweep
   (`repro_torch.core.simulate.run_trials`, 100 servers, 2,000 requests,
   100 trials, window 100, mixed workload, transient stragglers) with one
   shared log, and the same sweep per_client (200 clients, window 10
   after the clamp), each for the six engine policies; every
   `TrialResult` field is held against the same prep scheduled by the
   plain versions on the card;
5. times each kernel (CUDA events), its plain version and one whole
   `run_trials` for ``ect``: shared log, and per_client at 200 and at 64
   clients;
6. prints the ``kernels`` JSON line, then, last, the device JSON line.

Any failure ends the run with a non-zero exit and no result line.  It
never runs on the CPU: without a card it exits before printing results.
"""

import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import policy_core, simulate  # noqa: E402
from repro_torch.core.engine import KERNEL_POLICIES  # noqa: E402
from repro_torch.core.policies import PolicyConfig  # noqa: E402
from repro_torch.kernels.sched_select import _build  # noqa: E402
from repro_torch.kernels.sched_select import kernel as skernel  # noqa: E402
from repro_torch.kernels.sched_select import ops as sops  # noqa: E402
from repro_torch.kernels.sched_select import ref as sref  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet), used for the bounds
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

BODY_POLICIES = tuple(skernel.POLICY_CODES)
# (T, M, W, window): T below / not a multiple of the 4 warps per block
CHECK_SHAPES = ((5, 37, 4, 32), (7, 130, 3, 50), (6, 300, 3, 40))
# (T, C, M, W, window, client_tile, phantom clients): C not a multiple of
# the client tile, whole phantom clients
GRID_SHAPES = ((3, 7, 37, 3, 16, 2, 2), (5, 40, 130, 2, 10, 32, 3))
KW = dict(threshold=2.0, lam=50.0, window_dt=0.02, observe=True,
          renorm=True)
REPS = 20
PER_CLIENT_NOTE = "per_client window clamp"


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def max_abs(got, want) -> float:
    return max((a.double() - b.double()).abs().max().item()
               for a, b in zip(got, want) if a.numel())


def stream_fields_ok(got, want):
    """(contract fields bit-exact, probs err, ewma/est relative err) of
    the five per-stream outputs, any leading shape."""
    ch, lat, tab, wl, met = got
    rch, rlat, rtab, rwl, rmet = want
    exact = (torch.equal(ch, rch) and torch.equal(lat, rlat)
             and torch.equal(tab[..., 0, :], rtab[..., 0, :])
             and torch.equal(wl, rwl) and torch.equal(met, rmet))
    d_probs = (tab[..., 1, :] - rtab[..., 1, :]).abs().max().item()
    rel = ((tab[..., 2:, :] - rtab[..., 2:, :]).abs()
           / rtab[..., 2:, :].abs().clamp_min(1.0)).max().item()
    return exact, d_probs, rel


def timed_ms(fn, reps=REPS) -> float:
    """Mean ms per call of ``fn`` by CUDA events, after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def once_ms(fn) -> float:
    """ms of one call of ``fn`` by CUDA events (the slow plain versions)."""
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def bound(bytes_moved: float, ops: float):
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations")


# -- kernels against their plain versions ------------------------------------


def check_case(t, m, n_win, win, policy, seed, dev):
    """1-D kernel against plain version on the card for one case; returns
    the largest absolute difference over all outputs."""
    rng = np.random.default_rng(seed)
    n = n_win * win
    valid = rng.random((t, n)) > 0.2
    valid[:, n - win // 3:] = False                # padded final window
    args = (torch.from_numpy(rng.integers(0, 8 * m, (t, n)).astype(
                np.int32)).to(dev),
            torch.from_numpy(rng.uniform(1.0, 20.0, (t, n)).astype(
                np.float32)).to(dev),
            torch.from_numpy(valid).to(dev),
            policy_core.init_table(m, batch=t, device=dev),
            torch.from_numpy(rng.integers(0, 2 ** 32, (t,))).to(dev),
            torch.from_numpy(rng.uniform(50.0, 300.0, (t, n_win, m)).astype(
                np.float32)).to(dev))
    kw = dict(KW, n_servers=m, window_size=win, policy=policy)
    got = sops.sched_stream_batch(*args, **kw)
    torch.cuda.synchronize()
    want = sops.sched_stream_batch_plain(*args, **kw)
    torch.cuda.synchronize()
    exact, d_probs, rel = stream_fields_ok(got, want)
    ok = exact and d_probs <= 1e-6 and rel <= 1e-6
    print(f"check {policy:>10s} T={t} M={m} W={n_win} win={win}: "
          f"contract fields {'bit-exact' if exact else 'DIFFER'}, "
          f"probs err {d_probs:.3g}, ewma/est rel err {rel:.3g} "
          f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"kernel disagrees with its plain version ({policy}, M={m})")
    return max_abs(got, want)


def check_grid_case(shape, policy, merge_mean, seed, dev):
    """2-D kernels against the plain version on the card for one case;
    returns the largest absolute differences (per-stream, merged)."""
    t, c, m, n_win, win, ct, n_phantom = shape
    rng = np.random.default_rng(seed)
    n = n_win * win
    valid = rng.random((t, c, n)) > 0.2
    valid[..., n - win // 3:] = False              # padded last window
    valid[:, c - n_phantom:] = False               # whole phantom clients
    tables = policy_core.init_table(m, batch=t * c, device=dev).reshape(
        t, c, 4, m)
    tables[:, :, 0] = torch.from_numpy(
        rng.uniform(0.0, 60.0, (t, c, m)).astype(np.float32)).to(dev)
    args = (torch.from_numpy(rng.integers(0, 8 * m, (t, c, n)).astype(
                np.int32)).to(dev),
            torch.from_numpy(rng.uniform(1.0, 20.0, (t, c, n)).astype(
                np.float32)).to(dev),
            torch.from_numpy(valid).to(dev), tables,
            torch.from_numpy(rng.integers(0, 2 ** 32, (t, c))).to(dev),
            torch.from_numpy(rng.uniform(50.0, 300.0, (t, n_win, m)).astype(
                np.float32)).to(dev))
    kw = dict(KW, n_servers=m, window_size=win, policy=policy,
              client_tile=ct, merge_mean=merge_mean)
    got = sops.sched_stream_grid(*args, **kw)
    torch.cuda.synchronize()
    want = sops.sched_stream_grid_plain(*args, **kw)
    torch.cuda.synchronize()
    exact, d_probs, rel = stream_fields_ok(got[:5], want[:5])
    merged_exact = all(torch.equal(a, b) for a, b in zip(got[5:], want[5:]))
    real = int(got[6][0, policy_core.MET_N_CLIENTS].item())
    ok = (exact and merged_exact and d_probs <= 1e-6 and rel <= 1e-6
          and real == c - n_phantom)
    print(f"grid  {policy:>10s} T={t} C={c} M={m} W={n_win} win={win} "
          f"ct={ct} mean={merge_mean}: per-stream "
          f"{'bit-exact' if exact else 'DIFFER'}, merge "
          f"{'bit-exact' if merged_exact else 'DIFFER'} ({real} real "
          f"clients), probs err {d_probs:.3g}, ewma/est rel err {rel:.3g} "
          f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"2-D kernels disagree with their plain version ({policy}, "
             f"M={m}, merge_mean={merge_mean})")
    return max_abs(got[:5], want[:5]), max_abs(got[5:], want[5:])


def check_select(dev):
    """The legacy single-window wrapper against its plain version."""
    rng = np.random.default_rng(9)
    c, n, m = 8, 500, 37
    args = [torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, 8 * m, (c, n)).astype(np.int32),
        rng.uniform(1.0, 20.0, (c, n)).astype(np.float32),
        rng.uniform(0.0, 60.0, (c, m)).astype(np.float32),
        rng.integers(0, 2 ** 32, (c,)))]
    for policy in sops.STATIC_POLICIES:
        kw = dict(n_servers=m, threshold=2.0, lam=50.0, policy=policy)
        got = sops.sched_select(*args, **kw)
        torch.cuda.synchronize()
        want = sops.sched_select_plain(*args, **kw)
        ok = all(torch.equal(a, b) for a, b in zip(got, want))
        print(f"select {policy:>10s} C={c} N={n} M={m}: "
              f"{'bit-exact' if ok else 'DIFFER'}")
        if not ok:
            fail(f"sched_select disagrees with its plain version ({policy})")


# -- the main paths -----------------------------------------------------------


def run_main_path(name, cfg, log, pols, dev, expect):
    """Drive `run_trials` for every policy with the launch counts zeroed
    just before and read just after; each run must launch exactly the
    kernels of ``expect`` once.  Returns (results, launch counts)."""
    results = {}
    for k in skernel.LAUNCHES:
        skernel.LAUNCHES[k] = 0
    for p, pol in pols.items():
        before = dict(skernel.LAUNCHES)
        results[p] = simulate.run_trials(0, cfg, pol, log)
        step = {k: skernel.LAUNCHES[k] - before[k] for k in before}
        if step != {k: int(k in expect) for k in before}:
            fail(f"{name} run_trials({p}) launched {step}, expected one "
                 f"launch of each of {expect}")
    torch.cuda.synchronize()
    counts = dict(skernel.LAUNCHES)
    if counts != {k: len(pols) * int(k in expect) for k in counts}:
        fail(f"{name} main path launched {counts}")
    print(f"{name} main path: launches {counts}")

    t, r, m = cfg.n_trials, cfg.n_requests, cfg.n_servers
    _, per, _, win = simulate._client_split_shape(cfg)
    n_win = -(-per // win) if cfg.client_model == "per_client" \
        else cfg.n_windows
    for p, res in results.items():
        if res.chosen.shape != (t, r) or res.window_loads.shape != (
                t, n_win, m):
            fail(f"{name} {p}: unexpected result shapes")
        if not (torch.isfinite(res.latencies).all()
                and torch.isfinite(res.server_loads).all()
                and torch.isfinite(res.phase_time).all()
                and torch.isfinite(res.window_loads).all()):
            fail(f"{name} {p}: non-finite values in the result")
        if not bool((res.n_assigned.sum(dim=-1) == r).all()):
            fail(f"{name} {p}: n_assigned does not count every request")
    return results, counts


def prep(cfg, log, dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    return simulate._prep_trials(gen, cfg, log, dev)


def recording(fn, store):
    """``fn`` that also keeps its positional/keyword arguments and outputs."""
    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        store.update(args=args, kw=kw, out=out)
        return out
    return wrapped


def check_shared_log(results, cfg, log, pols, dev):
    for p, res in results.items():
        init, mask, works, states, traces, seeds = prep(cfg, log, dev)
        sched = simulate._sched_trials(
            cfg, pols[p], log, works, states, seeds, traces,
            stream_batch=sops.sched_stream_batch_plain)
        plain = simulate._post_trials(cfg, init, mask, works, traces, *sched)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(res, plain)):
            bad = [f for f, a, b in zip(res._fields, res, plain)
                   if not torch.equal(a, b)]
            fail(f"{p}: kernel run differs from the plain version in {bad}")
        p99 = policy_core.nearest_rank_p99(
            res.latencies, torch.ones_like(res.latencies, dtype=torch.bool))
        print(f"shared_log {p:>10s}: mean p99 latency "
              f"{p99.mean().item():.4f} s, mean makespan "
              f"{res.phase_time.mean().item():.4f} s, bit-exact with the "
              "plain version on the card")


def check_per_client(results, cfg, log, pols, dev):
    """Every TrialResult field against the plain versions on the same
    prep, and the 2-D kernels' nine outputs against the plain version's at
    the main path's shapes.  Returns the largest absolute differences
    (per-stream, merged)."""
    err_streams = err_merge = 0.0
    for p, res in results.items():
        init, mask, works, states, traces, seeds = prep(cfg, log, dev)
        kern, plain_rec = {}, {}
        simulate._sched_trials(
            cfg, pols[p], log, works, states, seeds, traces,
            stream_grid=recording(sops.sched_stream_grid, kern))
        sched = simulate._sched_trials(
            cfg, pols[p], log, works, states, seeds, traces,
            stream_grid=recording(sops.sched_stream_grid_plain, plain_rec))
        plain = simulate._post_trials(cfg, init, mask, works, traces, *sched)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(res, plain)):
            bad = [f for f, a, b in zip(res._fields, res, plain)
                   if not torch.equal(a, b)]
            fail(f"per_client {p}: kernel run differs from the plain "
                 f"version in {bad}")
        got, want = kern["out"], plain_rec["out"]
        exact, d_probs, rel = stream_fields_ok(got[:5], want[:5])
        merged_exact = all(torch.equal(a, b)
                           for a, b in zip(got[5:], want[5:]))
        if not (exact and merged_exact and d_probs <= 1e-6 and rel <= 1e-6):
            fail(f"per_client {p}: 2-D kernels differ from the plain "
                 f"version at the main path's shapes")
        err_streams = max(err_streams, max_abs(got[:5], want[:5]))
        err_merge = max(err_merge, max_abs(got[5:], want[5:]))
        cm = got[6]
        print(f"per_client {p:>10s}: mean merged p99 latency "
              f"{cm[:, policy_core.MET_P99].mean().item():.4f} s, mean "
              f"makespan {res.phase_time.mean().item():.4f} s, "
              f"{cm[:, policy_core.MET_N_CLIENTS].min().item():.0f} real "
              "clients per trial, bit-exact with the plain version on the "
              "card")
    return err_streams, err_merge


# -- timing -------------------------------------------------------------------


def stage_split(cfg, log, pol, dev):
    """(run_trials wall ms, [prep, sched, post] ms), each stage ended by a
    synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    simulate.run_trials(0, cfg, pol, log)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    marks = [time.perf_counter()]
    init, mask, works, states, traces, seeds = prep(cfg, log, dev)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    sched = simulate._sched_trials(cfg, pol, log, works, states, seeds,
                                   traces)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    simulate._post_trials(cfg, init, mask, works, traces, *sched)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    return wall_ms, [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]


def time_shared_log(cfg, log, pol, dev, card):
    captured = {}
    init, mask, works, states, traces, seeds = prep(cfg, log, dev)
    simulate._sched_trials(cfg, pol, log, works, states, seeds, traces,
                           stream_batch=recording(sops.sched_stream_batch,
                                                  captured))
    kargs = sops.pad_operands(*captured["args"])
    kkw = captured["kw"]
    kernel_ms = timed_ms(lambda: skernel.sched_stream_call(*kargs, **kkw))
    plain_ms = once_ms(lambda: sref.sched_stream_batch_ref(*kargs, **kkw))
    wall_ms, stage_ms = stage_split(cfg, log, pol, dev)

    # least time for the same work, over the n_servers real lanes (the
    # padding to 128 lanes is the kernel's choice, not the function's):
    # bytes in and out once over HBM — int32/f32/int32 request blocks,
    # (T, 4, M) tables, (T, W, M) rates, seeds; choices, latencies, tables,
    # window loads, metrics — and the float32 operations of ect (per
    # request: score add+div, argmin compare, probs add, est max+select on
    # every lane; per window: renorm and drain; per stream: 48 bisection
    # passes over N latencies)
    t_, n_ = kargs[0].shape
    m_, n_win = cfg.n_servers, kargs[5].shape[1]
    bytes_moved = 4 * (3 * t_ * n_ + t_ * 4 * m_ + t_ * n_win * m_ + t_
                       + 2 * t_ * n_ + t_ * 4 * m_ + t_ * n_win * m_
                       + t_ * policy_core.N_METRICS)
    ops = t_ * (n_ * 6 * m_ + n_win * 5 * m_ + 48 * n_ * 2)
    bound_ms, bound_by = bound(bytes_moved, ops)
    reqs = cfg.n_trials * cfg.n_requests
    print(f"timing shared_log ect, T={t_} N={n_} M={m_} on {card}:")
    print(f"  kernel  {kernel_ms:.4f} ms/launch ({reqs / kernel_ms * 1e3:.0f}"
          " requests/s)")
    print(f"  plain   {plain_ms:.2f} ms")
    print(f"  run_trials wall {wall_ms:.2f} ms "
          f"({reqs / wall_ms * 1e3:.0f} requests/s)")
    print(f"  stages  prep {stage_ms[0]:.2f} ms, sched {stage_ms[1]:.2f} ms"
          f" (stream kernel {kernel_ms:.4f} ms of it), post "
          f"{stage_ms[2]:.2f} ms; share of the run_trials wall outside the "
          f"stream kernel {1 - kernel_ms / wall_ms:.3f}")
    print(f"  bound   {bound_ms:.5f} ms ({bound_by}: {bytes_moved} bytes, "
          f"{ops} f32 ops)")
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def time_per_client(cfg, log, pol, dev, card):
    """Each 2-D kernel by CUDA events at the main path's operands, its
    plain version, one whole run_trials and the stage split."""
    captured = {}
    init, mask, works, states, traces, seeds = prep(cfg, log, dev)
    simulate._sched_trials(cfg, pol, log, works, states, seeds, traces,
                           stream_grid=recording(sops.sched_stream_grid,
                                                 captured))
    kargs = sops.pad_operands(*captured["args"])
    kkw = dict(captured["kw"])
    merge_kw = dict(client_tile=policy_core.resolve_client_tile(
        kargs[0].shape[1], kkw.pop("client_tile")), merge_mean=True)
    streams = skernel.sched_stream_grid_streams(*kargs, **kkw)
    _, lats, _, wloads, metrics = streams
    valid = kargs[2]
    streams_ms = timed_ms(
        lambda: skernel.sched_stream_grid_streams(*kargs, **kkw))
    merge_ms = timed_ms(lambda: skernel.client_merge_call(
        metrics, wloads, lats, valid, **merge_kw))
    streams_plain_ms = once_ms(
        lambda: sref.sched_stream_grid_streams_ref(*kargs, **kkw))
    merge_plain_ms = once_ms(lambda: sref.client_merge_ref(
        metrics, wloads, lats, valid, **merge_kw))
    wall_ms, stage_ms = stage_split(cfg, log, pol, dev)

    # least time for the same work, over the real servers and the real
    # clients (those with a valid step; padding lanes and phantom clients
    # are not the function's work).  Stream kernel: per real stream, its
    # request blocks, table in and out, seeds, choices, latencies, window
    # loads and metric row, plus each trial's rate rows once; ect's f32
    # operations as in the shared-log bound.  Merge: per real client, its
    # window loads, metric row, latencies and validity read and the
    # masked latency block written, plus per trial the merged loads and
    # row; operations: one add per window-load element, and the 48
    # bisection passes (compare + count) over the merged block.
    t_, c_, n_ = kargs[0].shape
    m_, n_win = cfg.n_servers, kargs[5].shape[1]
    real = int((metrics[..., policy_core.MET_N_VALID] > 0).sum().item())
    s_bytes = 4 * (real * (3 * n_ + 4 * m_ + 1 + 2 * n_ + 4 * m_
                           + n_win * m_ + policy_core.N_METRICS)
                   + t_ * n_win * m_)
    s_ops = real * (n_ * 6 * m_ + n_win * 5 * m_ + 48 * n_ * 2)
    m_bytes = 4 * (real * (n_win * m_ + policy_core.N_METRICS + 2 * n_
                           + 2 * n_)
                   + t_ * (n_win * m_ + policy_core.N_CMETRICS))
    m_ops = real * (n_win * m_ + 48 * n_ * 2)
    s_bound, s_by = bound(s_bytes, s_ops)
    m_bound, m_by = bound(m_bytes, m_ops)
    kernels_ms = streams_ms + merge_ms
    print(f"timing per_client ect, T={t_} C={c_} ({real // t_} real per "
          f"trial) N={n_} M={m_} on {card}:")
    print(f"  stream kernel (2-D)  {streams_ms:.4f} ms/launch, plain "
          f"{streams_plain_ms:.2f} ms, bound {s_bound:.5f} ms ({s_by}: "
          f"{s_bytes} bytes, {s_ops} f32 ops)")
    print(f"  client_merge         {merge_ms:.4f} ms/launch, plain "
          f"{merge_plain_ms:.2f} ms, bound {m_bound:.5f} ms ({m_by}: "
          f"{m_bytes} bytes, {m_ops} f32 ops)")
    reqs = cfg.n_trials * cfg.n_requests
    print(f"  run_trials wall {wall_ms:.2f} ms "
          f"({reqs / wall_ms * 1e3:.0f} requests/s)")
    print(f"  stages  prep {stage_ms[0]:.2f} ms, sched {stage_ms[1]:.2f} ms"
          f" (the two kernels {kernels_ms:.4f} ms of it), post "
          f"{stage_ms[2]:.2f} ms; share of the run_trials wall outside the "
          f"two kernels {1 - kernels_ms / wall_ms:.3f}")
    return (dict(ms=streams_ms, plain_ms=streams_plain_ms, bound_ms=s_bound,
                 bound_by=s_by),
            dict(ms=merge_ms, plain_ms=merge_plain_ms, bound_ms=m_bound,
                 bound_by=m_by))


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a card")
    dev = torch.device("cuda")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    warnings.filterwarnings("ignore", message=PER_CLIENT_NOTE)

    t0 = time.perf_counter()
    _build.build(skernel.SOURCE)
    print(f"built {skernel.SOURCE} in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log(skernel.SOURCE).splitlines():
        if "registers" in line or "spill" in line or "smem" in line \
                or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    # -- kernels against their plain versions ------------------------------
    err_1d = 0.0
    for i, (t, m, n_win, win) in enumerate(CHECK_SHAPES):
        for j, policy in enumerate(BODY_POLICIES):
            err_1d = max(err_1d, check_case(t, m, n_win, win, policy,
                                            100 * i + j, dev))
    err_grid = err_merge = 0.0
    for i, shape in enumerate(GRID_SHAPES):
        for j, policy in enumerate(BODY_POLICIES):
            for merge_mean in (True, False):
                e_s, e_m = check_grid_case(shape, policy, merge_mean,
                                           1000 + 100 * i + j, dev)
                err_grid, err_merge = max(err_grid, e_s), max(err_merge, e_m)
    check_select(dev)

    # -- the main paths at the paper's §4 size -----------------------------
    pols = {p: PolicyConfig(name=p, threshold=0.05 if p == "ect" else 5.0)
            for p in KERNEL_POLICIES}
    cfg = simulate.SimConfig(scenario=simulate.ScenarioConfig("transient"))
    log = simulate.default_log_cfg(cfg)
    results, shared_counts = run_main_path(
        "shared_log", cfg, log, pols, dev, ("sched_stream",))
    check_shared_log(results, cfg, log, pols, dev)

    pc_cfg = simulate.SimConfig(
        client_model="per_client",
        scenario=simulate.ScenarioConfig("transient"))
    pc_log = simulate.default_log_cfg(pc_cfg)
    c, per, _, win = simulate._client_split_shape(pc_cfg)
    print(f"per_client: {c} clients of {per} requests, window "
          f"{pc_cfg.window_size} clamped to {win}")
    results, pc_counts = run_main_path(
        "per_client", pc_cfg, pc_log, pols, dev,
        ("sched_stream_grid", "client_merge"))
    e_s, e_m = check_per_client(results, pc_cfg, pc_log, pols, dev)
    err_grid, err_merge = max(err_grid, e_s), max(err_merge, e_m)
    del results

    # -- timing, ect ---------------------------------------------------------
    t_1d = time_shared_log(cfg, log, pols["ect"], dev, card)
    t_grid, t_merge = time_per_client(pc_cfg, pc_log, pols["ect"], dev, card)
    # the JAX benchmark's own short-stream instance: 64 clients of 32
    # requests (benchmarks/sched_perf.py, per_client_phase_breakdown)
    c64 = simulate.SimConfig(client_model="per_client", n_clients=64,
                             scenario=simulate.ScenarioConfig("transient"))
    time_per_client(c64, simulate.default_log_cfg(c64), pols["ect"], dev,
                    card)

    src = "src/repro_torch/kernels/sched_select/csrc/sched_stream.cu"
    ref = "src/repro/kernels/sched_select/kernel.py"
    print(json.dumps({"kernels": [
        dict(name="sched_stream", route="cuda", source=src,
             replaces=f"{ref}:130", launches=shared_counts["sched_stream"],
             max_abs_err=err_1d, library_ms=None, **t_1d),
        dict(name="sched_stream_grid", route="cuda", source=src,
             replaces=f"{ref}:177",
             launches=pc_counts["sched_stream_grid"], max_abs_err=err_grid,
             library_ms=None, **t_grid),
        dict(name="client_merge", route="cuda", source=src,
             replaces=f"{ref}:558", launches=pc_counts["client_merge"],
             max_abs_err=err_merge, library_ms=None, **t_merge)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
