"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

From the root of a checkout, with one CUDA card visible.  It

1. prints the card's name and power limit and the torch/CUDA versions;
2. builds every CUDA kernel of the main path with nvcc and prints the
   ``-Xptxas -v`` register / shared-memory / spill lines;
3. holds each kernel against its plain PyTorch version on the card, for
   all eight policies of the stream kernel at M in {37, 130, 300}, with a
   padded final window and T not a multiple of the warps per block;
4. drives the main path — the paper's §4 Monte-Carlo sweep
   (`repro_torch.core.simulate.run_trials`, 100 servers, 2,000 requests,
   100 trials, window 100, mixed workload, transient stragglers) for the
   six engine policies — with the launch counts set to 0 just before and
   read just after, and holds every `TrialResult` field against the same
   prep scheduled by the plain version on the card;
5. times the kernel (CUDA events), the plain version and one whole
   `run_trials` for ``ect`` at that shape;
6. prints the ``kernels`` JSON line, then, last, the device JSON line.

Any failure ends the run with a non-zero exit and no result line.  It
never runs on the CPU: without a card it exits before printing results.
"""

import json
import subprocess
import sys
import time
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
from repro_torch.kernels.sched_select.ref import \
    sched_stream_batch_ref  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet), used for the bound
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

BODY_POLICIES = tuple(skernel.POLICY_CODES)
# (T, M, W, window): T below / not a multiple of the 4 warps per block
CHECK_SHAPES = ((5, 37, 4, 32), (7, 130, 3, 50), (6, 300, 3, 40))


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def check_case(t, m, n_win, win, policy, seed, dev):
    """Kernel against plain version on the card for one case; returns the
    largest absolute difference over all outputs."""
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
    kw = dict(n_servers=m, window_size=win, threshold=2.0, lam=50.0,
              window_dt=0.02, policy=policy, observe=True, renorm=True)
    got = sops.sched_stream_batch(*args, **kw)
    torch.cuda.synchronize()
    want = sops.sched_stream_batch_plain(*args, **kw)
    torch.cuda.synchronize()
    ch, lat, tab, wl, met = got
    rch, rlat, rtab, rwl, rmet = want
    exact = (torch.equal(ch, rch) and torch.equal(lat, rlat)
             and torch.equal(tab[:, 0], rtab[:, 0]) and torch.equal(wl, rwl)
             and torch.equal(met, rmet))
    d_probs = (tab[:, 1] - rtab[:, 1]).abs().max().item()
    rel = ((tab[:, 2:] - rtab[:, 2:]).abs()
           / rtab[:, 2:].abs().clamp_min(1.0)).max().item()
    err = max((a.double() - b.double()).abs().max().item()
              for a, b in zip(got, want))
    ok = exact and d_probs <= 1e-6 and rel <= 1e-6
    print(f"check {policy:>10s} T={t} M={m} W={n_win} win={win}: "
          f"contract fields {'bit-exact' if exact else 'DIFFER'}, "
          f"probs err {d_probs:.3g}, ewma/est rel err {rel:.3g} "
          f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"kernel disagrees with its plain version ({policy}, M={m})")
    return err


def results_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a card")
    dev = torch.device("cuda")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.build(skernel.SOURCE)
    print(f"built {skernel.SOURCE} in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log(skernel.SOURCE).splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  ptxas: {line.strip()}")

    # -- kernel against plain version, all body policies -------------------
    max_err = 0.0
    for i, (t, m, n_win, win) in enumerate(CHECK_SHAPES):
        for j, policy in enumerate(BODY_POLICIES):
            max_err = max(max_err, check_case(t, m, n_win, win, policy,
                                              100 * i + j, dev))

    # -- the main path at the paper's §4 size ------------------------------
    cfg = simulate.SimConfig(scenario=simulate.ScenarioConfig("transient"))
    log = simulate.default_log_cfg(cfg)
    pols = {p: PolicyConfig(name=p, threshold=0.05 if p == "ect" else 5.0)
            for p in KERNEL_POLICIES}
    results = {}
    skernel.LAUNCHES = 0
    for p, pol in pols.items():
        before = skernel.LAUNCHES
        results[p] = simulate.run_trials(0, cfg, pol, log)
        if skernel.LAUNCHES != before + 1:
            fail(f"run_trials({p}) launched the kernel "
                 f"{skernel.LAUNCHES - before} times, expected 1")
    torch.cuda.synchronize()
    main_launches = skernel.LAUNCHES
    if main_launches != len(pols):
        fail(f"main path launched the kernel {main_launches} times")

    t, r, m = cfg.n_trials, cfg.n_requests, cfg.n_servers
    for p, res in results.items():
        if res.chosen.shape != (t, r) or res.window_loads.shape != (
                t, cfg.n_windows, m):
            fail(f"{p}: unexpected result shapes")
        if not (torch.isfinite(res.latencies).all()
                and torch.isfinite(res.server_loads).all()
                and torch.isfinite(res.phase_time).all()):
            fail(f"{p}: non-finite values in the result")
        if not bool((res.n_assigned.sum(dim=-1) == r).all()):
            fail(f"{p}: n_assigned does not count every request")
        # the same prep through the plain version on the card
        gen = torch.Generator(device=dev).manual_seed(0)
        init, mask, works, states, traces, seeds = simulate._prep_trials(
            gen, cfg, log, dev)
        sched = simulate._sched_trials(
            cfg, pols[p], log, works, states, seeds, traces,
            stream_batch=sops.sched_stream_batch_plain)
        plain = simulate._post_trials(cfg, init, mask, works, traces, *sched)
        torch.cuda.synchronize()
        if not results_equal(res, plain):
            bad = [f for f, a, b in zip(res._fields, res, plain)
                   if not torch.equal(a, b)]
            fail(f"{p}: kernel run differs from the plain version in {bad}")
        p99 = policy_core.nearest_rank_p99(
            res.latencies, torch.ones_like(res.latencies, dtype=torch.bool))
        print(f"main path {p:>10s}: mean p99 latency "
              f"{p99.mean().item():.4f} s, mean makespan "
              f"{res.phase_time.mean().item():.4f} s, bit-exact with the "
              "plain version on the card")

    # -- timing, ect at the paper shape -------------------------------------
    captured = {}

    def capture(*args, **kw):
        captured["args"], captured["kw"] = args, kw
        return sops.sched_stream_batch(*args, **kw)

    gen = torch.Generator(device=dev).manual_seed(0)
    prep = simulate._prep_trials(gen, cfg, log, dev)
    simulate._sched_trials(cfg, pols["ect"], log, prep[2], prep[3], prep[5],
                           prep[4], stream_batch=capture)
    kargs = sops.pad_operands(*captured["args"])
    kkw = captured["kw"]
    for _ in range(3):
        skernel.sched_stream_call(*kargs, **kkw)
    torch.cuda.synchronize()
    reps = 20
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        skernel.sched_stream_call(*kargs, **kkw)
    end.record()
    torch.cuda.synchronize()
    kernel_ms = start.elapsed_time(end) / reps
    start.record()
    sched_stream_batch_ref(*kargs, **kkw)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    simulate.run_trials(0, cfg, pols["ect"], log)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    # the same sweep stage by stage, each ended by a synchronize
    marks = [time.perf_counter()]
    gen = torch.Generator(device=dev).manual_seed(0)
    init, mask, works, states, traces, seeds = simulate._prep_trials(
        gen, cfg, log, dev)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    sched = simulate._sched_trials(cfg, pols["ect"], log, works, states,
                                   seeds, traces)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    simulate._post_trials(cfg, init, mask, works, traces, *sched)
    torch.cuda.synchronize()
    marks.append(time.perf_counter())
    stage_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]

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
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    reqs = cfg.n_trials * cfg.n_requests
    print(f"timing ect, T={t_} N={n_} M={m_} on {card}:")
    print(f"  kernel  {kernel_ms:.4f} ms/launch ({reqs / kernel_ms * 1e3:.0f}"
          " requests/s)")
    print(f"  plain   {plain_ms:.2f} ms ({reqs / plain_ms * 1e3:.0f} "
          "requests/s)")
    print(f"  run_trials wall {sweep_s * 1e3:.2f} ms "
          f"({reqs / sweep_s:.0f} requests/s)")
    print(f"  stages  prep {stage_ms[0]:.2f} ms, sched {stage_ms[1]:.2f} ms"
          f" (stream kernel {kernel_ms:.2f} ms of it), post "
          f"{stage_ms[2]:.2f} ms; share of the run_trials wall outside the "
          f"stream kernel {1 - kernel_ms / (sweep_s * 1e3):.3f}")
    print(f"  bound   {bound_ms:.5f} ms ({bound_by}: {bytes_moved} bytes, "
          f"{ops} f32 ops)")

    print(json.dumps({"kernels": [{
        "name": "sched_stream", "route": "cuda",
        "source": "src/repro_torch/kernels/sched_select/csrc/"
                  "sched_stream.cu",
        "replaces": "src/repro/kernels/sched_select/kernel.py:130",
        "launches": main_launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
