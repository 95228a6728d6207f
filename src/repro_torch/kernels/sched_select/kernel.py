"""Launch wrappers of the CUDA stream kernels.

`sched_stream_call` is the counterpart of the JAX package's
``kernels/sched_select/kernel.py::sched_stream_call``: T independent
windowed request streams scheduled in one launch of
``csrc/sched_stream.cu`` (a warp per stream, or half of one in the 2-D
form where two streams fit a block, the stream's ``(4, M_pad)`` log in
shared memory: `check_stream_domain` is the kernel's one limit).  `sched_stream_grid_call` is the counterpart of
``sched_stream_grid_call``: the same kernel over the T·C streams of the
per_client model, then the ``client_merge`` kernel for the per-trial
cross-client merge.  `sched_select_call` is the legacy single-window
entry, a wrapper over `sched_stream_call`.  They take server-padded
operands on a CUDA device; `ops` does the padding and the dispatch.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core.policy_core import (MET_PAD, N_ROWS, ROW_EST,
                                          ROW_LOADS, ROW_PROBS,
                                          window_decrements)
from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "sched_stream.cu"
# policy codes of the CUDA source's `Policy` enum
POLICY_CODES = {"minload": 0, "two_random": 1, "ect": 2, "trh": 3, "rr": 4,
                "two_choice": 5, "mlml": 6, "nltr": 7}
# where inputs past the stream kernel's shared-memory budget do run: the
# eager engine has no cap (nothing dispatches there on its own)
EAGER_NOTE = ("; SimConfig(backend='jax') or run_stream(backend='jax') "
              "schedules them on the card with the eager engine, which has "
              "no cap")
# Warps per block of the stream kernel, by form: a launch shape only,
# since streams are independent.  Measured on the H100 (PERF.md, §6):
# the 1-D form's T=100 latency-bound streams read the same for ect at one
# and four to a block and rr, the shortest chain, ran faster at one, each
# stream then alone on an SM; the 2-D form reads level at four and eight.
WARPS_PER_BLOCK = {"sched_stream": 1, "sched_stream_grid": 4}
# the source's MAX_WARPS_PER_BLOCK: a launch takes 1 to 8 warps a block
MAX_WARPS_PER_BLOCK = 8
# Lanes per stream, by form: the 1-D form's long streams take a whole warp
# each; the 2-D form's short ones share a warp two to one, 16 lanes each,
# so the per-request scalar work every lane repeats serves two streams.
LANES_PER_STREAM = {"sched_stream": 32, "sched_stream_grid": 16}

# The ablate levels of the 1-D form (the reference's sched_stream_call
# ablate=), cumulative: 0 the full kernel, 1 no fused metrics, 2 also no
# per-request step loop, 3 also no window-start plan.  Outputs past the
# dropped phase are zeros.
ABLATE_LEVELS = (0, 1, 2, 3)

# Launches in this process, by kernel form (reset by callers that count):
# the stream kernel over trials (1-D) at its full level or at an ablate
# level above 0 (timing only), over trials x clients (2-D), and the
# cross-client merge.
LAUNCHES = {"sched_stream": 0, "sched_stream_ablate": 0,
            "sched_stream_grid": 0, "client_merge": 0}

_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        lib = _build.load(SOURCE)
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sched_stream_launch.argtypes = (
            [ptr] * 12 + [i32] * 6 + [f32] * 5 + [i32] * 9 + [ptr])
        lib.sched_stream_launch.restype = ctypes.c_int
        lib.sched_stream_occupancy.argtypes = (
            [i32] * 6 + [ctypes.POINTER(i32)] * 3)
        lib.sched_stream_occupancy.restype = ctypes.c_int
        i64p = ctypes.POINTER(ctypes.c_longlong)
        lib.sched_stream_budget.argtypes = [i32] * 3 + [i64p] * 2
        lib.sched_stream_budget.restype = ctypes.c_int
        lib.client_merge_launch.argtypes = [ptr] * 8 + [i32] * 6 + [ptr]
        lib.client_merge_launch.restype = ctypes.c_int
        lib.sched_stream_error_string.argtypes = [ctypes.c_int]
        lib.sched_stream_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def seeds_as_int32(seeds: torch.Tensor) -> torch.Tensor:
    """uint32 LCG states (held in any integer dtype) as the int32 tensor
    with the same bit pattern, which the kernel reads as unsigned."""
    s = seeds.to(torch.int64) & 0xFFFFFFFF
    return torch.where(s >= 2 ** 31, s - 2 ** 32, s).to(torch.int32)


def _check(name: str, x: torch.Tensor, dtype, shape) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} must lie on a CUDA device, got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def clamp_warps(trial_tile) -> int:
    """``trial_tile`` as warps per block: clamped to [1,
    `MAX_WARPS_PER_BLOCK`].  A launch shape only: no result depends on it
    (the launch clamps it further to the shared-memory budget)."""
    return max(min(int(trial_tile), MAX_WARPS_PER_BLOCK), 1)


def resolve_warps(form: str, trial_tile=None) -> int:
    """Warps per block of the stream kernel's launch in ``form``: the
    form's `WARPS_PER_BLOCK`, or ``trial_tile`` by `clamp_warps`."""
    return WARPS_PER_BLOCK[form] if trial_tile is None \
        else clamp_warps(trial_tile)


def _raise_on(code: int, what: str) -> None:
    if code != 0:
        msg = _library().sched_stream_error_string(code).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error "
                           f"{code} ({msg})")


def stream_budget(policy: str, m_pad: int, window_size: int) -> tuple:
    """(shared-memory bytes one stream of ``policy`` needs at this padded
    server count and window, the bytes a block of the current CUDA device
    may opt in to), as the CUDA source counts them
    (``sched_stream_budget``)."""
    words, budget = ctypes.c_longlong(), ctypes.c_longlong()
    _raise_on(_library().sched_stream_budget(
        POLICY_CODES[policy], int(m_pad), int(window_size),
        ctypes.byref(words), ctypes.byref(budget)), "sched_stream budget")
    return 4 * words.value, budget.value


def check_stream_domain(policy: str, m_pad: int, window_size: int) -> None:
    """Raise unless one stream of this shape fits a block's shared memory
    on the current CUDA device: the stream kernel's only limit on the
    window and the server count.  The message names the budget, what the
    input needs and the eager engine, which has no cap."""
    need, budget = stream_budget(policy, m_pad, window_size)
    if need > budget:
        raise ValueError(
            f"window_size={window_size} with M_pad={m_pad} needs {need} "
            f"bytes ({need // 4} words) of shared memory a stream under "
            f"{policy}, past the {budget} bytes a block may take on this "
            "card (cudaDevAttrMaxSharedMemoryPerBlockOptin), so the CUDA "
            "stream kernel cannot hold it (the JAX reference has no cap)"
            f"{EAGER_NOTE}")


def _launch_streams(object_ids, lengths, valid, tables, seeds, win_rates, *,
                    form, lead, n_servers, window_size, threshold, lam, alpha,
                    window_dt, policy, observe, renorm, nltr_n=2,
                    probe_choices=2, trial_tile=None, ablate=0):
    """Check the operands and launch the stream kernel over the streams of
    the leading shape ``lead`` ((T,) or (T, C)), with the launch shape of
    ``form`` (a `LAUNCHES` key; ``trial_tile`` as `resolve_warps`) at the
    ablate level ``ablate``; win_rates carry the trial axis only.
    Returns the five per-stream outputs."""
    if policy not in POLICY_CODES:
        raise ValueError(f"policy must be one of {tuple(POLICY_CODES)}")
    if ablate not in ABLATE_LEVELS:
        raise ValueError(f"ablate={ablate!r} must be one of {ABLATE_LEVELS}")
    n = object_ids.shape[-1]
    m_pad = tables.shape[-1]
    n_win = win_rates.shape[1]
    if n != n_win * window_size:
        raise ValueError(f"N={n} is not W*window_size={n_win}*{window_size}")
    if window_size < 1:
        raise ValueError(f"window_size={window_size} must be at least 1")
    if m_pad % 128 or not 1 <= n_servers <= m_pad:
        raise ValueError(f"M_pad={m_pad} must be a multiple of 128 holding "
                         f"n_servers={n_servers}")
    _check("object_ids", object_ids, torch.int32, lead + (n,))
    _check("lengths", lengths, torch.float32, lead + (n,))
    _check("valid", valid, torch.int32, lead + (n,))
    _check("tables", tables, torch.float32, lead + (N_ROWS, m_pad))
    _check("win_rates", win_rates, torch.float32, (lead[0], n_win, m_pad))
    if tuple(seeds.shape) != lead or seeds.device != object_ids.device:
        raise ValueError(f"seeds must be {lead} on {object_ids.device}")
    seeds32 = seeds_as_int32(seeds).contiguous()
    # drain decrements pre-multiplied outside the kernel: the kernel's
    # drain is a bare subtract
    win_dec = window_decrements(win_rates, window_dt).contiguous()
    dev = object_ids.device
    choices = torch.empty(lead + (n,), dtype=torch.int32, device=dev)
    lats = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    ftab = torch.empty(lead + (N_ROWS, m_pad), dtype=torch.float32,
                       device=dev)
    wloads = torch.empty(lead + (n_win, m_pad), dtype=torch.float32,
                         device=dev)
    metrics = torch.empty(lead + (MET_PAD,), dtype=torch.float32, device=dev)
    n_streams = 1
    for d in lead:
        n_streams *= d
    with torch.cuda.device(dev):
        check_stream_domain(policy, m_pad, window_size)
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _library().sched_stream_launch(
            object_ids.data_ptr(), lengths.data_ptr(), valid.data_ptr(),
            tables.data_ptr(), seeds32.data_ptr(), win_rates.data_ptr(),
            win_dec.data_ptr(), choices.data_ptr(), lats.data_ptr(),
            ftab.data_ptr(), wloads.data_ptr(), metrics.data_ptr(),
            n_streams, n_win, window_size, n_servers, m_pad,
            POLICY_CODES[policy], float(threshold), float(lam), float(alpha),
            float(1 - alpha), float(window_dt), int(bool(window_dt)),
            int(observe), int(renorm), int(nltr_n), int(probe_choices),
            n_streams // lead[0], resolve_warps(form, trial_tile),
            LANES_PER_STREAM[form], int(ablate), stream)
    _raise_on(code, "sched_stream")
    return choices, lats, ftab, wloads, metrics


def sched_stream_call(object_ids: torch.Tensor, lengths: torch.Tensor,
                      valid: torch.Tensor, tables: torch.Tensor,
                      seeds: torch.Tensor, win_rates: torch.Tensor, *,
                      n_servers: int, window_size: int, threshold: float,
                      lam: float, alpha: float, window_dt: float, policy: str,
                      observe: bool, renorm: bool, nltr_n: int = 2,
                      probe_choices: int = 2, trial_tile=None,
                      ablate: int = 0):
    """Launch the stream kernel on the current CUDA stream.

    object_ids/lengths/valid: (T, N) int32/float32/int32 with
    N = W * window_size; tables: (T, 4, M_pad) float32; seeds: (T,) uint32
    states in any integer dtype; win_rates: (T, W, M_pad) float32 true
    rates.  ``trial_tile``: warps per block (`resolve_warps`).
    ``ablate``: one of `ABLATE_LEVELS`; above 0 the launch is for timing
    and counts under ``LAUNCHES["sched_stream_ablate"]``.  Returns
    (choices (T, N) int32, latencies (T, N) float32, final_tables
    (T, 4, M_pad), window_loads (T, W, M_pad), metrics (T, MET_PAD)
    float32 in `policy_core.MET_*` lane order)."""
    out = _launch_streams(
        object_ids, lengths, valid, tables, seeds, win_rates,
        form="sched_stream", lead=tuple(object_ids.shape[:1]),
        n_servers=n_servers, window_size=window_size, threshold=threshold,
        lam=lam, alpha=alpha, window_dt=window_dt, policy=policy,
        observe=observe, renorm=renorm, nltr_n=nltr_n,
        probe_choices=probe_choices, trial_tile=trial_tile, ablate=ablate)
    LAUNCHES["sched_stream_ablate" if ablate else "sched_stream"] += 1
    return out


def sched_stream_grid_streams(object_ids: torch.Tensor,
                              lengths: torch.Tensor, valid: torch.Tensor,
                              tables: torch.Tensor, seeds: torch.Tensor,
                              win_rates: torch.Tensor, **kw):
    """The per-stream half of `sched_stream_grid_call`: the stream kernel
    over the T·C streams, each reading its trial's win_rates row.
    object_ids/lengths/valid (T, C, N), tables (T, C, 4, M_pad), seeds
    (T, C), win_rates (T, W, M_pad); keywords as `sched_stream_call`,
    ``trial_tile`` the warps per block (two streams a warp); ``ablate``
    above 0 raises, as in the reference.  Returns the five per-stream
    outputs with leading (T, C)."""
    if kw.get("ablate"):
        raise ValueError("ablate profiling levels support the trial-grid "
                         "(1-D) form only")
    out = _launch_streams(object_ids, lengths, valid, tables, seeds,
                          win_rates, form="sched_stream_grid",
                          lead=tuple(object_ids.shape[:2]), **kw)
    LAUNCHES["sched_stream_grid"] += 1
    return out


def stream_occupancy(form: str, policy: str, n_servers: int, m_pad: int,
                     window_size: int, trial_tile=None) -> tuple:
    """(blocks per SM, streams per block, dynamic shared memory bytes) of
    the stream kernel's level-0 launch in ``form`` for this policy and
    shape (``trial_tile`` as `resolve_warps`), as the CUDA runtime reports
    them for the current card."""
    i32 = ctypes.c_int
    blocks, streams, smem = i32(), i32(), i32()
    _raise_on(_library().sched_stream_occupancy(
        POLICY_CODES[policy], n_servers, m_pad, window_size,
        resolve_warps(form, trial_tile), LANES_PER_STREAM[form],
        ctypes.byref(blocks), ctypes.byref(streams), ctypes.byref(smem)),
        "sched_stream occupancy")
    return blocks.value, streams.value, smem.value


def client_merge_call(metrics: torch.Tensor, wloads: torch.Tensor,
                      lats: torch.Tensor, valid: torch.Tensor, *,
                      client_tile: int, merge_mean: bool):
    """Launch the cross-client merge: per trial, one block for the merged
    latencies and their p99 and a few for the masked client sums.

    metrics (T, C, MET_PAD), wloads (T, C, W, M_pad), lats (T, C, N)
    float32 and valid (T, C, N) int32, as the stream kernel leaves them.
    ``client_tile`` is the association width (`resolve_client_tile`).
    Returns (cm_wloads (T, W, M_pad) — the masked client mean, or the raw
    masked sum when ``merge_mean`` is False — cm_metrics (T, MET_PAD) in
    `MET_*` + `MET_N_CLIENTS` order with the merged p99 when
    ``merge_mean``, cm_lats (T, C, N) latencies masked to 0 and cm_lval
    (T, C, N) 0/1 validity)."""
    t, c, n = lats.shape
    n_win, m_pad = wloads.shape[2:]
    if not 1 <= client_tile <= c:
        raise ValueError(f"client_tile={client_tile} must be in [1, {c}]")
    _check("metrics", metrics, torch.float32, (t, c, MET_PAD))
    _check("wloads", wloads, torch.float32, (t, c, n_win, m_pad))
    _check("lats", lats, torch.float32, (t, c, n))
    _check("valid", valid, torch.int32, (t, c, n))
    dev = lats.device
    cm_wloads = torch.empty((t, n_win, m_pad), dtype=torch.float32,
                            device=dev)
    cm_metrics = torch.empty((t, MET_PAD), dtype=torch.float32, device=dev)
    cm_lats = torch.empty((t, c, n), dtype=torch.float32, device=dev)
    cm_lval = torch.empty((t, c, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _library().client_merge_launch(
            metrics.data_ptr(), wloads.data_ptr(), lats.data_ptr(),
            valid.data_ptr(), cm_wloads.data_ptr(), cm_metrics.data_ptr(),
            cm_lats.data_ptr(), cm_lval.data_ptr(), t, c, n, n_win * m_pad,
            int(client_tile), int(bool(merge_mean)), stream)
    _raise_on(code, "client_merge")
    LAUNCHES["client_merge"] += 1
    return cm_wloads, cm_metrics, cm_lats, cm_lval


def sched_stream_grid_call(object_ids: torch.Tensor, lengths: torch.Tensor,
                           valid: torch.Tensor, tables: torch.Tensor,
                           seeds: torch.Tensor, win_rates: torch.Tensor, *,
                           client_tile: int, merge_mean: bool = True, **kw):
    """2-D (trials × clients) form: the stream kernel over the T·C
    private-log streams, then the cross-client merge.  Operands as
    `sched_stream_grid_streams`; ``client_tile``/``merge_mean`` as
    `client_merge_call`.  Returns (choices, latencies, final_tables,
    window_loads, metrics) with leading (T, C), then (cm_wloads,
    cm_metrics, cm_lats, cm_lval)."""
    per_stream = sched_stream_grid_streams(object_ids, lengths, valid,
                                           tables, seeds, win_rates, **kw)
    _, lats, _, wloads, metrics = per_stream
    merged = client_merge_call(metrics, wloads, lats, valid,
                               client_tile=client_tile,
                               merge_mean=merge_mean)
    return per_stream + merged


def select_operands(object_ids: torch.Tensor, init_loads: torch.Tensor,
                    n_servers: int):
    """The stream operands of the legacy single-window model: a fresh log
    holding the known loads with the uniform prior ``1/M``, every request
    valid, one window of unit rates.  Returns (tables (C, 4, M_pad),
    valid (C, N) int32, win_rates (C, 1, M_pad))."""
    c, n = object_ids.shape
    m_pad = init_loads.shape[-1]
    dev = init_loads.device
    tables = torch.zeros((c, N_ROWS, m_pad), dtype=torch.float32, device=dev)
    tables[:, ROW_LOADS] = init_loads.to(torch.float32)
    tables[:, ROW_PROBS] = torch.tensor(1.0 / n_servers, dtype=torch.float32)
    tables[:, ROW_EST] = 1.0
    valid = torch.ones((c, n), dtype=torch.int32, device=dev)
    rates = torch.ones((c, 1, m_pad), dtype=torch.float32, device=dev)
    return tables, valid, rates


SELECT_KW = dict(alpha=0.25, window_dt=0.0, observe=False, renorm=False)


def sched_select_call(object_ids: torch.Tensor, lengths: torch.Tensor,
                      init_loads: torch.Tensor, seeds: torch.Tensor, *,
                      n_servers: int, threshold: float, lam: float,
                      policy: str):
    """Legacy single-window entry (the paper's static-load model) as one
    `sched_stream_call`: object_ids/lengths (C, N) int32/float32,
    init_loads (C, M_pad), seeds (C,).  Uniform prior, no observation,
    no drain, no renormalisation.  Returns (choices (C, N) int32,
    final_loads (C, M_pad))."""
    n = object_ids.shape[1]
    tables, valid, rates = select_operands(object_ids, init_loads, n_servers)
    choices, _, ftab, _, _ = sched_stream_call(
        object_ids, lengths, valid, tables, seeds, rates,
        n_servers=n_servers, window_size=n, threshold=threshold, lam=lam,
        policy=policy, **SELECT_KW)
    return choices, ftab[:, ROW_LOADS]
