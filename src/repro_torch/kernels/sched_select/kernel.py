"""Launch wrapper of the CUDA trial-grid stream kernel.

`sched_stream_call` is the counterpart of the JAX package's
``kernels/sched_select/kernel.py::sched_stream_call``: T independent
windowed request streams scheduled in one launch of
``csrc/sched_stream.cu`` (one warp per stream, the stream's ``(4, M_pad)``
log in shared memory).  It takes server-padded operands on a CUDA device;
`ops.sched_stream_batch` does the padding and the dispatch.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.policy_core import MET_PAD, N_ROWS, window_decrements
from repro_torch.kernels.sched_select import _build

SOURCE = "sched_stream.cu"
# policy codes of the CUDA source's `Policy` enum
POLICY_CODES = {"minload": 0, "two_random": 1, "ect": 2, "trh": 3, "rr": 4,
                "two_choice": 5, "mlml": 6, "nltr": 7}
MAX_WINDOW = 1024
MAX_M_PAD = 1024
WARPS_PER_BLOCK = 4     # launch shape only: streams are independent

# Launches of the kernel in this process (reset by callers that count).
LAUNCHES = 0

_FN = None


def _launcher():
    global _FN
    if _FN is None:
        lib = _build.load(SOURCE)
        fn = lib.sched_stream_launch
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([ptr] * 12 + [i32] * 6 + [f32] * 5 + [i32] * 6
                       + [ptr])
        fn.restype = ctypes.c_int
        lib.sched_stream_error_string.argtypes = [ctypes.c_int]
        lib.sched_stream_error_string.restype = ctypes.c_char_p
        _FN = (fn, lib.sched_stream_error_string)
    return _FN


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


def sched_stream_call(object_ids: torch.Tensor, lengths: torch.Tensor,
                      valid: torch.Tensor, tables: torch.Tensor,
                      seeds: torch.Tensor, win_rates: torch.Tensor, *,
                      n_servers: int, window_size: int, threshold: float,
                      lam: float, alpha: float, window_dt: float, policy: str,
                      observe: bool, renorm: bool, nltr_n: int = 2,
                      probe_choices: int = 2):
    """Launch the stream kernel on the current CUDA stream.

    object_ids/lengths/valid: (T, N) int32/float32/int32 with
    N = W * window_size; tables: (T, 4, M_pad) float32; seeds: (T,) uint32
    states in any integer dtype; win_rates: (T, W, M_pad) float32 true
    rates.  Returns (choices (T, N) int32, latencies (T, N) float32,
    final_tables (T, 4, M_pad), window_loads (T, W, M_pad), metrics
    (T, MET_PAD) float32 in `policy_core.MET_*` lane order)."""
    global LAUNCHES
    if policy not in POLICY_CODES:
        raise ValueError(f"policy must be one of {tuple(POLICY_CODES)}")
    t, n = object_ids.shape
    m_pad = tables.shape[-1]
    n_win = win_rates.shape[1]
    if n != n_win * window_size:
        raise ValueError(f"N={n} is not W*window_size={n_win}*{window_size}")
    if not 1 <= window_size <= MAX_WINDOW:
        raise ValueError(f"window_size={window_size} must be in "
                         f"[1, {MAX_WINDOW}] for this kernel")
    if m_pad > MAX_M_PAD or m_pad % 128 or not 1 <= n_servers <= m_pad:
        raise ValueError(f"M_pad={m_pad} must be a multiple of 128 up to "
                         f"{MAX_M_PAD} holding n_servers={n_servers}")
    _check("object_ids", object_ids, torch.int32, (t, n))
    _check("lengths", lengths, torch.float32, (t, n))
    _check("valid", valid, torch.int32, (t, n))
    _check("tables", tables, torch.float32, (t, N_ROWS, m_pad))
    _check("win_rates", win_rates, torch.float32, (t, n_win, m_pad))
    if seeds.shape != (t,) or seeds.device != object_ids.device:
        raise ValueError(f"seeds must be ({t},) on {object_ids.device}")
    seeds32 = seeds_as_int32(seeds).contiguous()
    # drain decrements pre-multiplied outside the kernel: the kernel's
    # drain is a bare subtract
    win_dec = window_decrements(win_rates, window_dt).contiguous()
    dev = object_ids.device
    choices = torch.empty((t, n), dtype=torch.int32, device=dev)
    lats = torch.empty((t, n), dtype=torch.float32, device=dev)
    ftab = torch.empty((t, N_ROWS, m_pad), dtype=torch.float32, device=dev)
    wloads = torch.empty((t, n_win, m_pad), dtype=torch.float32, device=dev)
    metrics = torch.empty((t, MET_PAD), dtype=torch.float32, device=dev)
    fn, err_str = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(object_ids.data_ptr(), lengths.data_ptr(), valid.data_ptr(),
                  tables.data_ptr(), seeds32.data_ptr(), win_rates.data_ptr(),
                  win_dec.data_ptr(), choices.data_ptr(), lats.data_ptr(),
                  ftab.data_ptr(), wloads.data_ptr(), metrics.data_ptr(),
                  t, n_win, window_size, n_servers, m_pad,
                  POLICY_CODES[policy], float(threshold), float(lam),
                  float(alpha), float(1 - alpha), float(window_dt),
                  int(bool(window_dt)), int(observe), int(renorm),
                  int(nltr_n), int(probe_choices), WARPS_PER_BLOCK, stream)
    if code != 0:
        raise RuntimeError(f"sched_stream kernel launch failed: CUDA error "
                           f"{code} ({err_str(code).decode()})")
    LAUNCHES += 1
    return choices, lats, ftab, wloads, metrics
