"""Launch wrapper of the CUDA threefry kernel (``csrc/threefry.cu``).

`threefry_counters_call` hashes, for every key of a batch, the counter
pairs ``(0, count_lo + j)`` for ``j < n`` on the current CUDA
stream: the counters of a `repro_torch.random` split, bits or fold_in.
It allocates the output with ``torch.empty``, does not synchronise, and
raises if the launch is refused.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "threefry.cu"

# Launches of the kernel in this process (reset by callers that count).
LAUNCHES = {"threefry": 0}

_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        lib = _build.load(SOURCE)
        ptr, i64, u32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint
        lib.threefry_launch.argtypes = [ptr, ptr, i64, i64, u32,
                                        ctypes.c_int, ptr]
        lib.threefry_launch.restype = ctypes.c_int
        lib.threefry_error_string.argtypes = [ctypes.c_int]
        lib.threefry_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def threefry_counters_call(keys: torch.Tensor, n: int, count_lo: int = 0,
                           xor: bool = False) -> torch.Tensor:
    """keys: (..., 2) int64 holding uint32, contiguous, on a CUDA device.
    Returns (..., n, 2) int64 holding the two output words of each
    counter, or (..., n) holding their xor when ``xor``."""
    if keys.device.type != "cuda":
        raise ValueError(f"keys must lie on a CUDA device, got {keys.device}")
    if keys.dtype != torch.int64:
        raise TypeError(f"keys must be int64, got {keys.dtype}")
    if keys.ndim < 1 or keys.shape[-1] != 2:
        raise ValueError(f"keys must be (..., 2), got {tuple(keys.shape)}")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    if n < 0:
        raise ValueError(f"n={n} must be >= 0")
    lead = tuple(keys.shape[:-1])
    out = torch.empty(lead + ((n,) if xor else (n, 2)), dtype=torch.int64,
                      device=keys.device)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        code = _library().threefry_launch(
            keys.data_ptr(), out.data_ptr(), keys.numel() // 2, n,
            count_lo & 0xFFFFFFFF, int(bool(xor)), stream)
    if code != 0:
        msg = _library().threefry_error_string(code).decode()
        raise RuntimeError(f"threefry kernel launch failed: CUDA error "
                           f"{code} ({msg})")
    LAUNCHES["threefry"] += 1
    return out
