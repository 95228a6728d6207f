"""Launch wrapper of the CUDA flash attention kernel.

`flash_attention_call` is the counterpart of the JAX package's
``kernels/flash_attention/kernel.py::flash_attention_fwd``: forward GQA
attention with an online softmax in float32, causal / sliding-window /
chunked-local masks and whole key tiles skipped, launched once per call
of ``csrc/flash_attn.cu`` (one block per (batch·head, query tile)).  It
takes contiguous ``(B, S, H, hd)`` / ``(B, S, KV, hd)`` operands on a CUDA
device; `ops` does the dispatch.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attn.cu"
MAX_BLOCK = 64          # rows of a query or key tile (the kernel's TILE)
MAX_HEAD_DIM = 256
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launches in this process (reset by callers that count).
LAUNCHES = {"flash_attention": 0}

_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        lib = _build.load(SOURCE)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_attn_launch.argtypes = (
            [ptr] * 4 + [i32] * 10 + [ctypes.c_float, i32, ptr])
        lib.flash_attn_launch.restype = ctypes.c_int
        lib.flash_attn_error_string.argtypes = [ctypes.c_int]
        lib.flash_attn_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


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


def flash_attention_call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: Optional[int],
                         chunk: Optional[int], block_q: int,
                         block_k: int) -> torch.Tensor:
    """Launch the kernel on the current CUDA stream.

    q (B, S, H, hd), k and v (B, S, KV, hd), one dtype (float32 or
    bfloat16), H a multiple of KV, hd at most 256; query tiles of
    ``block_q`` rows, key tiles of ``block_k`` rows (each 1..MAX_BLOCK).
    Window and chunk apply only with ``causal``.  Returns (B, S, H, hd)
    in q's dtype."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"q must be one of {tuple(DTYPE_CODES)}, got "
                        f"{q.dtype}")
    if kvh < 1 or h % kvh:
        raise ValueError(f"H={h} must be a multiple of KV={kvh}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim={hd} must be in [1, {MAX_HEAD_DIM}] "
                         "for this kernel")
    for name, blk in (("block_q", block_q), ("block_k", block_k)):
        if not 1 <= blk <= MAX_BLOCK:
            raise ValueError(f"{name}={blk} must be in [1, {MAX_BLOCK}]")
    if -(-s // block_q) > 65535:
        raise ValueError(f"S={s} needs more than 65535 query tiles of "
                         f"{block_q} rows")
    for name, width in (("window", window), ("chunk", chunk)):
        if width is not None and width < 1:
            raise ValueError(f"{name}={width} must be at least 1")
    _check("q", q, q.dtype, (b, s, h, hd))
    _check("k", k, q.dtype, (b, s, kvh, hd))
    _check("v", v, q.dtype, (b, s, kvh, hd))
    out = torch.empty_like(q)
    if out.numel():
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            code = _library().flash_attn_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, s, h, kvh, hd, int(causal),
                int(window or 0) if causal else 0,
                int(chunk or 0) if causal else 0, block_q, block_k,
                1.0 / hd ** 0.5, DTYPE_CODES[q.dtype], stream)
        if code != 0:
            msg = _library().flash_attn_error_string(code).decode()
            raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                               f"error {code} ({msg})")
        LAUNCHES["flash_attention"] += 1
    return out
