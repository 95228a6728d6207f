"""Launch wrappers of the two CUDA flash attention kernels.

Both are counterparts of the JAX package's
``kernels/flash_attention/kernel.py::flash_attention_fwd``: forward GQA
attention with an online softmax in float32, causal / sliding-window /
chunked-local masks and whole key tiles skipped, launched once per call.
They take contiguous ``(B, S, H, hd)`` / ``(B, S, KV, hd)`` operands on a
CUDA device; `ops` picks one.

* `flash_attention_wgmma_call` launches ``csrc/flash_attn_wgmma.cu``:
  bfloat16, ``hd`` a multiple of 8 up to 256, Hopper's tensor cores
  (wgmma) with TMA-staged tiles of 128 query and 64 key rows.
* `flash_attention_call` launches ``csrc/flash_attn.cu``, the SIMT kernel
  (scalar f32 products on the CUDA cores): float32 or bfloat16, any
  ``hd`` up to 256, tiles of ``block_q`` / ``block_k`` rows.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import _build

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash_attn.cu"
WGMMA_SOURCE = CSRC / "flash_attn_wgmma.cu"
MAX_BLOCK = 64          # rows of a query or key tile of the SIMT kernel
MAX_HEAD_DIM = 256
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
WGMMA_TILES = (128, 64)  # query and key rows of a wgmma kernel tile

# Launches in this process (reset by callers that count).
LAUNCHES = {"flash_attention_wgmma": 0, "flash_attention_simt": 0}

_LIBS = {}


def _library(source: Path, prefix: str, arg_types):
    """The ctypes library of ``source`` with ``<prefix>_launch`` (argument
    types ``arg_types``) and ``<prefix>_error_string`` declared."""
    if source not in _LIBS:
        lib = _build.load(source)
        launch = getattr(lib, f"{prefix}_launch")
        launch.argtypes = arg_types
        launch.restype = ctypes.c_int
        err = getattr(lib, f"{prefix}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _LIBS[source] = lib
    return _LIBS[source]


_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
_SIMT_ARGS = [_PTR] * 4 + [_I32] * 10 + [ctypes.c_float, _I32, _PTR]
_WGMMA_ARGS = [_PTR] * 4 + [_I32] * 8 + [ctypes.c_float, _PTR]


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


def _check_common(q, k, v, window, chunk) -> None:
    """Shapes, devices and mask widths both kernels require."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    if kvh < 1 or h % kvh:
        raise ValueError(f"H={h} must be a multiple of KV={kvh}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim={hd} must be in [1, {MAX_HEAD_DIM}] "
                         "for the CUDA flash kernels (their limit; the JAX "
                         "reference has none)")
    for name, width in (("window", window), ("chunk", chunk)):
        if width is not None and width < 1:
            raise ValueError(f"{name}={width} must be at least 1")
    _check("q", q, q.dtype, (b, s, h, hd))
    _check("k", k, q.dtype, (b, s, kvh, hd))
    _check("v", v, q.dtype, (b, s, kvh, hd))


def _raise_on(code: int, source: Path, prefix: str, name: str) -> None:
    if code != 0:
        msg = getattr(_LIBS[source], f"{prefix}_error_string")(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: error {code} "
                           f"({msg})")


def flash_attention_call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: Optional[int],
                         chunk: Optional[int], block_q: int,
                         block_k: int) -> torch.Tensor:
    """Launch the SIMT kernel on the current CUDA stream.

    q (B, S, H, hd), k and v (B, S, KV, hd), one dtype (float32 or
    bfloat16), H a multiple of KV, hd at most 256; query tiles of
    ``block_q`` rows, key tiles of ``block_k`` rows (each 1..MAX_BLOCK).
    Window and chunk apply only with ``causal``.  Returns (B, S, H, hd)
    in q's dtype."""
    b, s, h, hd = q.shape
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"q must be one of {tuple(DTYPE_CODES)} for the CUDA "
                        f"flash kernels (their limit; the JAX reference has "
                        f"none), got {q.dtype}")
    for name, blk in (("block_q", block_q), ("block_k", block_k)):
        if not 1 <= blk <= MAX_BLOCK:
            raise ValueError(f"{name}={blk} must be in [1, {MAX_BLOCK}]")
    if -(-s // block_q) > 65535:
        raise ValueError(f"S={s} needs more than 65535 query tiles of "
                         f"{block_q} rows")
    _check_common(q, k, v, window, chunk)
    out = torch.empty_like(q)
    if out.numel():
        lib = _library(SOURCE, "flash_attn", _SIMT_ARGS)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            code = lib.flash_attn_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, s, h, k.shape[2], hd, int(causal),
                int(window or 0) if causal else 0,
                int(chunk or 0) if causal else 0, block_q, block_k,
                1.0 / hd ** 0.5, DTYPE_CODES[q.dtype], stream)
        _raise_on(code, SOURCE, "flash_attn", "flash_attention_simt")
        LAUNCHES["flash_attention_simt"] += 1
    return out


def flash_attention_wgmma_call(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool,
                               window: Optional[int],
                               chunk: Optional[int]) -> torch.Tensor:
    """Launch the wgmma kernel on the current CUDA stream.

    q (B, S, H, hd), k and v (B, S, KV, hd), all bfloat16 and starting on
    16-byte boundaries (as fresh allocations do), H a multiple of KV, hd
    a multiple of 8 and at most 256; tiles of 128 query and 64 key
    rows (`WGMMA_TILES`).  Window and chunk apply only with ``causal``.
    Returns (B, S, H, hd) in bfloat16."""
    b, s, h, hd = q.shape
    if q.dtype != torch.bfloat16:
        raise TypeError(f"q must be torch.bfloat16 for the wgmma kernel, got "
                        f"{q.dtype}")
    if hd % 8:
        raise ValueError(f"head_dim={hd} must be a multiple of 8 for the "
                         "wgmma kernel")
    if -(-s // WGMMA_TILES[0]) > 65535:
        raise ValueError(f"S={s} needs more than 65535 query tiles of "
                         f"{WGMMA_TILES[0]} rows")
    _check_common(q, k, v, window, chunk)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:      # a TMA tensor map's base must be
            raise ValueError(f"{name} must start on a 16-byte boundary")
    out = torch.empty_like(q)
    if out.numel():
        lib = _library(WGMMA_SOURCE, "flash_attn_wgmma", _WGMMA_ARGS)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            code = lib.flash_attn_wgmma_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, s, h, k.shape[2], hd, int(causal),
                int(window or 0) if causal else 0,
                int(chunk or 0) if causal else 0, 1.0 / hd ** 0.5, stream)
        _raise_on(code, WGMMA_SOURCE, "flash_attn_wgmma",
                  "flash_attention_wgmma")
        LAUNCHES["flash_attention_wgmma"] += 1
    return out


def wgmma_occupancy(hd: int) -> tuple:
    """(dynamic shared memory bytes, blocks per SM) of the wgmma kernel's
    instance for head dim ``hd``, as the CUDA runtime reports them for the
    current card."""
    lib = _library(WGMMA_SOURCE, "flash_attn_wgmma", _WGMMA_ARGS)
    query = lib.flash_attn_wgmma_occupancy
    query.argtypes = [_I32, ctypes.POINTER(_I32), ctypes.POINTER(_I32)]
    query.restype = ctypes.c_int
    smem, blocks = _I32(), _I32()
    _raise_on(query(hd, ctypes.byref(smem), ctypes.byref(blocks)),
              WGMMA_SOURCE, "flash_attn_wgmma", "flash_attention_wgmma")
    return smem.value, blocks.value
