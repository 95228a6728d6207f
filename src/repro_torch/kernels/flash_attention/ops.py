"""Dispatch of the flash attention kernels.

`flash_attention` is the counterpart of the JAX package's
``kernels/flash_attention/ops.flash_attention``: ``is_global`` clears the
window and chunk (llama4's global layers attend plain causal), the tile
sizes (default 128, as there) are clamped to the sequence as there, and
`_route` names what runs:
a CUDA tensor in bfloat16 whose head dim is a multiple of 8 (at most 256)
goes through the wgmma kernel, any other CUDA tensor through the SIMT
kernel, and a CPU tensor through the plain version `ref.attention_ref`.
A kernel that cannot build or launch raises: there is no fallback.
`flash_attention_plain` runs the plain version on whatever device the
tensors lie on: what the kernels are held against on the card.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import (
    MAX_BLOCK, MAX_HEAD_DIM, flash_attention_call, flash_attention_wgmma_call)
from repro_torch.kernels.flash_attention.ref import attention_ref


def _plain(q, k, v, *, causal, window, chunk, block_q, block_k):
    """`attention_ref` under the kernels' signature (tiles do not change
    what it computes)."""
    return attention_ref(q, k, v, causal=causal, window=window, chunk=chunk)


def _simt(q, k, v, *, causal, window, chunk, block_q, block_k):
    """The SIMT kernel under the kernels' signature, its tiles clamped to
    its `kernel.MAX_BLOCK` rows: a tile changes only the association of
    the online softmax, never the function."""
    return flash_attention_call(q, k, v, causal=causal, window=window,
                                chunk=chunk, block_q=min(block_q, MAX_BLOCK),
                                block_k=min(block_k, MAX_BLOCK))


def _wgmma(q, k, v, *, causal, window, chunk, block_q, block_k):
    """The wgmma kernel under the kernels' signature: its tiles are fixed
    (`kernel.WGMMA_TILES`), so ``block_q``/``block_k`` go unused."""
    return flash_attention_wgmma_call(q, k, v, causal=causal, window=window,
                                      chunk=chunk)


def _route(dtype: torch.dtype, hd: int, device_type: str) -> str:
    """``"wgmma"``, ``"simt"`` or ``"plain"``: what runs for q of this
    dtype, head dim and device type."""
    if device_type == "cuda":
        if dtype == torch.bfloat16 and hd % 8 == 0 and hd <= MAX_HEAD_DIM:
            return "wgmma"
        return "simt"
    if device_type == "cpu":
        return "plain"
    raise ValueError(f"no flash attention implementation for "
                     f"{device_type} tensors")


_ROUTES = {"wgmma": _wgmma, "simt": _simt, "plain": _plain}


def _pick(x: torch.Tensor):
    return _ROUTES[_route(x.dtype, x.shape[-1], x.device.type)]


def _run(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool = True, window: Optional[int] = None,
         chunk: Optional[int] = None, is_global: bool = False,
         block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    if is_global:          # llama4 global layers: plain causal
        window = chunk = None
    s = q.shape[1]
    bq = min(block_q, max(8, s))
    bk = min(block_k, max(8, s))
    for name, blk in (("block_q", bq), ("block_k", bk)):
        if blk < 1:
            raise ValueError(f"{name}={blk} (after the clamp to S={s}) must "
                             "be at least 1")
    return fn(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
              window=window, chunk=chunk, block_q=bq, block_k=bk)


def flash_attention(q: torch.Tensor, *args, **kw) -> torch.Tensor:
    """Fused GQA attention. q: (B,S,H,hd); k,v: (B,S,KV,hd), float32 or
    bfloat16 -> (B,S,H,hd) in q's dtype.  Keywords ``causal``,
    ``window``, ``chunk``, ``is_global`` as the JAX function.
    ``block_q``/``block_k`` (default 128, as the JAX function's) are
    clamped to the sequence as there and steer only the SIMT kernel,
    which clamps them again to its `kernel.MAX_BLOCK` rows; the plain
    version ignores them and the wgmma kernel's tiles are fixed at 128
    query and 64 key rows."""
    return _run(_pick(q), q, *args, **kw)


flash_attention_plain = functools.partial(_run, _plain)
