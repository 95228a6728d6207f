"""Dispatch of the flash attention kernel.

`flash_attention` is the counterpart of the JAX package's
``kernels/flash_attention/ops.flash_attention``: ``is_global`` clears the
window and chunk (llama4's global layers attend plain causal), the tile
sizes are clamped to the sequence as there, and a CUDA tensor goes
through the CUDA kernel (which raises if it cannot run — there is no
fallback) while a CPU tensor goes through the plain version
`ref.attention_ref`.  `flash_attention_plain` runs the plain version on
whatever device the tensors lie on: what the kernel is held against on
the card.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import (MAX_BLOCK,
                                                        flash_attention_call)
from repro_torch.kernels.flash_attention.ref import attention_ref


def _plain(q, k, v, *, causal, window, chunk, block_q, block_k):
    """`attention_ref` under the kernel's signature (tiles do not change
    what it computes)."""
    return attention_ref(q, k, v, causal=causal, window=window, chunk=chunk)


def _pick(x: torch.Tensor):
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    if x.device.type == "cuda":
        return flash_attention_call
    if x.device.type == "cpu":
        return _plain
    raise ValueError(f"no flash attention implementation for {x.device}")


def _run(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool = True, window: Optional[int] = None,
         chunk: Optional[int] = None, is_global: bool = False,
         block_q: int = MAX_BLOCK, block_k: int = MAX_BLOCK) -> torch.Tensor:
    if is_global:          # llama4 global layers: plain causal
        window = chunk = None
    s = q.shape[1]
    bq = min(block_q, max(8, s))
    bk = min(block_k, max(8, s))
    for name, blk in (("block_q", bq), ("block_k", bk)):
        if not 1 <= blk <= MAX_BLOCK:
            raise ValueError(f"{name}={blk} (after the clamp to S={s}) must "
                             f"be in [1, {MAX_BLOCK}], the kernel's tile")
    return fn(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
              window=window, chunk=chunk, block_q=bq, block_k=bk)


def flash_attention(q: torch.Tensor, *args, **kw) -> torch.Tensor:
    """Fused GQA attention. q: (B,S,H,hd); k,v: (B,S,KV,hd), float32 or
    bfloat16 -> (B,S,H,hd) in q's dtype.  Keywords ``causal``,
    ``window``, ``chunk``, ``is_global`` as the JAX function;
    ``block_q``/``block_k`` are the kernel's query and key tiles, at most
    `kernel.MAX_BLOCK` rows after the clamp to the sequence, on any device
    (the JAX package's TPU default is 128)."""
    return _run(_pick(q), q, *args, **kw)


flash_attention_plain = functools.partial(_run, _plain)
