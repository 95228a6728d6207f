"""Plain PyTorch version of the flash attention kernel (no blocking
tricks): the port's counterpart of the JAX package's
``kernels/flash_attention/ref.py::attention_ref``."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  chunk: Optional[int] = None) -> torch.Tensor:
    """q: (B,S,H,hd); k,v: (B,S,KV,hd) -> (B,S,H,hd), f32 math, output in
    q's dtype.  Window and chunk apply only with ``causal``."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qf = q.float().reshape(b, s, kvh, g, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qf, k.float()) / (hd ** 0.5)
    if causal:
        rows = torch.arange(s, device=q.device)[:, None]
        cols = torch.arange(s, device=q.device)[None, :]
        mask = cols <= rows
        if window is not None:
            mask &= rows - cols < window
        if chunk is not None:
            mask &= rows // chunk == cols // chunk
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)
