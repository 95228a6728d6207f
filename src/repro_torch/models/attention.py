"""GQA attention: blocked full/prefill path + single-token decode path.

The port's counterpart of the JAX package's ``models/attention.py``.

* The train/prefill path is *blocked*: queries are processed in chunks
  of ``q_block`` (a Python loop), so the (S x S) score matrix is never
  materialized whole.  With ``cfg.use_pallas_attn`` set, `self_attend`
  routes through `kernels.flash_attention.ops.flash_attention` instead:
  the hand-written CUDA flash kernel on the card.  That route has no
  backward, so `self_attend` refuses it under autograd on every device.
* Locality masks: causal, sliding-window (danube/mixtral), chunked-local
  (llama4), or none (whisper's encoder and cross attention:
  `cross_attend` over keys `precompute_cross_kv` projects once from the
  encoder's output).  ``is_global`` is a Python bool per layer.
* Decode uses a ring KV cache sized to the layer's receptive field
  (full: S; SWA: window; chunked: chunk) with absolute slot positions for
  masking; keys are stored post-RoPE.  Unlike the JAX package, which
  returns new arrays, `decode_attend` writes the new token's entries into
  the cache tensors in place (one cache, no copy per step).

Score products take float32 operands where the JAX package asks for a
float32 result from bf16 operands (``preferred_element_type``): a bf16
product in PyTorch would round its output to bf16.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig, torch_dtype

Params = Dict[str, torch.Tensor]

NEG_INF = -1e30


# ------------------------------------------------------------------- params

def init_attention(gen: torch.Generator, cfg: ModelConfig, device=None,
                   cross: bool = False) -> Params:
    """Draws in the order wq, wk, wv, wo; zero q/k/v biases where
    ``cfg.qkv_bias``, except for cross attention (``cross``), which has
    none, as in the JAX package."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pd = cfg.pdtype
    p = {"wq": L.he_init(gen, (d, h * hd), pd, fan_in=d, device=device),
         "wk": L.he_init(gen, (d, kv * hd), pd, fan_in=d, device=device),
         "wv": L.he_init(gen, (d, kv * hd), pd, fan_in=d, device=device),
         "wo": L.he_init(gen, (h * hd, d), pd, fan_in=h * hd, device=device)}
    if cfg.qkv_bias and not cross:
        for name, width in (("bq", h * hd), ("bk", kv * hd), ("bv", kv * hd)):
            p[name] = torch.zeros(width, dtype=pd, device=device)
    return p


def project_q(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    b, s, _ = x.shape
    q = x @ L.wcast(p, "wq", cfg, [None, "model"])
    if "bq" in p:
        q = q + L.cast_to(p["bq"], cfg.cdtype)
    return q.reshape(b, s, cfg.n_heads, cfg.hd)


def project_kv(p: Params, x: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    k = x @ L.wcast(p, "wk", cfg, [None, "model"])
    v = x @ L.wcast(p, "wv", cfg, [None, "model"])
    if "bk" in p:
        k = k + L.cast_to(p["bk"], cfg.cdtype)
        v = v + L.cast_to(p["bv"], cfg.cdtype)
    return (k.reshape(b, s, cfg.n_kv_heads, cfg.hd),
            v.reshape(b, s, cfg.n_kv_heads, cfg.hd))


def out_proj(p: Params, o: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    b, s = o.shape[:2]
    return o.reshape(b, s, cfg.n_heads * cfg.hd) @ L.wcast(
        p, "wo", cfg, ["model", None])


def maybe_rope(x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig,
               use_rope: bool = True) -> torch.Tensor:
    """RoPE / partial rotary, or M-RoPE over (3, B, S) positions."""
    if not (cfg.use_rope and use_rope):
        return x
    if cfg.mrope:
        return L.apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return L.apply_rope(x, positions, cfg.rope_theta, cfg.rotary_pct)


# ------------------------------------------------------------------ masking

def _local_mask(qpos: torch.Tensor, kpos: torch.Tensor, cfg: ModelConfig,
                is_global: bool) -> torch.Tensor:
    """(Tq, Tk) bool mask from absolute positions; global layers (llama4)
    use plain causal."""
    causal = kpos[None, :] <= qpos[:, None]
    if is_global:
        return causal
    local = causal
    if cfg.sliding_window is not None:
        local = causal & (qpos[:, None] - kpos[None, :] < cfg.sliding_window)
    if cfg.chunk_attn is not None:
        local = causal & (qpos[:, None] // cfg.chunk_attn
                          == kpos[None, :] // cfg.chunk_attn)
    return local


# --------------------------------------------------------- full / prefill

def _inv_sqrt(hd: int, dtype: torch.dtype) -> float:
    """``1 / sqrt(hd)`` as the JAX package rounds it: in float32, then to
    ``dtype``."""
    f32 = 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32))
    return float(f32.to(dtype))


def gqa_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: Optional[torch.Tensor], cfg: ModelConfig) -> torch.Tensor:
    """One attention pass. q: (B,Tq,H,hd); k,v: (B,Tk,KV,hd);
    mask: (Tq,Tk) or (B,Tq,Tk) bool or None."""
    b, tq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    sdt = torch_dtype(cfg.attn_score_dtype)
    qg = q.reshape(b, tq, kvh, g, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.to(sdt), k.to(sdt))
    scores = scores * _inv_sqrt(hd, sdt)
    if mask is not None:
        m = mask if mask.dim() == 3 else mask[None]
        scores = scores.masked_fill(~m[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(b, tq, h, hd)


def attend_blocked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   cfg: ModelConfig, *, is_global: bool = False,
                   causal: bool = True, q_offset: int = 0,
                   q_block: Optional[int] = None) -> torch.Tensor:
    """Query-blocked attention (never materializes S x S scores)."""
    q_block = q_block or cfg.attn_q_block
    s = q.shape[1]
    kpos = torch.arange(k.shape[1], device=q.device)
    outs = []
    for start in range(0, s, q_block):
        blk = q[:, start:start + q_block]
        qpos = torch.arange(blk.shape[1], device=q.device) + start + q_offset
        mask = _local_mask(qpos, kpos, cfg, is_global) if causal else None
        outs.append(gqa_attend(blk, k, v, mask, cfg))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


# -------------------------------------------------------------- decode path

def cache_size_for(cfg: ModelConfig, seq_len: int,
                   layer_has_global: bool) -> int:
    """Ring-cache slots a layer actually needs at decode time."""
    if layer_has_global:
        return seq_len
    size = seq_len
    if cfg.sliding_window is not None:
        size = min(size, cfg.sliding_window)
    if cfg.chunk_attn is not None:
        size = min(size, cfg.chunk_attn)
    return size


def init_kv_cache(cfg: ModelConfig, batch: int, size: int,
                  device=None) -> Params:
    """Empty ring cache. ``slot_pos`` holds each slot's absolute position
    (-1 = empty); keys are stored post-RoPE.  ``kv_cache_dtype="int8"``
    stores symmetric per-(slot, head) quantized entries + f32 scales."""
    kv, hd = cfg.n_kv_heads, cfg.hd
    cache: Params = {"slot_pos": torch.full((size,), -1, dtype=torch.int32,
                                            device=device)}
    shape = (batch, size, kv, hd)
    if cfg.kv_cache_dtype == "int8":
        for name in ("k", "v"):
            cache[name] = torch.zeros(shape, dtype=torch.int8, device=device)
            cache[f"{name}_scale"] = torch.zeros(
                (batch, size, kv, 1), dtype=torch.float32, device=device)
    else:
        cache["k"] = torch.zeros(shape, dtype=cfg.cdtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=cfg.cdtype, device=device)
    return cache


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per-(token, head) quantization over head_dim."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0,
                        min=1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def decode_attend(p: Params, x1: torch.Tensor, cache: Params, pos: int,
                  cfg: ModelConfig, is_global: bool = False,
                  use_rope: bool = True) -> Tuple[torch.Tensor, Params]:
    """One-token decode: write (k,v) at ``pos % size`` in place, attend
    the ring.  x1: (B, 1, d); pos: absolute position of the new token."""
    b = x1.shape[0]
    size = cache["k"].shape[1]
    q = project_q(p, x1, cfg)
    k1, v1 = project_kv(p, x1, cfg)
    # M-RoPE turns all three streams by the one position
    shape = (3, b, 1) if cfg.mrope else (b, 1)
    pos_b = torch.full(shape, pos, dtype=torch.int32, device=x1.device)
    q = maybe_rope(q, pos_b, cfg, use_rope)
    k1 = maybe_rope(k1, pos_b, cfg, use_rope)
    slot = pos % size
    cdt = cfg.cdtype
    if cfg.kv_cache_dtype == "int8":
        for name, x in (("k", k1), ("v", v1)):
            xq, xs = _quantize_kv(x)
            cache[name][:, slot] = xq[:, 0]
            cache[f"{name}_scale"][:, slot] = xs[:, 0]
        kc = cache["k"].to(cdt) * cache["k_scale"].to(cdt)
        vc = cache["v"].to(cdt) * cache["v_scale"].to(cdt)
    else:
        cache["k"][:, slot] = k1[:, 0]
        cache["v"][:, slot] = v1[:, 0]
        kc, vc = cache["k"], cache["v"]
    cache["slot_pos"][slot] = pos

    # ring mask from absolute slot positions
    sp = cache["slot_pos"]
    valid = (sp >= 0) & (sp <= pos)
    mask = valid
    if not is_global:
        if cfg.sliding_window is not None:
            mask = valid & (pos - sp < cfg.sliding_window)
        elif cfg.chunk_attn is not None:
            mask = valid & (sp // cfg.chunk_attn == pos // cfg.chunk_attn)
    out = gqa_attend(q, kc, vc, mask[None, None, :].expand(b, 1, size), cfg)
    return out_proj(p, out, cfg), cache


# --------------------------------------------------------------- train path

def self_attend(p: Params, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, *, is_global: bool = False,
                use_rope: bool = True,
                q_block: Optional[int] = None) -> torch.Tensor:
    """Full causal self-attention over x: (B, S, d)."""
    q = project_q(p, x, cfg)
    k, v = project_kv(p, x, cfg)
    q = maybe_rope(q, positions, cfg, use_rope)
    k = maybe_rope(k, positions, cfg, use_rope)
    if cfg.use_pallas_attn:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            raise NotImplementedError(
                "use_pallas_attn=True under autograd: the CUDA flash "
                "kernels compute the forward only, and so does the JAX "
                "package's Pallas kernel (jax.grad cannot differentiate "
                "it); train with use_pallas_attn=False, or run the forward "
                "under torch.no_grad()")
        o = fops.flash_attention(q, k, v, causal=True,
                                 window=cfg.sliding_window,
                                 chunk=cfg.chunk_attn, is_global=is_global)
    else:
        o = attend_blocked(q, k, v, cfg, is_global=is_global, causal=True,
                           q_block=q_block)
    return out_proj(p, o, cfg)


def cross_attend(p: Params, x: torch.Tensor,
                 enc_kv: Tuple[torch.Tensor, torch.Tensor],
                 cfg: ModelConfig) -> torch.Tensor:
    """Encoder-decoder cross attention: x (B, S, d) attends every
    encoder position of ``enc_kv`` (`precompute_cross_kv`), no mask, no
    RoPE, on the blocked route."""
    q = project_q(p, x, cfg)
    k, v = enc_kv
    o = attend_blocked(q, k, v, cfg, causal=False)
    return out_proj(p, o, cfg)


def precompute_cross_kv(p: Params, enc_out: torch.Tensor, cfg: ModelConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A decoder layer's cross-attention keys and values of the encoder's
    output (B, S_enc, d), in the compute dtype."""
    return project_kv(p, L.cast_to(enc_out, cfg.cdtype), cfg)
