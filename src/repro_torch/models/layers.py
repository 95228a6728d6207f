"""Shared primitive layers: norms, MLPs, rotary embeddings, initializers.

The port's counterpart of the JAX package's ``models/layers.py``.  Every
layer is a pair ``init_*(generator, ...) -> params`` and
``apply_*(params, x, ...) -> y`` over a dict of tensors (an
``nn.ParameterDict`` inside the model).  Parameters are stored in
``cfg.param_dtype`` and cast to ``cfg.compute_dtype`` at use; norm and
rotary math run in float32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.parallel import sharding as PS

Params = Dict[str, torch.Tensor]


# ----------------------------------------------------------------- numerics

def cast_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype) if x.dtype != dtype else x


def wcast(p: Params, name: str, cfg, roles) -> torch.Tensor:
    """A weight cast to the compute dtype; with ``cfg.gather_weights``,
    constrained to ``roles`` (the JAX package drops the weight's FSDP
    sharding here: a ZeRO-3 weight all-gather instead of XLA's
    activation-partial sums).  Under the port's sharded step ``p`` holds
    weights gathered whole already (`parallel.sharding.at_use`), so the
    constraint places nothing."""
    w = cast_to(p[name], cfg.cdtype)
    if cfg.gather_weights:
        w = PS.constrain(w, roles)
    return w


def he_init(gen: torch.Generator, shape, dtype, fan_in: Optional[int] = None,
            device=None) -> torch.Tensor:
    fan = fan_in if fan_in is not None else shape[0]
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * (1.0 / math.sqrt(max(fan, 1)))).to(dtype)


# -------------------------------------------------------------------- norms

def init_norm(kind: str, d: int, dtype, device=None) -> Params:
    if kind == "rmsnorm":                                   # gemma-style (1+s)
        return {"scale": torch.zeros(d, dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.zeros(d, dtype=dtype, device=device),
                "bias": torch.zeros(d, dtype=dtype, device=device)}
    raise ValueError(kind)


def apply_norm(kind: str, p: Params, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * (1.0 + p["scale"].float())
    elif kind == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = ((xf - mu) * torch.rsqrt(var + eps) * (1.0 + p["scale"].float())
             + p["bias"].float())
    else:
        raise ValueError(kind)
    return y.to(x.dtype)


# --------------------------------------------------------------------- MLPs

def init_mlp(gen: torch.Generator, d: int, ff: int, activation: str, dtype,
             device=None) -> Params:
    """Draws in the order w_gate, w_in, w_out (the plain gelu MLP skips
    w_gate)."""
    p: Params = {}
    if activation in ("swiglu", "geglu"):
        p["w_gate"] = he_init(gen, (d, ff), dtype, fan_in=d, device=device)
    p["w_in"] = he_init(gen, (d, ff), dtype, fan_in=d, device=device)
    p["w_out"] = he_init(gen, (ff, d), dtype, fan_in=ff, device=device)
    return p


def apply_mlp(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    activation = cfg.activation
    x = cast_to(x, cfg.cdtype)
    w_in, w_out = wcast(p, "w_in", cfg, [None, "model"]), \
        wcast(p, "w_out", cfg, ["model", None])
    if activation == "swiglu":
        h = F.silu(x @ wcast(p, "w_gate", cfg, [None, "model"])) * (x @ w_in)
    elif activation == "geglu":
        h = F.gelu(x @ wcast(p, "w_gate", cfg, [None, "model"]),
                   approximate="tanh") * (x @ w_in)
    elif activation == "gelu":
        h = F.gelu(x @ w_in, approximate="tanh")
    else:
        raise ValueError(activation)
    return h @ w_out


# ------------------------------------------------------------------- rotary

def rope_freqs(hd_rot: int, theta: float, device=None) -> torch.Tensor:
    """(hd_rot/2,) inverse frequencies."""
    exps = torch.arange(0, hd_rot, 2, dtype=torch.float32,
                        device=device) / hd_rot
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rotary_pct: float = 1.0) -> torch.Tensor:
    """Rotate the first ``rotary_pct`` fraction of head_dim.

    x: (..., S, H, hd); positions: broadcastable to (..., S).
    """
    hd = x.shape[-1]
    hd_rot = int(hd * rotary_pct) // 2 * 2
    if hd_rot == 0:
        return x
    xr, xp = x[..., :hd_rot], x[..., hd_rot:]
    freqs = rope_freqs(hd_rot, theta, device=x.device)     # (hd_rot/2,)
    ang = positions[..., None].float() * freqs              # (..., S, hd/2)
    ang = ang[..., None, :]                                 # (..., S, 1, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(xr.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


def mrope_widths(hd: int, sections: Tuple[int, int, int]) -> List[int]:
    """The (t, h, w) widths of M-RoPE's ``hd // 2`` frequency slots:
    each section scaled to the half head dim and rounded (Python's
    ``round``), the last taking what the others leave."""
    half = hd // 2
    scale = half / sum(sections)
    widths = [int(round(s * scale)) for s in sections]
    widths[-1] = half - sum(widths[:-1])
    return widths


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL M-RoPE: head_dim/2 frequency slots split into (t, h, w)
    sections (`mrope_widths`), each rotated by its own position stream;
    the whole head dim turns.

    x: (B, S, H, hd); positions3: (3, B, S).
    """
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)          # (half,)
    slot = torch.cat([torch.full((w,), comp, dtype=torch.long)
                      for comp, w in enumerate(mrope_widths(hd, sections))])
    pos = positions3.float()[slot.to(positions3.device)]    # (half, B, S)
    ang = (pos * freqs[:, None, None]).permute(1, 2, 0)     # (B, S, half)
    ang = ang[..., None, :]                                 # (B, S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- embedding

def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype,
                   device=None) -> Params:
    table = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                        device=device)
    return {"table": table.to(dtype) * 0.02}


def embed(p: Params, tokens: torch.Tensor, cdtype,
          scale: bool = False) -> torch.Tensor:
    x = cast_to(p["table"][tokens], cdtype)    # gather, then cast the rows
    if scale:   # sqrt(d) rounded to float32, then to the compute dtype
        root = torch.tensor(math.sqrt(p["table"].shape[-1]),
                            dtype=torch.float32)
        x = x * float(root.to(cdtype))
    return x


def unembed(p_head: Optional[Params], p_embed: Params, x: torch.Tensor,
            cdtype, softcap: Optional[float] = None) -> torch.Tensor:
    if p_head is not None:
        logits = cast_to(x, cdtype) @ cast_to(p_head["w"], cdtype)
    else:  # tied
        logits = cast_to(x, cdtype) @ cast_to(p_embed["table"], cdtype).T
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    return logits
