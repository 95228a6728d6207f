"""Encoder-decoder backbone (whisper-tiny): the port's counterpart of the
JAX package's ``models/encdec.py``.

The conv/mel frontend is a stub: the encoder takes precomputed frame
embeddings (B, S_enc, d), adds sinusoidal positions and runs a
transformer encoder (no mask).  The decoder is a causal transformer with
cross attention over the encoder's output; its token positions are
sinusoidal too (whisper learns them; shape and FLOPs are identical).

The parameters are an `EncDec` module: ``embed`` (tied with the head),
``enc_blocks`` and ``enc_final_norm``, then the decoder's ``blocks`` and
``final_norm``, each block's leaf sets named as the JAX pytree's (the
JAX package stacks the layers on a leading axis and scans them; the port
loops over them in Python).  Entry points:

* ``encode(params, frames, cfg)``             -> encoder states
* ``forward_train(params, batch, cfg)``       -> logits (B, S, Vp)
* ``lm_loss(params, batch, cfg)``             -> loss, {"nll"}
* ``forward_prefill(params, batch, cfg)``     -> logits, decode caches
* ``init_caches(params, enc_out, cfg, b, s)`` -> decode caches
* ``decode_step(params, caches, tokens, pos, cfg)`` -> logits, caches

A batch is ``{"frames": (B, S_enc, d), "tokens": (B, S)}`` (and
``"targets"`` for the loss).  The decoder's self attention takes the
flash route under ``cfg.use_pallas_attn``; the encoder and the cross
attention take the blocked route, as in the JAX package.  Decode caches
are ``{"self": [a ring cache per layer], "cross": [{"ck", "cv"} per
layer]}``: the ring caches are written in place, the cross keys and
values are projected once from the encoder's output.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import sharding as PS

Params = Dict[str, torch.Tensor]

# each stack's leaf sets, as the JAX package's ``_init_enc_block`` /
# ``_init_dec_block`` make them
ENC_NAMES = ("attn_norm", "attn", "mlp_norm", "mlp")
DEC_NAMES = ("attn_norm", "attn", "cross_norm", "cross", "mlp_norm", "mlp")


# ------------------------------------------------------------ positions

def _angles(pos: torch.Tensor, d: int) -> torch.Tensor:
    """(len(pos), d/2) float32 angles ``pos / 10000**(2*dim/d)`` as the
    JAX package rounds them: the exponent in float32, the power correctly
    rounded to float32 (XLA's CPU power gives that value at every width
    the configurations use; PyTorch's float32 ``pow`` is an ulp off on a
    few), then a float32 division."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=pos.device)
    den = torch.pow(torch.tensor(10000.0, dtype=torch.float64,
                                 device=pos.device),
                    (2 * dim / d).double()).float()
    return pos.float()[:, None] / den[None, :]


def _sin_cos(ang: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``[sin, cos]`` of float32 angles, each correctly rounded to
    float32 (computed in float64: the same on the CPU and the card; XLA's
    float32 sin/cos is within an ulp of it), then cast to ``dtype``."""
    a = ang.double()
    return torch.cat([torch.sin(a), torch.cos(a)], dim=-1).float().to(dtype)


def sinusoid(seq: int, d: int, dtype, device=None) -> torch.Tensor:
    """(seq, d) sinusoidal positions of 0 .. seq - 1."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)
    return _sin_cos(_angles(pos, d), dtype)


def _pos_embed_at(pos: int, cfg: ModelConfig, device=None) -> torch.Tensor:
    """(1, 1, d) sinusoidal position of the absolute position ``pos``."""
    p = torch.tensor([pos], dtype=torch.float32, device=device)
    return _sin_cos(_angles(p, cfg.d_model), cfg.cdtype)[None]


# ----------------------------------------------------------------- init

class Leaves(nn.Module):
    """One block's leaf sets (``names``), each an ``nn.ParameterDict``
    named as the JAX pytree's."""

    def __init__(self, groups: Dict[str, Params], names: Sequence[str]):
        super().__init__()
        if set(groups) != set(names):
            raise ValueError(f"a block holds {sorted(groups)}, not "
                             f"{sorted(names)}")
        for name in names:
            setattr(self, name, T._param_dict(groups[name]))


class EncDec(nn.Module):
    """An encoder-decoder's parameters: ``embed`` (tied head),
    ``enc_blocks``, ``enc_final_norm``, ``blocks`` (the decoder) and
    ``final_norm``."""

    def __init__(self, embed: Params, enc_blocks: List[Dict[str, Params]],
                 enc_final_norm: Params, blocks: List[Dict[str, Params]],
                 final_norm: Params):
        super().__init__()
        self.embed = T._param_dict(embed)
        self.enc_blocks = nn.ModuleList(Leaves(b, ENC_NAMES)
                                        for b in enc_blocks)
        self.enc_final_norm = T._param_dict(enc_final_norm)
        self.blocks = nn.ModuleList(Leaves(b, DEC_NAMES) for b in blocks)
        self.final_norm = T._param_dict(final_norm)


def _check_encdec(cfg: ModelConfig) -> None:
    if not cfg.enc_dec:
        raise ValueError(f"{cfg.name} is not an encoder-decoder: build it "
                         "with transformer.init_lm")


def _init_block(gen, cfg: ModelConfig, dev, names) -> Dict[str, Params]:
    f32 = torch.float32
    p = {}
    for name in names:
        if name.endswith("norm"):
            p[name] = L.init_norm(cfg.norm, cfg.d_model, f32, dev)
        elif name in ("attn", "cross"):
            p[name] = A.init_attention(gen, cfg, dev, cross=name == "cross")
        else:
            p[name] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation,
                                 cfg.pdtype, dev)
    return p


def init_encdec(gen: torch.Generator, cfg: ModelConfig,
                device="cuda") -> EncDec:
    """Random parameters from ``gen`` (a generator on ``device``): the
    embedding, the encoder's blocks, then the decoder's (each block's
    attention, cross attention and MLP in that order).  The numbers
    differ from the JAX package's threefry draws; carry its parameters
    across with `interop.encdec_params_from_numpy` to compare."""
    return build_encdec(gen, cfg, resolve_device(device))


@torch.no_grad()
def build_encdec(gen: Optional[torch.Generator], cfg: ModelConfig,
                 dev: torch.device) -> EncDec:
    """`init_encdec` on a resolved device; on the ``meta`` device (``gen``
    None) it gives shapes and dtypes and allocates nothing."""
    _check_encdec(cfg)
    embed = L.init_embedding(gen, cfg.padded_vocab, cfg.d_model, cfg.pdtype,
                             dev)
    enc = [_init_block(gen, cfg, dev, ENC_NAMES)
           for _ in range(cfg.n_enc_layers)]
    dec = [_init_block(gen, cfg, dev, DEC_NAMES)
           for _ in range(cfg.n_layers)]
    norm = lambda: L.init_norm(cfg.norm, cfg.d_model, torch.float32, dev)
    return EncDec(embed, enc, norm(), dec, norm())


# -------------------------------------------------------------- encoder

def encode(params: EncDec, frames: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, S_enc, d) stub embeddings -> encoder states."""
    _, s, d = frames.shape
    x = L.cast_to(frames, cfg.cdtype) + sinusoid(s, d, cfg.cdtype,
                                                 frames.device)[None]
    x = PS.activations(x)
    for p in params.enc_blocks:
        h = L.apply_norm(cfg.norm, p.attn_norm, x)
        q = A.project_q(p.attn, h, cfg)
        k, v = A.project_kv(p.attn, h, cfg)
        o = A.attend_blocked(q, k, v, cfg, causal=False)
        x = x + A.out_proj(p.attn, o, cfg)
        h = L.apply_norm(cfg.norm, p.mlp_norm, x)
        x = PS.activations(x + L.apply_mlp(p.mlp, h, cfg))
    return L.apply_norm(cfg.norm, params.enc_final_norm, x)


# -------------------------------------------------------------- decoder

def _dec_block(p: Leaves, x: torch.Tensor, enc_out: torch.Tensor,
               cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    h = L.apply_norm(cfg.norm, p.attn_norm, x)
    x = x + A.self_attend(p.attn, h, positions, cfg)
    h = L.apply_norm(cfg.norm, p.cross_norm, x)
    enc_kv = A.precompute_cross_kv(p.cross, enc_out, cfg)
    x = x + A.cross_attend(p.cross, h, enc_kv, cfg)
    h = L.apply_norm(cfg.norm, p.mlp_norm, x)
    return x + L.apply_mlp(p.mlp, h, cfg)


def decode_forward(params: EncDec, tokens: torch.Tensor,
                   enc_out: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The decoder's teacher-forced forward over ``tokens`` (B, S) against
    the encoder states ``enc_out``: logits (B, S, padded_vocab), under the
    caller's grad mode, ``cfg.remat`` per decoder layer
    (`transformer._maybe_remat`)."""
    b, s = tokens.shape
    x = L.embed(params.embed, tokens, cfg.cdtype)
    x = x + sinusoid(s, cfg.d_model, cfg.cdtype, tokens.device)[None]
    x = PS.activations(x)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    layer = T._maybe_remat(_dec_block, cfg)
    for p in params.blocks:
        x = PS.activations(layer(p, x, enc_out, cfg, positions))
    x = L.apply_norm(cfg.norm, params.final_norm, x)
    return L.unembed(None, params.embed, x, cfg.cdtype)


def forward_train(params: EncDec, batch: Dict[str, torch.Tensor],
                  cfg: ModelConfig) -> torch.Tensor:
    """batch: {"frames": (B, S_enc, d), "tokens": (B, S)} -> logits: the
    encoder, then the decoder (`decode_forward`)."""
    enc_out = encode(params, batch["frames"], cfg)
    return decode_forward(params, batch["tokens"], enc_out, cfg)


def lm_loss(params: EncDec, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token NLL over ``batch["targets"]`` (B, S): the float32
    logits' ``logsumexp`` over the padded vocabulary less the gold logit
    (a gather, bit-equal to the JAX package's iota-mask sum).  Returns
    ``(nll, {"nll": nll})``; under a batch split of n slices
    (`parallel.sharding.split_batch`) this slice's share, its mean over
    n."""
    logits32 = forward_train(params, batch, cfg).float()
    lse = torch.logsumexp(logits32, dim=-1)
    gold = torch.gather(logits32, -1,
                        batch["targets"].long()[..., None])[..., 0]
    nll = torch.mean(lse - gold)
    if PS.split_ranks() > 1:
        nll = nll / nll.new_tensor(float(PS.split_ranks()))
    return nll, {"nll": nll}


# --------------------------------------------------------------- decode

@torch.no_grad()
def init_caches(params: EncDec, enc_out: torch.Tensor, cfg: ModelConfig,
                batch: int, seq_len: int) -> Dict[str, List[Params]]:
    """An empty ring cache of ``seq_len`` slots per decoder layer and its
    cross-attention keys and values of ``enc_out``, on its device."""
    _check_encdec(cfg)
    dev = enc_out.device
    cross = []
    for p in params.blocks:
        ck, cv = A.precompute_cross_kv(p.cross, enc_out, cfg)
        cross.append({"ck": ck, "cv": cv})
    return {"self": [A.init_kv_cache(cfg, batch, seq_len, dev)
                     for _ in range(cfg.n_layers)],
            "cross": cross}


def _decode_layers(params: EncDec, caches: Dict[str, List[Params]],
                   tokens: torch.Tensor, pos: int,
                   cfg: ModelConfig) -> torch.Tensor:
    """Embed one token per row at ``pos`` and run it through every
    decoder layer, writing each ring cache in place; returns the last
    layer's activations."""
    x = L.embed(params.embed, tokens, cfg.cdtype)
    x = x + _pos_embed_at(pos, cfg, tokens.device)
    x = PS.constrain(x, ["batch", None, None])
    for p, sc, cc in zip(params.blocks, caches["self"], caches["cross"]):
        h = L.apply_norm(cfg.norm, p.attn_norm, x)
        y, _ = A.decode_attend(p.attn, h, sc, pos, cfg)
        x = x + y
        h = L.apply_norm(cfg.norm, p.cross_norm, x)
        x = x + A.cross_attend(p.cross, h, (cc["ck"], cc["cv"]), cfg)
        h = L.apply_norm(cfg.norm, p.mlp_norm, x)
        x = x + L.apply_mlp(p.mlp, h, cfg)
    return x


@torch.no_grad()
def decode_step(params: EncDec, caches: Dict[str, List[Params]],
                tokens: torch.Tensor, pos: int, cfg: ModelConfig):
    """One decode step. tokens: (B, 1); pos: absolute position.  Returns
    (logits (B, 1, Vp), caches), the ring caches updated in place."""
    x = _decode_layers(params, caches, tokens, pos, cfg)
    x = L.apply_norm(cfg.norm, params.final_norm, x)
    return L.unembed(None, params.embed, x, cfg.cdtype), caches


@torch.no_grad()
def forward_prefill(params: EncDec, batch: Dict[str, torch.Tensor],
                    cfg: ModelConfig, cache_len: Optional[int] = None):
    """Prefill: the encoder once, whose output feeds both the decoder's
    forward (the prompt's logits) and `init_caches`; the ring caches are
    then filled by replaying the prompt one token at a time (exact), as
    the JAX serve fills them.  The replay skips the per-step
    unembedding, whose logits it would discard.  Returns (logits,
    caches)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    enc_out = encode(params, batch["frames"], cfg)
    caches = init_caches(params, enc_out, cfg, b, cache_len or s)
    logits = decode_forward(params, tokens, enc_out, cfg)
    for t in range(s):
        _decode_layers(params, caches, tokens[:, t:t + 1], t, cfg)
    return logits, caches
