"""Assigned input shapes and their meta-device specs: the port's
counterpart of the JAX package's ``configs/shapes.py``.

Four shapes per LM architecture (seq_len x global_batch):

    train_4k     4,096 x 256    training       -> train_step
    prefill_32k  32,768 x 32    inference      -> prefill_step
    decode_32k   32,768 x 128   decode         -> decode_step
                                                   (1 token, 32k KV cache)
    long_500k    524,288 x 1    long-context   -> decode_step; only for
                                                   sub-quadratic archs

``input_specs`` returns (args, in_roles): ``args`` are tensors on the
``meta`` device, which hold shapes and dtypes and allocate nothing (the
JAX package's ``ShapeDtypeStruct``s); ``in_roles`` mirror them with
logical sharding roles, each a plain list of axis names (tokens ->
batch, cache seq -> the "model" axis, etc.).

The port keeps a decoder LM's decode caches as a list of per-layer
dicts and an encoder-decoder's as ``{"self": [...], "cross": [...]}``
of per-layer dicts, where the JAX package stacks each group position's
layers on a leading axis; a cache leaf's roles here are the JAX
package's without that leading entry.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

# smoke-scale twins of the four shapes (same code paths, CPU-runnable)
SMOKE_SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 64, 4),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 128, 2),
    "decode_32k": ShapeSpec("decode_32k", "decode", 128, 4),
    "long_500k": ShapeSpec("long_500k", "decode", 256, 1),
}


def is_subquadratic(cfg: ModelConfig) -> bool:
    """long_500k applicability: any non-full-attention mechanism counts
    (SWA, chunked-local, SSM/recurrent blocks)."""
    if cfg.sliding_window is not None or cfg.chunk_attn is not None:
        return True
    return any(k != "attn" for k in cfg.group_pattern)


def shape_applies(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    if shape.name == "long_500k" and not is_subquadratic(cfg):
        return False, ("pure full-attention arch: 500k decode needs "
                       "sub-quadratic attention (skip noted in DESIGN.md)")
    return True, ""


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _token_batch(cfg: ModelConfig, b: int, s: int, with_targets: bool
                 ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    args = {"tokens": _spec((b, s), torch.int32)}
    roles = {"tokens": ["batch", None]}
    if with_targets:
        args["targets"] = _spec((b, s), torch.int32)
        roles["targets"] = ["batch", None]
    if cfg.enc_dec:
        args["frames"] = _spec((b, cfg.enc_seq, cfg.d_model), torch.float32)
        roles["frames"] = ["batch", None, None]
    if cfg.mrope:
        args["positions"] = _spec((3, b, s), torch.int32)
        roles["positions"] = [None, "batch", None]
        n_patch = min(1024, s // 2)
        args["patch_embeds"] = _spec((b, n_patch, cfg.d_model),
                                     torch.float32)
        roles["patch_embeds"] = ["batch", None, None]
    return args, roles


def map_with_path(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """``tree`` (nested dicts, lists and tuples) with each leaf replaced by
    ``fn(path, leaf)``, the path its keys and indices joined by "/" (the
    JAX package's ``keystr(simple=True, separator="/")``)."""
    path = lambda key: f"{prefix}/{key}" if prefix else str(key)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _cache_roles(caches_abs):
    """Logical roles for decode-cache leaves: batch on DP axes, the big
    sequence dim of KV rings on the "model" axis (sequence-sharded cache),
    wide state dims on "model".  Each leaf is one layer's (the JAX
    package's roles less their leading group entry)."""

    def role_for(path, leaf):
        name = path.rsplit("/", 1)[-1]
        nd = len(leaf.shape)
        if name in ("k", "v", "k_scale", "v_scale"):  # (B, S, KV, *)
            return ["batch", "seq_model", None, None]
        if name == "slot_pos":            # (S,)
            return ["seq_model"]
        if name in ("ck", "cv"):          # whisper cross kv (B,Se,KV,hd)
            return ["batch", None, None, None]
        if name == "conv":                # (B, dc-1, inner)
            return ["batch", None, "model"]
        if name == "ssm":                 # (B, inner, N)
            return ["batch", "model", None]
        if name == "c" and nd == 4:       # mlstm (B, H, hd, hd)
            return ["batch", None, "model", None]
        if name == "n" and nd == 3:       # mlstm (B, H, hd)
            return ["batch", None, "model"]
        if nd >= 1:                       # slstm (B, d) & friends
            return ["batch"] + ["model" if i == 1 and nd == 2 else None
                                for i in range(1, nd)]
        return []

    return map_with_path(role_for, caches_abs)


def input_specs(cfg: ModelConfig, shape: ShapeSpec
                ) -> Tuple[Tuple[Any, ...], Tuple[Any, ...]]:
    """(args, roles) for the step function of ``shape.kind``.

    * train:   (batch,)                      for train_step(state, batch)
    * prefill: (batch,)                      for prefill_step(params, batch)
    * decode:  (caches, tokens, pos)         for decode_step(params, ...)
    """
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        args, roles = _token_batch(cfg, b, s, with_targets=True)
        return (args,), (roles,)
    if shape.kind == "prefill":
        args, roles = _token_batch(cfg, b, s, with_targets=False)
        return (args,), (roles,)
    if shape.kind == "decode":
        if cfg.enc_dec:
            enc_abs = _spec((b, cfg.enc_seq, cfg.d_model), torch.float32)
            params_abs = E.build_encdec(None, cfg, META)
            caches_abs = E.init_caches(params_abs, enc_abs, cfg, b, s)
        else:
            caches_abs = T.init_caches(cfg, b, s, META)
        tokens = _spec((b, 1), torch.int32)
        pos = _spec((), torch.int32)
        c_roles = _cache_roles(caches_abs)
        return ((caches_abs, tokens, pos),
                (c_roles, ["batch", None], None))
    raise ValueError(shape.kind)
