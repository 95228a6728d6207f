"""Decoder-LM assembly over attention blocks: the port's counterpart of
the JAX package's ``models/transformer.py``.

The parameters are an `LM` module: the embedding, the final norm, an
optional untied head and one `Block` per layer in layer order (the JAX
package stacks layer groups on a leading axis and scans them; the port
loops over the layers in Python).  Each block's parameters sit in
``nn.ParameterDict``s named as the JAX pytree's leaves.  Parameters
require gradients: `forward_train` and `lm_loss` run under whatever grad
mode the caller sets, as the JAX functions do under ``jax.grad``, with
``cfg.remat`` applied per layer (`_maybe_remat`).  The serving entry
points run under ``torch.no_grad()``, so serving allocates nothing for
autograd.

Five entry points:

* ``forward_train(params, batch, cfg)``   -> logits (B, S, Vp)
* ``forward_train_aux(params, batch, cfg)`` -> logits, MoE terms (the
  JAX package's ``forward_train``)
* ``lm_loss(params, batch, cfg)``         -> loss, metrics
* ``forward_prefill(params, batch, cfg)`` -> logits, decode caches
* ``decode_step(params, caches, tokens, pos, cfg)`` -> logits, caches

Four block kinds, as in the JAX package: ``"attn"`` and ``"mamba"``
(`models.ssm`) blocks, each followed by a dense MLP or, on the layers
``cfg.layer_is_moe`` names, a Mixture-of-Experts FFN (`models.moe`) whose
auxiliary terms are summed over the layers for `lm_loss`; ``"mlstm"``
and ``"slstm"`` blocks are self-contained (the sLSTM's post-FFN is part
of its cell).  An encoder-decoder configuration is built and served by
`models.encdec` and raises here naming it.  Decode caches are a list with one entry per layer: an attention
layer's ring cache, updated in place, or a recurrent layer's state as a
dict of its fields, replaced each step.
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import sharding as PS

Params = Dict[str, torch.Tensor]


def _check_supported(cfg: ModelConfig) -> None:
    for kind in cfg.group_pattern:
        if kind not in BLOCK_NAMES:
            raise ValueError(f"unknown block kind {kind!r}")
    if cfg.moe is not None and cfg.group_size % cfg.moe.every_n_layers:
        raise ValueError("moe.every_n_layers must divide group size")
    if cfg.enc_dec:
        raise NotImplementedError(
            f"{cfg.name} is an encoder-decoder: its parameters come from "
            "models.encdec.init_encdec and its decode caches from "
            "encdec.init_caches, not the decoder-LM assembly")


def _param_dict(tensors: Params) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(t) for k, t in tensors.items()})


# each block kind's leaf sets; "attn" and "mamba" blocks add "mlp" or "moe"
BLOCK_NAMES = {"attn": ("attn_norm", "attn", "mlp_norm"),
               "mamba": ("attn_norm", "mamba", "mlp_norm"),
               "mlstm": ("norm", "cell"),
               "slstm": ("norm", "ff_norm", "cell")}
FFN_KINDS = ("attn", "mamba")


def block_names(kind: str, layer_is_moe: bool) -> Tuple[str, ...]:
    """The leaf sets of a ``kind`` block, as the JAX package's
    ``_init_block`` makes them."""
    if kind not in FFN_KINDS:
        return BLOCK_NAMES[kind]
    return (*BLOCK_NAMES[kind], "moe" if layer_is_moe else "mlp")


class Block(nn.Module):
    """One block, its leaf sets named as the JAX package's: an attention
    or mamba block (``attn_norm``, ``attn`` or ``mamba``, ``mlp_norm``,
    then ``mlp`` (dense) or ``moe``), an mLSTM block (``norm``, ``cell``)
    or an sLSTM block (``norm``, ``ff_norm``, ``cell``)."""

    def __init__(self, groups: Dict[str, Params]):
        super().__init__()
        allowed = [block_names(kind, moe) for kind in BLOCK_NAMES
                   for moe in (False, True)]
        names = next((n for n in allowed if set(groups) == set(n)), None)
        if names is None:
            raise ValueError(f"a block holds {sorted(groups)}: one of "
                             f"{sorted({tuple(sorted(n)) for n in allowed})}")
        for name in names:
            setattr(self, name, _param_dict(groups[name]))


class LM(nn.Module):
    """A decoder LM's parameters: ``embed``, ``final_norm``, ``head``
    (None when tied) and ``blocks`` in layer order."""

    def __init__(self, embed: Params, final_norm: Params,
                 head: Optional[Params], blocks: List[Dict[str, Params]]):
        super().__init__()
        self.embed = _param_dict(embed)
        self.final_norm = _param_dict(final_norm)
        self.head = None if head is None else _param_dict(head)
        self.blocks = nn.ModuleList(Block(b) for b in blocks)


# ===========================================================================
# init
# ===========================================================================

def _init_block(gen: torch.Generator, cfg: ModelConfig, device, kind: str,
                layer_is_moe: bool) -> Dict[str, Params]:
    f32 = torch.float32
    norm = lambda: L.init_norm(cfg.norm, cfg.d_model, f32, device)
    if kind == "mlstm":
        return {"norm": norm(), "cell": SSM.init_mlstm(gen, cfg, device)}
    if kind == "slstm":
        return {"norm": norm(), "ff_norm": norm(),
                "cell": SSM.init_slstm(gen, cfg, device)}
    if kind == "attn":
        p = {"attn_norm": norm(), "attn": A.init_attention(gen, cfg, device)}
    elif kind == "mamba":
        p = {"attn_norm": norm(), "mamba": SSM.init_mamba(gen, cfg, device)}
    else:
        raise ValueError(kind)
    p["mlp_norm"] = norm()
    if layer_is_moe:
        p["moe"] = MOE.init_moe(gen, cfg, device)
    else:
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation,
                              cfg.pdtype, device)
    return p


def group_flags(cfg: ModelConfig) -> torch.Tensor:
    """(n_groups, G) bool — per-layer 'global attention' flag (llama4)."""
    flags = torch.zeros((cfg.n_groups, cfg.group_size), dtype=torch.bool)
    for li in range(cfg.n_layers):
        flags[li // cfg.group_size, li % cfg.group_size] = \
            cfg.layer_is_global_attn(li)
    return flags


def init_lm(gen: torch.Generator, cfg: ModelConfig, device="cuda") -> LM:
    """Random parameters from ``gen`` (a generator on ``device``): the
    embedding, the head when untied, then each layer in order.  The
    numbers differ from the JAX package's threefry draws; carry its
    parameters across with `interop.lm_params_from_numpy` to compare."""
    return build_lm(gen, cfg, resolve_device(device))


@torch.no_grad()
def build_lm(gen: Optional[torch.Generator], cfg: ModelConfig,
             dev: torch.device) -> LM:
    """`init_lm` on a resolved device; on the ``meta`` device (``gen``
    None) it gives shapes and dtypes and allocates nothing."""
    _check_supported(cfg)
    embed = L.init_embedding(gen, cfg.padded_vocab, cfg.d_model, cfg.pdtype,
                             dev)
    head = None
    if not cfg.tie_embeddings:
        head = {"w": L.he_init(gen, (cfg.d_model, cfg.padded_vocab),
                               cfg.pdtype, fan_in=cfg.d_model, device=dev)}
    blocks = [_init_block(gen, cfg, dev, cfg.block_kind(li % cfg.group_size),
                          cfg.layer_is_moe(li))
              for li in range(cfg.n_layers)]
    final_norm = L.init_norm(cfg.norm, cfg.d_model, torch.float32, dev)
    return LM(embed, final_norm, head, blocks)


# ===========================================================================
# forward (train / prefill)
# ===========================================================================

class ScanAux(NamedTuple):
    """The MoE auxiliary terms, summed over the layers."""

    lb_loss: torch.Tensor
    z_loss: torch.Tensor
    dropped: torch.Tensor


@functools.lru_cache(maxsize=None)
def zero_aux(device: torch.device) -> ScanAux:
    """A dense layer's terms (the JAX package's ``ZERO_AUX``), made once
    for each device: nothing writes to them, so the decode step of a
    dense model launches no kernel for them (normal tensors, also when
    first asked for under ``torch.inference_mode``)."""
    with torch.inference_mode(False):
        return ScanAux(*(torch.zeros((), device=device) for _ in range(3)))


def _apply_mlp_or_moe(p: Block, x: torch.Tensor, cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, ScanAux]:
    """The FFN half of a block: (x + FFN(norm(x)), the MoE terms, zeros
    on a dense layer)."""
    h = L.apply_norm(cfg.norm, p.mlp_norm, x)
    if hasattr(p, "moe"):
        y, aux = MOE.apply_moe(p.moe, h, cfg)
        return x + y, ScanAux(*aux)
    return x + L.apply_mlp(p.mlp, h, cfg), zero_aux(x.device)


def _block_train(p: Block, x: torch.Tensor, kind: str, cfg: ModelConfig,
                 positions: torch.Tensor, is_global: bool
                 ) -> Tuple[torch.Tensor, ScanAux]:
    p = PS.at_use(p)     # inside the remat: gathered again to recompute
    if kind == "attn":
        h = L.apply_norm(cfg.norm, p.attn_norm, x)
        # llama4: NoPE on global layers
        x = x + A.self_attend(p.attn, h, positions, cfg, is_global=is_global,
                              use_rope=not is_global)
        return _apply_mlp_or_moe(p, x, cfg)
    x, _, aux = _recurrent_block(p, x, kind, cfg, None)
    return x, aux


def _recurrent_block(p: Block, x: torch.Tensor, kind: str, cfg: ModelConfig,
                     state: Optional[tuple]):
    """A mamba, mLSTM or sLSTM block over x: (B, T, d) from ``state``
    (None: the zero state) -> (x, the new state, the MoE terms).  The
    sLSTM block adds the cell on ``norm(x)``, then its post-FFN on
    ``ff_norm`` of the sum."""
    if kind == "mamba":
        h = L.apply_norm(cfg.norm, p.attn_norm, x)
        y, state = SSM.apply_mamba(p.mamba, h, cfg, state)
        x, aux = _apply_mlp_or_moe(p, x + y, cfg)
        return x, state, aux
    if kind == "mlstm":
        h = L.apply_norm(cfg.norm, p.norm, x)
        y, state = SSM.apply_mlstm(p.cell, h, cfg, state)
        return x + y, state, zero_aux(x.device)
    if kind == "slstm":
        h = L.apply_norm(cfg.norm, p.norm, x)
        y, state = SSM.apply_slstm_cell(p.cell, h, cfg, state)
        x = x + y
        h2 = L.apply_norm(cfg.norm, p.ff_norm, x)
        return x + SSM.slstm_ffn(p.cell, h2, cfg), state, zero_aux(x.device)
    raise ValueError(kind)


def _save_dots(ctx, op, *args, **kwargs) -> ckpt.CheckpointPolicy:
    """Save the products with no batch dimension, as JAX's
    ``dots_with_no_batch_dims_saveable`` does: the weight products, which
    a (B, S, d) @ (d, f) product reaches as ``mm`` (attention's einsums
    reach ``bmm``)."""
    if op is torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, cfg: ModelConfig):
    """``cfg.remat`` over one layer (the JAX package's ``_maybe_remat``
    over a scanned group; a dense group is one layer): ``"block"`` keeps
    only the layer's input and recomputes the rest in the backward pass,
    ``"dots"`` also keeps the weight products, ``"none"`` keeps all.
    Without grad mode the layer runs as is."""
    if cfg.remat == "none":
        return fn
    context_fn = ckpt.noop_context_fn      # "block"
    if cfg.remat == "dots":
        context_fn = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return ckpt.checkpoint(fn, *args, use_reentrant=False,
                               context_fn=context_fn)

    return run


def backbone(params: LM, x: torch.Tensor, cfg: ModelConfig,
             positions: torch.Tensor) -> Tuple[torch.Tensor, ScanAux]:
    """Run every layer over embedded activations x: (B, S, d); returns
    the activations and the MoE terms summed over the layers (zeros for a
    dense model)."""
    flags = group_flags(cfg).tolist()
    layer = _maybe_remat(_block_train, cfg)
    aux = zero_aux(x.device)
    for li, block in enumerate(params.blocks):
        g, pos = divmod(li, cfg.group_size)
        x, a = layer(block, x, cfg.block_kind(pos), cfg, positions,
                     flags[g][pos])
        aux = ScanAux(*(t + u for t, u in zip(aux, a)))
        x = PS.activations(x)
    return x, aux


def forward_train_aux(params: LM, batch: Dict[str, torch.Tensor],
                      cfg: ModelConfig) -> Tuple[torch.Tensor, ScanAux]:
    """The JAX package's ``forward_train``: logits (B, S, padded_vocab) of
    the teacher-forced forward over ``batch["tokens"]`` (B, S), under the
    caller's grad mode, and the MoE terms summed over the layers.

    A VLM batch (qwen2-vl) may carry ``patch_embeds`` (B, P, d), which
    take the first P token slots in the compute dtype (the vision tower
    is a stub, as in the JAX package), and, with ``cfg.mrope``,
    ``positions`` (3, B, S); without them each stream is ``arange(S)``.
    Without ``cfg.mrope`` the positions are ``arange(S)`` whatever the
    batch holds."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    params = PS.at_use(params)
    x = L.embed(params.embed, tokens, cfg.cdtype, scale=cfg.embed_scale)
    if "patch_embeds" in batch:
        patches = L.cast_to(batch["patch_embeds"], cfg.cdtype)
        x = torch.cat([patches, x[:, patches.shape[1]:]], dim=1)
    x = PS.activations(x)
    if cfg.mrope:
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(s, device=tokens.device).expand(3, b, s)
    else:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    x, aux = backbone(params, x, cfg, positions)
    x = L.apply_norm(cfg.norm, params.final_norm, x)
    logits = L.unembed(params.head, params.embed, x, cfg.cdtype,
                       softcap=cfg.logit_softcap)
    return PS.constrain(logits, ["batch", None, "model"]), aux


def forward_train(params: LM, batch: Dict[str, torch.Tensor],
                  cfg: ModelConfig) -> torch.Tensor:
    """The logits of `forward_train_aux` alone: what serving, the prefill
    step and the tests read."""
    return forward_train_aux(params, batch, cfg)[0]


# ===========================================================================
# loss
# ===========================================================================

def lm_loss(params: LM, batch: Dict[str, torch.Tensor], cfg: ModelConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token NLL over ``batch["targets"]`` (B, S), weighted by
    ``batch["loss_mask"]`` where given: the float32 logits'
    ``logsumexp`` over the padded vocabulary (padded columns count, as in
    the JAX package) less the gold logit.  The gold logit is a gather,
    bit-equal to the JAX package's iota-mask sum of one non-zero term.
    The total adds the MoE terms averaged over the MoE layers: the
    load-balancing loss weighted by ``moe.router_aux_weight`` and the
    z-loss.  Returns ``(total, {"nll", "lb_loss", "z_loss",
    "moe_dropped"})``, the last three averaged over the MoE layers (0 for
    a dense model, whose total is its NLL)."""
    logits, aux = forward_train_aux(params, batch, cfg)
    targets = batch["targets"]
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    gold = torch.gather(logits32, -1, targets.long()[..., None])[..., 0]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones_like(targets, dtype=torch.float32)
    count = PS.split_sum(torch.sum(mask))     # the whole batch's tokens
    nll = torch.sum((lse - gold) * mask) / torch.clamp(count, min=1.0)
    n_moe_layers = sum(1 for i in range(cfg.n_layers) if cfg.layer_is_moe(i))
    scale = 1.0 / max(n_moe_layers, 1)
    aux_w = cfg.moe.router_aux_weight if cfg.moe else 0.0
    total = nll + aux_w * scale * aux.lb_loss + scale * aux.z_loss
    return total, {"nll": nll, "lb_loss": aux.lb_loss * scale,
                   "z_loss": aux.z_loss * scale,
                   "moe_dropped": aux.dropped * scale}


# ===========================================================================
# decode (serve path)
# ===========================================================================

# a recurrent block kind's state and its initial value
_STATES = {"mamba": (SSM.MambaState, SSM.init_mamba_state),
           "mlstm": (SSM.MLSTMState, SSM.init_mlstm_state),
           "slstm": (SSM.SLSTMState, SSM.init_slstm_state)}


def init_caches(cfg: ModelConfig, batch: int, seq_len: int,
                device="cuda") -> List[Params]:
    """One decode cache per layer, in layer order: an empty ring cache
    for an attention layer, the initial state's fields for a recurrent
    one.  On the ``meta`` device it gives shapes and dtypes and allocates
    nothing (`configs.shapes.input_specs`)."""
    _check_supported(cfg)
    dev = torch.device(device)
    if dev.type != "meta":
        dev = resolve_device(dev)
    caches = []
    for li in range(cfg.n_layers):
        pos = li % cfg.group_size
        kind = cfg.block_kind(pos)
        if kind != "attn":
            caches.append(_STATES[kind][1](cfg, batch, dev)._asdict())
            continue
        # a position's layers may mix local/global across groups (llama4):
        # size for the largest receptive field among them
        has_global = any(cfg.layer_is_global_attn(g * cfg.group_size + pos)
                         for g in range(cfg.n_groups))
        caches.append(A.init_kv_cache(
            cfg, batch, A.cache_size_for(cfg, seq_len, has_global), dev))
    return caches


def _block_decode(p: Block, cache: Params, x: torch.Tensor, kind: str,
                  cfg: ModelConfig, pos: int, is_global: bool):
    # an MoE layer routes the step's B tokens as one pool
    p = PS.at_use(p)
    if kind != "attn":
        x, state, _ = _recurrent_block(p, x, kind, cfg,
                                       _STATES[kind][0](**cache))
        return x, state._asdict()
    h = L.apply_norm(cfg.norm, p.attn_norm, x)
    y, cache = A.decode_attend(p.attn, h, cache, pos, cfg,
                               is_global=is_global, use_rope=not is_global)
    return _apply_mlp_or_moe(p, x + y, cfg)[0], cache


def _decode_layers(params: LM, caches: List[Params], tokens: torch.Tensor,
                   pos: int, cfg: ModelConfig) -> torch.Tensor:
    """Embed one token per row and run it through every layer, writing
    each layer's cache in place; returns the last layer's activations."""
    params = PS.at_use(params)
    x = L.embed(params.embed, tokens, cfg.cdtype, scale=cfg.embed_scale)
    x = PS.constrain(x, ["batch", None, None])
    flags = group_flags(cfg).tolist()
    for li, block in enumerate(params.blocks):
        g, p_i = divmod(li, cfg.group_size)
        x, caches[li] = _block_decode(block, caches[li], x,
                                      cfg.block_kind(p_i), cfg, pos,
                                      flags[g][p_i])
    return x


@torch.no_grad()
def decode_step(params: LM, caches: List[Params], tokens: torch.Tensor,
                pos: int, cfg: ModelConfig):
    """One decode step. tokens: (B, 1); pos: absolute position.  Returns
    (logits (B, 1, Vp), caches), the caches updated in place."""
    params = PS.at_use(params)
    x = _decode_layers(params, caches, tokens, pos, cfg)
    x = L.apply_norm(cfg.norm, params.final_norm, x)
    logits = L.unembed(params.head, params.embed, x, cfg.cdtype,
                       softcap=cfg.logit_softcap)
    return logits, caches


@torch.no_grad()
def forward_prefill(params: LM, batch: Dict[str, torch.Tensor],
                    cfg: ModelConfig, cache_len: Optional[int] = None):
    """Prefill: the train forward's logits, and decode caches filled by
    replaying the prompt one token at a time (exact).  The replay skips
    the per-step unembedding, whose logits it would discard.

    As in the JAX package, the replay re-embeds the *tokens* at position
    ``t`` on every stream: a VLM batch's ``patch_embeds`` and
    ``positions`` reach the logits but not the caches, which hold the
    text alone."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    caches = init_caches(cfg, b, cache_len or s, tokens.device)
    logits = forward_train(params, batch, cfg)
    for t in range(s):
        _decode_layers(params, caches, tokens[:, t:t + 1], t, cfg)
    return logits, caches
