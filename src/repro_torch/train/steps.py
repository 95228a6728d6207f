"""Train / prefill / decode step functions: the port's counterpart of the
JAX package's ``train/steps.py``.

``make_train_step`` builds the canonical step:

    loss and gradients (remat per config) -> clip -> AdamW -> new TrainState

The JAX step is a pure function that the caller jits; the port's runs
eagerly and updates the state's parameters and moments in place (its
returned `TrainState` holds the same `LM` and moment tensors, with the
step advanced).  Encoder-decoder configurations (``cfg.enc_dec``) take
`models.encdec`'s parameters, loss, forward and decode step, as the JAX
package's steps do; their batches carry ``frames`` beside ``tokens`` and
``targets``.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, NamedTuple, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import encdec as E
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.train import optimizer as O


class TrainState(NamedTuple):
    params: Union[T.LM, E.EncDec]
    opt: O.OptState
    step: torch.Tensor         # int32, 0-dim


def _state(params, dev: torch.device) -> TrainState:
    return TrainState(params=params, opt=O.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def init_state(gen: torch.Generator, cfg: ModelConfig,
               device="cuda") -> TrainState:
    """Random parameters from ``gen`` (a generator on ``device``; see
    `transformer.init_lm`, or `encdec.init_encdec` for an
    encoder-decoder), zero moments, step 0."""
    dev = resolve_device(device)
    init = E.init_encdec if cfg.enc_dec else T.init_lm
    return _state(init(gen, cfg, dev), dev)


def abstract_state(cfg: ModelConfig) -> TrainState:
    """The `TrainState` on the ``meta`` device: every shape and dtype,
    no allocation (the JAX package's ``jax.eval_shape`` of
    ``init_state``)."""
    meta = torch.device("meta")
    build = E.build_encdec if cfg.enc_dec else T.build_lm
    return _state(build(None, cfg, meta), meta)


def loss_fn_for(cfg: ModelConfig) -> Callable:
    return E.lm_loss if cfg.enc_dec else T.lm_loss


def load_state(state: TrainState, restored: TrainState) -> TrainState:
    """``state`` with a checkpoint's leaves: ``restored`` is
    `Checkpointer.restore(target=state)`, whose params' place holds a
    ``state_dict``, loaded here into ``state``'s `LM` in place."""
    state.params.load_state_dict(restored.params)
    return TrainState(params=state.params, opt=restored.opt,
                      step=restored.step)


def make_train_step(cfg: ModelConfig, opt_cfg: O.OptConfig
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    loss_fn = loss_fn_for(cfg)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        names, leaves = zip(*state.params.named_parameters())
        with torch.enable_grad():
            loss, metrics = loss_fn(state.params, batch, cfg)
            grads = torch.autograd.grad(loss, leaves)
        _, opt, opt_metrics = O.update(opt_cfg, dict(zip(names, grads)),
                                       state.opt, state.params)
        del grads
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(opt_metrics)
        metrics["loss"] = loss.detach()
        return TrainState(params=state.params, opt=opt,
                          step=state.step + 1), metrics

    return train_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """Prefill = full forward over the prompt, logits out (an
    encoder-decoder's batch carries ``frames``)."""
    fwd = E.forward_train if cfg.enc_dec else T.forward_train

    @torch.no_grad()
    def prefill_step(params, batch):
        return fwd(params, batch, cfg)

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """One-token serve step: (params, caches, tokens (B,1), pos) ->
    (logits, caches)."""
    step = E.decode_step if cfg.enc_dec else T.decode_step

    @torch.no_grad()
    def decode(params, caches, tokens, pos):
        return step(params, caches, tokens, pos, cfg)

    return decode


def eval_ppl(params, batches: Iterable[Dict[str, torch.Tensor]],
             cfg: ModelConfig) -> float:
    """Mean token NLL over a list of batches (examples/quickstart)."""
    loss_fn = loss_fn_for(cfg)
    with torch.no_grad():
        nlls = [loss_fn(params, b, cfg)[1]["nll"].cpu().numpy()
                for b in batches]
    return float(np.mean(nlls))
