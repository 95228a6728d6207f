"""Train / prefill / decode step functions: the port's counterpart of the
JAX package's ``train/steps.py``.

``make_train_step`` builds the canonical step:

    loss and gradients (remat per config) -> clip -> AdamW -> new TrainState

The JAX step is a pure function that the caller jits; the port's runs
eagerly and updates the state's parameters and moments in place (its
returned `TrainState` holds the same `LM` and moment tensors, with the
step advanced).  Encoder-decoder configurations raise naming ROADMAP
Queue A13, as `transformer.init_lm` does.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.train import optimizer as O


class TrainState(NamedTuple):
    params: T.LM
    opt: O.OptState
    step: torch.Tensor         # int32, 0-dim


def _state(params: T.LM, dev: torch.device) -> TrainState:
    return TrainState(params=params, opt=O.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def init_state(gen: torch.Generator, cfg: ModelConfig,
               device="cuda") -> TrainState:
    """Random parameters from ``gen`` (a generator on ``device``; see
    `transformer.init_lm`), zero moments, step 0."""
    dev = resolve_device(device)
    return _state(T.init_lm(gen, cfg, dev), dev)


def abstract_state(cfg: ModelConfig) -> TrainState:
    """The `TrainState` on the ``meta`` device: every shape and dtype,
    no allocation (the JAX package's ``jax.eval_shape`` of
    ``init_state``)."""
    meta = torch.device("meta")
    return _state(T.build_lm(None, cfg, meta), meta)


def loss_fn_for(cfg: ModelConfig) -> Callable:
    if cfg.enc_dec:
        raise T._unported("the encoder-decoder stack")
    return T.lm_loss


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
    """Prefill = full forward over the prompt, logits out."""

    @torch.no_grad()
    def prefill_step(params, batch):
        return T.forward_train(params, batch, cfg)

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """One-token serve step: (params, caches, tokens (B,1), pos) ->
    (logits, caches)."""

    @torch.no_grad()
    def decode(params, caches, tokens, pos):
        return T.decode_step(params, caches, tokens, pos, cfg)

    return decode


def eval_ppl(params: T.LM, batches: Iterable[Dict[str, torch.Tensor]],
             cfg: ModelConfig) -> float:
    """Mean token NLL over a list of batches (examples/quickstart)."""
    loss_fn = loss_fn_for(cfg)
    with torch.no_grad():
        nlls = [loss_fn(params, b, cfg)[1]["nll"].cpu().numpy()
                for b in batches]
    return float(np.mean(nlls))
