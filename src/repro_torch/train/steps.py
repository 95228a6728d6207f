"""Prefill and decode step functions: the serving half of the JAX
package's ``train/steps.py``.  The training step, its state and the
optimizer come with the training slice (ROADMAP Queue A13)."""

from __future__ import annotations

from typing import Callable

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """Prefill = full forward over the prompt, logits out."""

    def prefill_step(params, batch):
        return T.forward_train(params, batch, cfg)

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """One-token serve step: (params, caches, tokens (B,1), pos) ->
    (logits, caches)."""

    def decode(params, caches, tokens, pos):
        return T.decode_step(params, caches, tokens, pos, cfg)

    return decode
