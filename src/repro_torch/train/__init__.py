"""repro_torch.train — the optimizer and the step functions."""

from repro_torch.train.optimizer import (OptConfig, OptState, init, lr_at,
                                         update)
from repro_torch.train.steps import (TrainState, abstract_state, eval_ppl,
                                     init_state, load_state, loss_fn_for,
                                     make_decode_step, make_prefill_step,
                                     make_train_step)

__all__ = ["OptConfig", "OptState", "TrainState", "abstract_state",
           "eval_ppl", "init", "init_state", "load_state", "loss_fn_for",
           "lr_at", "make_decode_step", "make_prefill_step",
           "make_train_step", "update"]
