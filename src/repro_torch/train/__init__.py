"""Step functions of the port (serving steps so far)."""

from repro_torch.train.steps import make_decode_step, make_prefill_step

__all__ = ["make_decode_step", "make_prefill_step"]
