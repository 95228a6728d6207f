"""The flash attention kernel: CUDA kernel, launch wrapper, plain PyTorch
version and dispatch."""

from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_plain)
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["flash_attention", "flash_attention_plain", "attention_ref"]
