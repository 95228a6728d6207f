"""PyTorch/CUDA port of the client-side straggler-aware I/O scheduler.

The package mirrors the layout of the JAX package it was ported from
(``core/``, ``kernels/``, ``models/``, ``configs/``, ``train/``,
``launch/``) so every module has an obvious counterpart.  It runs the
paper's §4 Monte-Carlo sweep (`core.simulate.run_trials`, one shared
statistic log or per_client) with the per-request scheduling loop and the
cross-client merge in hand-written CUDA kernels for Hopper
(`kernels/sched_select/csrc/sched_stream.cu`), and the LM serving path
(`launch.serve`: prefill, then greedy decode) with the flash attention
kernel in CUDA (`kernels/flash_attention/csrc/flash_attn.cu`).

Every entry point takes ``device`` and defaults to ``"cuda"``; asking for
CUDA where there is none raises (`resolve_device`).  The plain PyTorch
versions of the kernels run only for tensors that lie on the CPU.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
