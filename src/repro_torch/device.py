"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.

    CUDA is the default.  Asking for CUDA where no card is visible raises
    instead of falling back to the CPU: a run that silently lands on the
    CPU would report CPU times under the card's name.  The CPU is used
    only when the caller names it, as the tests do."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} asks for CUDA but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device={device!r} must be a CUDA or CPU device")
    return dev
