"""The threefry2x32 hash in plain PyTorch: what the CUDA kernel is held
against on the card, and what runs on a CPU tensor.

Words are uint32 values held in int64 tensors (the port's idiom for
unsigned 32-bit state, as in `policy_core`'s LCG): every add is masked
back to 32 bits and a rotate is two shifts and an or, so no op depends on
how a signed overflow behaves.  The rounds and key injections are those
of the JAX package's threefry (jax ``_src/prng.py``,
``_threefry2x32_lowering``): 20 rounds in groups of four with the
rotations 13 15 26 6 / 17 29 16 24, a key schedule of
``(k1, k2, k1 ^ k2 ^ 0x1BD11BDA)`` and five injections.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & MASK32) | (v >> (32 - r))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """Apply the hash to the counter pairs ``(x1, x2)`` under the key
    ``(k1, k2)``; all four broadcast against each other and hold uint32 in
    int64.  Returns the two output words (int64 holding uint32)."""
    ks = (k1 & MASK32, k2 & MASK32, (k1 ^ k2 ^ PARITY) & MASK32)
    x = [(x1 + ks[0]) & MASK32, (x2 + ks[1]) & MASK32]
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & MASK32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & MASK32
    return x[0], x[1]


def threefry_counters_ref(keys: torch.Tensor, n: int, count_lo: int = 0,
                          xor: bool = False) -> torch.Tensor:
    """What the kernel computes: for every key of ``keys`` (..., 2) and
    every ``j < n``, the hash of the counter pair ``(0, count_lo + j)``.
    Returns (..., n, 2) int64 holding the two output words, or (..., n)
    holding their xor when ``xor``."""
    j = torch.arange(n, dtype=torch.int64, device=keys.device)
    x2 = (j + count_lo) & MASK32
    x1 = torch.zeros_like(x2)
    y1, y2 = threefry2x32(keys[..., 0:1], keys[..., 1:2], x1, x2)
    if xor:
        return y1 ^ y2
    return torch.stack([y1, y2], dim=-1)
