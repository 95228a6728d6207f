"""Flash attention cases and inputs shared by the CPU parity tests and
the tests on the card (imports numpy only, so the card's tests can use
it where JAX is not installed)."""

import numpy as np

# (B, S, H, KV, hd, window, chunk, dtype): tests/test_kernels.py's
# FLASH_CASES with the dtype by name (test_torch_flash checks the copy)
FLASH_CASES = [
    (2, 64, 4, 2, 32, None, None, "float32"),
    (1, 128, 4, 1, 64, None, None, "float32"),      # MQA
    (2, 96, 4, 4, 16, 32, None, "float32"),         # MHA + SWA
    (1, 128, 8, 2, 32, None, 32, "float32"),        # chunked-local
    (1, 64, 2, 2, 128, None, None, "bfloat16"),     # bf16 end-to-end
    (1, 80, 4, 2, 24, 24, None, "float32"),         # ragged S, odd hd
]
# danube's shape class: head dim 120, GQA group 4, a sliding window, S not
# a multiple of the tile
DANUBE_CASE = (1, 100, 8, 2, 120, 32, None, "float32")


def flash_inputs(b, s, h, kv, hd, seed):
    """float32 numpy q (B,S,H,hd), k and v (B,S,KV,hd) from ``seed``."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, hd), dtype=np.float32),
            rng.standard_normal((b, s, kv, hd), dtype=np.float32),
            rng.standard_normal((b, s, kv, hd), dtype=np.float32))
