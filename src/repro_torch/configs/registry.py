"""Architecture registry: ``--arch <id>`` -> ModelConfig (+ reduced twin).

The ids are the JAX package's.  The three dense attention-only
architectures, the two attention + MoE ones (mixtral, llama4), the
mamba + attention + MoE hybrid (jamba), the xLSTM (xlstm) and the
encoder-decoder (whisper-tiny, `models.encdec`) run in the port; the
others need parts the port has not ported yet and raise naming their
ROADMAP item.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

_MODULES: Dict[str, str] = {
    "h2o-danube-3-4b": "repro_torch.configs.h2o_danube3_4b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "jamba-v0.1-52b": "repro_torch.configs.jamba_v01_52b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
}

# what each architecture not yet in the port waits for
_UNPORTED: Dict[str, str] = {
    "qwen2-72b": "the sharded multi-card stack (a 72B model)",
    "qwen2-vl-72b": "M-RoPE and the sharded multi-card stack",
}

ARCH_IDS: List[str] = list(_MODULES) + list(_UNPORTED)


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch in _UNPORTED:
        raise NotImplementedError(
            f"{arch} needs {_UNPORTED[arch]}, not ported yet "
            "(ROADMAP Queue A13)")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    mod = importlib.import_module(_MODULES[arch])
    return mod.REDUCED if reduced else mod.CONFIG
