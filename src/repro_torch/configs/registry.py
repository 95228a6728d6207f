"""Architecture registry: ``--arch <id>`` -> ModelConfig (+ reduced twin).

The ids are the JAX package's, and every one runs in the port: the
dense attention-only architectures (qwen2-72b; qwen2-vl-72b with M-RoPE
and the stub patch frontend), the two attention + MoE ones (mixtral,
llama4), the mamba + attention + MoE hybrid (jamba), the xLSTM (xlstm)
and the encoder-decoder (whisper-tiny, `models.encdec`).
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
    "qwen2-72b": "repro_torch.configs.qwen2_72b",
    "qwen2-vl-72b": "repro_torch.configs.qwen2_vl_72b",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCH_IDS}")
    mod = importlib.import_module(_MODULES[arch])
    return mod.REDUCED if reduced else mod.CONFIG
