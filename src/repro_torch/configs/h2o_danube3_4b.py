"""h2o-danube-3-4b [dense] — 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000; llama+mistral mix with sliding-window attention
[arXiv:2401.16818; unverified]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=5e5,
    notes="SWA 4096; head_dim=120 (non-128 MXU note in DESIGN.md)",
)

REDUCED = ModelConfig(
    name="h2o-danube-3-4b-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=512,
    sliding_window=16,
    rope_theta=5e5,
)
