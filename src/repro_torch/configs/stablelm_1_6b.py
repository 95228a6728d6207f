"""stablelm-1.6b [dense] — 24L d_model=2048 32H (MHA, kv=32) d_ff=5632
vocab=100352; LayerNorm + partial rotary (25%)
[hf:stabilityai/stablelm-2-1_6b; unverified]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    norm="layernorm",
    rotary_pct=0.25,
    qkv_bias=True,
    rope_theta=1e4,
    notes="MHA; partial rotary 25%; LayerNorm",
)

REDUCED = ModelConfig(
    name="stablelm-1.6b-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=160,
    vocab_size=512,
    norm="layernorm",
    rotary_pct=0.25,
    qkv_bias=True,
    rope_theta=1e4,
)
