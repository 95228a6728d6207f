"""qwen2-72b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064; GQA with QKV bias [arXiv:2407.10671; hf]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    notes="dense GQA; QKV bias",
)

REDUCED = ModelConfig(
    name="qwen2-72b-reduced",
    n_layers=4,
    d_model=96,
    n_heads=8,
    n_kv_heads=2,
    d_ff=192,
    vocab_size=512,
    qkv_bias=True,
    rope_theta=1e6,
)
