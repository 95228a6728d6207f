"""qwen2-vl-72b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064; M-RoPE + dynamic resolution [arXiv:2409.12191; hf].

Backbone only: the vision tower is a STUB — `configs.shapes.input_specs`
gives precomputed patch embeddings for the first P token slots plus the
(3, B, S) M-RoPE position streams (temporal / height / width).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1e6,
    notes="M-RoPE (16,24,24); vision tower stubbed",
)

REDUCED = ModelConfig(
    name="qwen2-vl-72b-reduced",
    n_layers=4,
    d_model=96,
    n_heads=8,
    n_kv_heads=2,
    d_ff=192,
    vocab_size=512,
    qkv_bias=True,
    mrope=True,
    mrope_sections=(2, 2, 2),
    rope_theta=1e6,
)
