"""gemma-2b [dense] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=256000; GeGLU, head_dim=256, tied embeddings scaled by sqrt(d)
[arXiv:2403.08295; hf]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    activation="geglu",
    tie_embeddings=True,
    embed_scale=True,
    rope_theta=1e4,
    notes="MQA; GeGLU; head_dim=256; tied+scaled embeddings",
)

REDUCED = ModelConfig(
    name="gemma-2b-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    activation="geglu",
    tie_embeddings=True,
    embed_scale=True,
    rope_theta=1e4,
)
