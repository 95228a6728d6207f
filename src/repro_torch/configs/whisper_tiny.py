"""whisper-tiny [audio] — enc-dec, conv frontend stubbed.

4L enc + 4L dec, d_model=384, 6H (MHA), d_ff=1536, vocab=51865
[arXiv:2212.04356; unverified].  The mel/conv frontend is a stub: the
encoder takes precomputed frame embeddings (B, 1500, 384).  Positional
embeddings are sinusoidal in both stacks (whisper's decoder learns its
own; shape and FLOPs are identical).  The model is `models.encdec`.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    enc_dec=True,
    n_enc_layers=4,
    enc_seq=1500,
    norm="layernorm",
    activation="gelu",
    qkv_bias=True,
    use_rope=False,
    tie_embeddings=True,
    notes="enc-dec; frontend stub; MHA (kv=6)",
)

REDUCED = ModelConfig(
    name="whisper-tiny-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    enc_dec=True,
    n_enc_layers=2,
    enc_seq=24,
    norm="layernorm",
    activation="gelu",
    qkv_bias=True,
    use_rope=False,
    tie_embeddings=True,
)
