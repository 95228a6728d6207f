"""xlstm-1.3b [ssm] — 48L d_model=2048 4H d_ff=0 vocab=50304; sLSTM +
mLSTM blocks at 1:7 per group of 8 [arXiv:2405.04517; unverified].

mLSTM blocks carry an (hd x hd) matrix memory per head (chunkwise-parallel
linear attention); sLSTM blocks are sequential scalar-memory cells with
block-diagonal recurrence + 4/3-factor post-FFN.  Attention-free.
"""

from repro_torch.models.config import ModelConfig

_PATTERN = ("slstm",) + ("mlstm",) * 7

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    group_pattern=_PATTERN,
    norm="layernorm",
    notes="1 sLSTM : 7 mLSTM; attention-free",
)

REDUCED = ModelConfig(
    name="xlstm-1.3b-reduced",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=512,
    group_pattern=_PATTERN,
    norm="layernorm",
)
