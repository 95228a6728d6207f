"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2; Mamba:attention 7:1 interleave, MoE every
other layer [arXiv:2403.19887; hf].

Group of 8 = [mamba x4, attn, mamba x3] (attn_layer_offset=4, period=8);
MoE on odd layers (expert_layer_offset=1, period=2).  No positional
encoding (use_rope=False), as in the paper.
"""

from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig

_PATTERN = ("mamba", "mamba", "mamba", "mamba",
            "attn", "mamba", "mamba", "mamba")

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    group_pattern=_PATTERN,
    # dispatch="local": per-DP-shard capacity pools under a mesh; on one
    # card the one global pool they equal at DP size 1 (models/moe.py)
    moe=MoEConfig(n_experts=16, top_k=2, every_n_layers=2,
                  dispatch="local"),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, chunk=128),
    use_rope=False,
    notes="hybrid 1:7 attn:mamba; MoE 16e top-2 every other layer; NoPE",
)

REDUCED = ModelConfig(
    name="jamba-v0.1-52b-reduced",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=512,
    group_pattern=_PATTERN,
    moe=MoEConfig(n_experts=4, top_k=2, every_n_layers=2),
    ssm=SSMConfig(d_state=4, d_conv=4, expand=2, chunk=16),
    use_rope=False,
)
