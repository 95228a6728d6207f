"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2 every layer, SWA [arXiv:2401.04088; hf]."""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    # dispatch="local": per-DP-shard capacity pools under a mesh
    # (EXPERIMENTS.md §Perf A); on one card the one global pool they
    # equal at DP size 1 (models/moe.py)
    moe=MoEConfig(n_experts=8, top_k=2, every_n_layers=1,
                  dispatch="local"),
    sliding_window=4096,
    rope_theta=1e6,
    notes="MoE 8e top-2 all layers; SWA 4096",
)

REDUCED = ModelConfig(
    name="mixtral-8x22b-reduced",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    moe=MoEConfig(n_experts=4, top_k=2, every_n_layers=1),
    sliding_window=16,
    rope_theta=1e6,
)
