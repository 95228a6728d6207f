"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 every layer; chunked-local attention
(8192) with a global NoPE layer every 4th; early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]."""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    # groups of 4 express the same layer sequence but let decode caches
    # size per position: only the every-4th global layer gets a full-
    # length ring (EXPERIMENTS.md §Perf D: 2.9-5.6x decode memory)
    group_pattern=("attn", "attn", "attn", "attn"),
    # dispatch="local": per-DP-shard pools under a mesh, the global pool
    # on one card (models/moe.py)
    moe=MoEConfig(n_experts=16, top_k=1, every_n_layers=1,
                  dispatch="local"),
    chunk_attn=8192,
    global_every=4,
    rope_theta=5e5,
    notes="MoE 16e top-1; chunked-local 8192 + global NoPE every 4th; "
          "40 heads not divisible by 16-way TP -> attn weights FSDP-only",
)

REDUCED = ModelConfig(
    name="llama4-scout-17b-a16e-reduced",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    moe=MoEConfig(n_experts=4, top_k=1, every_n_layers=1),
    chunk_attn=16,
    global_every=4,
    rope_theta=5e5,
)
