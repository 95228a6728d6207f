"""Model configuration: the port's copy of the JAX package's
``models/config.py``.

The dataclasses carry the same fields, defaults and checks, so a
configuration carries across field by field (`interop.
model_config_from_fields`); only `ModelConfig.cdtype`/`pdtype` return
``torch.dtype``s.  The port runs every block kind below, the attention
and mamba blocks with a dense MLP or a Mixture-of-Experts FFN
(`MoEConfig`), M-RoPE (``mrope``) and the encoder-decoder
(`models.encdec`), so every configuration of the registry runs.

Layer layout is a repeating *group pattern*: a tuple of block kinds of
length G; the stack is ``n_layers / G`` groups.  Block kinds: ``"attn"``
(self-attention + MLP/MoE), ``"mamba"`` (selective SSM + MLP/MoE),
``"mlstm"`` / ``"slstm"`` (xLSTM blocks, self-contained).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The ``torch.dtype`` of a configuration's dtype name."""
    if name not in _DTYPES:
        raise ValueError(f"dtype {name!r} must be one of {tuple(_DTYPES)}")
    return _DTYPES[name]

@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    every_n_layers: int = 1       # MoE on layers where (layer % n) == n-1
    router_aux_weight: float = 0.01
    # "global": one token-ordered capacity pool (paper-faithful GShard
    #           cumsum; SPMD cost = full-buffer psums per MoE layer).
    # "local":  per-data-shard capacity pools — dispatch scatter/gather
    #           stay local to each DP shard and the expert weights are
    #           all-gathered (bf16) instead; §Perf hillclimb for the
    #           collective-bound MoE trains.  Identical when DP size = 1.
    dispatch: str = "global"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    chunk: int = 128              # chunked-scan length
    dt_rank: Optional[int] = None  # defaults to ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None        # default d_model // n_heads
    group_pattern: Tuple[str, ...] = ("attn",)
    norm: str = "rmsnorm"                 # rmsnorm | layernorm
    activation: str = "swiglu"            # swiglu | geglu | gelu
    qkv_bias: bool = False
    tie_embeddings: bool = False
    embed_scale: bool = False             # gemma: x *= sqrt(d_model)

    # positional encoding
    use_rope: bool = True                 # whisper: sinusoidal abs instead
    rope_theta: float = 1e6
    rotary_pct: float = 1.0               # stablelm: 0.25
    mrope: bool = False                   # qwen2-vl M-RoPE (3 sections)
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # fractions of hd/2

    # attention locality
    sliding_window: Optional[int] = None  # SWA width (danube, mixtral)
    chunk_attn: Optional[int] = None      # llama4 chunked-local width
    global_every: Optional[int] = None    # llama4: every Nth layer global

    # mixtures / ssm
    moe: Optional[MoEConfig] = None
    ssm: SSMConfig = SSMConfig()

    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500                   # whisper frame count after conv

    # numerics / execution
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "block"                  # none | block | dots (training)
    # Name kept from the JAX package (where it picks the Pallas kernel):
    # in the port it routes prefill attention through the hand-written
    # CUDA flash kernel (`kernels/flash_attention`).
    use_pallas_attn: bool = False
    logit_softcap: Optional[float] = None
    attn_q_block: int = 1024              # query-block size (blocked path)
    # Attention score/softmax dtype of the blocked path (float32 for
    # fidelity; the flash kernel keeps f32 accumulators either way).
    attn_score_dtype: str = "float32"
    # KV-cache storage dtype: "bfloat16" (default) or "int8" (per-slot
    # per-head symmetric quantization; halves decode cache bytes).
    kv_cache_dtype: str = "bfloat16"
    # Carried so JAX configurations map field for field; the port has no
    # scans to unroll, and its sharded step gathers every block's weights
    # whole where the block runs (`parallel.sharding.at_use`), so neither
    # changes what it computes.
    unroll_scans: bool = False
    gather_weights: bool = False

    # scale metadata (roofline bookkeeping)
    notes: str = ""

    def __post_init__(self):
        if self.n_layers % len(self.group_pattern):
            raise ValueError(f"{self.name}: n_layers {self.n_layers} not a "
                             f"multiple of group size {len(self.group_pattern)}")
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be a multiple of n_kv_heads")

    # ----------------------------------------------------------- dimensions
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to 256 so the embedding/head shard on 16-way TP
        (DESIGN.md: configs keep the true vocab; padding is internal)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.group_pattern)

    @property
    def group_size(self) -> int:
        return len(self.group_pattern)

    def block_kind(self, pos: int) -> str:
        return self.group_pattern[pos]

    def layer_is_moe(self, layer_idx: int) -> bool:
        if self.moe is None:
            return False
        n = self.moe.every_n_layers
        return layer_idx % n == n - 1

    def layer_is_global_attn(self, layer_idx: int) -> bool:
        """llama4: every ``global_every``-th layer attends globally (NoPE)."""
        if self.global_every is None:
            return False
        return (layer_idx + 1) % self.global_every == 0

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    # ------------------------------------------------------------- counting
    def param_count(self) -> int:
        """Exact parameter count (embedding + blocks + norms + head)."""
        d, ff, v, hd = self.d_model, self.d_ff, self.vocab_size, self.hd
        h, kv = self.n_heads, self.n_kv_heads
        total = v * d                                   # embedding
        if not self.tie_embeddings:
            total += d * v                              # lm head
        total += d                                      # final norm
        for i in range(self.n_layers):
            kind = self.block_kind(i % self.group_size)
            if kind == "attn":
                total += d * (h * hd) + 2 * d * (kv * hd) + (h * hd) * d
                if self.qkv_bias:
                    total += h * hd + 2 * kv * hd
                total += d  # attn norm
            elif kind == "mamba":
                s = self.ssm
                inner = s.expand * d
                dtr = s.dt_rank or -(-d // 16)
                total += d * 2 * inner            # in_proj (x, z)
                total += inner * s.d_conv         # conv
                total += inner * (dtr + 2 * s.d_state)  # x -> dt,B,C
                total += dtr * inner + inner      # dt proj + bias
                total += inner * s.d_state + inner  # A_log, D
                total += inner * d                # out_proj
                total += d                        # norm
            elif kind == "mlstm":
                inner = 2 * d
                total += d * 2 * inner            # up proj (x, z)
                total += 3 * inner * inner // 4   # q,k,v proj (blockdiag/4 heads)
                total += 3 * inner                # i,f,o gates (per-dim)
                total += inner * d                # down proj
                total += 2 * d                    # norms
            elif kind == "slstm":
                total += 4 * d * d + 4 * d        # input gates W (i,f,z,o)
                total += 4 * d * d                # recurrent R (i,f,z,o)
                total += 2 * d * ff_slstm(d)      # post-FFN up/down (4/3 d)
                total += 2 * d                    # norms
            if kind in ("attn", "mamba"):
                if self.layer_is_moe(i):
                    m = self.moe
                    total += d * m.n_experts            # router
                    n_mats = 3 if self.activation in ("swiglu", "geglu") else 2
                    total += m.n_experts * n_mats * d * ff
                else:
                    n_mats = 3 if self.activation in ("swiglu", "geglu") else 2
                    total += n_mats * d * ff
                total += d  # mlp norm
        if self.enc_dec:
            # encoder layers + cross attention in decoder
            for _ in range(self.n_enc_layers):
                total += d * (h * hd) * 2 + 2 * d * (kv * hd) + 3 * d * ff + 2 * d
            total += self.n_layers * (d * (h * hd) + 2 * d * (kv * hd)
                                      + (h * hd) * d + d)
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE top-k instead of all experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        n_mats = 3 if self.activation in ("swiglu", "geglu") else 2
        per_expert = n_mats * self.d_model * self.d_ff
        n_moe_layers = sum(1 for i in range(self.n_layers)
                           if self.layer_is_moe(i))
        return (self.param_count()
                - n_moe_layers * (m.n_experts - m.top_k) * per_expert)


def ff_slstm(d: int) -> int:
    """sLSTM post-FFN width: 4/3 * d, rounded up to 128 (TP divisibility)."""
    return -(-(4 * d // 3) // 128) * 128
