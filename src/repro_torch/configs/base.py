"""Model + shape configuration dataclasses shared by every architecture.

Every assigned architecture gets one module in ``repro_torch.configs`` exposing
``CONFIG`` (the full published configuration) and ``smoke_config()`` (a reduced
same-family configuration for CPU smoke tests).  ``repro_torch.configs.registry``
maps ``--arch <id>`` to these modules.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    num_experts_per_tok: int
    d_ff: int                      # per-expert hidden width
    num_shared_experts: int = 0
    shared_d_ff: int = 0           # hidden width of the shared expert(s)
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    first_k_dense: int = 0         # leading layers that use a dense FFN
    dense_d_ff: int = 0            # width of those dense layers


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class SSMConfig:
    kind: str                      # "mamba2" | "rwkv6"
    state_dim: int                 # N (mamba2) / head_dim (rwkv6)
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    n_groups: int = 1
    chunk: int = 128               # chunked-scan block length


@dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend STUB: input_specs() provides precomputed embeddings."""
    kind: str                      # "vision" | "audio"
    num_tokens: int                # frontend tokens per sample
    embed_dim: int                 # dimensionality delivered by the stub
    # anyres tiling metadata (vision only, informational)
    tiles: int = 0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    hidden_act: str = "silu"       # silu => SwiGLU, gelu => GeGLU
    qkv_bias: bool = False
    attn_out_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    qk_norm: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one shared attention block applied every k layers
    hybrid_attn_every: int = 0
    hybrid_attn_heads: int = 0
    # encoder-decoder
    encoder_decoder: bool = False
    num_encoder_layers: int = 0
    frontend: Optional[FrontendConfig] = None
    # numerics
    dtype: str = "bfloat16"
    # MoE dispatch sharding: ep_model (E on model axis) | ep_data_tp_ffn
    # (E on data, expert-FFN hidden on model; serving hillclimb)
    expert_scheme: str = "ep_model"
    # attention implementation knobs (hillclimbable)
    attn_q_block: int = 512
    attn_kv_block: int = 1024
    attn_impl: str = "masked"      # masked | balanced (causal flop-halving)
    remat: str = "none"            # none | block  (rematerialize each layer)
    # citation / provenance string
    source: str = ""

    # ---------------------------------------------------------------- helpers
    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(1, self.num_kv_heads)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str                      # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode
    microbatch: int = 0            # 0 => no gradient accumulation


LM_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeConfig:
    for s in LM_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


# ----------------------------------------------------------------- accounting
def count_params(cfg: ModelConfig) -> int:
    """Analytic parameter count (matches init_params; used for roofline)."""
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    V = cfg.vocab_size
    n = V * D                                      # embedding
    if not cfg.tie_embeddings:
        n += V * D                                 # lm head

    def attn_params(heads: int, kv_heads: int) -> int:
        p = D * heads * hd + 2 * D * kv_heads * hd + heads * hd * D
        if cfg.qkv_bias:
            p += heads * hd + 2 * kv_heads * hd
        if cfg.qk_norm:
            p += 2 * hd
        return p

    def mla_params() -> int:
        m = cfg.mla
        qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
        p = D * m.q_lora_rank + m.q_lora_rank * H * qk_dim          # q down/up
        p += D * (m.kv_lora_rank + m.qk_rope_head_dim)              # kv down
        p += m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
        p += H * m.v_head_dim * D                                   # out proj
        p += m.q_lora_rank + m.kv_lora_rank                         # norms
        return p

    def dense_ffn(dff: int) -> int:
        return 3 * D * dff                         # gate, up, down

    def moe_ffn(layer: int) -> int:
        mo = cfg.moe
        if layer < mo.first_k_dense:
            return dense_ffn(mo.dense_d_ff or cfg.d_ff)
        p = D * mo.num_experts                     # router
        p += mo.num_experts * 3 * D * mo.d_ff
        if mo.num_shared_experts:
            p += mo.num_shared_experts * 3 * D * (mo.shared_d_ff or mo.d_ff)
        return p

    def mamba2_layer() -> int:
        s = cfg.ssm
        d_in = s.expand * D
        heads = d_in // s.head_dim
        conv_dim = d_in + 2 * s.n_groups * s.state_dim
        p = D * (2 * d_in + 2 * s.n_groups * s.state_dim + heads)   # in_proj
        p += (s.conv_kernel + 1) * conv_dim                         # conv w+b
        p += heads * 2                                              # A_log, D
        p += heads                                                  # dt_bias
        p += d_in                                                   # gated norm
        p += d_in * D                                               # out_proj
        return p

    def rwkv6_layer() -> int:
        p = 6 * D                                  # mu_base + 5 lerp coefs
        p += D * 5 * 32 + 5 * 32 * D               # ddlerp lora
        p += D + D * 64 + 64 * D                   # w0 + decay lora
        p += 4 * D * D                             # r,k,v,g projections
        p += D                                     # u (bonus)
        p += 2 * D                                 # per-head groupnorm
        p += D * D                                 # output proj
        p += 2 * D                                 # channel-mix lerp coefs
        p += D * cfg.d_ff + cfg.d_ff * D + D * D   # channel mix (k,v,r)
        return p

    per_layer = 2 * D                              # two RMSNorm scales
    if cfg.ssm and cfg.ssm.kind == "mamba2":
        layers = cfg.num_layers * (mamba2_layer() + D)
        if cfg.hybrid_attn_every:
            heads = cfg.hybrid_attn_heads or H
            shared = (2 * D) * heads * hd + 2 * (2 * D) * cfg.num_kv_heads * hd \
                + heads * hd * D + dense_ffn(cfg.d_ff) + 3 * D
            layers += shared                       # one shared block (concat input)
        n += layers + D                            # final norm
        return n
    if cfg.ssm and cfg.ssm.kind == "rwkv6":
        n += cfg.num_layers * (rwkv6_layer() + 2 * D) + 2 * D
        return n

    for layer in range(cfg.num_layers):
        p = per_layer
        p += mla_params() if cfg.mla else attn_params(H, KV)
        p += moe_ffn(layer) if cfg.moe else dense_ffn(cfg.d_ff)
        n += p
    if cfg.encoder_decoder:
        for _ in range(cfg.num_encoder_layers):
            p = per_layer + attn_params(H, KV) + dense_ffn(cfg.d_ff)
            n += p
        # decoder cross-attention blocks + encoder final norm
        n += cfg.num_layers * (attn_params(H, KV) + D) + D
    n += D                                         # final norm
    if cfg.frontend:
        if cfg.encoder_decoder:
            n += cfg.frontend.embed_dim * D        # single linear projector
        else:
            n += cfg.frontend.embed_dim * D + D * D  # 2-layer projector
    return n


def active_params(cfg: ModelConfig) -> int:
    """Activated parameters per token (MoE-aware), for MODEL_FLOPS = 6*N_act*D."""
    if not cfg.moe:
        return count_params(cfg)
    mo = cfg.moe
    full = count_params(cfg)
    all_expert = cfg.num_layers - mo.first_k_dense
    expert_params = all_expert * mo.num_experts * 3 * cfg.d_model * mo.d_ff
    active_expert = all_expert * mo.num_experts_per_tok * 3 * cfg.d_model * mo.d_ff
    return full - expert_params + active_expert


def human(n: float) -> str:
    for unit in ("", "K", "M", "B", "T"):
        if abs(n) < 1000:
            return f"{n:.2f}{unit}"
        n /= 1000
    return f"{n:.2f}P"
