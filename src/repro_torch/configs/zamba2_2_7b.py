"""zamba2-2.7b — [hybrid] 54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000,
ssm_state=64 — Mamba2 backbone + shared attention blocks.  [arXiv:2411.15242; hf]

Shared transformer block (attention + MLP over concat(hidden, embedding))
applied every 6th layer; per-invocation LoRA deltas of Zamba2 are omitted
(DESIGN.md §8).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    hidden_act="gelu",
    ssm=SSMConfig(kind="mamba2", state_dim=64, head_dim=64, expand=2,
                  conv_kernel=4, n_groups=1, chunk=128),
    hybrid_attn_every=6,
    hybrid_attn_heads=32,
    source="arXiv:2411.15242; hf",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512,
        ssm=SSMConfig(kind="mamba2", state_dim=16, head_dim=16, expand=2,
                      conv_kernel=4, n_groups=1, chunk=32),
        hybrid_attn_every=2, hybrid_attn_heads=4,
        attn_q_block=32, attn_kv_block=32)
