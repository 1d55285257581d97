"""qwen3-moe-30b-a3b — [moe] 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,                      # per-expert width (also used as default)
    vocab_size=151936,
    hidden_act="silu",
    qk_norm=True,
    rope_theta=1000000.0,
    moe=MoEConfig(num_experts=128, num_experts_per_tok=8, d_ff=768,
                  num_shared_experts=0, capacity_factor=1.25),
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=32, vocab_size=512,
        moe=MoEConfig(num_experts=8, num_experts_per_tok=2, d_ff=32,
                      capacity_factor=1.5),
        attn_q_block=32, attn_kv_block=32)
