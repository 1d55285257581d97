"""qwen2.5-32b — 64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064,
GQA, QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    hidden_act="silu",
    qkv_bias=True,
    rope_theta=1000000.0,
    source="hf:Qwen/Qwen2.5-0.5B; hf",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
        d_ff=160, vocab_size=512, attn_q_block=32, attn_kv_block=32)
