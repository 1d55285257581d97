"""codeqwen1.5-7b — 32L d_model=4096 32H (kv=32) d_ff=13440 vocab=92416,
qwen1.5-arch (MHA, QKV bias).  [hf:Qwen/CodeQwen1.5-7B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab_size=92416,
    hidden_act="silu",
    qkv_bias=True,
    rope_theta=1000000.0,
    source="hf:Qwen/CodeQwen1.5-7B; hf",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=96, vocab_size=512, attn_q_block=32, attn_kv_block=32)
