"""gemma-7b — 28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000, GeGLU,
head_dim=256.  [arXiv:2403.08295; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    hidden_act="gelu",             # GeGLU
    rope_theta=10000.0,
    tie_embeddings=True,           # gemma ties input/output embeddings
    source="arXiv:2403.08295; hf",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512, attn_q_block=32, attn_kv_block=32)
