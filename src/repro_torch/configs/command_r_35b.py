"""command-r-35b — 40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000,
GQA, no-bias.  [hf:CohereForAI/c4ai-command-r-v01; unverified]

Block structure upstream is [unverified]; we use standard sequential pre-norm
blocks with SwiGLU and no biases (recorded in DESIGN.md §8).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    hidden_act="silu",
    qkv_bias=False,
    rope_theta=10000.0,
    tie_embeddings=True,
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
        d_ff=160, vocab_size=512, attn_q_block=32, attn_kv_block=32)
