"""llava-next-mistral-7b — [vlm] 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000 — anyres tiling.  [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

The vision frontend is a STUB per the brief: input_specs() provides
precomputed patch embeddings (anyres: base 576 + 4 tiles x 576 = 2880 tokens,
CLIP-L/14 dim 1024) fed through a 2-layer MLP projector into the mistral-7b
backbone.  Mistral's sliding-window attention is modeled as full causal
attention (noted in DESIGN.md §8).
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    hidden_act="silu",
    rope_theta=10000.0,
    frontend=FrontendConfig(kind="vision", num_tokens=2880, embed_dim=1024,
                            tiles=5),
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
        d_ff=160, vocab_size=512,
        frontend=FrontendConfig(kind="vision", num_tokens=16, embed_dim=32,
                                tiles=2),
        attn_q_block=32, attn_kv_block=32)
