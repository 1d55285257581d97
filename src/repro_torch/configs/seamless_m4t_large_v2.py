"""seamless-m4t-large-v2 — [audio] 24L d_model=1024 16H d_ff=8192
vocab=256206 — enc-dec, multimodal.  [arXiv:2308.11596; hf]

Transformer BACKBONE only: the speech frontend is a STUB — input_specs()
provides precomputed frame embeddings for the 24-layer encoder; the 24-layer
decoder attends to the encoder output via cross-attention.
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,                 # decoder layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    hidden_act="silu",
    encoder_decoder=True,
    num_encoder_layers=24,
    frontend=FrontendConfig(kind="audio", num_tokens=0, embed_dim=1024),
    source="arXiv:2308.11596; hf",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, num_encoder_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
        frontend=FrontendConfig(kind="audio", num_tokens=0, embed_dim=64),
        attn_q_block=32, attn_kv_block=32)
