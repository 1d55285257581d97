"""rwkv6-3b — [ssm] 32L d_model=2560 (attn-free) d_ff=8960 vocab=65536 —
Finch, data-dependent decay.  [arXiv:2404.05892; hf]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,                  # d_model / head_dim(64)
    num_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    hidden_act="relu",             # channel-mix uses squared ReLU
    ssm=SSMConfig(kind="rwkv6", state_dim=64, head_dim=64, chunk=128),
    source="arXiv:2404.05892; hf",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512,
        ssm=SSMConfig(kind="rwkv6", state_dim=16, head_dim=16, chunk=32))
