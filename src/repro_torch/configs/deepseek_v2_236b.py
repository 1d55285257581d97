"""deepseek-v2-236b — [moe] 60L d_model=5120 128H d_ff=1536 vocab=102400,
MLA kv_lora=512, 2 shared + 160 routed experts top-6.  [arXiv:2405.04434; hf]

First layer uses a dense FFN (width 12288) per the paper; MLA dims:
q_lora 1536, kv_lora 512, qk_nope 128, qk_rope 64, v_head 128.
"""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,              # MLA: all heads share the latent KV
    head_dim=128,
    d_ff=1536,                     # routed-expert width
    vocab_size=102400,
    hidden_act="silu",
    rope_theta=10000.0,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=160, num_experts_per_tok=6, d_ff=1536,
                  num_shared_experts=2, shared_d_ff=1536,
                  capacity_factor=1.25, first_k_dense=1, dense_d_ff=12288),
    source="arXiv:2405.04434; hf",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=32, vocab_size=512,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        moe=MoEConfig(num_experts=8, num_experts_per_tok=2, d_ff=32,
                      num_shared_experts=1, shared_d_ff=32,
                      capacity_factor=1.5, first_k_dense=1, dense_d_ff=64),
        attn_q_block=32, attn_kv_block=32)
