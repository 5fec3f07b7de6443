"""grok-1-314b — MoE 8 experts top-2.  [hf:xai-org/grok-1]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    head_dim=128,
    n_experts=8,
    experts_per_tok=2,
    moe_d_ff=32768,
    moe_sharding="tp",     # 8 experts < model axis 16 -> shard expert FFN dim
    rope_theta=10000.0,
    opt_precision="moments_fp32",
)

REDUCED = ModelConfig(
    name="grok-1-314b-reduced",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=512,
    head_dim=16,
    n_experts=4,
    experts_per_tok=2,
    moe_d_ff=160,
    moe_sharding="tp",
    rope_theta=10000.0,
)
