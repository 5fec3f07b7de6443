"""deepseek-v2-236b — MoE 160e top-6 + 2 shared, MLA kv_lora=512.  [arXiv:2405.04434]

MLA: q_lora_rank=1536, kv_lora_rank=512, qk_nope=128, qk_rope=64, v=128.
First layer is dense (d_ff=12288); remaining 59 layers are MoE with
per-expert d_ff=1536.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=12288,            # dense layers (first_k_dense)
    vocab_size=102400,
    n_experts=160,
    experts_per_tok=6,
    n_shared_experts=2,
    moe_d_ff=1536,
    first_k_dense=1,
    moe_sharding="ep",     # 160 % 16 == 0 -> expert parallel over 'model'
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_theta=10000.0,
    opt_precision="moments_fp32",
)

REDUCED = ModelConfig(
    name="deepseek-v2-236b-reduced",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=160,
    vocab_size=512,
    n_experts=8,
    experts_per_tok=2,
    n_shared_experts=1,
    moe_d_ff=48,
    first_k_dense=1,
    moe_sharding="ep",
    use_mla=True,
    q_lora_rank=48,
    kv_lora_rank=32,
    qk_nope_head_dim=16,
    qk_rope_head_dim=8,
    v_head_dim=16,
    rope_theta=10000.0,
)
