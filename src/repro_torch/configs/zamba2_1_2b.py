"""zamba2-1.2b — hybrid: Mamba2 backbone + one shared attention block.
[arXiv:2411.15242]

38 mamba2 layers (d_model=2048, headdim=64, d_state=64); a single *shared*
(weight-tied) attention+MLP block is applied every ``attn_every`` mamba layers.
Sub-quadratic backbone: runs long_500k (the shared-attn KV caches are
sequence-sharded at that length — see launch/sharding.py).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    head_dim=64,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=256,
    conv_kernel=4,
    attn_every=6,
    rope_theta=10000.0,
)

REDUCED = ModelConfig(
    name="zamba2-1.2b-reduced",
    family="hybrid",
    n_layers=5,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=16,
    ssm_chunk=16,
    conv_kernel=4,
    attn_every=2,
    rope_theta=10000.0,
)
