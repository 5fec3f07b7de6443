"""mamba2-130m — SSM (state-space duality), attention-free.  [arXiv:2405.21060]

24 layers, d_model=768, expand=2 -> d_inner=1536, headdim=64 (24 SSM heads),
d_state=128, depthwise conv kernel 4.  Sub-quadratic: runs long_500k.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    head_dim=1,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=256,
    conv_kernel=4,
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="mamba2-130m-reduced",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=256,
    head_dim=1,
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=16,
    ssm_chunk=32,
    conv_kernel=4,
    tie_embeddings=True,
)
