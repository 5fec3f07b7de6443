"""qwen3-32b — dense, qk_norm + GQA kv=8, head_dim=128.  [hf:Qwen/Qwen3-8B family]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1000000.0,
)

REDUCED = ModelConfig(
    name="qwen3-32b-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=192,
    vocab_size=512,
    head_dim=16,
    qk_norm=True,
    rope_theta=1000000.0,
)
