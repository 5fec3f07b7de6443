"""internlm2-20b — dense, GQA kv=8.  [arXiv:2403.17297]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
    rope_theta=1000000.0,
)

REDUCED = ModelConfig(
    name="internlm2-20b-reduced",
    family="dense",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    rope_theta=1000000.0,
)
