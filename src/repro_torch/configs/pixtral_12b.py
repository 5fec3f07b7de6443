"""pixtral-12b — VLM: pixtral-ViT stub frontend + mistral-nemo backbone.

[hf:mistralai/Pixtral-12B-2409].  The vision tower is a STUB per assignment:
``input_specs()`` provides precomputed patch embeddings occupying the first
``n_patches`` sequence positions; the decoder backbone (the part we build) is
the mistral-nemo-style dense transformer below.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    rope_theta=1000000.0,
    n_patches=1024,
)

REDUCED = ModelConfig(
    name="pixtral-12b-reduced",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=512,
    head_dim=16,
    rope_theta=1000000.0,
    n_patches=8,
)
