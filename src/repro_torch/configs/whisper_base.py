"""whisper-base — encoder-decoder audio backbone; conv frontend STUBBED.
[arXiv:2212.04356]

6 encoder + 6 decoder layers, d_model=512, 8 heads, d_ff=2048 (non-gated GeLU
MLP), vocab=51865.  The mel/conv frontend is a stub: ``input_specs()``
provides precomputed frame embeddings of length ``enc_seq_len``.
Decoder has self-attention (causal, cached at decode) + cross-attention.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,             # decoder depth
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    gated_mlp=False,
    use_abs_pos=True,
    max_abs_pos=65536,
    enc_layers=6,
    enc_seq_len=1500,
)

REDUCED = ModelConfig(
    name="whisper-base-reduced",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    gated_mlp=False,
    use_abs_pos=True,
    max_abs_pos=1024,
    enc_layers=2,
    enc_seq_len=30,
)
