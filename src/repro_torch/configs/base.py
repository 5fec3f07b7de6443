"""Model/shape configuration schema (the port's copy of ``repro.configs.base``).

Every assigned architecture gets one ``configs/<id>.py`` exporting a
``CONFIG`` (the exact published shape) and a ``REDUCED`` (same family, tiny —
used by CPU smoke tests).  ``registry()`` collects them all.

Shapes (the four assigned input-shape cells) are defined here as
``ShapeSpec`` and are paired with every architecture.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (the *model*, not the HPT search space)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads

    # attention features
    rope_theta: float = 10000.0
    qk_norm: bool = False
    qkv_bias: bool = False
    norm_eps: float = 1e-5
    use_abs_pos: bool = False       # learned absolute positions (whisper)
    max_abs_pos: int = 8192

    # MLP
    gated_mlp: bool = True          # SwiGLU when True, plain GeLU MLP otherwise
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0               # per-expert hidden dim
    first_k_dense: int = 0          # leading dense layers (deepseek-v2 layer 0)
    capacity_factor: float = 1.25
    moe_aux_loss_coef: float = 0.01
    moe_sharding: str = "auto"      # auto | ep | tp  (see models/moe.py)

    # MLA (deepseek-v2)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    ssm_groups: int = 1
    conv_kernel: int = 4

    # hybrid (zamba2): apply the single shared attention block every k layers
    attn_every: int = 0

    # encoder-decoder (whisper): n_layers is the decoder depth
    enc_layers: int = 0
    enc_seq_len: int = 0            # stub frame-embedding length

    # vlm (pixtral): stub patch embeddings occupy the first n_patches positions
    n_patches: int = 0

    # numerics
    dtype: str = "bfloat16"
    # "fp32" = fp32 master + fp32 moments; "moments_fp32" = bf16 params,
    # fp32 moments only (used by the >100B MoE archs to fit v5e HBM).
    opt_precision: str = "fp32"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ---- derived quantities -------------------------------------------------
    @property
    def is_encoder_decoder(self) -> bool:
        return self.enc_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.family == "ssm"

    @property
    def is_hybrid(self) -> bool:
        return self.family == "hybrid"

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_d_inner // self.ssm_headdim

    @property
    def sub_quadratic(self) -> bool:
        """True when the arch supports long_500k (no full-attention scaling)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Total parameter count (analytic, matches init)."""
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top-k routed only)."""
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

ARCH_IDS = [
    "phi3-mini-3.8b",
    "qwen1.5-0.5b",
    "internlm2-20b",
    "qwen3-32b",
    "pixtral-12b",
    "deepseek-v2-236b",
    "grok-1-314b",
    "mamba2-130m",
    "zamba2-1.2b",
    "whisper-base",
]


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether an (arch, shape) cell runs, and why not when skipped.

    ``long_500k`` needs sub-quadratic attention: run only for ssm/hybrid.
    (documented in DESIGN.md §Arch-applicability).
    """
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 500k decode is quadratic — skipped"
    return True, ""


_REGISTRY: dict | None = None


def registry() -> dict:
    """arch id -> module with CONFIG / REDUCED."""
    global _REGISTRY
    if _REGISTRY is None:
        import importlib

        mods = {}
        for arch in ARCH_IDS:
            mod = importlib.import_module(
                "repro_torch.configs." + arch.replace("-", "_").replace(".", "_")
            )
            mods[arch] = mod
        _REGISTRY = mods
    return _REGISTRY


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    mod = registry()[arch]
    return mod.REDUCED if reduced else mod.CONFIG
