"""Concrete sample batches (the port of
``repro.models.inputs.sample_train_batch``; the abstract ``*_shapes``
helpers belong to the dry-run and are not ported).  The same generator
state gives the same tokens and frames as the JAX package's function."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dtype_of


def sample_train_batch(rng: np.random.Generator, cfg: ModelConfig, batch: int,
                       seq: int) -> dict:
    """{"tokens": (batch, seq) int32, "labels": (batch, seq) int32}: uniform
    token ids and the tokens shifted by one.  The audio family adds
    ``"frames"`` (batch, enc_seq_len, d_model), the stub frame embeddings:
    float64 ``standard_normal * 0.02`` drawn after the tokens, cast to the
    config dtype as a CPU tensor (numpy has no bfloat16).  The vlm stub
    (patch embeddings) belongs to a family not ported yet (ROADMAP A10)."""
    if cfg.family == "vlm":
        raise NotImplementedError(f"family {cfg.family!r} is not ported to "
                                  "repro_torch yet (ROADMAP A10)")
    toks = rng.integers(0, cfg.vocab_size, size=(batch, seq), dtype=np.int32)
    labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1).astype(np.int32)
    out = {"tokens": toks}
    if cfg.family == "audio":
        frames = rng.standard_normal((batch, cfg.enc_seq_len, cfg.d_model)) * 0.02
        # float64 -> float32 -> the config dtype, the rounding path of
        # jnp.asarray(float64 array, dtype=bfloat16)
        out["frames"] = torch.from_numpy(frames.astype(np.float32)).to(dtype_of(cfg))
    out["labels"] = labels
    return out
