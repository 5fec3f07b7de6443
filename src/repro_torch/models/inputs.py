"""Concrete sample batches (the port of
``repro.models.inputs.sample_train_batch``; the abstract ``*_shapes``
helpers belong to the dry-run and are not ported).  The same generator
state gives the same tokens, patch embeddings and frames as the JAX
package's function."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dtype_of


def sample_train_batch(rng: np.random.Generator, cfg: ModelConfig, batch: int,
                       seq: int) -> dict:
    """{"tokens": (batch, n_text) int32, "labels": (batch, seq) int32}:
    uniform token ids and the tokens shifted by one.  The stub modality
    embeddings, float64 ``standard_normal * 0.02`` drawn after the tokens
    and cast to the config dtype as a CPU tensor (numpy has no bfloat16):
    the vlm family's ``"patch_embeds"`` (batch, n_patches, d_model), which
    take the first n_patches of the seq positions (n_text = seq -
    n_patches; their labels are -1, masked out of the loss); the audio
    family's ``"frames"`` (batch, enc_seq_len, d_model)."""
    n_text = seq - (cfg.n_patches if cfg.family == "vlm" else 0)
    toks = rng.integers(0, cfg.vocab_size, size=(batch, n_text), dtype=np.int32)
    labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1).astype(np.int32)
    out = {"tokens": toks}
    if cfg.family == "vlm":
        out["patch_embeds"] = _stub(rng, (batch, cfg.n_patches, cfg.d_model), cfg)
        pad = np.full((batch, cfg.n_patches), -1, np.int32)
        labels = np.concatenate([pad, labels], axis=1)
    if cfg.family == "audio":
        out["frames"] = _stub(rng, (batch, cfg.enc_seq_len, cfg.d_model), cfg)
    out["labels"] = labels
    return out


def _stub(rng, shape, cfg):
    """float64 -> float32 -> the config dtype: the rounding path of
    jnp.asarray(float64 array, dtype=bfloat16)."""
    x = rng.standard_normal(shape) * 0.02
    return torch.from_numpy(x.astype(np.float32)).to(dtype_of(cfg))
