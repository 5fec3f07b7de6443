"""Concrete sample batches, as numpy (the port of
``repro.models.inputs.sample_train_batch``; the abstract ``*_shapes``
helpers belong to the dry-run and are not ported).  The same generator
state gives the same tokens as the JAX package's function."""

from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ModelConfig


def sample_train_batch(rng: np.random.Generator, cfg: ModelConfig, batch: int,
                       seq: int) -> dict:
    """{"tokens": (batch, seq) int32, "labels": (batch, seq) int32}: uniform
    token ids and the tokens shifted by one.  The vlm and audio stubs
    (patch and frame embeddings) belong to families not ported yet."""
    if cfg.family in ("vlm", "audio"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported to "
                                  "repro_torch yet (ROADMAP A10)")
    toks = rng.integers(0, cfg.vocab_size, size=(batch, seq), dtype=np.int32)
    labels = np.concatenate([toks[:, 1:], toks[:, :1]], axis=1).astype(np.int32)
    return {"tokens": toks, "labels": labels}
