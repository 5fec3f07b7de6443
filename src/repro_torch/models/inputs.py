"""Input construction (the port of ``repro.models.inputs``): abstract
stand-ins for the dry run, tensors on the ``meta`` device that carry a
shape and a type and no storage (the JAX package's ``ShapeDtypeStruct``s;
token ids and labels are int64, the port's index type, where the JAX
package's are int32), and concrete sample batches.  The same generator
state gives the same tokens, patch embeddings and frames as the JAX
package's ``sample_train_batch``.

Modality frontends are stubs: whisper takes precomputed frame embeddings
(B, enc_seq_len, d_model), pixtral precomputed patch embeddings
(B, n_patches, d_model); both are inputs, not parameters."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.context import null_ctx
from repro_torch.models.layers import dtype_of

_META = torch.device("meta")


def _abstract(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=_META)


def train_batch_shapes(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """Abstract train batch: {tokens, labels [, frames | patch_embeds]}."""
    dt = dtype_of(cfg)
    n_text = seq - (cfg.n_patches if cfg.family == "vlm" else 0)
    d = {"tokens": _abstract((batch, n_text), torch.int64),
         "labels": _abstract((batch, seq), torch.int64)}
    if cfg.family == "vlm":
        d["patch_embeds"] = _abstract((batch, cfg.n_patches, cfg.d_model), dt)
    if cfg.family == "audio":
        d["frames"] = _abstract((batch, cfg.enc_seq_len, cfg.d_model), dt)
    return d


def prefill_batch_shapes(cfg: ModelConfig, batch: int, seq: int) -> dict:
    d = train_batch_shapes(cfg, batch, seq)
    d.pop("labels")
    return d


def decode_input_shapes(cfg: ModelConfig, batch: int, seq: int):
    """(tokens, cache, pos) abstract inputs of ``Model.decode_step``.  The
    cache is what the port's own ``Model.prefill`` returns on ``meta``
    tensors of the prompt (the JAX package's ``eval_shape`` of its
    prefill): always the model code's structure, nothing allocated.  The
    prefill takes the kernels' routes (``kernels="cuda"``), whose
    operators give their shapes on ``meta`` tensors in one call a chunk."""
    from repro_torch.models.model import Model, _param_shapes

    with torch.no_grad():
        _, cache = Model(cfg).prefill(_param_shapes(cfg),
                                      prefill_batch_shapes(cfg, batch, seq),
                                      null_ctx(kernels="cuda"))
    return _abstract((batch, 1), torch.int64), cache, _abstract((), torch.int64)


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
