"""Basic layers in plain PyTorch: norms, MLPs, RoPE, embeddings.

The port of ``repro.models.layers``.  Parameters are nested dicts of
tensors; every function is pure.  Compute runs in the config dtype (bf16 by
default) with float32 norms and rotations: every float32 upcast and every
cast back to the input dtype sits where the JAX package has it, since bf16
parity depends on it.  Initializers draw from a ``torch.Generator`` with the
JAX package's distributions (the numbers differ: ``jax.random`` is not
reproduced); a tensor on the ``meta`` device draws nothing.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.collectives import replicate_like

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def _draw(gen, shape, device, dtype, fill):
    """A float32 draw on the generator's device, moved to ``device`` in
    ``dtype``; ``fill(t, gen)`` fills it in place.  On ``meta`` only the
    shape and type are made."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    fill(t, gen)
    return t.to(device=device, dtype=dtype)


def dense_init(gen, in_dim: int, out_dim: int, dtype, device, scale: float = 1.0):
    """Truncated-normal fan-in init: N(0, 1) cut at +-2, times
    scale / sqrt(in_dim), as ``repro.models.layers.dense_init``."""
    std = scale / np.sqrt(in_dim)

    def fill(t, g):
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=g)
        t.mul_(float(std))
    return _draw(gen, (in_dim, out_dim), device, dtype, fill)


def normal_init(gen, shape, std: float, dtype, device):
    return _draw(gen, shape, device, dtype,
                 lambda t, g: t.normal_(0.0, std, generator=g))


def uniform_init(gen, shape, lo: float, hi: float, device):
    return _draw(gen, shape, device, torch.float32,
                 lambda t, g: t.uniform_(lo, hi, generator=g))


def embed_init(gen, vocab: int, dim: int, dtype, device):
    return normal_init(gen, (vocab, dim), 0.02, dtype, device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_rmsnorm(dim: int, device, dtype=torch.float32):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rms_norm(x, params, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(dt)


def init_layernorm(dim: int, device, dtype=torch.float32):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layer_norm(x, params, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(dt)


# ---------------------------------------------------------------------------
# MLP (SwiGLU or plain GeLU)
# ---------------------------------------------------------------------------


def init_mlp(gen, d_model: int, d_ff: int, gated: bool, dtype, device):
    p = {"w_up": dense_init(gen, d_model, d_ff, dtype, device),
         "w_down": dense_init(gen, d_ff, d_model, dtype, device)}
    if gated:
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype, device)
    return p


def mlp(x, params, gated: bool):
    up = x @ params["w_up"]
    if gated:
        act = F.silu(x @ params["w_gate"]) * up
    else:
        act = F.gelu(up, approximate="tanh")     # jax.nn.gelu's default
    return act @ params["w_down"]


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float):
    """Inverse frequencies for the even half of head_dim."""
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq).
    The half-split convention (rotate the [a, b] halves), as llama."""
    head_dim = x.shape[-1]
    inv_freq = torch.as_tensor(rope_frequencies(head_dim, theta), device=x.device)
    ang = positions[..., None].to(torch.float32) * inv_freq   # (..., seq, half)
    cos = replicate_like(torch.cos(ang)[..., None, :], x)     # (..., seq, 1, half)
    sin = replicate_like(torch.sin(ang)[..., None, :], x)
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------


def init_embed(gen, cfg, device):
    p = {"tok": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype_of(cfg), device)}
    if cfg.use_abs_pos:
        p["pos"] = embed_init(gen, cfg.max_abs_pos, cfg.d_model, dtype_of(cfg), device)
    return p


def _rows(table, ids):
    """``table[ids]``; a DTensor table through ``F.embedding``, whose
    sharding rule keeps the table's placement (d_model over the model axis)
    and whose backward has one."""
    if isinstance(table, DTensor):
        return F.embedding(replicate_like(ids, table), table)
    return table[ids]


def embed_tokens(params, tokens, cfg, positions=None):
    x = _rows(params["tok"], tokens)
    if cfg.use_abs_pos:
        if positions is None:
            positions = torch.arange(tokens.shape[-1], device=tokens.device)
        x = x + _rows(params["pos"], positions)
    return x
