"""GQA attention: full-sequence attention on the flash kernel, naive
reference, KV cache and single-token decode.

The port of ``repro.models.attention``, with its layouts:
  q               (B, Sq, KV, G, Dh)   G = n_heads // n_kv_heads
  k, v            (B, Sk, KV, Dh)
  scores          (B, KV, G, Sq, Sk)

Full-sequence attention (train forward and prefill) always goes through
``kops.flash_attention``: the hand-written kernel on the card, its plain
version on the CPU.  Where the JAX package picks a lowering by length (the
``lax.scan`` flash path when S is a multiple of the chunk, else the naive
one), the function is the same, so the port runs the kernel at every length.
Decode stays plain PyTorch over the full local cache.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import layers

NEG_INF = -1e30


def init_attention(gen, cfg, device):
    dt = layers.dtype_of(cfg)
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": layers.dense_init(gen, d, h * dh, dt, device),
        "wk": layers.dense_init(gen, d, kv * dh, dt, device),
        "wv": layers.dense_init(gen, d, kv * dh, dt, device),
        "wo": layers.dense_init(gen, h * dh, d, dt, device),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", h * dh), ("bk", kv * dh), ("bv", kv * dh)):
            p[name] = torch.zeros((n,), dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = layers.init_rmsnorm(dh, device)
        p["k_norm"] = layers.init_rmsnorm(dh, device)
    return p


def qkv_project(x, params, cfg, positions, rope: bool = True):
    """x: (B, S, D) -> q (B,S,KV,G,Dh), k, v (B,S,KV,Dh)."""
    B, S, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // kv
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, S, kv, g, dh)
    k = k.reshape(B, S, kv, dh)
    v = v.reshape(B, S, kv, dh)
    if cfg.qk_norm:
        q = layers.rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = layers.rms_norm(k, params["k_norm"], cfg.norm_eps)
    if rope:
        qf = layers.apply_rope(q.reshape(B, S, kv * g, dh), positions, cfg.rope_theta)
        q = qf.reshape(B, S, kv, g, dh)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def naive_attention(q, k, v, causal: bool, q_offset: int = 0,
                    scale: Optional[float] = None):
    """Materialized-scores attention.  q (B,Sq,KV,G,Dh); k, v (B,Sk,KV,Dh)."""
    Sq, Dh = q.shape[1], q.shape[-1]
    Sk = k.shape[1]
    scale = scale if scale is not None else Dh ** -0.5
    f32 = torch.float32
    s = torch.einsum("bqkgd,bskd->bkgqs", q.to(f32), k.to(f32)) * scale
    if causal:
        qpos = torch.arange(Sq, device=q.device) + q_offset
        kpos = torch.arange(Sk, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        s = torch.where(mask, s, torch.full((), NEG_INF, dtype=f32, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(f32))
    return o.to(q.dtype)


def attention(q, k, v, causal: bool, scale: Optional[float] = None,
              kernels: Optional[str] = None):
    """Full-sequence attention through ``kops.flash_attention``.
    q (B,S,KV,G,Dh); k, v (B,S,KV,Dh) -> (B,S,KV,G,Dh) in q's type.  K/V are
    expanded to the H = KV * G query heads first (the kernel's layout, as
    ``flash_attention.py`` asks of GQA callers); ``kernels`` is
    ``ModelCtx.kernels``."""
    B, S, KV, G, Dh = q.shape
    q4 = q.reshape(B, S, KV * G, Dh)
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    o = kops.flash_attention(q4, k, v, causal, scale, force=kernels)
    return o.reshape(B, S, KV, G, Dh)


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, seq_len: int, device, dtype=None,
               n_kv: Optional[int] = None, head_dim: Optional[int] = None):
    dt = dtype or layers.dtype_of(cfg)
    kv = n_kv if n_kv is not None else cfg.n_kv_heads
    dh = head_dim if head_dim is not None else cfg.head_dim
    return {"k": torch.zeros((batch, seq_len, kv, dh), dtype=dt, device=device),
            "v": torch.zeros((batch, seq_len, kv, dh), dtype=dt, device=device)}


def cache_update(cache, k_new, v_new, pos: int):
    """Write (B, 1, KV, Dh) at position ``pos``.  In place, where the JAX
    package returns a new cache (its jitted step donates the old one): the
    cache's tensors are updated and the same dict is returned."""
    cache["k"][:, pos:pos + 1] = k_new.to(cache["k"].dtype)
    cache["v"][:, pos:pos + 1] = v_new.to(cache["v"].dtype)
    return cache


def decode_attention(q, cache, pos: int, scale: Optional[float] = None):
    """Single-token decode over a full local cache.  q (B, 1, KV, G, Dh);
    cache k/v (B, S, KV, Dh); cache positions > ``pos`` are masked out."""
    Dh = q.shape[-1]
    S = cache["k"].shape[1]
    scale = scale if scale is not None else Dh ** -0.5
    f32 = torch.float32
    s = torch.einsum("bqkgd,bskd->bkgqs", q.to(f32) * scale, cache["k"].to(f32))
    valid = torch.arange(S, device=q.device) <= pos
    s = torch.where(valid, s, torch.full((), NEG_INF, dtype=f32, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, cache["v"].to(f32))
    return o.to(q.dtype)


def merge_heads(o, cfg):
    """(B, S, KV, G, Dh) -> (B, S, H*Dh)."""
    B, S = o.shape[:2]
    return o.reshape(B, S, cfg.n_heads * cfg.head_dim)
