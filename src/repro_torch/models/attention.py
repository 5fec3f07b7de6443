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
Training takes the kernel's ``FlashAttention`` Function, whose plain
backward walks the keys in chunks of ``min(chunk, S)`` (one chunk where
that does not divide S), as the JAX package's flash VJP does.  The
gradients of the K/V heads that GQA repeats are summed by autograd of
``repeat_interleave``.  Decode stays plain PyTorch: over the full local
cache, or, on a mesh, over this rank's shard of it
(``distributed_decode_attention``: the JAX package's ``shard_map``
flash-decode, its ``pmax`` / ``psum`` as all-reduces over process groups).
A rank's block of queries against the whole sequence's keys takes the
kernel with the causal mask offset by the block's first position
(``q_offset``).  v may be narrower than q and k: MLA's materialized form
(q and k 192 wide, v 128 at deepseek-v2's width) takes the kernel too.
MLA's absorbed form (one shared key head 576 wide, value head 512) runs
its own kernels on the card (``models.mla.latent_attention``) and, on the
CPU, ``plain_attention``: the JAX package's chunked flash VJP or its naive
path, chosen as the reference's ``attention.attention`` chooses, plain.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.collectives import axis_index, axis_size, replicate_like
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
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


def qkv_project(x, params, cfg, positions, rope: bool = True, layout=None,
                flat_q: bool = False):
    """x: (B, S, D) -> q (B,S,KV,G,Dh), k, v (B,S,KV,Dh).

    The sharded forward passes ``layout``, a function that places each flat
    projection (B, S, n*Dh) before its heads are split, called as
    ``layout(t, "q")`` and ``layout(t, "kv")``; with ``flat_q`` q comes
    back as (B, S, H, Dh) (a head dim split over the model axis cannot be
    cut into KV x G on a DTensor when KV does not divide it)."""
    B, S, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // kv
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    if layout is not None:
        q, k, v = layout(q, "q"), layout(k, "kv"), layout(v, "kv")
    q = q.reshape(B, S, h, dh)
    k = k.reshape(B, S, kv, dh)
    v = v.reshape(B, S, kv, dh)
    if cfg.qk_norm:
        q = layers.rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = layers.rms_norm(k, params["k_norm"], cfg.norm_eps)
    if rope:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    return (q if flat_q else q.reshape(B, S, kv, g, dh)), k, v


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
        mask = replicate_like(qpos[:, None] >= kpos[None, :], s)
        s = torch.where(mask, s, torch.full((), NEG_INF, dtype=f32, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(f32))
    return o.to(q.dtype)


class ChunkedAttention(torch.autograd.Function):
    """The JAX package's ``flash_attention_vjp``, plain: the forward an
    online softmax over key chunks that keeps (o, lse)
    (``ref.flash_attention_fwd_lse``), the backward recomputing each chunk's
    probabilities from lse (``ref.flash_attention_bwd``), so neither pass
    holds more than one (Sq, chunk) score tile.  q (B,Sq,KV,G,Dk); k
    (B,Sk,KV,Dk), v (B,Sk,KV,Dv), each K/V head read once for its G query
    heads (never repeated per head), Dk and Dv free -> (B,Sq,KV,G,Dv)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, chunk, q_offset, scale):
        o, lse = ref.flash_attention_fwd_lse(q, k, v, causal, scale, chunk, q_offset)
        ctx.save_for_backward(q, k, v, lse)
        ctx.args = (causal, scale, chunk, q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        causal, scale, chunk, q_offset = ctx.args
        dq, dk, dv = ref.flash_attention_bwd(q, k, v, lse, do, causal, scale, chunk,
                                             q_offset)
        return dq, dk, dv, None, None, None, None


def plain_attention(q, k, v, causal: bool, chunk: int, q_offset: int = 0,
                    use_chunked: bool = True, scale: Optional[float] = None):
    """Plain attention routed as the JAX package's ``attention.attention``:
    ``ChunkedAttention`` over key chunks of ``chunk`` where ``use_chunked``,
    Sk >= chunk and chunk divides Sk, else ``naive_attention``.  The layouts
    are ``ChunkedAttention``'s (v's width free); ``q_offset`` is the global
    position of q's first row under the causal mask."""
    Sk = k.shape[1]
    if use_chunked and Sk >= chunk and Sk % chunk == 0:
        s = float(scale if scale is not None else q.shape[-1] ** -0.5)
        return ChunkedAttention.apply(q, k, v, causal, min(chunk, Sk), q_offset, s)
    return naive_attention(q, k, v, causal, q_offset, scale=scale)


def attention(q, k, v, causal: bool, scale: Optional[float] = None,
              kernels: Optional[str] = None, chunk: Optional[int] = None,
              q_offset: int = 0):
    """Full-sequence attention through ``kops.flash_attention``.
    q, k (B,Sq,KV,G,Dh), (B,Sk,KV,Dh); v (B,Sk,KV,Dv) -> (B,Sq,KV,G,Dv) in
    q's type (Dv = Dh but in MLA's materialized form).  K/V
    are expanded to the H = KV * G query heads first (the kernel's layout,
    as ``flash_attention.py`` asks of GQA callers); ``kernels`` is
    ``ModelCtx.kernels``, ``chunk`` its ``attn_chunk`` (the backward's key
    chunk); ``q_offset`` the global position of q's first row under the
    causal mask (a rank's sequence block against the whole keys)."""
    B, S, KV, G, Dh = q.shape
    q4 = q.reshape(B, S, KV * G, Dh)
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    o = kops.flash_attention(q4, k, v, causal, scale, chunk=chunk, force=kernels,
                             q_offset=q_offset)
    return o.reshape(B, S, KV, G, v.shape[-1])


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


def cache_update(cache, k_new, v_new, pos: int,
                 shard_start: Optional[int] = None):
    """Write (B, 1, KV, Dh) at position ``pos``.  In place, where the JAX
    package returns a new cache (its jitted step donates the old one): the
    cache's tensors are updated and the same dict is returned.  With
    ``shard_start`` the cache is this rank's slice of a sequence-sharded
    one, whose first slot is global position ``shard_start``: only the rank
    whose slice holds ``pos`` writes, at ``pos - shard_start``."""
    if shard_start is not None:
        pos -= shard_start
        if not 0 <= pos < cache["k"].shape[1]:
            return cache
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
    """(B, S, KV, G, Dh) or (B, S, H, Dh) -> (B, S, H*Dh)."""
    B, S = o.shape[:2]
    return o.reshape(B, S, cfg.n_heads * cfg.head_dim)


def distributed_decode_attention(q, k_shard, v_shard, pos: int, seq_group,
                                 shard_start: int, scale: Optional[float] = None,
                                 hd_group=None):
    """Flash-decode across a sequence-sharded cache: the JAX package's
    ``shard_map`` body, its collectives on process groups.

    q (B,1,KV,G,Dh) the same on every rank of ``seq_group``; k/v shards
    (B,S_loc,KV,Dh'); ``shard_start``: this shard's first global cache slot.
    One MAX all-reduce and two SUM all-reduces over ``seq_group`` implement
    an exact log-sum-exp combine, the sum normalized after the product
    (``seq_group`` None: one shard, no collective, and the softmax before
    the product, ``decode_attention``'s order: the JAX package's decode
    under a plan without sequence axes runs ``decode_attention``).  When
    the head_dim is additionally split over the model axis (``hd_group``),
    the partial scores are SUM-reduced over it before the softmax;
    ``scale`` is then the full head's, which the caller passes.  ->
    (B,1,KV,G,Dv') in q's type."""
    Dh = q.shape[-1]
    S_loc = k_shard.shape[1]
    scale = scale if scale is not None else Dh ** -0.5
    f32 = torch.float32
    s = torch.einsum("bqkgd,bskd->bkgqs", q.to(f32) * scale, k_shard.to(f32))
    if hd_group is not None:
        dist.all_reduce(s, op=dist.ReduceOp.SUM, group=hd_group)
    gpos = shard_start + torch.arange(S_loc, device=q.device)
    s = torch.where(gpos <= pos, s, torch.full((), NEG_INF, dtype=f32, device=q.device))
    if seq_group is None:
        # one shard of the sequence: ``decode_attention``'s arithmetic (the
        # softmax before the product), as the JAX package's decode computes
        # under a plan with no sequence axes
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bkgqs,bskd->bqkgd", p, v_shard.to(f32)).to(q.dtype)

    m = torch.amax(s, dim=-1)                                   # (B,KV,G,1)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=seq_group)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    o = torch.einsum("bkgqs,bskd->bkgqd", p, v_shard.to(f32))
    dist.all_reduce(l, op=dist.ReduceOp.SUM, group=seq_group)
    dist.all_reduce(o, op=dist.ReduceOp.SUM, group=seq_group)
    o = o / torch.clamp(l, min=1e-30)[..., None]                # (B,KV,G,1,Dv)
    return o.permute(0, 3, 1, 2, 4).to(q.dtype)                 # (B,1,KV,G,Dv)


def seq_shard_start(mesh, seq_axes, total_len: int) -> int:
    """Global offset of this rank's slice of a cache sequence of
    ``total_len`` split over ``seq_axes`` (major to minor)."""
    if not seq_axes:
        return 0
    return axis_index(mesh, seq_axes) * (total_len // axis_size(mesh, seq_axes))
