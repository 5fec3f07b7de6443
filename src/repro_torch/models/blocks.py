"""Block composition: pre-norm transformer (dense GQA or MLA attention,
dense or MoE FFN), mamba and whisper encoder / decoder blocks.

The port of ``repro.models.blocks``.  Each block provides ``init_*``, a
full-sequence ``*_fwd``, a ``*_prefill`` (returns a decode cache) and a
``*_decode`` (one token); whisper's encoder block has the forward only.
Blocks are pure functions over per-layer parameter dicts; ``model.py``
stacks them along a leading L axis and loops over it.
"""

from __future__ import annotations

import torch

from repro_torch.collectives import all_gather_ordered, axis_index
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers, mla, moe, ssd


# ---------------------------------------------------------------------------
# attention sub-block (dense GQA or MLA)
# ---------------------------------------------------------------------------


def init_attn(gen, cfg, device):
    if cfg.use_mla:
        return mla.init_mla(gen, cfg, device)
    return attn_lib.init_attention(gen, cfg, device)


def _sharded_attention(q, k, v, cfg, ctx, causal):
    """The JAX package's 'kv' attention layout (heads as they come); one
    card shards nothing."""
    return attn_lib.attention(q, k, v, causal=causal, kernels=ctx.kernels,
                              chunk=ctx.attn_chunk)


def attn_fwd(h, p, cfg, ctx, positions, causal=True):
    """Normed input -> attention output (full sequence)."""
    if cfg.use_mla:
        return mla.mla_train(h, p, cfg, positions, ctx)
    q, k, v = attn_lib.qkv_project(h, p, cfg, positions)
    o = _sharded_attention(q, k, v, cfg, ctx, causal)
    return attn_lib.merge_heads(o, cfg) @ p["wo"]


def attn_prefill(h, p, cfg, ctx, positions):
    if cfg.use_mla:
        return mla.mla_prefill(h, p, cfg, positions, ctx)
    q, k, v = attn_lib.qkv_project(h, p, cfg, positions)
    o = _sharded_attention(q, k, v, cfg, ctx, causal=True)
    out = attn_lib.merge_heads(o, cfg) @ p["wo"]
    return out, {"k": k, "v": v}  # the cache stays KV-compact


def attn_decode(h, p, cfg, ctx, cache, pos: int):
    """h (B,1,D); cache {k, v} (B,S,KV,Dh) or MLA's {c_kv, k_rope}, updated
    in place; pos int.  Under a decode plan on a mesh (``ctx.sharded_decode``)
    h is this rank's batch slice and the cache its shard."""
    if cfg.use_mla:
        return mla.mla_decode(h, p, cfg, cache, pos, ctx)
    B = h.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=h.device)
    q, k_new, v_new = attn_lib.qkv_project(h, p, cfg, positions)
    if ctx.sharded_decode:
        o = _distributed_decode(q, k_new, v_new, cache, pos, ctx)
    else:
        cache = attn_lib.cache_update(cache, k_new, v_new, pos)
        o = attn_lib.decode_attention(q, cache, pos)
    return attn_lib.merge_heads(o, cfg) @ p["wo"], cache


def _distributed_decode(q, k_new, v_new, cache, pos: int, ctx):
    """Flash-decode over this rank's shard of the KV cache (the JAX
    package's ``shard_map`` body, with the cache write it does outside).

    The layout is ``ctx.decode_plan``'s: the batch over ``plan.b_axes`` (q
    is already this rank's batch slice), the cache sequence over
    ``plan.seq_axes``, the KV heads (``kv_axis == "model"``) or the head_dim
    (``"HD"``) over the model axis.  q and the new K/V are computed whole on
    every rank; each keeps its own heads or head_dim slice, the rank whose
    sequence slice holds ``pos`` writes the new K/V, and the output's heads
    or head_dim are gathered back over the model axis.  A plan without
    sequence axes (mode "local") makes no sequence collective."""
    plan, mesh, groups, m = ctx.decode_plan, ctx.mesh, ctx.groups, ctx.model_axis
    seq = tuple(plan.seq_axes)
    scale = q.shape[-1] ** -0.5                     # the whole head's
    # the dims of q (B,1,KV,G,Dh) and of k, v (B,1,KV,Dh) the model axis splits
    q_dim, kv_dim = {"model": (2, 2), "HD": (4, 3)}.get(plan.kv_axis, (None, None))
    if q_dim is not None:
        n, i = ctx.axis_size(m), axis_index(mesh, m)
        q = q.narrow(q_dim, i * (q.shape[q_dim] // n), q.shape[q_dim] // n)
        w = k_new.shape[kv_dim] // n
        k_new, v_new = k_new.narrow(kv_dim, i * w, w), v_new.narrow(kv_dim, i * w, w)
    start = attn_lib.seq_shard_start(mesh, seq, cache["k"].shape[1] * ctx.axis_size(seq))
    attn_lib.cache_update(cache, k_new, v_new, pos, shard_start=start)
    o = attn_lib.distributed_decode_attention(
        q, cache["k"], cache["v"], pos, groups.group(seq) if seq else None, start,
        scale=scale, hd_group=groups.group(m) if plan.kv_axis == "HD" else None)
    if q_dim is not None:
        o = all_gather_ordered(o, groups, m, q_dim)
    return o


# ---------------------------------------------------------------------------
# dense / MoE transformer blocks
# ---------------------------------------------------------------------------


def init_block(gen, cfg, moe_layer: bool, device):
    p = {
        "ln1": layers.init_rmsnorm(cfg.d_model, device),
        "attn": init_attn(gen, cfg, device),
        "ln2": layers.init_rmsnorm(cfg.d_model, device),
    }
    if moe_layer:
        p["moe"] = moe.init_moe(gen, cfg, device)
    else:
        p["mlp"] = layers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                                   layers.dtype_of(cfg), device)
    return p


def _ffn(x, p, cfg, ctx):
    """Second half-block: returns (delta, aux_loss)."""
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        return moe.moe_ffn(h, p["moe"], cfg, ctx)
    return (layers.mlp(h, p["mlp"], cfg.gated_mlp),
            torch.zeros((), dtype=torch.float32, device=x.device))


def block_fwd(x, p, cfg, ctx, positions):
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + attn_fwd(h, p["attn"], cfg, ctx, positions)
    delta, aux = _ffn(x, p, cfg, ctx)
    return x + delta, aux


def block_prefill(x, p, cfg, ctx, positions):
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    a, cache = attn_prefill(h, p["attn"], cfg, ctx, positions)
    x = x + a
    delta, _ = _ffn(x, p, cfg, ctx)
    return x + delta, cache


def block_decode(x, p, cfg, ctx, cache, pos: int):
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    a, cache = attn_decode(h, p["attn"], cfg, ctx, cache, pos)
    x = x + a
    delta, _ = _ffn(x, p, cfg, ctx)
    return x + delta, cache


# ---------------------------------------------------------------------------
# mamba block (pre-norm residual around the SSD mixer)
# ---------------------------------------------------------------------------


def init_mamba(gen, cfg, device):
    return {"ln": layers.init_rmsnorm(cfg.d_model, device),
            "mixer": ssd.init_ssd(gen, cfg, device)}


def mamba_fwd(x, p, cfg, ctx):
    h = layers.rms_norm(x, p["ln"], cfg.norm_eps)
    return x + ssd.mamba_block(h, p["mixer"], cfg, ctx)


def mamba_prefill(x, p, cfg, ctx):
    h = layers.rms_norm(x, p["ln"], cfg.norm_eps)
    y, cache = ssd.mamba_prefill(h, p["mixer"], cfg, ctx)
    return x + y, cache


def mamba_decode(x, p, cfg, ctx, cache):
    h = layers.rms_norm(x, p["ln"], cfg.norm_eps)
    y, cache = ssd.mamba_decode(h, p["mixer"], cfg, cache, ctx)
    return x + y, cache


# ---------------------------------------------------------------------------
# whisper-style encoder / decoder blocks (LayerNorm + non-gated GeLU MLP)
# ---------------------------------------------------------------------------


def init_enc_block(gen, cfg, device):
    return {
        "ln1": layers.init_layernorm(cfg.d_model, device),
        "attn": attn_lib.init_attention(gen, cfg, device),
        "ln2": layers.init_layernorm(cfg.d_model, device),
        "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, False,
                               layers.dtype_of(cfg), device),
    }


def enc_block_fwd(x, p, cfg, ctx, positions):
    """Non-causal self-attention over the frames (no RoPE), then the MLP."""
    h = layers.layer_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = attn_lib.qkv_project(h, p["attn"], cfg, positions, rope=False)
    o = _sharded_attention(q, k, v, cfg, ctx, causal=False)
    x = x + attn_lib.merge_heads(o, cfg) @ p["attn"]["wo"]
    h = layers.layer_norm(x, p["ln2"], cfg.norm_eps)
    return x + layers.mlp(h, p["mlp"], False)


def init_dec_block(gen, cfg, device):
    dt = layers.dtype_of(cfg)
    return {
        "ln1": layers.init_layernorm(cfg.d_model, device),
        "self_attn": attn_lib.init_attention(gen, cfg, device),
        "ln_x": layers.init_layernorm(cfg.d_model, device),
        "cross_attn": attn_lib.init_attention(gen, cfg, device),
        "ln2": layers.init_layernorm(cfg.d_model, device),
        "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, False, dt, device),
    }


def _cross_kv(enc_out, p, cfg):
    """Cross-attention K/V from the encoder output: (B, Se, KV, Dh) each."""
    B, Se, _ = enc_out.shape
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    k = (enc_out @ p["wk"]).reshape(B, Se, kv, dh)
    v = (enc_out @ p["wv"]).reshape(B, Se, kv, dh)
    return k, v


def _dec_self_and_cross(x, p, cfg, ctx, positions, enc_out):
    """The decoder block's two attention halves -> (x, self k, self v,
    cross k, cross v).  Cross-attention is non-causal with Sq != Sk (the
    prompt against the frames)."""
    h = layers.layer_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = attn_lib.qkv_project(h, p["self_attn"], cfg, positions, rope=False)
    o = _sharded_attention(q, k, v, cfg, ctx, causal=True)
    x = x + attn_lib.merge_heads(o, cfg) @ p["self_attn"]["wo"]

    h = layers.layer_norm(x, p["ln_x"], cfg.norm_eps)
    B, S, _ = h.shape
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    qx = (h @ p["cross_attn"]["wq"]).reshape(B, S, kv, cfg.n_heads // kv, dh)
    kx, vx = _cross_kv(enc_out, p["cross_attn"], cfg)
    o = _sharded_attention(qx, kx, vx, cfg, ctx, causal=False)
    x = x + attn_lib.merge_heads(o, cfg) @ p["cross_attn"]["wo"]
    return x, k, v, kx, vx


def dec_block_fwd(x, p, cfg, ctx, positions, enc_out):
    x = _dec_self_and_cross(x, p, cfg, ctx, positions, enc_out)[0]
    h = layers.layer_norm(x, p["ln2"], cfg.norm_eps)
    return x + layers.mlp(h, p["mlp"], False)


def dec_block_prefill(x, p, cfg, ctx, positions, enc_out):
    """-> (x, cache): the self-attention K/V and the cross K/V, computed
    once here and read by every decode step."""
    x, k, v, kx, vx = _dec_self_and_cross(x, p, cfg, ctx, positions, enc_out)
    h = layers.layer_norm(x, p["ln2"], cfg.norm_eps)
    x = x + layers.mlp(h, p["mlp"], False)
    return x, {"k": k, "v": v, "xk": kx, "xv": vx}


def dec_block_decode(x, p, cfg, ctx, cache, pos: int):
    """h (B,1,D); cache {k, v, xk, xv}: the self K/V updated in place at
    ``pos``, the cross K/V read whole."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    h = layers.layer_norm(x, p["ln1"], cfg.norm_eps)
    q, k_new, v_new = attn_lib.qkv_project(h, p["self_attn"], cfg, positions,
                                           rope=False)
    self_cache = attn_lib.cache_update({"k": cache["k"], "v": cache["v"]},
                                       k_new, v_new, pos)
    o = attn_lib.decode_attention(q, self_cache, pos)
    x = x + attn_lib.merge_heads(o, cfg) @ p["self_attn"]["wo"]

    h = layers.layer_norm(x, p["ln_x"], cfg.norm_eps)
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    qx = (h @ p["cross_attn"]["wq"]).reshape(B, 1, kv, cfg.n_heads // kv, dh)
    Se = cache["xk"].shape[1]
    o = attn_lib.decode_attention(qx, {"k": cache["xk"], "v": cache["xv"]}, Se - 1)
    x = x + attn_lib.merge_heads(o, cfg) @ p["cross_attn"]["wo"]

    h = layers.layer_norm(x, p["ln2"], cfg.norm_eps)
    x = x + layers.mlp(h, p["mlp"], False)
    return x, cache
