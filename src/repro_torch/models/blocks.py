"""Block composition: pre-norm transformer and mamba blocks.

The port of ``repro.models.blocks`` for the dense, ssm and hybrid families.
Each block provides ``init_*``, a full-sequence ``*_fwd``, a ``*_prefill``
(returns a decode cache) and a ``*_decode`` (one token).  Blocks are pure
functions over per-layer parameter dicts; ``model.py`` stacks them along a
leading L axis and loops over it.  MLA, MoE layers and the encoder-decoder
blocks are not ported yet (ROADMAP A10) and raise.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import layers, ssd


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to repro_torch yet "
                               "(ROADMAP A10)")


# ---------------------------------------------------------------------------
# attention sub-block (dense GQA)
# ---------------------------------------------------------------------------


def init_attn(gen, cfg, device):
    if cfg.use_mla:
        raise _not_ported("MLA attention")
    return attn_lib.init_attention(gen, cfg, device)


def _sharded_attention(q, k, v, cfg, ctx, causal):
    """The JAX package's 'kv' attention layout (heads as they come); one
    card shards nothing."""
    return attn_lib.attention(q, k, v, causal=causal, kernels=ctx.kernels,
                              chunk=ctx.attn_chunk)


def attn_fwd(h, p, cfg, ctx, positions, causal=True):
    """Normed input -> attention output (full sequence)."""
    if cfg.use_mla:
        raise _not_ported("MLA attention")
    q, k, v = attn_lib.qkv_project(h, p, cfg, positions)
    o = _sharded_attention(q, k, v, cfg, ctx, causal)
    return attn_lib.merge_heads(o, cfg) @ p["wo"]


def attn_prefill(h, p, cfg, ctx, positions):
    if cfg.use_mla:
        raise _not_ported("MLA attention")
    q, k, v = attn_lib.qkv_project(h, p, cfg, positions)
    o = _sharded_attention(q, k, v, cfg, ctx, causal=True)
    out = attn_lib.merge_heads(o, cfg) @ p["wo"]
    return out, {"k": k, "v": v}  # the cache stays KV-compact


def attn_decode(h, p, cfg, ctx, cache, pos: int):
    """h (B,1,D); cache {k, v} (B,S,KV,Dh), updated in place; pos int."""
    if cfg.use_mla:
        raise _not_ported("MLA attention")
    if ctx.decode_attn != "local":
        raise NotImplementedError(f"decode_attn={ctx.decode_attn!r}: the port "
                                  "has only 'local' (one card, no mesh)")
    B = h.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=h.device)
    q, k_new, v_new = attn_lib.qkv_project(h, p, cfg, positions)
    cache = attn_lib.cache_update(cache, k_new, v_new, pos)
    o = attn_lib.decode_attention(q, cache, pos)
    return attn_lib.merge_heads(o, cfg) @ p["wo"], cache


# ---------------------------------------------------------------------------
# dense transformer block
# ---------------------------------------------------------------------------


def init_block(gen, cfg, moe_layer: bool, device):
    if moe_layer:
        raise _not_ported("the MoE layer")
    return {
        "ln1": layers.init_rmsnorm(cfg.d_model, device),
        "attn": init_attn(gen, cfg, device),
        "ln2": layers.init_rmsnorm(cfg.d_model, device),
        "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                               layers.dtype_of(cfg), device),
    }


def _ffn(x, p, cfg, ctx):
    """Second half-block: returns (delta, aux_loss)."""
    if "moe" in p:
        raise _not_ported("the MoE layer")
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
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
