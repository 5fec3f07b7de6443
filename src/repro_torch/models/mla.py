"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

The port of ``repro.models.mla``, with its two exactly equivalent forms:

* the absorbed form (``mla_prefill``, ``mla_decode`` and ``mla_train`` by
  default): the cache holds only the normed latent ``c_kv``
  (kv_lora_rank wide) and the shared RoPE key ``k_rope`` per token; the
  per-head nope key projection is folded into the query and the value
  projection into the output, so attention runs with one shared key head,
  ``concat(c_kv, k_rope)`` (576 wide at deepseek-v2's width), one shared
  value head ``c_kv`` (512 wide) and G = H query heads;
* the materialized form (``_mla_train_materialized``, behind
  ``ctx.rules["mla_materialized"]``): per-head K (qk_nope + qk_rope wide)
  and V (v_head_dim wide).

The JAX package computes both with ``attention.attention`` (its chunked
flash VJP where the key length is a multiple of ``ctx.attn_chunk``, else
the naive path: XLA code, no Pallas kernel).  The materialized form runs
``attention.attention`` as every other family does: the flash kernels on
the card, forward and backward (``kops.flash_attention``: q and k of one
width, v of its own, (192, 128) at deepseek-v2's width, the reduced
config's (24, 16) padded to a built pair), their plain versions on the
CPU (``FlashAttention`` over key chunks of ``ctx.attn_chunk``, one (S,
chunk) score tile at a time in either pass).  The absorbed form's
attention runs the hand-written MLA kernels on the card
(``kops.mla_attention``, ``kernels/csrc/mla_attention.cu``: one shared
key and value head, forward and backward) and plain on the CPU: float32
scores and softmax routed as the reference routes them
(``attention.plain_attention``: ``ChunkedAttention`` over key chunks, or
``naive_attention``).  The one-token decode stays plain.  Which form runs
is decided by ``cfg.use_mla`` and ``ctx.rules`` alone.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Shard

from repro_torch.collectives import P, all_gather_ordered, local_map_summed
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers, tp


def init_mla(gen, cfg, device):
    dt = layers.dtype_of(cfg)
    d, h = cfg.d_model, cfg.n_heads
    qk, qr, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    R = cfg.kv_lora_rank
    return {
        "wq_a": layers.dense_init(gen, d, cfg.q_lora_rank, dt, device),
        "q_a_norm": layers.init_rmsnorm(cfg.q_lora_rank, device),
        "wq_b": layers.dense_init(gen, cfg.q_lora_rank, h * (qk + qr), dt, device),
        "wkv_a": layers.dense_init(gen, d, R + qr, dt, device),
        "kv_a_norm": layers.init_rmsnorm(R, device),
        # K-nope and V halves apart, so that decode absorbs each on its own
        "wkv_b_k": layers.dense_init(gen, R, h * qk, dt, device).reshape(R, h, qk),
        "wkv_b_v": layers.dense_init(gen, R, h * vd, dt, device).reshape(R, h, vd),
        "wo": layers.dense_init(gen, h * vd, d, dt, device),
    }


def _scale(cfg) -> float:
    """The softmax scale over the true query-key width, qk_nope + qk_rope."""
    return (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5


def _project_q(x, params, cfg, positions):
    """-> q_nope (B,S,H,qk), q_rope (B,S,H,qr) with RoPE applied."""
    B, S, _ = x.shape
    h, qk, qr = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    cq = layers.rms_norm(x @ params["wq_a"], params["q_a_norm"], cfg.norm_eps)
    q = (cq @ params["wq_b"]).reshape(B, S, h, qk + qr)
    q_nope, q_rope = q[..., :qk], q[..., qk:]
    return q_nope, layers.apply_rope(q_rope, positions, cfg.rope_theta)


def _project_kv_latent(x, params, cfg, positions):
    """-> c_kv (B,S,R) the normed latent, k_rope (B,S,qr) the shared RoPE
    key."""
    R = cfg.kv_lora_rank
    kv = x @ params["wkv_a"]
    c_kv = layers.rms_norm(kv[..., :R], params["kv_a_norm"], cfg.norm_eps)
    k_rope = layers.apply_rope(kv[..., R:][:, :, None, :], positions,
                               cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def _absorbed_q(q_nope, q_rope, params):
    """The per-head nope key projection folded into the query -> q_eff
    (B,S,H,R+qr), against the keys concat(c_kv, k_rope)."""
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, params["wkv_b_k"])
    return torch.cat([q_lat, q_rope], dim=-1)


def latent_attention(q_eff, k_eff, v_eff, causal: bool, scale: float, ctx):
    """Attention of H query heads against one shared key head and one shared
    value head: q_eff (B,S,H,Dk), k_eff (B,Sk,Dk), v_eff (B,Sk,Dv) ->
    (B,S,H,Dv) in q's type.  On the card (or with ``ctx.kernels ==
    "cuda"``) the hand-written kernels (``kops.mla_attention``: forward,
    and backward through ``MlaAttention``); on the CPU (or with
    ``ctx.kernels == "ref"``) plain: float32 scores and softmax over the
    shared head (one group of G = H), the key never repeated per head, over
    key chunks of ``ctx.attn_chunk`` where the JAX package chunks them
    (``attention.plain_attention``)."""
    if (ctx.kernels or ("cuda" if q_eff.is_cuda else "ref")) == "cuda":
        return kops.mla_attention(q_eff, k_eff, v_eff, causal, scale,
                                  chunk=ctx.attn_chunk, force="cuda")
    o = attn_lib.plain_attention(q_eff[:, :, None], k_eff[:, :, None],
                                   v_eff[:, :, None], causal, ctx.attn_chunk,
                                   use_chunked=ctx.use_chunked_attn, scale=scale)
    return o[:, :, 0]


def _on_local_heads(fn, q, kvs, ctx, shared: bool):
    """``fn(q, *kvs)`` on each rank's local heads of a DTensor q (B, S, H,
    D) under ``local_map``: the heads over the model axis where they split
    it, the batch as the residual's; the key/value tensors either shared by
    every head (``shared``: (B, S, D'), whole over the model axis, their
    gradients partial sums over it) or per head like q.  Plain tensors:
    ``fn`` of them."""
    if not isinstance(q, DTensor):
        return fn(q, *kvs)
    m = ctx.model_axis
    hm = m if q.shape[2] % ctx.axis_size(m) == 0 else None
    b = ctx.rules["residual"][0]
    q = ctx.place(q, P(b, None, hm, None))
    kv_spec = P(b, None, None) if shared else P(b, None, hm, None)
    kvs = [ctx.place(t, kv_spec) for t in kvs]
    # a shared key/value's gradient: partial over the mesh dims that split
    # q's heads
    grad = ([Partial() if isinstance(qp, Shard) and qp.dim == 2 else kp
             for qp, kp in zip(q.placements, kvs[0].placements)] if shared
            else list(kvs[0].placements))
    return local_map_summed(fn, list(q.placements),
                            (q.placements,) + tuple(t.placements for t in kvs),
                            (q.placements,) + (grad,) * len(kvs), ctx.mesh,
                            ctx.groups)(q, *kvs)


def mla_train(x, params, cfg, positions, ctx):
    """Training-time MLA: the absorbed form, or the materialized one when
    ``ctx.rules["mla_materialized"]`` is set (as in the JAX package)."""
    if not ctx.rules.get("mla_materialized", False):
        return mla_prefill(x, params, cfg, positions, ctx)[0]
    return _mla_train_materialized(x, params, cfg, positions, ctx)


def _mla_train_materialized(x, params, cfg, positions, ctx):
    """Full attention with per-head K (qk + qr wide) and V (vd wide), as
    KV = H heads of one group each, through ``attention.attention`` (the
    flash kernels on the card)."""
    B, S, _ = x.shape
    h, qr, vd = cfg.n_heads, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope = _project_q(x, params, cfg, positions)
    c_kv, k_rope = _project_kv_latent(x, params, cfg, positions)
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, params["wkv_b_k"])
    v = torch.einsum("bsr,rhk->bshk", c_kv, params["wkv_b_v"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(B, S, h, qr)], dim=-1)
    o = _on_local_heads(
        lambda q, k, v: attn_lib.attention(
            q[:, :, :, None, :], k, v, True, scale=_scale(cfg), kernels=ctx.kernels,
            chunk=ctx.attn_chunk)[:, :, :, 0],
        q, (k, v), ctx, shared=False)
    return o.reshape(B, S, h * vd) @ params["wo"]


def mla_prefill(x, params, cfg, positions, ctx):
    """The absorbed form -> (out (B,S,D), cache {c_kv, k_rope})."""
    B, S, _ = x.shape
    q_nope, q_rope = _project_q(x, params, cfg, positions)
    c_kv, k_rope = _project_kv_latent(x, params, cfg, positions)
    q_eff = _absorbed_q(q_nope, q_rope, params)                      # (B,S,H,R+qr)
    k_eff = torch.cat([c_kv, k_rope], dim=-1)                        # (B,S,R+qr)
    o_lat = _on_local_heads(
        lambda q, k, v: latent_attention(q, k, v, True, _scale(cfg), ctx),
        q_eff, (k_eff, c_kv), ctx, shared=True)
    o = torch.einsum("bshr,rhk->bshk", o_lat, params["wkv_b_v"])
    out = o.reshape(B, S, cfg.n_heads * cfg.v_head_dim) @ params["wo"]
    return out, {"c_kv": c_kv, "k_rope": k_rope}


def init_mla_cache(cfg, batch: int, seq_len: int, dtype, device):
    return {"c_kv": torch.zeros((batch, seq_len, cfg.kv_lora_rank), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((batch, seq_len, cfg.qk_rope_head_dim),
                                  dtype=dtype, device=device)}


def mla_decode(x, params, cfg, cache, pos: int, ctx):
    """One token, absorbed.  x (B,1,D); the compressed cache {c_kv, k_rope}
    updated in place at ``pos`` (the JAX package's jitted step donates it
    and returns a new one).  Under a decode plan on a mesh
    (``ctx.sharded_decode``) see ``_sharded_mla_decode``."""
    if ctx.sharded_decode:
        return _sharded_mla_decode(x, params, cfg, cache, pos, ctx)
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q_nope, q_rope = _project_q(x, params, cfg, positions)
    c_new, kr_new = _project_kv_latent(x, params, cfg, positions)
    _write(cache, c_new, kr_new, pos)
    q_eff = _absorbed_q(q_nope, q_rope, params)                      # (B,1,H,R+qr)
    kv = {"k": torch.cat([cache["c_kv"], cache["k_rope"]], dim=-1)[:, :, None],
          "v": cache["c_kv"][:, :, None]}
    o_lat = attn_lib.decode_attention(q_eff[:, :, None], kv, pos,
                                      scale=_scale(cfg))[:, :, 0]    # (B,1,H,R)
    o = torch.einsum("bshr,rhk->bshk", o_lat, params["wkv_b_v"])
    return o.reshape(B, 1, cfg.n_heads * cfg.v_head_dim) @ params["wo"], cache


def _write(cache, c_new, kr_new, i: int):
    """The new token's latent and RoPE key at slot ``i`` of this cache (no
    write where the slot is not in it)."""
    if 0 <= i < cache["c_kv"].shape[1]:
        cache["c_kv"][:, i:i + 1] = c_new.to(cache["c_kv"].dtype)
        cache["k_rope"][:, i:i + 1] = kr_new.to(cache["k_rope"].dtype)


def _sharded_mla_decode(x, params, cfg, cache, pos: int, ctx):
    """``mla_decode`` under a decode plan on a mesh: x is this rank's batch
    rows and the cache its sequence shard (only the rank whose slice holds
    ``pos`` writes).  Each product takes the rank's block of its weight
    (``models.tp``): the query, its absorbed
    nope projection and the output on the rank's heads where they split
    over the model axis, the absorbed queries then gathered whole over it
    for the attention, which combines the cache's shards
    (``_distributed_mla_decode``); the latent and the RoPE key whole."""
    B, D = x.shape[0], x.shape[-1]
    h, qk, qr, vd = (cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                     cfg.v_head_dim)
    R = cfg.kv_lora_rank
    m = ctx.model_axis
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    hs = tp.split(h, ctx)
    hl = h if hs is None else hs.stop - hs.start
    Rq = cfg.q_lora_rank
    cq = layers.rms_norm(tp.cols(x, params["wq_a"], ctx, tp.spec(ctx, "wq_a", (D, Rq))),
                         params["q_a_norm"], cfg.norm_eps)
    q = tp.cols(cq, params["wq_b"], ctx, tp.spec(ctx, "wq_b", (Rq, h * (qk + qr))),
                None if hs is None else slice(hs.start * (qk + qr), hs.stop * (qk + qr)))
    q = q.reshape(B, 1, hl, qk + qr)
    q_rope = layers.apply_rope(q[..., qk:], positions, cfg.rope_theta)
    kv = tp.cols(x, params["wkv_a"], ctx, tp.spec(ctx, "wkv_a", (D, R + qr)))
    c_new = layers.rms_norm(kv[..., :R], params["kv_a_norm"], cfg.norm_eps)
    kr_new = layers.apply_rope(kv[..., R:][:, :, None, :], positions,
                               cfg.rope_theta)[:, :, 0]

    def heads(name, d):
        """The rank's heads of the (R, H, d) weight ``name`` (its block,
        whose heads split where ``hs`` does), its R gathered whole."""
        w = params[name]
        return tp.whole(w, 0, tp.spec(ctx, name, (R, h, d))[0], ctx)

    q_eff = _absorbed_q(q[..., :qk], q_rope, {"wkv_b_k": heads("wkv_b_k", qk)})
    if hs is not None:
        q_eff = all_gather_ordered(q_eff, ctx.groups, m, 2)           # (B,1,H,R+qr)
    seq = tuple(ctx.decode_plan.seq_axes)
    start = attn_lib.seq_shard_start(ctx.mesh, seq,
                                     cache["c_kv"].shape[1] * ctx.axis_size(seq))
    _write(cache, c_new, kr_new, pos - start)
    o_lat = _distributed_mla_decode(q_eff, cache, pos, start, ctx, _scale(cfg))
    if hs is not None:
        o_lat = o_lat[:, :, hs]
    o = torch.einsum("bshr,rhk->bshk", o_lat, heads("wkv_b_v", vd))
    o = o.reshape(B, 1, hl * vd)
    wo = tp.spec(ctx, "wo", (h * vd, D))
    if hs is None:
        return tp.rows_whole(o, params["wo"], ctx, wo), cache
    return tp.rows(o, params["wo"], ctx, wo), cache


def _distributed_mla_decode(q_eff, cache, pos: int, start: int, ctx, scale):
    """Flash-decode over the sequence-sharded compressed cache (MQA form:
    one shared key head concat(c_kv, k_rope), 576 wide at deepseek-v2's
    width, and G = n_heads query heads), the JAX package's ``shard_map``
    body: the log-sum-exp combine over ``plan.seq_axes``; ``start`` is this
    shard's first global slot.  -> (B,1,H,R)."""
    seq = tuple(ctx.decode_plan.seq_axes)
    k = torch.cat([cache["c_kv"], cache["k_rope"]], dim=-1)[:, :, None]  # (B,S_loc,1,·)
    o = attn_lib.distributed_decode_attention(
        q_eff[:, :, None], k, cache["c_kv"][:, :, None], pos,
        ctx.groups.group(seq) if seq else None, start, scale=scale)
    return o[:, :, 0]
