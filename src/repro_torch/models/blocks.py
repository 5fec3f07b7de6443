"""Block composition: pre-norm transformer (dense GQA or MLA attention,
dense or MoE FFN), mamba and whisper encoder / decoder blocks.

The port of ``repro.models.blocks``.  Each block provides ``init_*``, a
full-sequence ``*_fwd``, a ``*_prefill`` (returns a decode cache) and a
``*_decode`` (one token); whisper's encoder block has the forward only.
Blocks are pure functions over per-layer parameter dicts; ``model.py``
stacks them along a leading L axis and loops over it.  Each body is
written once: on the whole sequence (plain tensors, or DTensors laid out
by the policy's rules) and, under the data-parallel-only layout whose
sequence splits over the model axis, on each rank's sequence block
(``_by_block``: the same body with a ``_Seq``, the sequence mixers
gathering their inputs whole).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch import collectives as C
from repro_torch.collectives import P, all_gather_ordered, axis_index
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers, mla, moe, ssd, tp


# ---------------------------------------------------------------------------
# attention sub-block (dense GQA or MLA)
# ---------------------------------------------------------------------------


def init_attn(gen, cfg, device):
    if cfg.use_mla:
        return mla.init_mla(gen, cfg, device)
    return attn_lib.init_attention(gen, cfg, device)


def _proj_layout(ctx, h):
    """The sharded forward's placement of the flat q and k/v projections
    (B, S, n*Dh), from the attention mode's rules: the sequence whole, the
    batch over the residual's batch axes, and the heads over the model axis
    where the mode shards them ("kv": q and k/v; "expand": q, whose H heads
    then split evenly; "replicate": none).  None unless the input ``h`` is
    a ``DTensor``."""
    if not isinstance(h, DTensor):
        return None
    mode = _mode(ctx)
    b, m = ctx.rules["residual"][0], ctx.model_axis
    q_spec = P(b, None, m if mode in ("kv", "expand") else None)
    kv_spec = P(b, None, m if mode == "kv" else None)
    return lambda t, which: ctx.place(t, q_spec if which == "q" else kv_spec)


def _qkv(h, p, cfg, ctx, positions, rope: bool = True):
    """``attn_lib.qkv_project`` with the sharded forward's layout; q is
    (B, S, H, Dh) under "expand" on a mesh, (B, S, KV, G, Dh) otherwise."""
    h = ctx.gather_seq(h)
    return attn_lib.qkv_project(h, p, cfg, positions, rope=rope,
                                layout=_proj_layout(ctx, h),
                                flat_q=_expand_on_mesh(ctx, h))


def _expand_on_mesh(ctx, h) -> bool:
    return isinstance(h, DTensor) and _mode(ctx) == "expand"


def _mode(ctx) -> str:
    return ctx.rules.get("attn_mode", "kv")


def _sharded_attention(q, k, v, cfg, ctx, causal, q_offset: int = 0):
    """-> the attention output with its heads merged, (B, Sq, H*Dh).

    The policy's attention layout (``launch.sharding``): "kv" shards the KV
    heads; "expand" repeats K/V to the full H heads and then shards H (each
    shard holds only its own heads' copies); "replicate" leaves the heads
    whole.  Off a mesh, and on a rank's sequence block (plain tensors,
    ``q_offset`` the block's first position), this is
    ``attn_lib.attention``.  On a mesh q, k and v are DTensors, placed here
    by the mode's rules, and the flash kernel runs on each rank's local
    (B_loc, S, H_loc, Dh) under ``local_map``; its gradients come back
    with the inputs' placements."""
    if not isinstance(q, DTensor):
        return attn_lib.merge_heads(attn_lib.attention(
            q, k, v, causal=causal, kernels=ctx.kernels, chunk=ctx.attn_chunk,
            q_offset=q_offset), cfg)
    mode = _mode(ctx)
    if mode == "expand":
        # q arrives (B, S, H, Dh); repeat first, then shard H (attn_kv4)
        G = cfg.n_heads // cfg.n_kv_heads
        q = ctx.constrain(q, "attn_q4")[:, :, :, None]        # G = 1
        k = ctx.constrain(k.repeat_interleave(G, dim=2), "attn_kv4")
        v = ctx.constrain(v.repeat_interleave(G, dim=2), "attn_kv4")
    elif mode == "kv":
        q = ctx.constrain(q, "attn_q")
        k, v = ctx.constrain(k, "attn_kv"), ctx.constrain(v, "attn_kv")
    else:
        b = ctx.rules["residual"][0]
        q = ctx.place(q, P(b, None, None, None, None))
        k, v = (ctx.place(t, P(b, None, None, None)) for t in (k, v))

    def local(q, k, v):
        o = attn_lib.attention(q, k, v, causal=causal, kernels=ctx.kernels,
                               chunk=ctx.attn_chunk)
        return o.reshape(o.shape[0], o.shape[1], -1)

    # the heads merge on the local shard: the output's gradient then comes
    # back to the placements of the forward (its heads major in H*Dh)
    out = [pl if not isinstance(pl, Shard) or pl.dim < 2 else Shard(2)
           for pl in q.placements]
    return local_map(local, out_placements=out,
                     in_placements=(q.placements, k.placements, v.placements),
                     device_mesh=ctx.mesh)(q, k, v)


def _self_attention(h, p, cfg, ctx, positions, seq, causal=True, rope=True):
    """Self-attention of the normed input ``h`` -> (out (B, S, D), k, v),
    k and v those of h's own positions.  With ``seq`` (a ``_Seq``) h is a
    rank's sequence block: its queries, at their global positions, attend
    to the whole sequence's keys and values, gathered over the model axis;
    ``seq`` None: h is the whole sequence (plain, or a DTensor laid out by
    the policy's rules)."""
    if seq is not None:
        positions = positions[seq.offset:seq.offset + h.shape[1]]
    q, k, v = _qkv(h, p, cfg, ctx, positions, rope=rope)
    kw, vw = (k, v) if seq is None else (seq.gather(k), seq.gather(v))
    o = _sharded_attention(q, kw, vw, cfg, ctx, causal,
                           q_offset=0 if seq is None else seq.offset)
    return o @ p["wo"], k, v


def attn_fwd(h, p, cfg, ctx, positions, causal=True, seq=None):
    """Normed input -> attention output (``_self_attention``)."""
    if cfg.use_mla:
        return mla.mla_train(ctx.gather_seq(h), p, cfg, positions, ctx)
    return _self_attention(h, p, cfg, ctx, positions, seq, causal)[0]


def attn_prefill(h, p, cfg, ctx, positions, seq=None):
    if cfg.use_mla:
        return mla.mla_prefill(ctx.gather_seq(h), p, cfg, positions, ctx)
    out, k, v = _self_attention(h, p, cfg, ctx, positions, seq)
    return out, {"k": k, "v": v}  # the cache stays KV-compact


def attn_decode(h, p, cfg, ctx, cache, pos: int):
    """h (B,1,D); cache {k, v} (B,S,KV,Dh) or MLA's {c_kv, k_rope}, updated
    in place; pos int.  Under a decode plan on a mesh (``ctx.sharded_decode``)
    h is this rank's batch slice and the cache its shard: tensor-parallel
    over the rank's KV heads where the plan splits them
    (``_tp_attn_decode``), else through ``_distributed_decode``."""
    if cfg.use_mla:
        return mla.mla_decode(h, p, cfg, cache, pos, ctx)
    if _tp_heads(cfg, ctx) is not None:
        return _tp_attn_decode(h, p, cfg, ctx, cache, pos), cache
    B = h.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=h.device)
    if ctx.sharded_decode:
        q, k_new, v_new = _decode_qkv(h, p, cfg, ctx, positions)
        o = _distributed_decode(q, k_new, v_new, cache, pos, ctx)
        return _out_proj(o, p, cfg, ctx, h.shape[-1]), cache
    q, k_new, v_new = attn_lib.qkv_project(h, p, cfg, positions)
    cache = attn_lib.cache_update(cache, k_new, v_new, pos)
    o = attn_lib.decode_attention(q, cache, pos)
    return attn_lib.merge_heads(o, cfg) @ p["wo"], cache


def _out_proj(o, p, cfg, ctx, D: int):
    """The attention output (whole heads) through the rank's block of
    ``wo`` (``tp.rows_whole``)."""
    return tp.rows_whole(attn_lib.merge_heads(o, cfg), p["wo"], ctx,
                         tp.spec(ctx, "wo", (cfg.n_heads * cfg.head_dim, D)))


def _decode_qkv(h, p, cfg, ctx, positions, rope: bool = True):
    """``attn_lib.qkv_project`` of a decode step on a mesh, q, k and v
    whole: each product through ``tp.cols`` (the rank's block of the
    weight's columns, the outputs gathered over the model axis)."""
    B, D = h.shape[0], h.shape[-1]
    h_, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def project(w, b, n, norm, heads):
        t = tp.cols(h, p[w], ctx, tp.spec(ctx, w, (D, n)))
        if cfg.qkv_bias:
            t = t + p[b]
        t = t.reshape(B, 1, heads, dh)
        if cfg.qk_norm and norm:
            t = layers.rms_norm(t, p[norm], cfg.norm_eps)
        return layers.apply_rope(t, positions, cfg.rope_theta) if rope and norm else t

    q = project("wq", "bq", h_ * dh, "q_norm", h_).reshape(B, 1, kv, h_ // kv, dh)
    return (q, project("wk", "bk", kv * dh, "k_norm", kv),
            project("wv", "bv", kv * dh, None, kv))


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
    sequence axes (mode "local") makes no sequence collective.  With
    ``k_new`` None nothing is written (whisper's cross cache, read at the
    last position)."""
    plan, mesh, groups, m = ctx.decode_plan, ctx.mesh, ctx.groups, ctx.model_axis
    seq = tuple(plan.seq_axes)
    scale = q.shape[-1] ** -0.5                     # the whole head's
    # the dims of q (B,1,KV,G,Dh) and of k, v (B,1,KV,Dh) the model axis splits
    q_dim, kv_dim = {"model": (2, 2), "HD": (4, 3)}.get(plan.kv_axis, (None, None))
    if q_dim is not None:
        n, i = ctx.axis_size(m), axis_index(mesh, m)
        q = q.narrow(q_dim, i * (q.shape[q_dim] // n), q.shape[q_dim] // n)
        if k_new is not None:
            w = k_new.shape[kv_dim] // n
            k_new, v_new = k_new.narrow(kv_dim, i * w, w), v_new.narrow(kv_dim, i * w, w)
    start = attn_lib.seq_shard_start(mesh, seq, cache["k"].shape[1] * ctx.axis_size(seq))
    if k_new is not None:
        attn_lib.cache_update(cache, k_new, v_new, pos, shard_start=start)
    o = attn_lib.distributed_decode_attention(
        q, cache["k"], cache["v"], pos, groups.group(seq) if seq else None, start,
        scale=scale, hd_group=groups.group(m) if plan.kv_axis == "HD" else None)
    if q_dim is not None:
        o = all_gather_ordered(o, groups, m, q_dim)
    return o


def _tp_heads(cfg, ctx):
    """This rank's KV heads where the decode runs tensor-parallel over
    them (a plan on a mesh whose cache splits its KV heads over the model
    axis), else None."""
    if not (ctx.sharded_decode and ctx.decode_plan.kv_axis == "model"):
        return None
    return tp.split(cfg.n_kv_heads, ctx)


def _tp_attn_decode(h, p, cfg, ctx, cache, pos: int, rope: bool = True,
                    write: bool = True):
    """Attention decode on this rank's KV heads (``models.tp``): q, and
    with ``write`` the new K/V, projected for those heads only and written
    to this rank's cache shard (``cache`` {k, v}), the flash-decode combine
    over the plan's sequence axes (``attn_lib.distributed_decode_attention``),
    and the out-projection's partial sums reduced over the model axis.
    ``write`` False reads the cache at ``pos`` (whisper's cross cache)."""
    B, D = h.shape[0], h.shape[-1]
    kvs = _tp_heads(cfg, ctx)
    kv, dh = kvs.stop - kvs.start, cfg.head_dim
    g = cfg.n_heads // cfg.n_kv_heads
    qs = slice(kvs.start * g * dh, kvs.stop * g * dh)
    ks = slice(kvs.start * dh, kvs.stop * dh)
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=h.device)

    def project(w, b, sl, norm, n):
        whole = (cfg.n_heads if w == "wq" else cfg.n_kv_heads) * dh
        t = tp.cols(h, p[w], ctx, tp.spec(ctx, w, (D, whole)), sl)
        if cfg.qkv_bias:
            t = t + p[b][sl]
        t = t.reshape(B, 1, n, dh)
        if cfg.qk_norm and norm:
            t = layers.rms_norm(t, p[norm], cfg.norm_eps)
        return layers.apply_rope(t, positions, cfg.rope_theta) if rope and norm else t

    q = project("wq", "bq", qs, "q_norm", kv * g).reshape(B, 1, kv, g, dh)
    seq = tuple(ctx.decode_plan.seq_axes)
    start = attn_lib.seq_shard_start(ctx.mesh, seq,
                                     cache["k"].shape[1] * ctx.axis_size(seq))
    if write:
        k = project("wk", "bk", ks, "k_norm", kv)
        v = project("wv", "bv", ks, None, kv)
        attn_lib.cache_update(cache, k, v, pos, shard_start=start)
    o = attn_lib.distributed_decode_attention(
        q, cache["k"], cache["v"], pos, ctx.groups.group(seq) if seq else None, start,
        scale=dh ** -0.5)
    return tp.rows(o.reshape(B, 1, kv * g * dh), p["wo"], ctx,
                   tp.spec(ctx, "wo", (cfg.n_heads * dh, D)))


def _mlp_decode(h, p, gated: bool, ctx, d_ff: int):
    """``layers.mlp`` of a decode step (``d_ff`` hidden units): on a mesh
    tensor-parallel over them (``models.tp``) where they split over the
    model axis, else each product from the rank's blocks of the weights."""
    if not ctx.sharded_decode:
        return layers.mlp(h, p, gated)
    D = h.shape[-1]
    fs = tp.split(d_ff, ctx)
    up = tp.cols(h, p["w_up"], ctx, tp.spec(ctx, "w_up", (D, d_ff)), fs)
    if gated:
        act = F.silu(tp.cols(h, p["w_gate"], ctx, tp.spec(ctx, "w_gate", (D, d_ff)),
                             fs)) * up
    else:
        act = F.gelu(up, approximate="tanh")
    down = tp.spec(ctx, "w_down", (d_ff, D))
    if fs is None:
        return tp.rows_whole(act, p["w_down"], ctx, down)
    return tp.rows(act, p["w_down"], ctx, down)


def _add(x, delta, ctx):
    """The residual plus a sub-block's output, the output moved to the
    residual's layout first on a mesh (a row-parallel product's partial sum
    reduce-scattered over the sequence), so that its gradient comes back
    in the product's own layout."""
    return x + ctx.constrain(delta, "residual")


# ---------------------------------------------------------------------------
# the data-parallel-only layout: each rank on its own sequence block
# ---------------------------------------------------------------------------


def _seq_split(ctx, x) -> bool:
    """``x`` a residual ``DTensor`` whose sequence splits evenly over the
    model axis."""
    return (isinstance(x, DTensor) and ctx.spec("residual")[1] == ctx.model_axis
            and x.shape[1] % ctx.axis_size(ctx.model_axis) == 0)


def _seq_local(ctx, x) -> bool:
    """The data-parallel-only layout (``ctx.policy.dp_only``: the weights
    and heads replicated) whose residual splits its sequence over the model
    axis (``_seq_split``): each block then runs on the rank's own sequence
    block (``_by_block``), not on the gathered sequence."""
    return getattr(ctx.policy, "dp_only", False) and _seq_split(ctx, x)


class _Seq:
    """A rank's block of the sequence inside ``_on_seq_block``: ``offset``
    is the global position of its first; ``gather`` makes a (B, S_loc, ...)
    tensor of the block the whole sequence's, over the model axis (an
    autograd all-gather: the gradient comes back reduce-scattered)."""

    def __init__(self, ctx, offset):
        self.ctx, self.offset = ctx, offset

    def gather(self, t):
        return C.all_gather(t, self.ctx.groups, self.ctx.model_axis, 1)


def _on_seq_block(fn, ctx, x, params, extra=(), rest=()):
    """``fn(x_local, params, *extra, seq)`` on each rank's (B_loc, S_loc, D)
    block of the residual DTensor ``x`` under ``local_map``, ``seq`` its
    ``_Seq``: the position-wise products, norms and MLPs on the rank's
    positions only, the sequence mixers gathering what they need whole over
    the model axis (``seq.gather``).  The parameters and the ``extra``
    tensors (whisper's encoder output, its batch as the residual's) enter
    replicated over the dims that do not shard them, their gradients the
    sums of the ranks' parts.  ``fn`` returns y, which takes ``x``'s
    placements, or, where ``rest`` lists its leaves, (y, a tree of
    tensors: a prefill's cache) whose leaves, in order, take ``x``'s
    placements ("seq": the rank's sequence block) or the batch's only
    ("batch").  Where the JAX package's XLA partitions the sequence under
    the same shardings, the port splits it by hand: torch's DTensor
    refuses the views that flatten a sharded sequence dim with the
    batch."""
    mesh, m = ctx.mesh, ctx.model_axis
    x_pl = list(x.placements)
    batch_pl = [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
                for pl in x_pl]
    leaves, spec = tree_flatten(params)
    leaves = [ctx.place(t, P()) for t in leaves]
    extra = [t.redistribute(mesh, batch_pl) for t in extra]
    ins = [x_pl] + [list(t.placements) for t in leaves + extra]
    grads = [x_pl] + [[Partial() if isinstance(xp, Shard) and not isinstance(q, Shard)
                       else q for xp, q in zip(x_pl, pl)] for pl in ins[1:]]
    n_p = len(leaves)
    out_spec = []

    def local(xl, *args):
        seq = _Seq(ctx, axis_index(mesh, m) * xl.shape[1])
        out = fn(xl, tree_unflatten(list(args[:n_p]), spec), *args[n_p:], seq)
        if not rest:
            return out
        flat, rest_spec = tree_flatten(out[1])
        out_spec.append(rest_spec)
        return (out[0], *flat)

    outs = [x_pl] + [x_pl if r == "seq" else batch_pl for r in rest]
    res = C.local_map_summed(local, tuple(outs) if rest else x_pl, tuple(ins),
                             tuple(grads), mesh, ctx.groups)(x, *leaves, *extra)
    if not rest:
        return res
    return res[0], tree_unflatten(list(res[1:]), out_spec[0])


def _by_block(fn, ctx, x, params, extra=(), rest=(), split=True):
    """``fn(x, params, *extra, seq)``, a block body: on each rank's sequence
    block (``_on_seq_block``) under the data-parallel-only layout whose
    sequence splits over the model axis (``split`` False: never), else on
    ``x`` as it is, plain or laid out by the policy's rules, ``seq``
    None."""
    if split and _seq_local(ctx, x):
        return _on_seq_block(fn, ctx, x, params, extra, rest)
    return fn(x, params, *extra, None)


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


def _attn_half(x, p, cfg, ctx, positions, seq, cache: bool):
    """The attention half-block (pre-norm, attention, residual add) -> x,
    or with ``cache`` (x, the prefill's {k, v})."""
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    if cache:
        a, kv = attn_prefill(h, p["attn"], cfg, ctx, positions, seq)
    else:
        a = attn_fwd(h, p["attn"], cfg, ctx, positions, seq=seq)
    x = ctx.constrain(_add(x, a, ctx), "residual")
    return (x, kv) if cache else x


def _ffn(x, p, cfg, ctx):
    """Second half-block's delta: returns (delta, aux_loss)."""
    h = ctx.gather_seq(layers.rms_norm(x, p["ln2"], cfg.norm_eps))
    if "moe" in p:
        return moe.moe_ffn(h, p["moe"], cfg, ctx)
    return (layers.mlp(h, p["mlp"], cfg.gated_mlp),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _ffn_half(x, p, cfg, ctx):
    """The FFN half-block -> (x, aux): the MLP position-wise, on each rank's
    sequence block where the sequence splits (``_by_block``); the MoE FFN
    by its own sharded route."""
    def body(x, q, seq):
        delta, aux = _ffn(x, q, cfg, ctx)
        return ctx.constrain(_add(x, delta, ctx), "residual"), aux
    if "moe" in p:
        return body(x, p, None)
    x = _by_block(lambda x, q, seq: body(x, q, seq)[0], ctx, x,
                  {"ln2": p["ln2"], "mlp": p["mlp"]})
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _attn_params(p):
    return {"ln1": p["ln1"], "attn": p["attn"]}


def block_fwd(x, p, cfg, ctx, positions):
    # MLA's attention takes the sequence whole
    x = _by_block(lambda x, q, seq: _attn_half(x, q, cfg, ctx, positions, seq, False),
                  ctx, x, _attn_params(p), split=not cfg.use_mla)
    return _ffn_half(x, p, cfg, ctx)


def block_prefill(x, p, cfg, ctx, positions):
    x, cache = _by_block(
        lambda x, q, seq: _attn_half(x, q, cfg, ctx, positions, seq, True),
        ctx, x, _attn_params(p), rest=("seq", "seq"), split=not cfg.use_mla)
    return _ffn_half(x, p, cfg, ctx)[0], cache


def block_decode(x, p, cfg, ctx, cache, pos: int):
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    a, cache = attn_decode(h, p["attn"], cfg, ctx, cache, pos)
    x = x + a
    h = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    if "mlp" in p:
        return x + _mlp_decode(h, p["mlp"], cfg.gated_mlp, ctx, cfg.d_ff), cache
    if ctx.sharded_decode:
        return x + moe.moe_decode(h, p["moe"], cfg, ctx), cache
    delta, _ = moe.moe_ffn(h, p["moe"], cfg, ctx)
    return x + delta, cache


# ---------------------------------------------------------------------------
# mamba block (pre-norm residual around the SSD mixer)
# ---------------------------------------------------------------------------


def init_mamba(gen, cfg, device):
    return {"ln": layers.init_rmsnorm(cfg.d_model, device),
            "mixer": ssd.init_ssd(gen, cfg, device)}


def mamba_fwd(x, p, cfg, ctx):
    return mamba_prefill(x, p, cfg, ctx)[0]


def mamba_prefill(x, p, cfg, ctx):
    """-> (x, cache).  Under the sequence split (``_by_block``) the norm,
    the projections, the gate and the out-projection run on the rank's
    positions, the conv and the SSD scan on the projected inputs gathered
    whole, and the state and conv windows are the whole sequence's, on
    every rank."""
    def body(x, q, seq):
        h = ctx.gather_seq(layers.rms_norm(x, q["ln"], cfg.norm_eps))
        y, cache = ssd.mamba_prefill(h, q["mixer"], cfg, ctx, seq)
        return ctx.constrain(_add(x, y, ctx), "residual"), cache
    return _by_block(body, ctx, x, p, rest=("batch",) * 4)


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
    def body(x, q, seq):
        h = layers.layer_norm(x, q["ln1"], cfg.norm_eps)
        x = _add(x, _self_attention(h, q["attn"], cfg, ctx, positions, seq,
                                    causal=False, rope=False)[0], ctx)
        h = ctx.gather_seq(layers.layer_norm(x, q["ln2"], cfg.norm_eps))
        return ctx.constrain(_add(x, layers.mlp(h, q["mlp"], False), ctx), "residual")
    return _by_block(body, ctx, x, p)


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


def _cross_kv(enc_out, p, cfg, layout=None):
    """Cross-attention K/V from the encoder output: (B, Se, KV, Dh) each
    (``layout`` as ``attn_lib.qkv_project``'s)."""
    B, Se, _ = enc_out.shape
    kv, dh = cfg.n_kv_heads, cfg.head_dim
    k, v = enc_out @ p["wk"], enc_out @ p["wv"]
    if layout is not None:
        k, v = layout(k, "kv"), layout(v, "kv")
    return k.reshape(B, Se, kv, dh), v.reshape(B, Se, kv, dh)


def _dec_block(x, p, cfg, ctx, positions, enc_out, cache: bool):
    """Whisper's decoder block: causal self-attention, cross-attention (non
    causal, Sq != Sk: the prompt against the frames), the MLP -> x, or with
    ``cache`` (x, {k, v, xk, xv}).  Under the sequence split
    (``_by_block``) the queries are the rank's positions', the self K/V
    gathered whole and the cross K/V the whole encoder output's."""
    def body(x, q, enc, seq):
        h = layers.layer_norm(x, q["ln1"], cfg.norm_eps)
        a, k, v = _self_attention(h, q["self_attn"], cfg, ctx, positions, seq,
                                  rope=False)
        x = _add(x, a, ctx)
        h = ctx.gather_seq(layers.layer_norm(x, q["ln_x"], cfg.norm_eps))
        B, S, _ = h.shape
        kv, dh = cfg.n_kv_heads, cfg.head_dim
        layout = _proj_layout(ctx, h)
        qx = h @ q["cross_attn"]["wq"]
        if layout is not None:
            qx = layout(qx, "q")
        qx = qx.reshape(B, S, cfg.n_heads, dh)
        if not _expand_on_mesh(ctx, h):
            qx = qx.reshape(B, S, kv, cfg.n_heads // kv, dh)
        kx, vx = _cross_kv(ctx.gather_seq(enc), q["cross_attn"], cfg, layout)
        x = _add(x, _sharded_attention(qx, kx, vx, cfg, ctx, causal=False)
                 @ q["cross_attn"]["wo"], ctx)
        h = ctx.gather_seq(layers.layer_norm(x, q["ln2"], cfg.norm_eps))
        x = ctx.constrain(_add(x, layers.mlp(h, q["mlp"], False), ctx), "residual")
        return (x, {"k": k, "v": v, "xk": kx, "xv": vx}) if cache else x
    return _by_block(body, ctx, x, p, extra=(enc_out,),
                     rest=("seq", "seq", "batch", "batch") if cache else ())


def dec_block_fwd(x, p, cfg, ctx, positions, enc_out):
    return _dec_block(x, p, cfg, ctx, positions, enc_out, False)


def dec_block_prefill(x, p, cfg, ctx, positions, enc_out):
    """-> (x, cache): the self-attention K/V and the cross K/V, computed
    once here and read by every decode step."""
    return _dec_block(x, p, cfg, ctx, positions, enc_out, True)


def dec_block_decode(x, p, cfg, ctx, cache, pos: int):
    """h (B,1,D); cache {k, v, xk, xv}: the self K/V updated in place at
    ``pos``, the cross K/V read whole.  Under a decode plan on a mesh
    (``ctx.sharded_decode``) both caches are this rank's shards, cut by the
    same plan, and the cross K/V is read by the same log-sum-exp combine
    as the self K/V, at the frames' last position, with no write: on the
    rank's heads, tensor-parallel (``_tp_attn_decode``), where the plan
    splits the KV heads, else through ``_distributed_decode``; the MLP is
    tensor-parallel where its hidden units split (``_mlp_decode``)."""
    B = x.shape[0]
    self_cache = {"k": cache["k"], "v": cache["v"]}
    cross = {"k": cache["xk"], "v": cache["xv"]}
    h = layers.layer_norm(x, p["ln1"], cfg.norm_eps)
    if _tp_heads(cfg, ctx) is not None:
        x = x + _tp_attn_decode(h, p["self_attn"], cfg, ctx, self_cache, pos,
                                rope=False)
        h = layers.layer_norm(x, p["ln_x"], cfg.norm_eps)
        Se = cache["xk"].shape[1] * ctx.axis_size(tuple(ctx.decode_plan.seq_axes))
        x = x + _tp_attn_decode(h, p["cross_attn"], cfg, ctx, cross, Se - 1,
                                rope=False, write=False)
    else:
        positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
        D = x.shape[-1]
        if ctx.sharded_decode:
            q, k_new, v_new = _decode_qkv(h, p["self_attn"], cfg, ctx, positions,
                                          rope=False)
            o = _distributed_decode(q, k_new, v_new, self_cache, pos, ctx)
            x = x + _out_proj(o, p["self_attn"], cfg, ctx, D)
        else:
            q, k_new, v_new = attn_lib.qkv_project(h, p["self_attn"], cfg, positions,
                                                   rope=False)
            self_cache = attn_lib.cache_update(self_cache, k_new, v_new, pos)
            o = attn_lib.decode_attention(q, self_cache, pos)
            x = x + attn_lib.merge_heads(o, cfg) @ p["self_attn"]["wo"]

        h = layers.layer_norm(x, p["ln_x"], cfg.norm_eps)
        kv, dh = cfg.n_kv_heads, cfg.head_dim
        if ctx.sharded_decode:
            qx = tp.cols(h, p["cross_attn"]["wq"], ctx,
                         tp.spec(ctx, "wq", (D, cfg.n_heads * dh)))
            qx = qx.reshape(B, 1, kv, cfg.n_heads // kv, dh)
            Se = cache["xk"].shape[1] * ctx.axis_size(tuple(ctx.decode_plan.seq_axes))
            o = _distributed_decode(qx, None, None, cross, Se - 1, ctx)
            x = x + _out_proj(o, p["cross_attn"], cfg, ctx, D)
        else:
            qx = (h @ p["cross_attn"]["wq"]).reshape(B, 1, kv, cfg.n_heads // kv, dh)
            o = attn_lib.decode_attention(qx, cross, cache["xk"].shape[1] - 1)
            x = x + attn_lib.merge_heads(o, cfg) @ p["cross_attn"]["wo"]

    h = layers.layer_norm(x, p["ln2"], cfg.norm_eps)
    x = x + _mlp_decode(h, p["mlp"], False, ctx, cfg.d_ff)
    return x, cache
