"""Model: init / full-sequence forward / prefill / decode.

The port of ``repro.models.model`` for the families

  dense    pre-norm GQA transformer
  vlm      the same over stub patch embeddings prepended to the tokens
           (pixtral)
  moe      the same skeleton with MoE FFNs after ``first_k_dense`` dense
           layers (grok-1; deepseek-v2 with MLA attention)
  ssm      mamba2 stack
  hybrid   mamba2 stack + one weight-shared attention block after every
           ``attn_every`` layers (zamba2)
  audio    whisper-style encoder-decoder over stub frame embeddings

Parameters keep the JAX package's pytree: nested dicts with the layer
stacks along a leading L axis.  Where the JAX package runs ``lax.scan``
over a stack, the port loops in Python over its rows.  ``params_from_numpy`` carries the JAX
package's weights across; ``Model.init`` draws fresh ones with the same
distributions (not the same numbers).

Decode updates the cache in place and returns the same dict: the JAX
package's jitted step donates its cache and returns a new one, which here
would copy every layer's KV cache each token.

``Model.loss`` is the training objective: the backbone, the final norm and
the unembedding, masked cross-entropy and the MoE aux term.  With
``ctx.remat == "full"`` each layer body that the JAX package wraps in
``jax.checkpoint`` is run under ``torch.utils.checkpoint`` (recomputed in
the backward) while grad mode is on.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.checkpoint.checkpointer import leaf_paths
from repro_torch.collectives import P, axis_names, psum
from repro_torch.device import resolve_device
from repro_torch.models import blocks, layers, tp
from repro_torch.models.context import ModelCtx, null_ctx
from repro_torch.optim.optimizers import tree_leaves, tree_map

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")


def _stacked_init(init_fn, n):
    return tree_map(lambda *xs: torch.stack(xs), *[init_fn() for _ in range(n)])


def _row(tree, i):
    """Layer ``i`` of a stacked tree, as views."""
    return tree_map(lambda a: a[i], tree)


def _write_row(tree, i, new):
    tree_map(lambda a, b: a[i].copy_(b), tree, new)


class Model:
    def __init__(self, cfg):
        if cfg.family not in FAMILIES:
            raise ValueError(f"family {cfg.family!r} ({cfg.name}): one of "
                             f"{FAMILIES}")
        self.cfg = cfg

    # ------------------------------------------------------------------ init
    def init(self, generator: Optional[torch.Generator], device="cuda"):
        """Fresh parameters: truncated-normal fan-in weights, N(0, 0.02)
        embeddings, the mamba2 ``A_log`` / ``dt_bias`` / ``D_skip`` inits, in
        the config dtype (norm scales and SSM scalars float32).  Drawn on the
        generator's device, then moved to ``device``; on ``meta`` only the
        shapes are made and ``generator`` may be None."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = generator
        p = {"embed": layers.init_embed(gen, cfg, dev)}
        if cfg.family in ("dense", "vlm"):
            p["layers"] = _stacked_init(
                lambda: blocks.init_block(gen, cfg, False, dev), cfg.n_layers)
        elif cfg.family == "moe":
            if cfg.first_k_dense:
                p["dense_layers"] = _stacked_init(
                    lambda: blocks.init_block(gen, cfg, False, dev),
                    cfg.first_k_dense)
            p["moe_layers"] = _stacked_init(
                lambda: blocks.init_block(gen, cfg, True, dev),
                cfg.n_layers - cfg.first_k_dense)
        elif cfg.family == "ssm":
            p["layers"] = _stacked_init(
                lambda: blocks.init_mamba(gen, cfg, dev), cfg.n_layers)
        elif cfg.family == "hybrid":
            p["mamba_layers"] = _stacked_init(
                lambda: blocks.init_mamba(gen, cfg, dev), cfg.n_layers)
            p["shared_block"] = blocks.init_block(gen, cfg, False, dev)
        else:
            p["enc_pos"] = layers.embed_init(gen, cfg.enc_seq_len, cfg.d_model,
                                             layers.dtype_of(cfg), dev)
            p["enc_layers"] = _stacked_init(
                lambda: blocks.init_enc_block(gen, cfg, dev), cfg.enc_layers)
            p["ln_enc"] = layers.init_layernorm(cfg.d_model, dev)
            p["dec_layers"] = _stacked_init(
                lambda: blocks.init_dec_block(gen, cfg, dev), cfg.n_layers)
        p["ln_f"] = (layers.init_layernorm(cfg.d_model, dev)
                     if cfg.family == "audio" else layers.init_rmsnorm(cfg.d_model, dev))
        if not cfg.tie_embeddings:
            p["unembed"] = layers.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                             layers.dtype_of(cfg), dev)
        return p

    # ------------------------------------------------------------- embedding
    def _embed_inputs(self, params, batch, ctx):
        """-> (x (B,S,D), positions (S,)).  vlm: the stub patch embeddings
        ``batch["patch_embeds"]`` (B, n_patches, D) ahead of the token
        embeddings, the positions over the whole S."""
        cfg = self.cfg
        x = layers.embed_tokens(params["embed"], batch["tokens"], cfg)
        if cfg.family == "vlm":
            patches = batch["patch_embeds"].to(layers.dtype_of(cfg))
            x = torch.cat([patches, x], dim=1)
        positions = torch.arange(x.shape[1], device=x.device)
        return ctx.constrain(x, "residual"), positions

    def _unembed(self, params, x, ctx, role: str = "logits"):
        """The final norm and the unembedding, the logits laid out by
        ``role``: "logits" (vocab over the model axis) for prefill and
        decode, "logits_sp" (sequence over it, vocab local) for the loss.
        The loss's, and under the data-parallel-only layout every role's,
        are each rank's logits of its own sequence block through the whole
        weight (``blocks._on_seq_block``), as the JAX package's program
        computes them in the "logits_sp" layout: no rank holds the whole
        sequence's logits, nor moves them from the vocabulary's split to
        the sequence's."""
        cfg = self.cfg
        norm = layers.layer_norm if cfg.family == "audio" else layers.rms_norm
        w = params["embed"]["tok"].T if cfg.tie_embeddings else params["unembed"]
        if blocks._seq_local(ctx, x) or (role == "logits_sp"
                                         and blocks._seq_split(ctx, x)):
            # each rank's logits of its own positions
            return ctx.constrain(blocks._on_seq_block(
                lambda xl, q, _: norm(xl, q["ln"], cfg.norm_eps) @ q["w"], ctx, x,
                {"ln": params["ln_f"], "w": w}), role)
        x = ctx.gather_seq(norm(x, params["ln_f"], cfg.norm_eps))
        if ctx.sharded_decode:
            # the decode's logits on a mesh, from the rank's block of the
            # weight: the tied table's over d_model (row-parallel), the
            # unembedding's over the vocabulary (column-parallel)
            D, V = cfg.d_model, cfg.vocab_size
            if cfg.tie_embeddings:
                return tp.rows_whole(x, w, ctx, tp.spec(ctx, "embed']['tok", (V, D))[::-1])
            return tp.cols(x, w, ctx, tp.spec(ctx, "unembed", (D, V)))
        return ctx.constrain(x @ w, role)

    def _encode(self, params, batch, ctx):
        """Whisper's encoder over the stub frame embeddings ``batch["frames"]``
        (B, Se, D): absolute encoder positions, the encoder stack, a final
        LayerNorm."""
        cfg = self.cfg
        frames = batch["frames"].to(layers.dtype_of(cfg))
        Se = frames.shape[1]
        x = ctx.constrain(frames + params["enc_pos"][None, :Se], "residual")
        positions = torch.arange(Se, device=x.device)
        body = self._maybe_remat(
            lambda x, lp: blocks.enc_block_fwd(x, lp, cfg, ctx, positions), ctx)
        for i in range(cfg.enc_layers):
            x = body(x, _row(params["enc_layers"], i))
        return layers.layer_norm(x, params["ln_enc"], cfg.norm_eps)

    def _segments(self):
        cfg = self.cfg
        segs, lo = [], 0
        while lo < cfg.n_layers:
            hi = min(lo + cfg.attn_every, cfg.n_layers)
            segs.append((lo, hi))
            lo = hi
        return segs

    def _block_stacks(self):
        """The transformer families' layer stacks in order, as (parameter
        key, cache key, depth): moe's cache is {"dense": ..., "moe": ...},
        the dense and vlm cache is the one stack's (cache key None)."""
        cfg = self.cfg
        if cfg.family != "moe":
            return (("layers", None, cfg.n_layers),)
        dense = (("dense_layers", "dense", cfg.first_k_dense),)
        return (dense if cfg.first_k_dense else ()) + (
            ("moe_layers", "moe", cfg.n_layers - cfg.first_k_dense),)

    @property
    def n_shared_invocations(self):
        return len(self._segments())

    @staticmethod
    def _maybe_remat(body, ctx):
        """``body`` recomputed in the backward when ``ctx.remat`` is "full"
        and grad mode is on (the JAX package's ``jax.checkpoint`` of the
        scan body); as it is otherwise."""
        if ctx.remat != "full":
            return body

        def run(*args):
            if not torch.is_grad_enabled():
                return body(*args)
            return checkpoint(body, *args, use_reentrant=False)
        return run

    # ------------------------------------------------------------ forward
    def forward(self, params, batch, ctx: Optional[ModelCtx] = None):
        """Full-sequence forward.  Returns (logits, aux_loss)."""
        ctx = ctx or null_ctx()
        x, aux = self._backbone(params, batch, ctx)
        return self._unembed(params, x, ctx), aux

    def _backbone(self, params, batch, ctx: ModelCtx):
        """The layer stack only: pre-final-norm hidden states.  Returns
        (x, aux)."""
        cfg = self.cfg
        x, positions = self._embed_inputs(params, batch, ctx)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family in ("dense", "vlm", "moe"):
            body = self._maybe_remat(
                lambda x, lp: blocks.block_fwd(x, lp, cfg, ctx, positions), ctx)
            for name, _, depth in self._block_stacks():
                for i in range(depth):
                    x, a = body(x, _row(params[name], i))
                    aux = aux + a
        elif cfg.family == "audio":
            enc_out = self._encode(params, batch, ctx)
            body = self._maybe_remat(
                lambda x, lp, e: blocks.dec_block_fwd(x, lp, cfg, ctx, positions, e),
                ctx)
            for i in range(cfg.n_layers):
                x = body(x, _row(params["dec_layers"], i), enc_out)
        else:
            body = self._maybe_remat(
                lambda x, lp: blocks.mamba_fwd(x, lp, cfg, ctx), ctx)
            if cfg.family == "ssm":
                for i in range(cfg.n_layers):
                    x = body(x, _row(params["layers"], i))
            else:
                for lo, hi in self._segments():
                    for i in range(lo, hi):
                        x = body(x, _row(params["mamba_layers"], i))
                    x, _ = blocks.block_fwd(x, params["shared_block"], cfg, ctx,
                                            positions)
        return x, aux

    def loss(self, params, batch, ctx: Optional[ModelCtx] = None):
        """Scalar LM loss: the mean cross-entropy over ``labels >= 0`` plus
        the MoE aux term -> (loss, {"xent", "aux"}).  As in the JAX package,
        the log-sum-exp subtracts a detached row max inside the exp and adds
        the (not detached) max back, and the logits are float32 from the
        product in the config dtype.  ``batch``: {"tokens", "labels"}
        (B, S) integer tensors on the parameters' device."""
        ctx = ctx or null_ctx()
        x, aux = self._backbone(params, batch, ctx)
        labels = batch["labels"].long()
        # on a mesh (S over the model axis, V local) each rank reduces its
        # own block and the two sums are reduced over the shards
        logits = self._unembed(params, x, ctx, "logits_sp")
        labels = ctx.constrain(labels, "logits_sp")
        if isinstance(logits, DTensor):
            total, count = _sharded_xent_sums(logits, labels, ctx)
        else:
            total, count = _xent_sums(logits, labels)
        xe = total / torch.clamp(count, min=1.0)
        return xe + aux, {"xent": xe, "aux": aux}

    # -------------------------------------------------------------- prefill
    def prefill(self, params, batch, ctx: Optional[ModelCtx] = None,
                cache_len: Optional[int] = None):
        """Process the prompt; return (last-position logits, decode cache).

        ``cache_len``: KV-cache capacity (>= prompt length); sequence-indexed
        cache leaves are right-padded to it so decode has free slots.  On a
        mesh under a policy (``ctx.policy``) each layer's cache leaves its
        layer in the decode plan's layout for this batch
        (``Policy.cache_shardings``), as the JAX package lowers its prefill
        with ``out_shardings`` of that layout: no rank holds a layer's
        cache whole past its layer."""
        cfg = self.cfg
        ctx = ctx or null_ctx()
        x, positions = self._embed_inputs(params, batch, ctx)
        stack = lambda cs: tree_map(lambda *xs: _stack(xs), *cs)  # noqa: E731
        plan = _cache_plan(ctx, x)
        out = lambda c: _layer_cache(c, ctx, plan, cache_len)  # noqa: E731
        if cfg.family in ("dense", "vlm", "moe"):
            cache = {}
            for name, key, depth in self._block_stacks():
                caches = []
                for i in range(depth):
                    x, c = blocks.block_prefill(x, _row(params[name], i), cfg, ctx,
                                                positions)
                    caches.append(out(c))
                cache[key] = stack(caches)
            cache = cache.get(None, cache)
        elif cfg.family == "ssm":
            caches = []
            for i in range(cfg.n_layers):
                x, c = blocks.mamba_prefill(x, _row(params["layers"], i), cfg, ctx)
                caches.append(out(c))
            cache = stack(caches)
        elif cfg.family == "audio":
            enc_out = self._encode(params, batch, ctx)
            caches = []
            for i in range(cfg.n_layers):
                x, c = blocks.dec_block_prefill(x, _row(params["dec_layers"], i),
                                                cfg, ctx, positions, enc_out)
                caches.append(out(c))
            cache = stack(caches)
        else:
            m_caches, a_caches = [], []
            for lo, hi in self._segments():
                for i in range(lo, hi):
                    x, c = blocks.mamba_prefill(x, _row(params["mamba_layers"], i),
                                                cfg, ctx)
                    m_caches.append(out(c))
                x, c = blocks.block_prefill(x, params["shared_block"], cfg, ctx,
                                            positions)
                a_caches.append(out(c))
            cache = {"mamba": stack(m_caches), "attn": stack(a_caches)}
        return self._unembed(params, ctx.gather_seq(x)[:, -1:], ctx), cache

    # --------------------------------------------------------------- decode
    def decode_step(self, params, cache, tokens, pos: int,
                    ctx: Optional[ModelCtx] = None):
        """One token step.  tokens (B,1); pos (int) the insert position.
        Returns (logits (B,1,V), cache), the cache updated in place."""
        cfg = self.cfg
        ctx = ctx or null_ctx()
        pos = int(pos)
        x = layers.embed_tokens(
            params["embed"], tokens, cfg,
            positions=(torch.full((1,), pos, dtype=torch.int64, device=tokens.device)
                       if cfg.use_abs_pos else None))
        if ctx.sharded_decode:
            # the rank's block of the tables (d_model over the model axis)
            D = tp.spec(ctx, "embed']['tok", (cfg.vocab_size, cfg.d_model))[1]
            x = tp.whole(x, 2, D, ctx)
        if cfg.family in ("dense", "vlm", "moe"):
            for name, key, depth in self._block_stacks():
                c = cache if key is None else cache[key]
                for i in range(depth):
                    x, _ = blocks.block_decode(x, _row(params[name], i), cfg, ctx,
                                               _row(c, i), pos)
        elif cfg.family == "ssm":
            for i in range(cfg.n_layers):
                x, c = blocks.mamba_decode(x, _row(params["layers"], i), cfg, ctx,
                                           _row(cache, i))
                _write_row(cache, i, c)
        elif cfg.family == "audio":
            for i in range(cfg.n_layers):
                x, _ = blocks.dec_block_decode(x, _row(params["dec_layers"], i), cfg,
                                               ctx, _row(cache, i), pos)
        else:
            for n, (lo, hi) in enumerate(self._segments()):
                for i in range(lo, hi):
                    x, c = blocks.mamba_decode(x, _row(params["mamba_layers"], i),
                                               cfg, ctx, _row(cache["mamba"], i))
                    _write_row(cache["mamba"], i, c)
                x, _ = blocks.block_decode(x, params["shared_block"], cfg, ctx,
                                           _row(cache["attn"], n), pos)
        return self._unembed(params, x, ctx), cache


def _xent_sums(logits, labels):
    """(the summed cross-entropy over ``labels >= 0``, their count) of a
    block of logits, float32: the log-sum-exp subtracts a detached row max
    inside the exp and adds the (not detached) max back, as in the JAX
    package."""
    logits32 = logits.float()
    m = (labels >= 0).float()
    mx = torch.amax(logits32, dim=-1, keepdim=True)
    lse = torch.log(torch.sum(torch.exp(logits32 - mx.detach()), dim=-1)) + mx[..., 0]
    gold = torch.gather(logits32, -1, labels.clamp(min=0)[..., None])[..., 0]
    return torch.sum((lse - gold) * m), torch.sum(m)


def _sharded_xent_sums(logits, labels, ctx):
    """``_xent_sums`` of DTensor logits (B, S, V) on each rank's local block
    (``local_map``), the two sums reduced over the mesh dims that split the
    block: the gradient of the logits stays the rank's block (DTensor's
    own reductions and gather would make the global float32 gradient whole
    on every rank)."""
    mesh = ctx.mesh
    axes = tuple(n for n, pl in zip(axis_names(mesh), logits.placements)
                 if isinstance(pl, Shard))

    def local(lg, lab):
        total, count = _xent_sums(lg, lab)
        if axes:
            total, count = psum(total, ctx.groups, axes), psum(count, ctx.groups, axes)
        return total, count

    rep = [Replicate()] * mesh.ndim
    return local_map(local, out_placements=(rep, rep),
                     in_placements=(logits.placements, labels.placements),
                     device_mesh=mesh)(logits, labels)


def _stack(xs):
    """``torch.stack`` of the layers' cache leaves along a new leading dim;
    ``DTensor`` leaves (the sharded prefill's) by their local blocks, the
    placements moved one dim on (DTensor's own ``stack`` fails on some
    placements in the torch of the card's machine)."""
    x0 = xs[0]
    if not isinstance(x0, DTensor):
        return torch.stack(xs)
    mesh, pl = x0.device_mesh, x0.placements
    local = torch.stack([x.redistribute(mesh, pl).to_local() for x in xs])
    shape = (len(xs),) + tuple(x0.shape)
    return DTensor.from_local(
        local, mesh, [Shard(p.dim + 1) if isinstance(p, Shard) else p for p in pl],
        run_check=False, shape=shape, stride=_contiguous_stride(shape))


def _contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``, computed with no
    tensor (a traced program would otherwise make one)."""
    stride, n = [], 1
    for d in reversed(shape):
        stride.append(n)
        n *= max(int(d), 1)
    return tuple(reversed(stride))


_SEQ_CACHE_KEYS = ("k", "v", "c_kv", "k_rope")  # leaves with a seq axis at dim 1


def _cache_plan(ctx, x):
    """The decode plan whose layout the prefill's cache takes: under a
    policy on a mesh (``x`` a ``DTensor``), the policy's plan for x's
    batch; else None."""
    if ctx.policy is None or not isinstance(x, DTensor):
        return None
    return ctx.policy.decode_plan(x.shape[0])


def _layer_cache(cache, ctx, plan, cache_len: Optional[int]):
    """One layer's prefill cache (a dict of leaves (B, S, ...) or (B, ...))
    as the decode takes it: the sequence-indexed leaves right-padded with
    zeros to ``cache_len`` (SSM states, conv windows and the cross K/V
    ``xk``, ``xv`` untouched), then, under ``plan``, each leaf moved to the
    plan's layout of its stacked leaf with the layer dim left out."""
    if cache_len is not None:
        cache = {k: (F.pad(v, [0, 0] * (v.dim() - 2) + [0, cache_len - v.shape[1]])
                     if k in _SEQ_CACHE_KEYS and cache_len > v.shape[1] else v)
                 for k, v in cache.items()}
    if plan is None:
        return cache
    stacked = {k: SimpleNamespace(shape=(1, *v.shape)) for k, v in cache.items()}
    specs = dict(leaf_paths(ctx.policy.cache_shardings(stacked, plan)))
    return {k: ctx.place(v, P(*specs[f"[{k!r}]"].spec[1:])) for k, v in cache.items()}


# ---------------------------------------------------------------------------
# analytic accounting (params / model flops) from shapes: nothing allocated
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _param_shapes(cfg):
    """The parameter tree ``Model.init`` makes on the ``meta`` device: the
    JAX package's leaf names and shapes, no storage (grok-1 has 314 B
    parameters)."""
    return Model(cfg).init(None, device="meta")


def count_params_analytic(cfg, active_only: bool = False) -> int:
    """Parameter count from the shapes of ``_param_shapes``; whisper's
    encoder stack and its position table are in it.  ``active_only``: the
    parameters a token touches, the routed experts counted at
    ``experts_per_tok / n_experts`` of their size.  As in the JAX package,
    "routed" is every leaf under a key ``w_gate``, ``w_up`` or ``w_down``
    in ``moe_layers``, and so includes the shared experts' MLP, which has
    the same names."""
    params = _param_shapes(cfg)
    total = sum(t.numel() for t in tree_leaves(params))
    if active_only and cfg.n_experts > 0:
        routed = sum(t.numel() for name in ("w_gate", "w_up", "w_down")
                     for sub in _find(params.get("moe_layers", {}), name)
                     for t in tree_leaves(sub))
        frac = cfg.experts_per_tok / cfg.n_experts
        total = total - routed + int(routed * frac)
    return total


def matmul_param_count(cfg) -> int:
    """Parameters that take part in a token's products (MoE: the active
    ones; the embedding gather left out; a tied unembedding counted once,
    as a product)."""
    total = count_params_analytic(cfg, active_only=True)
    total -= sum(t.numel() for t in tree_leaves(_param_shapes(cfg)["embed"]))
    if cfg.tie_embeddings:
        total += cfg.d_model * cfg.vocab_size
    return total


def model_flops(cfg, shape, kind: Optional[str] = None) -> float:
    """MODEL_FLOPS = 6 N_active D (train) / 2 N_active D (inference), the
    attention scores left out (the 6ND convention; the roofline's
    MODEL / counted ratio shows them).  Whisper adds its encoder over the
    frames (not on a decode step)."""
    kind = kind or shape.kind
    mult = 6.0 if kind == "train" else 2.0
    fl = mult * matmul_param_count(cfg) * shape.tokens
    if cfg.is_encoder_decoder and kind != "decode":
        enc_n = sum(t.numel() for t in tree_leaves(_param_shapes(cfg)["enc_layers"]))
        fl += mult * enc_n * cfg.enc_seq_len * shape.global_batch
    return fl


def _find(tree, name):
    """The subtrees under keys equal to ``name``, not searched below."""
    out = []

    def rec(t):
        if isinstance(t, dict):
            for k, v in t.items():
                if k == name:
                    out.append(v)
                else:
                    rec(v)
    rec(tree)
    return out


def _to_tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":            # ml_dtypes' bfloat16
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(cfg, tree, device="cuda"):
    """The JAX package's parameter pytree for ``cfg``, as numpy arrays, as
    the port's: the same nested dicts, every leaf a tensor of the same shape
    and dtype on ``device``."""
    Model(cfg)                                     # the family is ported
    dev = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a, dev), tree)
