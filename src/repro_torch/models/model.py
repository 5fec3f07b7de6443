"""Model: init / full-sequence forward / prefill / decode.

The port of ``repro.models.model`` for the families

  dense    pre-norm GQA transformer
  ssm      mamba2 stack
  hybrid   mamba2 stack + one weight-shared attention block after every
           ``attn_every`` layers (zamba2)

(``moe``, ``audio`` and ``vlm`` are not ported yet and raise).  Parameters
keep the JAX package's pytree: nested dicts with the layer stacks along a
leading L axis.  Where the JAX package runs ``lax.scan`` over a stack, the
port loops in Python over its rows.  ``params_from_numpy`` carries the JAX
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

from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import blocks, layers
from repro_torch.models.context import ModelCtx, null_ctx
from repro_torch.optim.optimizers import tree_leaves, tree_map

FAMILIES = ("dense", "ssm", "hybrid")


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
            raise NotImplementedError(
                f"family {cfg.family!r} ({cfg.name}) is not ported to "
                f"repro_torch yet (ROADMAP A10); ported: {FAMILIES}")
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
        if cfg.family == "dense":
            p["layers"] = _stacked_init(
                lambda: blocks.init_block(gen, cfg, False, dev), cfg.n_layers)
        elif cfg.family == "ssm":
            p["layers"] = _stacked_init(
                lambda: blocks.init_mamba(gen, cfg, dev), cfg.n_layers)
        else:
            p["mamba_layers"] = _stacked_init(
                lambda: blocks.init_mamba(gen, cfg, dev), cfg.n_layers)
            p["shared_block"] = blocks.init_block(gen, cfg, False, dev)
        p["ln_f"] = layers.init_rmsnorm(cfg.d_model, dev)
        if not cfg.tie_embeddings:
            p["unembed"] = layers.dense_init(gen, cfg.d_model, cfg.vocab_size,
                                             layers.dtype_of(cfg), dev)
        return p

    # ------------------------------------------------------------- embedding
    def _embed_inputs(self, params, batch, ctx):
        """-> (x (B,S,D), positions (S,))."""
        tokens = batch["tokens"]
        x = layers.embed_tokens(params["embed"], tokens, self.cfg)
        positions = torch.arange(x.shape[1], device=x.device)
        return ctx.constrain(x, "residual"), positions

    def _unembed(self, params, x, ctx):
        cfg = self.cfg
        x = layers.rms_norm(x, params["ln_f"], cfg.norm_eps)
        w = params["embed"]["tok"].T if cfg.tie_embeddings else params["unembed"]
        return ctx.constrain(x @ w, "logits")

    def _segments(self):
        cfg = self.cfg
        segs, lo = [], 0
        while lo < cfg.n_layers:
            hi = min(lo + cfg.attn_every, cfg.n_layers)
            segs.append((lo, hi))
            lo = hi
        return segs

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
        if cfg.family == "dense":
            body = self._maybe_remat(
                lambda x, lp: blocks.block_fwd(x, lp, cfg, ctx, positions), ctx)
            for i in range(cfg.n_layers):
                x, a = body(x, _row(params["layers"], i))
                aux = aux + a
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
        logits32 = self._unembed(params, x, ctx).float()
        m = (labels >= 0).float()
        mx = torch.amax(logits32, dim=-1, keepdim=True)
        lse = torch.log(torch.sum(torch.exp(logits32 - mx.detach()), dim=-1)) + mx[..., 0]
        gold = torch.gather(logits32, -1, labels.clamp(min=0)[..., None])[..., 0]
        xe = torch.sum((lse - gold) * m) / torch.clamp(torch.sum(m), min=1.0)
        return xe + aux, {"xent": xe, "aux": aux}

    # -------------------------------------------------------------- prefill
    def prefill(self, params, batch, ctx: Optional[ModelCtx] = None,
                cache_len: Optional[int] = None):
        """Process the prompt; return (last-position logits, decode cache).

        ``cache_len``: KV-cache capacity (>= prompt length); sequence-indexed
        cache leaves are right-padded to it so decode has free slots."""
        cfg = self.cfg
        ctx = ctx or null_ctx()
        x, positions = self._embed_inputs(params, batch, ctx)
        stack = lambda cs: tree_map(lambda *xs: torch.stack(xs), *cs)  # noqa: E731
        if cfg.family == "dense":
            caches = []
            for i in range(cfg.n_layers):
                x, c = blocks.block_prefill(x, _row(params["layers"], i), cfg, ctx,
                                            positions)
                caches.append(c)
            cache = stack(caches)
        elif cfg.family == "ssm":
            caches = []
            for i in range(cfg.n_layers):
                x, c = blocks.mamba_prefill(x, _row(params["layers"], i), cfg, ctx)
                caches.append(c)
            cache = stack(caches)
        else:
            m_caches, a_caches = [], []
            for lo, hi in self._segments():
                for i in range(lo, hi):
                    x, c = blocks.mamba_prefill(x, _row(params["mamba_layers"], i),
                                                cfg, ctx)
                    m_caches.append(c)
                x, c = blocks.block_prefill(x, params["shared_block"], cfg, ctx,
                                            positions)
                a_caches.append(c)
            cache = {"mamba": stack(m_caches), "attn": stack(a_caches)}
        if cache_len is not None:
            cache = _pad_cache_to(cache, cache_len)
        return self._unembed(params, x[:, -1:], ctx), cache

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
        if cfg.family == "dense":
            for i in range(cfg.n_layers):
                x, _ = blocks.block_decode(x, _row(params["layers"], i), cfg, ctx,
                                           _row(cache, i), pos)
        elif cfg.family == "ssm":
            for i in range(cfg.n_layers):
                x, c = blocks.mamba_decode(x, _row(params["layers"], i), cfg, ctx,
                                           _row(cache, i))
                _write_row(cache, i, c)
        else:
            for n, (lo, hi) in enumerate(self._segments()):
                for i in range(lo, hi):
                    x, c = blocks.mamba_decode(x, _row(params["mamba_layers"], i),
                                               cfg, ctx, _row(cache["mamba"], i))
                    _write_row(cache["mamba"], i, c)
                x, _ = blocks.block_decode(x, params["shared_block"], cfg, ctx,
                                           _row(cache["attn"], n), pos)
        return self._unembed(params, x, ctx), cache


_SEQ_CACHE_KEYS = ("k", "v", "c_kv", "k_rope")  # leaves with a seq axis at dim 2


def _pad_cache_to(cache, cache_len: int):
    """Right-pad sequence-indexed cache leaves (stacked layout (L, B, S, ...))
    to ``cache_len`` with zeros.  SSM states and conv windows untouched."""
    out = {}
    for key, val in cache.items():
        if isinstance(val, dict):
            out[key] = _pad_cache_to(val, cache_len)
        elif key in _SEQ_CACHE_KEYS and cache_len > val.shape[2]:
            pad = torch.zeros(val.shape[:2] + (cache_len - val.shape[2],)
                              + val.shape[3:], dtype=val.dtype, device=val.device)
            out[key] = torch.cat([val, pad], dim=2)
        else:
            out[key] = val
    return out


def count_params_analytic(cfg, active_only: bool = False) -> int:
    """Parameter count from the shapes ``Model.init`` makes on the ``meta``
    device (nothing allocated).  The ported families have no experts, so
    ``active_only`` counts the same."""
    params = Model(cfg).init(None, device="meta")
    return sum(t.numel() for t in tree_leaves(params))


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
