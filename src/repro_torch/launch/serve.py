"""Serving: one prefill, then batched greedy decode.

The port of ``repro.launch.serve``: one prefill over the prompts, then a
host loop of single-token decode steps, each feeding back the argmax.  On
the card the prefill runs the ``flash_attention`` and ``ssd_chunk`` kernels
(through ``Model.prefill``); decode is plain PyTorch.  Whisper's prefill
takes the stub frame embeddings (``frames``) beside the prompt; its
encoder runs once there, and decode reads the cached cross K/V.
Pixtral's takes the stub patch embeddings (``patch_embeds``), which come
ahead of the prompt and take its first ``n_patches`` positions.

On a mesh, ``Server(cfg, params, ctx=policy.ctx(decode=True, batch=B))``
with ``policy = Policy(cfg, mesh, "decode")``: every rank is given the
whole batch and the whole (replicated) parameters; it prefills its batch
slice (``plan.b_axes``) replicated, cuts the cache to its shard as
``Policy.cache_shardings`` lays it out (sequence over ``plan.seq_axes``, KV
heads or head_dim over ``model``; the SSM state over heads or head dim
and the conv windows over channels, where they split), decodes through
the shard-aware path, which splits each product over the mesh
(``models.tp``: a rank computes its heads', channels' and hidden units'
share), and gathers the tokens of the whole batch.  The
cache's sequence (``max_len``) must split evenly over the sequence axes.
Every family decodes on a mesh: the transformer families (dense, vlm, moe,
MLA), mamba2 (ssm), zamba2 (hybrid: the mamba stacks and the shared
attention block) and whisper (audio: its cross cache cut by the same
plan).

The prefill also runs sharded: ``Server(cfg, params,
ctx=Policy(cfg, mesh, "prefill").ctx())`` places the parameters by that
policy (each rank keeps its blocks) and each prompt batch by its
``batch_shardings``, and ``prefill`` runs the model as the policy's rules
lay it out, for every family, returning ``DTensor`` logits and cache.
``generate`` under the prefill ctx prefills sharded, gathers the logits,
the cache and the parameters whole and decodes the whole batch on every
rank with no mesh (the function the JAX ``Server`` computes under any
ctx).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.collectives import all_gather_ordered
from repro_torch.device import resolve_device
from repro_torch.checkpoint.checkpointer import leaf_paths
from repro_torch.launch.sharding import (Policy, full_state, local_block,
                                         map_with_path, place, place_batch)
from repro_torch.models.context import ModelCtx, null_ctx
from repro_torch.models.model import Model


class Server:
    """Batched greedy-decoding server for one model.  ``params`` must lie on
    ``device`` (``Model.init`` or ``params_from_numpy`` with that device)."""

    def __init__(self, cfg, params, ctx: Optional[ModelCtx] = None,
                 max_len: int = 512, device="cuda"):
        self.cfg = cfg
        self.model = Model(cfg)
        self.device = resolve_device(device)
        self.params = params
        self.ctx = ctx or null_ctx()
        self.max_len = max_len
        # a prefill or train policy's ctx on a mesh: the sharded prefill
        self.policy = (self.ctx.policy if self.ctx.sharded and self.ctx.decode_plan
                       is None else None)
        if self.policy is not None:
            self.params = place(params, self.policy.param_shardings(params))

    def prefill(self, tokens, frames=None, patch_embeds=None):
        """(last-position logits (B,1,V), cache padded to ``max_len``);
        ``frames`` (B, enc_seq_len, D), whisper's, and ``patch_embeds``
        (B, n_patches, D), pixtral's, on the server's device.
        Serving takes no gradient: the kernels run as they do in
        ``generate``, whatever the weights' ``requires_grad`` (under
        ``no_grad`` on a mesh: DTensors do not take inference mode)."""
        with torch.no_grad() if self.policy is not None else torch.inference_mode():
            return self._prefill(tokens, frames, patch_embeds)

    def _prefill(self, tokens, frames, patch_embeds):
        batch = {"tokens": tokens}
        if frames is not None:
            batch["frames"] = frames
        if patch_embeds is not None:
            batch["patch_embeds"] = patch_embeds
        if self.policy is not None:
            batch = place_batch(batch, self.policy)
        return self.model.prefill(self.params, batch, self.ctx,
                                  cache_len=self.max_len)

    @torch.inference_mode()
    def step(self, cache, tok, pos: int):
        """One decode step -> (next tokens (B,1) int64, cache)."""
        logits, cache = self.model.decode_step(self.params, cache, tok, pos,
                                               self.ctx)
        return torch.argmax(logits[:, -1], dim=-1)[:, None], cache

    def generate(self, batch: dict, max_new_tokens: int = 32):
        """batch: prefill inputs ({'tokens': (B, S_prompt)}, numpy or a
        tensor, and whisper's ``frames`` or pixtral's ``patch_embeds``, a
        tensor).  Returns (B, max_new_tokens) int32 greedy continuations,
        on the server's device."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        frames, patches = (None if batch.get(k) is None else
                           torch.as_tensor(batch[k], device=self.device)
                           for k in ("frames", "patch_embeds"))
        prompt_len = tokens.shape[1]      # the frames sit in the encoder
        if self.cfg.family == "vlm":      # the patches ahead of the prompt
            prompt_len += self.cfg.n_patches
        if prompt_len + max_new_tokens > self.max_len:
            raise ValueError(f"prompt {prompt_len} + {max_new_tokens} new tokens "
                             f"exceeds max_len {self.max_len}")
        if self.policy is not None:
            return self._generate_gathered(tokens, frames, patches, prompt_len,
                                           max_new_tokens)
        with torch.inference_mode():
            return self._generate(tokens, frames, patches, prompt_len,
                                  max_new_tokens)

    def _generate(self, tokens, frames, patches, prompt_len, max_new_tokens):
        b_axes = self.ctx.decode_plan.b_axes if self.ctx.sharded_decode else None
        if b_axes:
            tokens, frames, patches = (None if t is None else self._batch_slice(t)
                                       for t in (tokens, frames, patches))
        logits, cache = self.prefill(tokens, frames, patches)
        if self.ctx.sharded_decode:
            cache = self._shard_cache(cache)
        out = self._decode(logits, cache, self.params, self.ctx, prompt_len,
                           max_new_tokens)
        if b_axes:
            out = all_gather_ordered(out, self.ctx.groups, b_axes, 0)
        return out

    def _generate_gathered(self, tokens, frames, patches, prompt_len,
                           max_new_tokens):
        """Under a prefill ctx on a mesh: the sharded prefill, its logits,
        cache and the parameters gathered whole, then the whole batch
        decoded on every rank with no mesh."""
        logits, cache = self.prefill(tokens, frames, patches)
        with torch.no_grad():
            logits = logits.full_tensor()
            cache, params = full_state(cache), full_state(self.params)
        with torch.inference_mode():
            return self._decode(logits, cache, params,
                                null_ctx(kernels=self.ctx.kernels), prompt_len,
                                max_new_tokens)

    def _decode(self, logits, cache, params, ctx, prompt_len, max_new_tokens):
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out = [tok]
        for i in range(max_new_tokens - 1):
            logits, cache = self.model.decode_step(params, cache, tok,
                                                   prompt_len + i, ctx)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            out.append(tok)
        return torch.cat(out, dim=1).to(torch.int32)

    def _batch_slice(self, t):
        """This rank's rows of a whole batch (the plan's batch axes)."""
        return local_block(t, (tuple(self.ctx.decode_plan.b_axes),), self.ctx.mesh)

    def _shard_cache(self, cache):
        """A prefill's cache (this rank's batch rows, whole sequence and
        heads) cut to this rank's shard, as ``Policy.cache_shardings`` lays
        it out; the batch dim is already this rank's.  Each leaf is copied
        to storage of its own, so the whole cache is freed."""
        sh = Policy(self.cfg, self.ctx.mesh, "decode").cache_shardings(
            cache, self.ctx.decode_plan)
        flat = dict(leaf_paths(sh))

        def cut(path, t):
            spec = list(flat[path].spec)
            spec[1] = None                        # (L, B, ...): B is local
            return local_block(t, spec, self.ctx.mesh).clone(
                memory_format=torch.contiguous_format)
        return map_with_path(cut, cache)
