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
with ``policy = Policy(cfg, mesh, "decode")``: the caller gives every rank
the whole batch and the whole parameters, and each rank keeps only its
block of every parameter, as ``policy.param_shardings`` lays them out
(the tensor-parallel dim over ``model``, the other over the FSDP axis;
the JAX package lowers its decode with those ``in_shardings``), in
storage of its own, so that the caller's whole tensors can be freed.
``Server.params`` are those blocks.  The prefill runs sharded from them,
no weight gathered whole: the blocks as ``DTensor``s of the policy's
placements (views), the whole batch placed by ``policy.batch_shardings``
and the model laid out by the same policy's forward rules
(``policy.ctx()``), as the JAX package prefills from its sharded
parameters; then a rank keeps its rows of the logits (``plan.b_axes``)
and its shard of the cache, as ``Policy.cache_shardings`` lays it out
(sequence over ``plan.seq_axes``, KV heads or head_dim over ``model``;
the SSM state over heads or head dim and the conv windows over channels,
where they split).  It decodes through the shard-aware path, whose every
product takes the rank's block of its weight (``models.tp``: a rank
computes its heads', channels', hidden units' and experts' share, an
FSDP block gathered before its product or contracted in place), and
gathers the tokens of the whole batch.  The cache's sequence
(``max_len``) must split evenly over the sequence axes.
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

from torch.distributed.tensor import DTensor

from repro_torch.collectives import all_gather_ordered
from repro_torch.device import resolve_device
from repro_torch.checkpoint.checkpointer import leaf_paths
from repro_torch.launch.sharding import (full_state, local_block, map_with_path,
                                         place, place_batch)
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
        elif self.ctx.sharded_decode:
            self.params = self._param_blocks(params)

    def prefill(self, tokens, frames=None, patch_embeds=None):
        """(last-position logits (B,1,V), cache padded to ``max_len``);
        ``frames`` (B, enc_seq_len, D), whisper's, and ``patch_embeds``
        (B, n_patches, D), pixtral's, on the server's device.  Under a
        decode ctx on a mesh the inputs are the whole batch, and the
        result this rank's rows of the logits and its shard of the cache.
        Serving takes no gradient: the kernels run as they do in
        ``generate``, whatever the weights' ``requires_grad`` (under
        ``no_grad`` on a mesh: DTensors do not take inference mode)."""
        batch = {"tokens": tokens}
        if frames is not None:
            batch["frames"] = frames
        if patch_embeds is not None:
            batch["patch_embeds"] = patch_embeds
        if self.policy is not None:
            with torch.no_grad():
                return self.model.prefill(self.params, place_batch(batch, self.policy),
                                          self.ctx, cache_len=self.max_len)
        if self.ctx.sharded_decode:
            with torch.inference_mode(False), torch.no_grad():
                return self._prefill_blocks(batch)
        with torch.inference_mode():
            return self.model.prefill(self.params, batch, self.ctx,
                                      cache_len=self.max_len)

    def _prefill_blocks(self, batch):
        """The decode ctx's prefill: the whole batch through the decode
        policy's sharded forward (``policy.ctx()``) on the rank's blocks as
        ``DTensor``s (views of them, nothing gathered), then this rank's
        rows of the logits and its shard of the cache."""
        policy, mesh = self.ctx.policy, self.ctx.mesh
        ctx = policy.ctx(batch=batch["tokens"].shape[0])
        ctx.kernels = self.ctx.kernels

        def placed(path, t):
            pl, shape, stride = self._layout[path]
            return DTensor.from_local(t, mesh, pl, run_check=False, shape=shape,
                                      stride=stride)
        logits, cache = self.model.prefill(map_with_path(placed, self.params),
                                           place_batch(batch, policy), ctx,
                                           cache_len=self.max_len)
        logits = logits.full_tensor()
        if self.ctx.decode_plan.b_axes:
            logits = self._batch_slice(logits)
        return logits, self._shard_cache(cache)

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
        logits, cache = self.prefill(tokens, frames, patches)
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

    def _param_blocks(self, params):
        """This rank's block of every parameter under the decode policy, in
        storage of its own (a block that is the whole tensor, on a mesh of
        one card, keeps the caller's storage); each one's placements, whole
        shape and contiguous stride kept (``_layout``) for the prefill."""
        shardings = dict(leaf_paths(self.ctx.policy.param_shardings(params)))
        self._layout = {}

        def cut(path, t):
            sh = shardings[path]
            self._layout[path] = (sh.placements, t.shape,
                                  torch.empty(t.shape, device="meta").stride())
            b = local_block(t, sh.spec, self.ctx.mesh)
            if b.shape == t.shape and t.is_contiguous():
                return t
            return b.clone(memory_format=torch.contiguous_format)
        return map_with_path(cut, params)

    def _batch_slice(self, t):
        """This rank's rows of a whole batch (the plan's batch axes)."""
        return local_block(t, (tuple(self.ctx.decode_plan.b_axes),), self.ctx.mesh)

    def _shard_cache(self, cache):
        """The sharded prefill's cache (``DTensor`` leaves, which
        ``Model.prefill`` leaves in the plan of the prompt's batch) as this
        rank's shard under this server's decode plan, in storage of its own.
        The two plans differ where the server's ctx was made for another
        batch (``batch=None`` takes the "distributed" plan); where they
        agree the ``redistribute`` moves nothing."""
        flat = dict(leaf_paths(self.ctx.policy.cache_shardings(
            cache, self.ctx.decode_plan)))

        def cut(path, t):
            return t.redistribute(self.ctx.mesh, flat[path].placements).to_local().clone(
                memory_format=torch.contiguous_format)
        return map_with_path(cut, cache)
