"""Serving: one prefill, then batched greedy decode.

The port of ``repro.launch.serve``: one prefill over the prompts, then a
host loop of single-token decode steps, each feeding back the argmax.  On
the card the prefill runs the ``flash_attention`` and ``ssd_chunk`` kernels
(through ``Model.prefill``); decode is plain PyTorch.  Whisper's prefill
takes the stub frame embeddings (``frames``) beside the prompt; its
encoder runs once there, and decode reads the cached cross K/V.
Pixtral's takes the stub patch embeddings (``patch_embeds``), which come
ahead of the prompt and take its first ``n_patches`` positions.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve_device
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

    @torch.inference_mode()
    def prefill(self, tokens, frames=None, patch_embeds=None):
        """(last-position logits (B,1,V), cache padded to ``max_len``);
        ``frames`` (B, enc_seq_len, D), whisper's, and ``patch_embeds``
        (B, n_patches, D), pixtral's, on the server's device.
        Serving takes no gradient: the kernels run as they do in
        ``generate``, whatever the weights' ``requires_grad``."""
        batch = {"tokens": tokens}
        if frames is not None:
            batch["frames"] = frames
        if patch_embeds is not None:
            batch["patch_embeds"] = patch_embeds
        return self.model.prefill(self.params, batch, self.ctx,
                                  cache_len=self.max_len)

    @torch.inference_mode()
    def step(self, cache, tok, pos: int):
        """One decode step -> (next tokens (B,1) int64, cache)."""
        logits, cache = self.model.decode_step(self.params, cache, tok, pos,
                                               self.ctx)
        return torch.argmax(logits[:, -1], dim=-1)[:, None], cache

    @torch.inference_mode()
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
        logits, cache = self.prefill(tokens, frames, patches)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out = [tok]
        for i in range(max_new_tokens - 1):
            tok, cache = self.step(cache, tok, prompt_len + i)
            out.append(tok)
        return torch.cat(out, dim=1).to(torch.int32)
