"""Training driver: the train-step builder and a ``Trainer`` with
checkpoint/restart (the port of ``repro.launch.train``).

One train step: the loss (masked cross-entropy + MoE aux, ``Model.loss``)
-> the gradients of every parameter leaf by ``torch.autograd.grad`` ->
the optimizer's update (clip + AdamW by default), functional as in the JAX
package.  On the card the model's attention and SSD chunks run the
hand-written ``flash_attention`` and ``ssd_chunk`` kernels in the forward,
with their plain backwards.  Fault tolerance comes from the checkpoint
manager (atomic manifests) and the deterministic data pipeline: a restore
replays the exact stream.

On a mesh, ``Trainer(..., ctx=policy.ctx())`` with ``policy =
Policy(cfg, mesh, "train", global_batch=batch)`` places its state by the
policy (``launch.sharding.place_state``: every rank holds its blocks of
the parameters and the AdamW moments) and each batch by
``policy.batch_shardings``; the step is the JAX package's jitted step
under ``in_shardings``: the forward and backward sharded as the policy's
rules lay them out, the gradients placed like their parameters, the
update on each rank's shards.  ``save`` gathers the state whole (rank 0
writes); ``restore`` reads it back onto the policy's placements.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.checkpointer import MANIFEST
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.device import resolve_device
from repro_torch.launch.sharding import (full_state, place_batch, place_state,
                                         restore_hook)
from repro_torch.models.context import ModelCtx, null_ctx
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.optim.optimizers import (Optimizer, tree_leaves, tree_map,
                                          tree_unflatten)


def _plain(t):
    """A metric as a plain tensor (a replicated ``DTensor`` gathered)."""
    t = t.detach()
    return t.full_tensor() if isinstance(t, DTensor) else t


def loss_and_grads(model: Model, params, batch, ctx: ModelCtx):
    """(loss, metrics, grads): ``Model.loss`` (detached) and the gradient of
    every parameter leaf (zeros where a leaf is unused), each placed like
    its parameter on a mesh."""
    params = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(params)
    with torch.enable_grad():
        loss, metrics = model.loss(params, batch, ctx)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None
             else g.redistribute(p.device_mesh, p.placements) if isinstance(g, DTensor)
             else g for p, g in zip(leaves, grads)]
    # the loss and metrics detached: their graph (whose leaves share the
    # parameters' storage) goes with this frame, so that a donated update
    # finds the parameters held by nothing else
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(params, grads)


def make_train_step(model: Model, optimizer: Optimizer, ctx: ModelCtx,
                    donate: bool = False) -> Callable:
    """``train_step(state, batch) -> (new_state, metrics)``: state
    {"params", "opt"}; batch {"tokens", "labels"} (and whisper's
    ``frames``) tensors on the parameters' device, or, on a mesh, the
    state and batch placed by ``ctx.policy``; metrics {"loss", "xent",
    "aux", "lr", "grad_norm"} (tensors, and a float lr).  The given state
    is not changed; with ``donate`` (an ``adamw`` optimizer) it is
    consumed, as the JAX package's ``Trainer`` donates it to its jitted
    step: each of its leaves is released from its dict as the update makes
    the new one, the dicts left holding ``None``."""
    def train_step(state, batch):
        loss, metrics, grads = loss_and_grads(model, state["params"], batch, ctx)
        kw = {"donate": True} if donate else {}
        new_params, new_opt, opt_metrics = optimizer.update(
            grads, state["opt"], state["params"], **kw)
        return ({"params": new_params, "opt": new_opt},
                {"loss": _plain(loss), **{k: _plain(v) for k, v in metrics.items()},
                 **opt_metrics})

    return train_step


def init_state(model: Model, optimizer: Optimizer, seed: int = 0, device="cuda",
               draw_on: str = "cpu"):
    """Fresh parameters from ``torch.Generator(draw_on).manual_seed(seed)``
    (drawn on the CPU by default, so a seed gives the same weights on every
    device; ``draw_on="cuda"`` draws on the card, where a model of billions
    of parameters initializes in seconds) and the optimizer's state."""
    params = model.init(torch.Generator(device=draw_on).manual_seed(seed),
                        device=device)
    return {"params": params, "opt": optimizer.init(params)}


def batch_to(batch: dict, device) -> dict:
    """A batch as ``SyntheticLMDataset`` makes it, on ``device``: the token
    ids and labels (numpy) as int64 tensors, whisper's ``frames`` (a float
    tensor) in its own type."""
    return {k: (v.to(device) if isinstance(v, torch.Tensor) and v.is_floating_point()
                else torch.as_tensor(np.asarray(v), device=device).long())
            for k, v in batch.items()}


class Trainer:
    """Small real-training loop with checkpoint/restart.

    SpotTune treats one Trainer as one HPT trial; ``run_steps`` advances it
    and returns the validation metric stream the engine and EarlyCurve
    consume.  It runs on the card by default (``device="cuda"``, raising
    without one); ``device="cpu"`` runs the plain versions.  Each step
    consumes the Trainer's state (``make_train_step(..., donate=True)``, as
    the JAX ``Trainer`` donates it): a state assigned to ``Trainer.state``
    is read, not changed, and a step that raises leaves the Trainer with
    no state.  ``draw_on`` is ``init_state``'s."""

    def __init__(self, cfg, batch: int, seq: int, lr: float = 3e-3,
                 lr_schedule=None, seed: int = 0,
                 ckpt: Optional[CheckpointManager] = None,
                 val_every: int = 10, ctx: Optional[ModelCtx] = None,
                 device="cuda", draw_on: str = "cpu"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = Model(cfg)
        self.optimizer = adamw(lr_schedule if lr_schedule is not None else lr,
                               keep_master=(cfg.opt_precision == "fp32"))
        self.ctx = ctx or null_ctx(attn_chunk=min(512, seq), remat="none")
        self.data = SyntheticLMDataset(cfg, batch, seq, seed=seed)
        self.step_fn = make_train_step(self.model, self.optimizer, self.ctx,
                                       donate=True)
        self.state = init_state(self.model, self.optimizer, seed, self.device,
                                draw_on)
        self.policy = self.ctx.policy if self.ctx.sharded else None
        if self.policy is not None:
            self.state = place_state(self.state, self.policy)
        self.step = 0
        self.ckpt = ckpt
        self.val_every = val_every
        self.metrics_steps: list = []
        self.metrics_vals: list = []
        self.step_seconds: list = []

    def run_steps(self, n: int):
        """Advance n steps; returns newly recorded (step, val_loss) points."""
        new_points = []
        for _ in range(n):
            batch = batch_to(self.data.get_batch(self.step), self.device)
            if self.policy is not None:
                batch = place_batch(batch, self.policy)
            t0 = time.perf_counter()
            # the step takes dicts of its own (the leaves shared): the
            # donation empties those, and the Trainer's reference goes
            state, self.state = tree_map(lambda t: t, self.state), None
            self.state, m = self.step_fn(state, batch)
            del state
            loss = float(m["loss"])              # waits for the step
            self.step_seconds.append(time.perf_counter() - t0)
            self.step += 1
            if self.step % self.val_every == 0:
                self.metrics_steps.append(self.step)
                self.metrics_vals.append(loss)
                new_points.append((self.step, loss))
            if self.ckpt and self.ckpt.should_save(self.step):
                self.save()
        return new_points

    # ------------------------------------------------------- checkpointing
    def save(self, blocking: bool = True):
        if self.ckpt is None:
            raise RuntimeError("Trainer.save: no CheckpointManager (ckpt=None)")
        meta = {"metrics_steps": self.metrics_steps,
                "metrics_vals": self.metrics_vals}
        if self.policy is None:
            self.ckpt.save(self.step, self.state, blocking=blocking, extra_meta=meta)
            return
        # on a mesh: the state gathered whole, written by rank 0
        state = full_state(self.state)
        if dist.get_rank() == 0:
            self.ckpt.save(self.step, state, blocking=True, extra_meta=meta)
        dist.barrier()

    def restore(self, sharding_fn=None, step=None):
        """Rehydrate from the latest checkpoint (or an explicit ``step``)
        onto the trainer's device (or ``sharding_fn(leaf)``); the metric
        stream reloads from the manifest so the trial continues the
        original stream exactly."""
        if self.ckpt is None:
            raise RuntimeError("Trainer.restore: no CheckpointManager (ckpt=None)")
        if self.policy is not None and sharding_fn is None:
            # each leaf read and cut to this rank's block, as the policy lays it out
            sharding_fn = restore_hook(self.policy.state_shardings(self.state),
                                       self.state)
        self.state, step = self.ckpt.restore(self.state, step=step,
                                             sharding_fn=sharding_fn)
        self.step = step
        base = f"{self.ckpt.prefix}/step_{step:08d}"
        meta = json.loads(self.ckpt.store.get(f"{base}/{MANIFEST}").decode())
        extra = meta.get("extra", {})
        self.metrics_steps = list(extra.get("metrics_steps", []))
        self.metrics_vals = list(extra.get("metrics_vals", []))
        return step

    def mean_step_time(self) -> float:
        xs = self.step_seconds[2:] or self.step_seconds  # drop warm-up steps
        return float(np.mean(xs)) if xs else 0.0
