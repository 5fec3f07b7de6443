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
"""

from __future__ import annotations

import json
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.checkpointer import MANIFEST
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.device import resolve_device
from repro_torch.models.context import ModelCtx, null_ctx
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.optim.optimizers import (Optimizer, tree_leaves, tree_map,
                                          tree_unflatten)


def make_train_step(model: Model, optimizer: Optimizer, ctx: ModelCtx) -> Callable:
    """``train_step(state, batch) -> (new_state, metrics)``: state
    {"params", "opt"}; batch {"tokens", "labels"} tensors on the
    parameters' device; metrics {"loss", "xent", "aux", "lr",
    "grad_norm"} (tensors, and a float lr).  The given state is not
    changed."""
    def train_step(state, batch):
        params = tree_map(lambda p: p.detach().requires_grad_(True),
                          state["params"])
        leaves = tree_leaves(params)
        with torch.enable_grad():
            loss, metrics = model.loss(params, batch, ctx)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        new_params, new_opt, opt_metrics = optimizer.update(
            tree_unflatten(params, grads), state["opt"], state["params"])
        return ({"params": new_params, "opt": new_opt},
                {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()},
                 **opt_metrics})

    return train_step


def init_state(model: Model, optimizer: Optimizer, seed: int = 0, device="cuda"):
    """Fresh parameters from ``torch.Generator().manual_seed(seed)`` (drawn
    on the CPU, so a seed gives the same weights on every device) and the
    optimizer's state."""
    params = model.init(torch.Generator().manual_seed(seed), device=device)
    return {"params": params, "opt": optimizer.init(params)}


def batch_to(batch: dict, device) -> dict:
    """A numpy batch ({"tokens", "labels"}) as int64 tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v), device=device).long()
            for k, v in batch.items()}


class Trainer:
    """Small real-training loop with checkpoint/restart.

    SpotTune treats one Trainer as one HPT trial; ``run_steps`` advances it
    and returns the validation metric stream the engine and EarlyCurve
    consume.  It runs on the card by default (``device="cuda"``, raising
    without one); ``device="cpu"`` runs the plain versions."""

    def __init__(self, cfg, batch: int, seq: int, lr: float = 3e-3,
                 lr_schedule=None, seed: int = 0,
                 ckpt: Optional[CheckpointManager] = None,
                 val_every: int = 10, ctx: Optional[ModelCtx] = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = Model(cfg)
        self.optimizer = adamw(lr_schedule if lr_schedule is not None else lr,
                               keep_master=(cfg.opt_precision == "fp32"))
        self.ctx = ctx or null_ctx(attn_chunk=min(512, seq), remat="none")
        self.data = SyntheticLMDataset(cfg, batch, seq, seed=seed)
        self.step_fn = make_train_step(self.model, self.optimizer, self.ctx)
        self.state = init_state(self.model, self.optimizer, seed, self.device)
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
            t0 = time.perf_counter()
            self.state, m = self.step_fn(self.state, batch)
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
        self.ckpt.save(self.step, self.state, blocking=blocking, extra_meta=meta)

    def restore(self, sharding_fn=None, step=None):
        """Rehydrate from the latest checkpoint (or an explicit ``step``)
        onto the trainer's device (or ``sharding_fn(leaf)``); the metric
        stream reloads from the manifest so the trial continues the
        original stream exactly."""
        if self.ckpt is None:
            raise RuntimeError("Trainer.restore: no CheckpointManager (ckpt=None)")
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
