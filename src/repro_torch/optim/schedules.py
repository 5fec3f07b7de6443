"""Learning-rate schedules (the port of ``repro.optim.schedules``).

A schedule maps the optimizer step (1 at the first update, an int or a
tensor) to the learning rate, a Python float.  The arithmetic is float32
in the JAX package's order, so a schedule gives the reference's float32
value.  The exponential-decay schedule mirrors the paper's HP search
dimensions (lr, decay-rate ``dr``, decay-steps ``ds``; Table II of
SpotTune), which produce the multi-stage loss curves that EarlyCurve's
staged model exists for.
"""

from __future__ import annotations

import math

import torch

_F32 = torch.float32


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F32)


def constant_schedule(lr: float):
    return lambda step: float(_f32(lr))


def exponential_decay_schedule(lr: float, decay_rate: float, decay_steps: int,
                               staircase: bool = True):
    """lr * dr^(step/ds); staircase=True gives the stepped curve that creates
    multi-stage validation-loss trajectories (paper Fig. 5(b))."""
    def f(step):
        e = _f32(step) / decay_steps
        if staircase:
            e = torch.floor(e)
        return float(_f32(lr) * torch.pow(_f32(decay_rate), e))
    return f


def cosine_warmup_schedule(lr: float, warmup: int, total: int,
                           min_frac: float = 0.1):
    def f(step):
        s = _f32(step)
        warm = s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return float(_f32(lr) * torch.where(s < warmup, warm, cos))
    return f
