"""Optimizers over the port's parameter trees (nested dicts and lists of
tensors), in the JAX package's arithmetic order.

optimizers   ``Optimizer``, ``clip_by_global_norm``, ``adamw``, ``sgd``
schedules    ``constant_schedule``, ``exponential_decay_schedule``,
             ``cosine_warmup_schedule``
compression  int8 + error-feedback gradient compression (``compressed``,
             ``int8_allreduce``)
"""

from repro_torch.optim.compression import compressed, int8_allreduce  # noqa: F401
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adamw,
    clip_by_global_norm,
    sgd,
)
from repro_torch.optim.schedules import (  # noqa: F401
    constant_schedule,
    cosine_warmup_schedule,
    exponential_decay_schedule,
)
