"""Optimizers over the port's parameter trees (nested dicts and lists of
tensors), in the JAX package's arithmetic order.

optimizers  ``Optimizer``, ``clip_by_global_norm``, ``adamw``
"""

from repro_torch.optim.optimizers import Optimizer, adamw, clip_by_global_norm  # noqa: F401
