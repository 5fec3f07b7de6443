"""The check every wrapper of a kernel without a backward makes before it
launches: such a kernel's output has no ``grad_fn``, so a gradient through
it would be lost without a word."""

from __future__ import annotations

import torch


def check_no_grad(name: str, *tensors) -> None:
    """Raise RuntimeError where autograd would need the gradient of a
    kernel that has none: grad mode is on and an input requires grad."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward yet (ROADMAP A10); call it "
            "under torch.no_grad() or torch.inference_mode(), or on tensors "
            "that do not require grad")
