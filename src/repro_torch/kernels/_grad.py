"""The checks every raw kernel wrapper makes before it launches: a raw
wrapper's output has no ``grad_fn``, so a gradient through it would be lost
without a word; and a tensor given to a kernel lies on the card or is
traced (``traced``)."""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor


def traced(t) -> bool:
    """A tensor that has a shape and no storage: a fake tensor of a traced
    program (the dry run) or a ``meta`` tensor.  The kernels' operators
    give such tensors their outputs' shapes and launch nothing."""
    return t.is_meta or isinstance(t, FakeTensor)


def needs_grad(*tensors) -> bool:
    """Grad mode is on and one of the tensors requires grad."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def check_no_grad(name: str, *tensors, route: str | None = None) -> None:
    """Raise RuntimeError where autograd would need the gradient of a raw
    wrapper's output: grad mode is on and an input requires grad.  The
    message names ``route``, the call that trains through the kernel,
    where there is one, else says that the kernel has no backward yet."""
    if needs_grad(*tensors):
        why = (f"the raw wrapper has no gradient; train through {route}"
               if route else "the kernel has no backward yet (ROADMAP A10)")
        raise RuntimeError(
            f"{name}: {why}; call it under torch.no_grad() or "
            "torch.inference_mode(), or on tensors that do not require grad")
