"""Where the port's tensors live.

Entry points that hold tensors run on the card unless the caller asks for
the CPU; without a card they raise instead of moving to the CPU quietly.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch path on the CPU")
    return dev
