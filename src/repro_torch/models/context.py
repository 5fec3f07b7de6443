"""ModelCtx: the lowering flags threaded through the models.

The port's counterpart of ``repro.models.context`` without a mesh: one card,
so ``constrain`` is the identity.  ``kernels`` is the port's own field:
``"ref"`` sends every ``kops`` call on the model path to its plain PyTorch
version (the model-level form of ``ops``'s ``force``; tests and
``chip_smoke.py`` set it to hold the kernels against their plain versions),
``None`` lets the device decide.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class ModelCtx:
    # kept for the JAX package's constructor; the port's full-sequence
    # attention runs the flash kernel at every length, so they select nothing
    use_chunked_attn: bool = True
    attn_chunk: int = 1024
    decode_attn: str = "local"     # the port has only "local"
    kernels: Optional[str] = None  # None (by device) | "ref" | "cuda"

    def constrain(self, x, role: str):
        return x


def null_ctx(**kw) -> ModelCtx:
    return ModelCtx(**kw)
