"""ModelCtx: the lowering flags threaded through the models.

The port's counterpart of ``repro.models.context`` without a mesh: one card,
so ``constrain`` is the identity.  ``remat`` is the JAX package's: ``"full"``
recomputes each layer body in the backward (``torch.utils.checkpoint``,
where the JAX package applies ``jax.checkpoint`` to its scan body),
``"none"`` keeps the activations.  ``kernels`` is the port's own field:
``"ref"`` sends every ``kops`` call on the model path to its plain PyTorch
version (the model-level form of ``ops``'s ``force``; tests and
``chip_smoke.py`` set it to hold the kernels against their plain versions),
``None`` lets the device decide.  ``rules`` is the JAX package's dict of
sharding rules and switches; with no mesh the port reads one key of it,
``"mla_materialized"`` (``models.mla.mla_train``'s form).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

REMAT = ("none", "full")


@dataclasses.dataclass
class ModelCtx:
    use_chunked_attn: bool = True  # kept for the JAX package's constructor
    # key chunk of the flash backward (the JAX package's flash chunk); the
    # forward runs the flash kernel at every length whatever its value
    attn_chunk: int = 1024
    remat: str = "full"            # none | full (checkpoint each layer body)
    decode_attn: str = "local"     # the port has only "local"
    kernels: Optional[str] = None  # None (by device) | "ref" | "cuda"
    rules: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.remat not in REMAT:
            raise ValueError(f"remat={self.remat!r}: one of {REMAT}")

    def constrain(self, x, role: str):
        return x


def null_ctx(**kw) -> ModelCtx:
    return ModelCtx(**kw)
