"""SpotTune in PyTorch for an NVIDIA H100 (Hopper, sm_90a).

The port of the JAX package ``repro``, slice by slice, with the same
sub-package layout and names.  It imports ``torch``, numpy and the standard
library, never ``jax`` or ``repro``.  Entry points that hold tensors
(``core.revpred``, ``core.earlycurve``, ``sweep``, ``models.model``,
``launch.serve``) run on the card unless the caller passes
``device="cpu"``; ``kernels`` holds the hand-written CUDA kernels.
``collectives`` and ``launch.{mesh,sharding,elastic}`` lay states and
decode caches out on a ``torch.distributed`` ``DeviceMesh``.
"""
