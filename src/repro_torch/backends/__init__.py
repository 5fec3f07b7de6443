"""Trial backends: the ground-truth providers behind the execution engine.

``TrialBackend`` (``repro_torch.backends.base``) is the protocol; the
simulated ``repro_torch.core.trial.SimTrialBackend`` implements it.
"""

from repro_torch.backends.base import TrialBackend  # noqa: F401

__all__ = ["TrialBackend"]
