"""Trial backends: the ground-truth providers behind the execution engine.

``TrialBackend`` (``repro_torch.backends.base``) is the protocol; the
registry names two implementations:

  sim        ``repro_torch.core.trial.SimTrialBackend`` — synthetic
             anchor-lattice curves and a hand-modelled step-time table.
             Dependency-light, bit-exact, the default everywhere.
  training   real training runs of small seed configs; not ported yet
             (ROADMAP A11): ``make_backend("training")`` raises.

``BACKENDS`` is the machine-readable registry (consumed by
``repro_torch.tuner.registry.describe_json`` and ``ScenarioSpec.validate``);
``make_backend`` constructs by name.
"""

from __future__ import annotations

from repro_torch.backends.base import TrialBackend

#: name -> metadata for every registered backend.  ``spaces`` lists the
#: ScenarioSpec ``space`` values the backend can ground-truth; ``workloads``
#: (training only) the seed configs it binds HPs onto.
BACKENDS = {
    "sim": {
        "class": "SimTrialBackend",
        "module": "repro_torch.core.trial",
        "spaces": ["grid", "continuous"],
        "workloads": None,          # any Table-II workload (and variants)
        "default": True,
    },
    "training": {
        "class": "TrainingTrialBackend",
        "module": "repro_torch.backends.training",
        "spaces": ["grid"],
        "workloads": ["qwen1.5-0.5b", "mamba2-130m", "whisper-base"],
        "default": False,
    },
}


def make_backend(name: str, pool=None, **kw):
    """Construct a backend by registry name."""
    if name == "sim":
        from repro_torch.core.market import DEFAULT_POOL
        from repro_torch.core.trial import SimTrialBackend
        return SimTrialBackend(list(pool or DEFAULT_POOL), **kw)
    if name == "training":
        raise NotImplementedError(
            "the training backend is not ported yet (ROADMAP A11): the port "
            "runs simulated trials only")
    raise ValueError(f"unknown backend {name!r} "
                     f"(registered: {sorted(BACKENDS)})")


__all__ = ["TrialBackend", "BACKENDS", "make_backend"]
