"""Regenerate the recorded train-step costs of the training backend.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/record_step_cost.py

Counts, with the JAX package, one train step of each seed binding of
``repro.backends.training`` at both batch sizes of its workload's HP grid
(``_step_cost``: XLA compiles the step and ``launch/hlo_cost.py`` walks its
HLO) and prints ``RECORDED_STEP_COST`` as it stands in
``src/repro_torch/backends/training.py``: (arch, reduced, bs, seq) ->
(flops, hbm_bytes, grad_bytes).  ``tests/test_torch_training_backend.py``
holds the port's table equal to this count.
"""

from __future__ import annotations


def main() -> None:
    from repro.backends.training import (TRAINING_BINDINGS, TRAINING_WORKLOADS,
                                         _step_cost)

    print("RECORDED_STEP_COST: Dict[tuple, tuple] = {")
    for arch, w in TRAINING_WORKLOADS.items():
        binding = TRAINING_BINDINGS[w.name]
        for bs in dict(w.hp_space)["bs"]:
            key = (binding.arch, binding.reduced, bs, binding.seq)
            print(f"    {key!r}: {_step_cost(binding, bs)!r},")
    print("}")


if __name__ == "__main__":
    main()
