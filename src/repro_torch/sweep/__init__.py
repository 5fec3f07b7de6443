"""Batched multi-replica scenario runtime (sweeps over market randomness).

spec     ScenarioSpec (one replica: seed x workload x policy x θ) + the
         cartesian ``scenario_grid`` builder and replica factories
runner   SweepRunner: concurrent execution with cross-replica batched
         RevPred forwards and EarlyCurve fits, plus the sequential
         naive-loop baseline; ``device`` says where its tensors live
soa      SoaSweep: the structure-of-arrays lockstep stepper, whose EWMA
         fold and boundary min run as one CUDA kernel launch on the card
result   SweepResult / Summary: per-replica records, mean ± 95% CI
         aggregation over any spec axes, JSON/CSV/markdown exports
"""

from repro_torch.sweep.result import (ReplicaResult, Summary,  # noqa: F401
                                      SweepResult, markdown_table, summarize)
from repro_torch.sweep.runner import (SweepRunner,  # noqa: F401
                                      clear_shared_caches)
from repro_torch.sweep.spec import (ScenarioSpec, build_replica,  # noqa: F401
                                    build_revpred, build_scheduler,
                                    build_searcher, resolve_policy,
                                    scenario_grid)
