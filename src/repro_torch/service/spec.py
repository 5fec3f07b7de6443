"""Study-level submission specs for the multi-tenant tuning service.

A ``StudySpec`` is what a tenant submits: a named batch of ``ScenarioSpec``
replicas plus the service-level knobs (fair-share weight, budget cap).
Validation aggregates *every* problem across the batch into one error —
a rejected submission names all its invalid fields, not the first hit
(``ScenarioSpec.validation_errors`` provides the per-replica lists).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple

from repro_torch.sweep.spec import ScenarioSpec


class StudyStatus(enum.Enum):
    QUEUED = "queued"        # submitted, not yet admitted to a round
    RUNNING = "running"      # replicas prepared, stepping through rounds
    PAUSED = "paused"        # excluded from admission until resume()
    CANCELLED = "cancelled"  # terminal: user cancel or budget exhaustion
    DONE = "done"            # terminal: every replica finished

    @property
    def terminal(self) -> bool:
        return self in (StudyStatus.CANCELLED, StudyStatus.DONE)


@dataclasses.dataclass(frozen=True)
class StudySpec:
    """One tenant's submission: a batch of scenario replicas + service knobs."""

    tenant: str
    specs: Tuple[ScenarioSpec, ...]
    # weighted max-min fair share: a weight-2 study is entitled to twice the
    # concurrent instance-seconds of a weight-1 study under contention
    weight: float = 1.0
    # terminal spend ceiling in simulated dollars (billed - refunded is NOT
    # used: caps gate gross spend, matching a cloud budget alarm); None = no
    # cap.  Exhaustion cancels the study, it never un-admits a running round
    budget_cap: Optional[float] = None
    tag: str = ""                        # free-form grouping label

    def __post_init__(self):
        object.__setattr__(self, "specs", tuple(self.specs))

    def validation_errors(self) -> List[str]:
        """All invalid fields across the whole batch; empty when valid."""
        errs: List[str] = []
        if not self.tenant:
            errs.append("tenant must be a non-empty string")
        if not self.specs:
            errs.append("specs must contain at least one ScenarioSpec")
        if not self.weight > 0:
            errs.append(f"weight must be positive, got {self.weight!r}")
        if self.budget_cap is not None and not self.budget_cap > 0:
            errs.append("budget_cap must be positive (or None), "
                        f"got {self.budget_cap!r}")
        for i, spec in enumerate(self.specs):
            for e in spec.validation_errors():
                errs.append(f"specs[{i}]: {e}")
        return errs

    def validate(self) -> None:
        errs = self.validation_errors()
        if errs:
            raise ValueError(
                f"invalid StudySpec ({len(errs)} problem"
                f"{'s' if len(errs) > 1 else ''}): " + "; ".join(errs))
