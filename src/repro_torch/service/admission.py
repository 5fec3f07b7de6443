"""Admission control: which studies' replicas enter the next SoA round.

Every pump of the service loop builds one ``StudyView`` per runnable study
and asks the configured policy to partition them into ``(admit, cancel)``.
Policies are pure functions of the views (no hidden state, no clocks), so
the service's interleaving — and therefore every simulated outcome — is a
deterministic function of the submitted studies.  The loop then steps the
single admitted study with the earliest simulated boundary; admission
decides *eligibility*, the global virtual clock decides *order*.

Registered policies (``repro_torch.tuner.registry.make_fairness_policy``):

* ``fifo``   — submission order, at most ``max_active`` studies admitted
* ``maxmin`` — weighted max-min over accumulated concurrent
  instance-seconds: the ``max_active`` studies with the smallest
  ``usage_s / weight`` are admitted, so lagging (or heavier-weighted)
  studies catch up and long-run shares converge to the weight ratios
* ``budget`` — per-tenant spend caps layered over an inner policy:
  studies of tenants at/over their cap (and studies over their own
  ``budget_cap``) are cancelled at admission time, the rest fall through
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

Selection = Tuple[List[str], List[str]]          # (admit ids, cancel ids)


@dataclasses.dataclass
class StudyView:
    """What a policy may see of one runnable study.  ``usage_s`` is the
    study's accumulated concurrent instance-seconds (live allocations count
    up to the study's current simulated time); ``spend`` is gross billed
    simulated dollars."""

    study_id: str
    tenant: str
    seq: int                      # submission order (ties broken on this)
    weight: float
    usage_s: float
    spend: float
    budget_cap: Optional[float]


class FifoPolicy:
    """Admit in submission order, at most ``max_active`` at a time."""

    name = "fifo"

    def __init__(self, max_active: Optional[int] = None):
        if max_active is not None and max_active < 1:
            raise ValueError(f"max_active must be >= 1, got {max_active}")
        self.max_active = max_active

    def select(self, views: Sequence[StudyView],
               tenant_spend: Dict[str, float]) -> Selection:
        order = sorted(views, key=lambda v: v.seq)
        if self.max_active is not None:
            order = order[: self.max_active]
        return [v.study_id for v in order], []


class WeightedMaxMinPolicy:
    """Admit the ``max_active`` studies with the smallest normalized usage
    ``usage_s / weight`` (ties on submission order) — weighted max-min
    fairness over concurrent instance-seconds, recomputed every round."""

    name = "maxmin"

    def __init__(self, max_active: Optional[int] = None):
        if max_active is not None and max_active < 1:
            raise ValueError(f"max_active must be >= 1, got {max_active}")
        self.max_active = max_active

    def select(self, views: Sequence[StudyView],
               tenant_spend: Dict[str, float]) -> Selection:
        order = sorted(views, key=lambda v: (v.usage_s / v.weight, v.seq))
        if self.max_active is not None:
            order = order[: self.max_active]
        return [v.study_id for v in order], []


class BudgetCapPolicy:
    """Per-tenant (and per-study) budget caps over an inner policy.

    A study is cancelled at admission when its tenant's aggregate gross
    spend has reached ``caps[tenant]``, or its own ``StudySpec.budget_cap``
    is exhausted; surviving studies are admitted by the inner policy
    (FIFO by default, ``inner="maxmin"`` for fair-share under caps)."""

    name = "budget"

    def __init__(self, caps: Optional[Dict[str, float]] = None,
                 max_active: Optional[int] = None, inner: str = "fifo"):
        self.caps = dict(caps or {})
        if inner == "fifo":
            self.inner = FifoPolicy(max_active)
        elif inner == "maxmin":
            self.inner = WeightedMaxMinPolicy(max_active)
        else:
            raise ValueError(f"unknown inner policy {inner!r} "
                             "(expected 'fifo' or 'maxmin')")

    def _exhausted(self, v: StudyView,
                   tenant_spend: Dict[str, float]) -> bool:
        cap = self.caps.get(v.tenant)
        if cap is not None and tenant_spend.get(v.tenant, 0.0) >= cap:
            return True
        return v.budget_cap is not None and v.spend >= v.budget_cap

    def select(self, views: Sequence[StudyView],
               tenant_spend: Dict[str, float]) -> Selection:
        cancel = [v.study_id for v in views
                  if self._exhausted(v, tenant_spend)]
        dead = set(cancel)
        keep = [v for v in views if v.study_id not in dead]
        admit, _ = self.inner.select(keep, tenant_spend)
        return admit, cancel


# name -> factory(params dict); the registry's service-visible catalog
FAIRNESS_POLICIES = {
    "fifo": lambda p: FifoPolicy(**p),
    "maxmin": lambda p: WeightedMaxMinPolicy(**p),
    "budget": lambda p: BudgetCapPolicy(**p),
}
