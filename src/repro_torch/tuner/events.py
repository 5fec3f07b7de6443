"""Typed trial lifecycle events emitted by the execution engine.

The engine (``repro_torch.tuner.engine.ExecutionEngine``) owns the transient-resource
mechanics — market, provisioning, checkpoint/restore, refunds — and narrates
everything that happens to a trial as a stream of these events.  A
``Scheduler`` consumes the stream and answers with ``Decision``s
(``repro_torch.tuner.scheduler``); it never touches the market directly.

Every event carries the simulation time ``t`` (seconds) and the ``trial`` key
(``TrialSpec.key``).  Event-specific payloads:

  TrialStarted      a deployment succeeded: instance name, the bid (max price)
                    and the provisioner's revocation-probability estimate
  MetricReported    a validation-metric point was crossed (step, value).  The
                    engine appends ALL points crossed in one tick's advance to
                    the trial's history before dispatching any of them, so a
                    handler for step k sees a ``view.metrics_vals`` that may
                    already include later points from the same tick — decide
                    on the view's full history, not on "history up to k".
                    With a scheduler that implements ``preview_metrics``,
                    points it previewed as inert are appended to the history
                    *silently* (no event) — only the first actionable point
                    and its same-tick companions dispatch.  Schedulers must
                    therefore not rely on seeing every crossing; the history
                    on the view is always complete.
  RevocationNotice  the market delivered the advance notice; the engine has
                    already checkpointed (the paper's l.24-26 reaction)
  TrialRevoked      the revocation fired; the trial rolled back to its
                    checkpoint (``lost_steps`` of work discarded) and was
                    requeued.  A ``PAUSE`` decision parks it instead —
                    ASHA uses this: the forced checkpoint is a free rung
                    boundary.
  HourRotation      the engine voluntarily rotated the trial off its
                    allocation at the 1-hour billing boundary
  TrialFinished     the trial reached its target steps (or a ``STOP``
                    decision); it has checkpointed and released its allocation
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TrialEvent:
    """Base: simulation time + trial key."""

    t: float
    trial: str


@dataclasses.dataclass(frozen=True)
class TrialStarted(TrialEvent):
    inst: str
    max_price: float
    p_revoke: float


@dataclasses.dataclass(frozen=True)
class MetricReported(TrialEvent):
    step: int
    value: float


@dataclasses.dataclass(frozen=True)
class RevocationNotice(TrialEvent):
    t_revoke: float


@dataclasses.dataclass(frozen=True)
class TrialRevoked(TrialEvent):
    lost_steps: float
    ckpt_steps: float


@dataclasses.dataclass(frozen=True)
class HourRotation(TrialEvent):
    held_s: float


@dataclasses.dataclass(frozen=True)
class TrialFinished(TrialEvent):
    steps: float
    stopped: bool
