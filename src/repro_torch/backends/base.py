"""TrialBackend protocol: what the execution engine requires of a trial.

Extracted from ``SimTrialBackend``'s de-facto interface so that real
training backends (``repro.backends.training``) and the synthetic
simulation (``repro_torch.core.trial``) are interchangeable behind one surface.
The engine (``repro_torch.tuner.engine``) consumes exactly four capability
groups:

  step timing     ``base_step_time`` / ``step_time`` / ``noisy_step_times``
                  — ground-truth seconds/step per instance type, plus the
                  deterministic per-tick observation jitter the perf matrix
                  (Algorithm 1 line 36) is fed with.  The jitter stream is a
                  pure function of ``(workload.seed, int(t))`` — that purity
                  is what lets the event-driven fast path replay skipped
                  ticks in one vectorized fold and stay bit-identical to
                  the legacy tick loop.
  metric stream   ``metric_at`` / ``metric_range`` / ``true_final`` — the
                  validation-metric value at each ``val_every`` grid point.
                  Must be a pure function of the trial: a revoked trial
                  that rolls back and re-runs sees the same values (the sim
                  guarantees this by construction; real training guarantees
                  it via the deterministic data pipeline + bitwise
                  checkpoint restore).
  model bytes     ``model_bytes`` / ``checkpoint_time`` — checkpoint size
                  and the snapshot/restore wall-time the engine charges.
                  The default prices ``model_bytes`` at the engine's
                  configured bandwidth; a real backend answers from its
                  object store's measured transfer model instead.
  snapshot/restore ``snapshot`` / ``restore`` — lifecycle hooks the engine
                  calls when it checkpoints (revocation notice, pause,
                  rotation, finish) and when it re-deploys a trial with
                  prior progress.  ``snapshot`` returns the step count that
                  is actually durable: the default echoes the request (the
                  sim's curves need no state), while a training backend
                  saves a real pytree — gated by the 2-minute-notice
                  deadline (``CheckpointManager.fits_deadline``), so an
                  oversized model may only be durable at an older step.

Defaults are provided wherever the behavior is derivable (jitter stream,
``metric_range`` from ``metric_at``, checkpoint time from model bytes,
no-op snapshot/restore), so a backend only implements its ground truth:
``base_step_time``, ``metric_at``, ``true_final``, ``model_bytes``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class TrialBackend:
    """Base class / protocol for trial backends.  See module docstring."""

    # ----------------------------------------------------------- step times
    def base_step_time(self, trial, inst) -> float:
        """Noise-free ground-truth seconds/step of ``trial`` on ``inst``."""
        raise NotImplementedError

    def step_time(self, trial, inst, noisy_t: Optional[float] = None) -> float:
        """Seconds/step; with ``noisy_t`` set, the jittered observation the
        perf matrix would record at simulated time ``noisy_t``.  The jitter
        draw is the shared ``SeedSequence([workload.seed, int(t)])`` stream —
        identical to ``noisy_step_times``'s per-tick entries."""
        base = self.base_step_time(trial, inst)
        if noisy_t is None:
            return base
        j = np.random.default_rng(np.random.SeedSequence(
            [trial.workload.seed, int(noisy_t)])).normal(1.0, 0.02)
        return base * max(j, 0.5)

    def noisy_step_times(self, trial, inst, k0: int, k1: int, tick_s: float,
                         base: Optional[float] = None):
        """``step_time(trial, inst, noisy_t=k*tick_s)`` for grid ticks
        ``k0..k1`` inclusive, bit-identical to the per-tick calls — the
        engine's vectorized EWMA-replay bulk read."""
        from repro_torch.core.trial import _jitter_ticks  # shared memoized stream

        if base is None:
            base = self.base_step_time(trial, inst)
        jit = _jitter_ticks(trial.workload.seed, tick_s, k1)
        if k1 - k0 < 8:
            return [base * max(j, 0.5) for j in jit[k0:k1 + 1]]
        return base * np.maximum(jit[k0:k1 + 1], 0.5)

    # --------------------------------------------------------- metric stream
    def metric_at(self, trial, step: int) -> Optional[float]:
        """Metric value at ``step`` (a ``val_every`` multiple); None when the
        trial has not reached its first metric point."""
        raise NotImplementedError

    def metric_range(self, trial, lo: int, hi: int) -> List[float]:
        """``metric_at(trial, k * val_every)`` for grid indices ``lo..hi``
        (``lo >= 1``) as one list — the engine's metric-preview bulk read."""
        ve = trial.workload.val_every
        return [self.metric_at(trial, k * ve) for k in range(lo, hi + 1)]

    def true_final(self, trial) -> float:
        """Ground-truth final metric (full-budget); ranking reference."""
        raise NotImplementedError

    # ------------------------------------------------- checkpoint accounting
    def model_bytes(self, trial) -> float:
        """Checkpoint size in bytes (full training state)."""
        return trial.workload.model_bytes

    def checkpoint_time(self, trial, bandwidth_bps: float) -> float:
        """Seconds one snapshot (or restore) transfer takes.  The default
        prices ``model_bytes`` at the engine-configured bandwidth — exactly
        the legacy engine arithmetic; backends with their own object-store
        transfer model override this."""
        return self.model_bytes(trial) / bandwidth_bps

    # ------------------------------------------------------ snapshot/restore
    def snapshot(self, trial, steps: float, deadline_s: float = 120.0) -> float:
        """Persist trial state at (the integer part of) ``steps``; called by
        the engine at every checkpoint event.  Returns the step count that
        is durable after the call — the engine rolls revoked trials back to
        this value.  The default is a no-op echo: analytic backends carry no
        state, so any step is trivially 'durable'."""
        return steps

    def restore(self, trial, steps: float) -> None:
        """Rehydrate trial state from the snapshot at ``steps``; called by
        the engine when it re-deploys a trial with prior progress (the
        elastic re-shard path).  Default: nothing to rehydrate."""
        return None
