"""Study bookkeeping: ids, lifecycle status, incremental result records.

The registry is pure bookkeeping — no simulation state.  Each study's
finished replicas append one ``SweepResult``-shaped record (the same dict
``SweepResult.records()`` emits, plus the service envelope: study id,
tenant, replica index); consumers read them incrementally through
``poll(study_id, cursor)`` without ever re-reading what they have seen.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from repro_torch.service.spec import StudySpec, StudyStatus


class StudyRecord:
    """One submitted study's live state inside the service."""

    __slots__ = ("study_id", "spec", "seq", "status", "tuners", "sweep",
                 "markets", "specs", "records", "emitted", "result",
                 "submitted_wall", "first_step_wall", "done_wall")

    def __init__(self, study_id: str, spec: StudySpec, seq: int):
        self.study_id = study_id
        self.spec = spec
        self.seq = seq
        self.status = StudyStatus.QUEUED
        self.tuners = None              # set by the loop's lazy prepare
        self.sweep = None               # the study's SoaSweep
        self.markets = ()
        self.specs = tuple(spec.specs)
        self.records: List[dict] = []   # incremental per-replica results
        self.emitted: set = set()       # replica indices already recorded
        self.result = None              # SweepResult once DONE
        # wall-clock marks for the service benchmark (admission-to-decision
        # latency = first_step_wall - submitted_wall)
        self.submitted_wall = time.perf_counter()
        self.first_step_wall: Optional[float] = None
        self.done_wall: Optional[float] = None

    def next_time(self) -> float:
        """This study's earliest upcoming simulated boundary (0.0 before
        prepare: an unstarted study is due at simulated t=0)."""
        if self.sweep is None:
            return 0.0
        return self.sweep.next_time()


class StudyRegistry:
    """Id allocation + status transitions + the poll/stream read side."""

    def __init__(self):
        self._by_id: Dict[str, StudyRecord] = {}
        self._seq = 0

    def add(self, spec: StudySpec) -> StudyRecord:
        self._seq += 1
        study_id = f"study-{self._seq:04d}"
        rec = StudyRecord(study_id, spec, self._seq)
        self._by_id[study_id] = rec
        return rec

    def get(self, study_id: str) -> StudyRecord:
        try:
            return self._by_id[study_id]
        except KeyError:
            raise KeyError(f"unknown study id {study_id!r}") from None

    def all(self) -> List[StudyRecord]:
        return list(self._by_id.values())

    def runnable(self) -> List[StudyRecord]:
        """Admission candidates, in submission order."""
        return [r for r in self._by_id.values()
                if r.status in (StudyStatus.QUEUED, StudyStatus.RUNNING)]

    def unfinished(self) -> List[StudyRecord]:
        return [r for r in self._by_id.values() if not r.status.terminal]

    # ------------------------------------------------------------ reads
    def poll(self, study_id: str,
             cursor: int = 0) -> Tuple[List[dict], StudyStatus]:
        """Records appended since ``cursor`` plus the current status; the
        next cursor is ``cursor + len(records)``."""
        rec = self.get(study_id)
        return rec.records[cursor:], rec.status

    # ------------------------------------------------- status transitions
    def cancel(self, study_id: str) -> bool:
        """Cancel a non-terminal study; True if the status changed."""
        rec = self.get(study_id)
        if rec.status.terminal:
            return False
        rec.status = StudyStatus.CANCELLED
        rec.done_wall = time.perf_counter()
        return True

    def pause(self, study_id: str) -> bool:
        rec = self.get(study_id)
        if rec.status not in (StudyStatus.QUEUED, StudyStatus.RUNNING):
            return False
        rec.status = StudyStatus.PAUSED
        return True

    def resume(self, study_id: str) -> bool:
        rec = self.get(study_id)
        if rec.status is not StudyStatus.PAUSED:
            return False
        # un-prepared studies go back to the admission queue; prepared ones
        # resume stepping where they stopped
        rec.status = (StudyStatus.QUEUED if rec.sweep is None
                      else StudyStatus.RUNNING)
        return True
