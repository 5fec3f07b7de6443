"""Sweep aggregation: per-replica results -> mean/CI summaries and exports.

``SweepResult`` pairs every ``ScenarioSpec`` with its ``RunResult`` and
aggregates any metric over any grouping of spec axes into mean, sample
standard deviation, and a 95% confidence interval (Student t for small n).
``to_json`` / ``to_csv`` persist the per-replica records; ``markdown_table``
renders the mean ± CI rows EXPERIMENTS.md is built from.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.sweep.spec import ScenarioSpec
from repro_torch.tuner.tuner import RunResult

# two-sided 97.5% Student-t quantiles by degrees of freedom (normal beyond)
_T975 = {1: 12.706, 2: 4.303, 3: 3.182, 4: 2.776, 5: 2.571, 6: 2.447,
         7: 2.365, 8: 2.306, 9: 2.262, 10: 2.228, 11: 2.201, 12: 2.179,
         13: 2.160, 14: 2.145, 15: 2.131, 16: 2.120, 17: 2.110, 18: 2.101,
         19: 2.093, 20: 2.086, 21: 2.080, 22: 2.074, 23: 2.069, 24: 2.064,
         25: 2.060, 26: 2.056, 27: 2.052, 28: 2.048, 29: 2.045, 30: 2.042}


def t975(df: int) -> float:
    return _T975.get(df, 1.96) if df >= 1 else float("inf")


@dataclasses.dataclass(frozen=True)
class Summary:
    """Mean with a 95% CI half-width over n replicas."""

    n: int
    mean: float
    std: float          # sample std (ddof=1); 0 for n=1
    ci95: float         # t-based half-width; 0 for n=1

    @property
    def lo(self) -> float:
        return self.mean - self.ci95

    @property
    def hi(self) -> float:
        return self.mean + self.ci95

    def fmt(self, prec: int = 3) -> str:
        if self.n <= 1:
            return f"{self.mean:.{prec}f}"
        return f"{self.mean:.{prec}f} ± {self.ci95:.{prec}f}"


def summarize(values: Sequence[float]) -> Summary:
    vals = [float(v) for v in values]
    n = len(vals)
    if n == 0:
        return Summary(0, math.nan, math.nan, math.nan)
    mean = sum(vals) / n
    if n == 1:
        return Summary(1, mean, 0.0, 0.0)
    var = sum((v - mean) ** 2 for v in vals) / (n - 1)
    std = math.sqrt(var)
    return Summary(n, mean, std, t975(n - 1) * std / math.sqrt(n))


@dataclasses.dataclass
class ReplicaResult:
    spec: ScenarioSpec
    result: RunResult
    # {trial_key: (metrics_steps, metrics_vals)} — the full per-trial metric
    # histories, kept so sweep determinism is checkable end to end
    metrics: Optional[Dict[str, tuple]] = None


MetricFn = Union[str, Callable[[RunResult], float]]


def _metric_fn(metric: MetricFn) -> Callable[[RunResult], float]:
    if callable(metric):
        return metric
    if metric == "pcr":
        return lambda r: r.pcr()
    return lambda r, attr=metric: float(getattr(r, attr))


class SweepResult:
    """All replicas of one sweep + aggregation/export helpers."""

    def __init__(self, replicas: List[ReplicaResult], wall_s: float = 0.0,
                 mode: str = "batched"):
        self.replicas = replicas
        self.wall_s = wall_s
        self.mode = mode

    def __len__(self) -> int:
        return len(self.replicas)

    @property
    def replicas_per_sec(self) -> float:
        return len(self.replicas) / max(self.wall_s, 1e-9)

    def values(self, metric: MetricFn,
               where: Optional[Callable[[ScenarioSpec], bool]] = None
               ) -> List[float]:
        fn = _metric_fn(metric)
        return [fn(r.result) for r in self.replicas
                if where is None or where(r.spec)]

    def summarize(self, metric: MetricFn,
                  by: Sequence[str] = (),
                  where: Optional[Callable[[ScenarioSpec], bool]] = None
                  ) -> Dict[Tuple, Summary]:
        """Group replicas by spec fields and summarize ``metric`` per group.

        ``by=()`` puts everything in one group keyed ``()``."""
        fn = _metric_fn(metric)
        groups: Dict[Tuple, List[float]] = {}
        for r in self.replicas:
            if where is not None and not where(r.spec):
                continue
            key = tuple(getattr(r.spec, f) for f in by)
            groups.setdefault(key, []).append(fn(r.result))
        return {k: summarize(v) for k, v in groups.items()}

    # ------------------------------------------------------------- exports
    def records(self, metrics: Sequence[MetricFn] = (
            "cost", "refunded", "jct", "free_frac", "top1_correct",
            "top3_contains_best", "pcr")) -> List[dict]:
        out = []
        for r in self.replicas:
            rec = dict(r.spec.asdict())
            for m in metrics:
                name = m if isinstance(m, str) else m.__name__
                rec[name] = _metric_fn(m)(r.result)
            out.append(rec)
        return out

    def to_json(self, path: str, **meta) -> None:
        with open(path, "w") as fh:
            json.dump({"mode": self.mode, "wall_s": round(self.wall_s, 3),
                       "replicas_per_sec": round(self.replicas_per_sec, 2),
                       **meta, "replicas": self.records()}, fh, indent=1)

    def to_csv(self, path: str) -> None:
        recs = self.records()
        if not recs:
            return
        with open(path, "w", newline="") as fh:
            writer = csv.DictWriter(fh, fieldnames=list(recs[0]))
            writer.writeheader()
            writer.writerows(recs)


def markdown_table(header: Sequence[str], rows: Sequence[Sequence[str]]) -> str:
    lines = ["| " + " | ".join(header) + " |",
             "|" + "|".join("---" for _ in header) + "|"]
    for row in rows:
        lines.append("| " + " | ".join(str(c) for c in row) + " |")
    return "\n".join(lines)
