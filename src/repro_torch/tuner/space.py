"""Typed HP domains and the SearchSpace they compose into.

The paper's tuner assumed one shape of search space everywhere: a product of
2-value dims (`Workload.hp_space` tuples), enumerated once into a 16-point
grid whose positional index doubled as trial identity.  This module makes
the space a first-class value so the same engine/policy stack covers
continuous relaxations (TrimTuner, Scavenger-style config x HP products)
with the grid as the degenerate all-finite case:

  Choice      unordered finite set (categorical) — neighbor = any other value
  Ordinal     ordered finite set — neighbor = adjacent value (the legacy
              2-value grid dims; ``SearchSpace.from_legacy`` maps them here)
  Uniform     continuous interval, linear scale
  LogUniform  continuous interval, log scale (learning rates)
  IntUniform  integer interval (decay steps, tree counts)

A ``SearchSpace`` is an ordered tuple of named domains with

  * seeded sampling (``sample``) and single-dim perturbation (``neighbor``),
  * vectorized encode/decode to a normalized ``[0, 1]^d`` feature matrix —
    the representation every numpy/jax hot path (BO posteriors, GP kernels)
    consumes,
  * process-independent config hashing (``config_hash`` / ``config_key``)
    for duplicate detection and trial identity off the grid,
  * grid enumeration (``grid``) when every domain is finite — bit-compatible
    with the legacy ``Workload.hp_grid()`` product order,
  * per-dim *anchor* values (``anchor_values``): the lattice the simulation
    backend interpolates its ground-truth curves between (finite domains
    anchor on their own values; continuous domains on their bounds).

Everything is a frozen dataclass: spaces ride inside ``Workload`` (itself
frozen/hashable) and key process-wide memo caches.  This module deliberately
imports nothing from the rest of the tuner so ``repro_torch.core.trial`` can use
it without an import cycle.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np


# ---------------------------------------------------------------------------
# domains
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Domain:
    """One hyper-parameter dimension.  Subclasses define the value set."""

    #: continuous domains admit values outside any finite lattice
    is_continuous = False

    # -- value set ---------------------------------------------------------
    def sample(self, rng: np.random.Generator):
        raise NotImplementedError

    def contains(self, value) -> bool:
        raise NotImplementedError

    # -- normalized feature space -----------------------------------------
    def encode(self, value) -> float:
        """Map a value into [0, 1] (the model-facing representation)."""
        raise NotImplementedError

    def decode(self, u: float):
        """Inverse of ``encode`` (up to rounding for discrete domains)."""
        raise NotImplementedError

    # -- structure ---------------------------------------------------------
    def anchor_values(self) -> tuple:
        """The lattice points ground-truth interpolation anchors on."""
        raise NotImplementedError

    def neighbor_values(self, value) -> list:
        """Finite domains: adjacent-move candidates, preferred first.
        Continuous domains return [] (use ``neighbor``)."""
        return []

    def neighbor(self, value, rng: np.random.Generator):
        """A perturbed value near ``value`` (PBT explore's one-dim move)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Choice(Domain):
    """Unordered finite set.  ``encode`` uses the declared position (the
    model sees *some* embedding; for true categoricals with >2 values a
    one-hot would be better, but every paper workload is binary)."""

    values: tuple

    def __post_init__(self):
        object.__setattr__(self, "values", tuple(self.values))
        assert len(self.values) >= 1

    def sample(self, rng):
        return self.values[int(rng.integers(len(self.values)))]

    def contains(self, value):
        return value in self.values

    def encode(self, value):
        return self.values.index(value) / max(len(self.values) - 1, 1)

    def decode(self, u):
        i = int(round(float(u) * max(len(self.values) - 1, 1)))
        return self.values[min(max(i, 0), len(self.values) - 1)]

    def anchor_values(self):
        return self.values

    def neighbor_values(self, value):
        return [v for v in self.values if v != value]

    def neighbor(self, value, rng):
        others = [v for v in self.values if v != value]
        if not others:
            return value
        return others[int(rng.integers(len(others)))]


@dataclasses.dataclass(frozen=True)
class Ordinal(Choice):
    """Ordered finite set: neighbors are adjacent values.  The legacy grid
    dims map here, so PBT's perturb-to-adjacent-grid-value is literally
    ``Ordinal.neighbor``."""

    def neighbor_values(self, value):
        j = self.values.index(value)
        return [self.values[nj] for nj in (j + 1, j - 1)
                if 0 <= nj < len(self.values)]

    def neighbor(self, value, rng):
        cands = self.neighbor_values(value)
        if not cands:
            return value
        return cands[int(rng.integers(len(cands)))]


@dataclasses.dataclass(frozen=True)
class Uniform(Domain):
    """Continuous interval on a linear scale.

    ``anchors`` optionally overrides the ground-truth anchor lattice (and
    its order): ``continuous_variant`` relaxes a legacy 2-value dim into
    ``Uniform(min, max, anchors=<values in declared order>)`` so the
    anchor product indices — and with them the simulated anchor curves —
    stay exactly the base workload's grid.  Empty = (lo, hi)."""

    lo: float
    hi: float
    #: neighbor() perturbation scale, as a fraction of the encoded range
    perturb: float = 0.2
    anchors: tuple = ()

    is_continuous = True

    def __post_init__(self):
        assert self.hi > self.lo
        assert all(self.contains(a) for a in self.anchors)

    def sample(self, rng):
        return float(rng.uniform(self.lo, self.hi))

    def contains(self, value):
        return self.lo <= value <= self.hi

    def encode(self, value):
        return (float(value) - self.lo) / (self.hi - self.lo)

    def decode(self, u):
        v = self.lo + (self.hi - self.lo) * min(max(float(u), 0.0), 1.0)
        return float(min(max(v, self.lo), self.hi))   # FP overshoot clamp

    def anchor_values(self):
        return self.anchors or (self.lo, self.hi)

    def neighbor(self, value, rng):
        u = self.encode(value) + self.perturb * float(rng.normal())
        return self.decode(u)


@dataclasses.dataclass(frozen=True)
class LogUniform(Uniform):
    """Continuous interval sampled/encoded on a log scale (learning rates:
    uniform in log-space, so 1e-3..1e-1 doesn't collapse onto the top)."""

    def __post_init__(self):
        assert 0 < self.lo < self.hi
        assert all(self.contains(a) for a in self.anchors)

    def sample(self, rng):
        v = math.exp(rng.uniform(math.log(self.lo), math.log(self.hi)))
        return float(min(max(v, self.lo), self.hi))

    def encode(self, value):
        return ((math.log(float(value)) - math.log(self.lo))
                / (math.log(self.hi) - math.log(self.lo)))

    def decode(self, u):
        u = min(max(float(u), 0.0), 1.0)
        v = math.exp(math.log(self.lo)
                     + u * (math.log(self.hi) - math.log(self.lo)))
        return float(min(max(v, self.lo), self.hi))   # FP overshoot clamp


@dataclasses.dataclass(frozen=True)
class IntUniform(Uniform):
    """Integer interval; encode/decode round-trip through the int lattice."""

    def __post_init__(self):
        assert self.hi > self.lo
        assert float(self.lo).is_integer() and float(self.hi).is_integer()
        assert all(self.contains(a) for a in self.anchors)

    def sample(self, rng):
        return int(rng.integers(int(self.lo), int(self.hi) + 1))

    def contains(self, value):
        return (self.lo <= value <= self.hi
                and float(value).is_integer())

    def decode(self, u):
        v = self.lo + (self.hi - self.lo) * min(max(float(u), 0.0), 1.0)
        return int(min(max(round(v), self.lo), self.hi))

    def anchor_values(self):
        return self.anchors or (int(self.lo), int(self.hi))

    def neighbor(self, value, rng):
        v = self.decode(self.encode(value) + self.perturb * float(rng.normal()))
        if v == value:             # a too-small move must still *move*
            v = value + (1 if value < self.hi else -1)
        return int(v)


#: what ``SearchSpace.from_legacy`` accepts per dim: an explicit Domain or
#: the legacy tuple-of-values shorthand (mapped to Ordinal)
DomainLike = Union[Domain, Sequence]


def as_domain(values: DomainLike) -> Domain:
    return values if isinstance(values, Domain) else Ordinal(tuple(values))


# ---------------------------------------------------------------------------
# config hashing
# ---------------------------------------------------------------------------


def _canon(value) -> str:
    """Canonical, process-independent text form of one HP value."""
    if isinstance(value, bool):
        return f"b:{value}"
    if isinstance(value, (int, np.integer)):
        return f"i:{int(value)}"
    if isinstance(value, (float, np.floating)):
        f = float(value)
        return _canon(int(f)) if f.is_integer() else f"f:{f.hex()}"
    return f"s:{value}"


def config_hash(hp: Dict[str, object]) -> int:
    """64-bit stable hash of a config dict (key-order independent)."""
    blob = "|".join(f"{k}={_canon(v)}"
                    for k, v in sorted(hp.items())).encode()
    return int.from_bytes(hashlib.blake2b(blob, digest_size=8).digest(),
                          "big")


# ---------------------------------------------------------------------------
# the space
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """Ordered, named product of domains.

    ``dims`` is a tuple of ``(name, Domain)`` pairs; declaration order is
    the feature-column order and, for finite spaces, the grid enumeration
    order (itertools.product over per-dim values — byte-compatible with the
    legacy ``Workload.hp_grid()``)."""

    dims: Tuple[Tuple[str, Domain], ...]

    def __post_init__(self):
        object.__setattr__(self, "dims",
                           tuple((k, as_domain(d)) for k, d in self.dims))
        names = [k for k, _ in self.dims]
        assert len(set(names)) == len(names), f"duplicate dim names: {names}"

    @classmethod
    def from_legacy(cls, hp_space: Iterable) -> "SearchSpace":
        """Legacy ``Workload.hp_space`` (``(key, (values...))`` tuples,
        Domains allowed in the value slot) -> SearchSpace."""
        return cls(tuple((k, as_domain(v)) for k, v in hp_space))

    # -------------------------------------------------------------- shape
    @property
    def names(self) -> List[str]:
        return [k for k, _ in self.dims]

    def __len__(self) -> int:
        return len(self.dims)

    @property
    def is_finite(self) -> bool:
        return not any(d.is_continuous for _, d in self.dims)

    def domain(self, name: str) -> Domain:
        for k, d in self.dims:
            if k == name:
                return d
        raise KeyError(name)

    # --------------------------------------------------------- enumeration
    def grid(self) -> List[dict]:
        """Every config of a finite space, legacy product order."""
        if not self.is_finite:
            cont = [k for k, d in self.dims if d.is_continuous]
            raise ValueError(f"space has continuous dims {cont}; "
                             "grid() needs an all-finite space")
        keys = self.names
        vals = [d.values for _, d in self.dims]
        return [dict(zip(keys, combo)) for combo in itertools.product(*vals)]

    def grid_size(self) -> Optional[int]:
        if not self.is_finite:
            return None
        n = 1
        for _, d in self.dims:
            n *= len(d.values)
        return n

    def anchor_grid(self) -> List[dict]:
        """Corner configs of the anchor lattice, product order.  Equals
        ``grid()`` for finite spaces; continuous dims anchor on (lo, hi)."""
        keys = self.names
        vals = [d.anchor_values() for _, d in self.dims]
        return [dict(zip(keys, combo)) for combo in itertools.product(*vals)]

    def grid_index(self, hp: dict) -> Optional[int]:
        """Anchor-lattice product index of an on-lattice config, else None."""
        idx = 0
        for k, d in self.dims:
            anchors = d.anchor_values()
            try:
                j = anchors.index(hp[k])
            except ValueError:
                return None
            idx = idx * len(anchors) + j
        return idx

    # ------------------------------------------------------------ sampling
    def sample(self, rng: Union[int, np.random.Generator],
               n: Optional[int] = None) -> Union[dict, List[dict]]:
        """``n`` seeded configs (one per call order: dims in declared order,
        configs consecutively — batch == loop).  ``n=None`` -> one config."""
        if not isinstance(rng, np.random.Generator):
            rng = np.random.default_rng(rng)
        single = n is None
        out = [{k: d.sample(rng) for k, d in self.dims}
               for _ in range(1 if single else n)]
        return out[0] if single else out

    #: consecutive duplicate draws ``sample_distinct`` tolerates before
    #: concluding a continuous-typed space is effectively exhausted (a pure
    #: ``IntUniform(0, 1)`` product holds only a handful of configs)
    MAX_DUP_MISSES = 64

    def sample_distinct(self, rng: Union[int, np.random.Generator],
                        n: int, seen: Optional[set] = None,
                        max_misses: Optional[int] = None) -> List[dict]:
        """Up to ``n`` configs with pairwise-distinct config hashes, also
        distinct from ``seen`` (mutated in place with the accepted hashes
        when supplied).  Gives up — returning fewer configs — after
        ``max_misses`` consecutive duplicate draws, so tiny
        continuous-typed spaces terminate instead of spinning.  Identical
        draw stream to ``sample`` while no duplicates occur."""
        if not isinstance(rng, np.random.Generator):
            rng = np.random.default_rng(rng)
        if max_misses is None:
            max_misses = self.MAX_DUP_MISSES
        seen = set() if seen is None else seen
        out: List[dict] = []
        misses = 0
        while len(out) < n and misses < max_misses:
            hp = self.sample(rng)
            h = self.config_hash(hp)
            if h in seen:
                misses += 1
                continue
            misses = 0
            seen.add(h)
            out.append(hp)
        return out

    def neighbor(self, hp: dict, rng: np.random.Generator) -> dict:
        """Perturb one seeded-random dim to a nearby value (PBT explore)."""
        k, d = self.dims[int(rng.integers(len(self.dims)))]
        out = dict(hp)
        out[k] = d.neighbor(hp[k], rng)
        return out

    # ----------------------------------------------------- feature matrix
    def encode_one(self, hp: dict) -> np.ndarray:
        return np.array([d.encode(hp[k]) for k, d in self.dims], np.float64)

    def encode(self, configs: Sequence[dict]) -> np.ndarray:
        """(n, d) normalized feature matrix — the numpy/jax hot-path view."""
        if not len(configs):
            return np.zeros((0, len(self.dims)), np.float64)
        return np.stack([self.encode_one(hp) for hp in configs])

    def decode_one(self, u: np.ndarray) -> dict:
        return {k: d.decode(u[i]) for i, (k, d) in enumerate(self.dims)}

    def decode(self, U: np.ndarray) -> List[dict]:
        U = np.atleast_2d(np.asarray(U, np.float64))
        assert U.shape[1] == len(self.dims)
        return [self.decode_one(row) for row in U]

    # ------------------------------------------------------------ identity
    def config_hash(self, hp: dict) -> int:
        return config_hash({k: hp[k] for k, _ in self.dims})

    def config_key(self, hp: dict) -> str:
        """Short stable identity fragment for trial keys off the grid."""
        return f"{self.config_hash(hp):016x}"[:12]
