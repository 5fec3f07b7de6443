"""Data pipeline: deterministic synthetic LM batches, DP-rank sharding,
threaded prefetch.

The port of ``repro.data.pipeline``.  Batches are numpy, drawn by the
port's ``models.inputs.sample_train_batch`` from the same seed sequence as
the JAX package, so the two packages see bit-equal batches.

Determinism contract: batch contents are a pure function of
(seed, step, dp_rank): a restarted or re-deployed trial (the SpotTune
revocation path) resumes from its checkpointed step and sees exactly the
token stream it would have seen, so checkpoint/restart replays the same
data.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.models import inputs as inputs_lib


class SyntheticLMDataset:
    """Uniform-token LM batches with next-token labels."""

    def __init__(self, cfg, batch: int, seq: int, seed: int = 0,
                 dp_rank: int = 0, dp_size: int = 1):
        if batch % dp_size:
            raise ValueError(f"batch {batch} is not a multiple of dp_size "
                             f"{dp_size}")
        self.cfg = cfg
        self.global_batch = batch
        self.batch = batch // dp_size
        self.seq = seq
        self.seed = seed
        self.dp_rank = dp_rank
        self.dp_size = dp_size

    def get_batch(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.dp_rank]))
        return inputs_lib.sample_train_batch(rng, self.cfg, self.batch, self.seq)

    def iter_from(self, step: int = 0) -> Iterator[dict]:
        while True:
            yield self.get_batch(step)
            step += 1


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """Background-thread prefetch (host-side pipeline overlap)."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        finally:
            q.put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            return
        yield item
