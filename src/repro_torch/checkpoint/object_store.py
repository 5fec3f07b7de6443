"""Object-store abstraction: the stand-in for S3/GCS (the port of
``repro.checkpoint.object_store``, pure Python, unchanged).

``LocalObjectStore`` is a real durable store (directory-backed, atomic
writes via tmp+rename).  ``ThrottledStore`` wraps any store with a
bandwidth/latency model so the checkpoint-overhead benchmark (paper Fig. 12
/ §IV-F) can emulate the measured S3 speeds (the paper reports 62.83 MB/s on
t2.micro .. 134.22 MB/s on m4.4xlarge — CPU-bound on their VMs; on a GPU
host the knob models its NIC/NVMe limits instead).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Iterable


class LocalObjectStore:
    """Directory-backed key/value store with atomic puts."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()
        self.bytes_written = 0
        self.bytes_read = 0

    def _path(self, key: str) -> str:
        assert ".." not in key, key
        return os.path.join(self.root, key)

    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic on POSIX
        with self._lock:
            self.bytes_written += len(data)

    def get(self, key: str) -> bytes:
        with open(self._path(key), "rb") as f:
            data = f.read()
        with self._lock:
            self.bytes_read += len(data)
        return data

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def list(self, prefix: str = "") -> Iterable[str]:
        base = self.root
        out = []
        for dirpath, _, files in os.walk(base):
            for fn in files:
                rel = os.path.relpath(os.path.join(dirpath, fn), base)
                if rel.startswith(prefix) and not fn.startswith("."):
                    out.append(rel)
        return sorted(out)


class ThrottledStore:
    """Bandwidth/latency-modelled wrapper (emulated S3 for benchmarks).

    ``simulate=True`` only *accounts* the transfer time (fast benches);
    ``simulate=False`` actually sleeps, for end-to-end overhead measurement.
    """

    def __init__(self, inner, bandwidth_bps: float = 100e6, latency_s: float = 0.02,
                 simulate: bool = True):
        self.inner = inner
        self.bandwidth_bps = bandwidth_bps
        self.latency_s = latency_s
        self.simulate = simulate
        self.simulated_time = 0.0
        self._lock = threading.Lock()

    def _charge(self, nbytes: int):
        dt = self.latency_s + nbytes / self.bandwidth_bps
        if self.simulate:
            with self._lock:
                self.simulated_time += dt
        else:
            time.sleep(dt)

    def put(self, key: str, data: bytes) -> None:
        self._charge(len(data))
        self.inner.put(key, data)

    def get(self, key: str) -> bytes:
        data = self.inner.get(key)
        self._charge(len(data))
        return data

    def exists(self, key: str) -> bool:
        return self.inner.exists(key)

    def delete(self, key: str) -> None:
        self.inner.delete(key)

    def list(self, prefix: str = ""):
        return self.inner.list(prefix)

    def transfer_time(self, nbytes: int) -> float:
        """Predicted seconds to move nbytes (the 2-minute-notice budget check)."""
        return self.latency_s + nbytes / self.bandwidth_bps
