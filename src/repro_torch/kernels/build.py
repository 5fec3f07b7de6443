"""Build the hand-written CUDA kernels at first use.

Every ``csrc/*.cu`` compiles with ``nvcc`` into a shared library with a plain
C interface, loaded with ``ctypes``.  The libraries go to ``build/kernels/``
at the root of the checkout, named by a hash of all the sources and the
compiler flags, so an edited source rebuilds and an unchanged one is loaded
as it is.  All sources compile at once, one ``nvcc`` process each.  Nothing
is fetched: the sources, the CUDA toolkit and its headers are all it needs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: what the last build printed (``-Xptxas -v``: registers, spills) and took
BUILD_LOG: Dict[str, str] = {}
BUILD_SECONDS: Dict[str, float] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build")
    return nvcc


def _sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` not yet built; -> {stem: library path}."""
    tag = _sources_hash()
    out_dir = BUILD_DIR / tag
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {src.stem: out_dir / f"lib{src.stem}.so"
            for src in sorted(CSRC.glob("*.cu"))}
    todo = {stem: path for stem, path in libs.items() if not path.exists()}
    if not todo:
        return libs
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for stem, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    failed = []
    for stem, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[stem] = log
        BUILD_SECONDS[stem] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{stem}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return libs


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built if needed)."""
    with _LOCK:
        lib = _LIBS.get(stem)
        if lib is None:
            path = build_all().get(stem)
            if path is None:
                raise FileNotFoundError(f"no kernel source csrc/{stem}.cu")
            lib = _LIBS[stem] = ctypes.CDLL(str(path))
        return lib
