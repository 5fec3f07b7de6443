"""Checkpointing: async, atomic, restore onto any device.

The port of ``repro.checkpoint.checkpointer`` for trees of tensors (nested
dicts and lists, as the port's parameters and optimizer states; a Python
int leaf, such as an optimizer's step, is stored as an int32 scalar, as
the JAX package's state holds it).  The layout is the JAX package's, one
object per leaf:

    <prefix>/step_<N>/leaf_<i>.npy      # one leaf's raw bytes
    <prefix>/step_<N>/MANIFEST.json     # written LAST -> atomicity marker

Leaves are numbered in the JAX package's flatten order (dict keys sorted,
``optimizers.tree_leaves``), and the manifest has its ``treedef``,
``keys``, ``shapes`` and ``dtypes`` strings, so a checkpoint that either
package writes can be read by the other.  A checkpoint is valid iff its
manifest exists (readers ignore torn writes).  bfloat16 leaves move as raw
bytes through ``tensor.view(torch.uint8)`` and ``torch.frombuffer``, which
needs no numpy type for bfloat16.

The 2-minute-revocation-notice budget: ``CheckpointManager.fits_deadline``
predicts the transfer time from the store's bandwidth model, reproducing the
paper's "max model size = speed x 120 s" bound (§IV-F).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.optim.optimizers import tree_leaves, tree_unflatten

MANIFEST = "MANIFEST.json"

_DTYPES = {torch.float32: "float32", torch.float64: "float64",
           torch.float16: "float16", torch.bfloat16: "bfloat16",
           torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
           torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool"}
_BY_NAME = {v: k for k, v in _DTYPES.items()}


def _paths(tree, prefix=""):
    """(key string, leaf) in leaf order; keys as ``jax.tree_util.keystr``
    writes them (``['opt']['m'][0]``)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree) for p in _paths(t, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _treedef(tree) -> str:
    """The tree's structure as ``str`` of a JAX treedef prints it."""
    def rec(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {rec(t[k])}" for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(rec(x) for x in t) + "]"
        if isinstance(t, tuple):
            return "(" + ", ".join(rec(x) for x in t) + ("," if len(t) == 1 else "") + ")"
        return "*"
    return f"PyTreeDef({rec(tree)})"


def _host(leaf) -> torch.Tensor:
    """A leaf as a contiguous CPU copy, which later in-place updates of the
    leaf do not reach (a Python int as an int32 scalar)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).contiguous()
    if isinstance(leaf, bool) or not isinstance(leaf, int):
        raise TypeError(f"checkpoint leaf of type {type(leaf).__name__}: "
                        "tensors and int steps only")
    return torch.tensor(leaf, dtype=torch.int32)


def _raw(t: torch.Tensor) -> bytes:
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def tree_bytes(tree) -> int:
    """Bytes of the tree's leaves (an int leaf counts as an int32)."""
    return sum(t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 4
               for t in tree_leaves(tree))


def save_pytree(store, prefix: str, step: int, tree, blocking: bool = True,
                extra_meta: Optional[dict] = None):
    """Serialize a tree.  The leaves are copied to the host before a write
    thread starts.  Returns a handle with .wait() (async support)."""
    paths = _paths(tree)
    host = [_host(leaf) for _, leaf in paths]        # device -> host first
    meta = {
        "treedef": _treedef(tree),
        "n_leaves": len(host),
        "step": step,
        "shapes": [list(t.shape) for t in host],
        "dtypes": [_DTYPES[t.dtype] for t in host],
        "keys": [k for k, _ in paths],
        "extra": extra_meta or {},
    }

    def write():
        base = f"{prefix}/step_{step:08d}"
        for i, t in enumerate(host):
            store.put(f"{base}/leaf_{i:05d}.npy", _raw(t))
        store.put(f"{base}/{MANIFEST}", json.dumps(meta).encode())

    if blocking:
        write()
        return _DoneHandle()
    t = threading.Thread(target=write, daemon=True)
    t.start()
    return _ThreadHandle(t)


class _DoneHandle:
    def wait(self):
        return None

    def done(self) -> bool:
        return True


class _ThreadHandle:
    def __init__(self, t):
        self._t = t

    def wait(self):
        self._t.join()

    def done(self) -> bool:
        return not self._t.is_alive()


def steps(store, prefix: str):
    """All *valid* (manifest-present) checkpoint steps, ascending."""
    out = []
    for key in store.list(prefix + "/"):
        if key.endswith(MANIFEST):
            stepdir = key.split("/")[-2]
            out.append(int(stepdir.split("_")[1]))
    return sorted(set(out))


def latest_step(store, prefix: str) -> Optional[int]:
    s = steps(store, prefix)
    return s[-1] if s else None


def _leaf(data: bytes, dtype: str, shape, tmpl, device_fn):
    """One stored leaf in the template's type, on the template's device (or
    ``device_fn(tmpl)``); an int template gets an int back."""
    if dtype not in _BY_NAME:
        raise ValueError(f"checkpoint leaf of dtype {dtype!r} is not readable")
    t = (torch.frombuffer(bytearray(data), dtype=_BY_NAME[dtype]) if data
         else torch.empty(0, dtype=_BY_NAME[dtype])).reshape(shape)
    if not isinstance(tmpl, torch.Tensor):
        return int(t)
    if list(t.shape) != list(tmpl.shape):
        raise ValueError(f"checkpoint leaf of shape {list(t.shape)}, template "
                         f"{list(tmpl.shape)}")
    dev = device_fn(tmpl) if device_fn is not None else tmpl.device
    return t.to(device=dev, dtype=tmpl.dtype)


def restore_pytree(store, prefix: str, like, step: Optional[int] = None,
                   sharding_fn: Optional[Callable[[Any], Any]] = None):
    """Restore into the structure of ``like`` (a tree of tensors, int
    leaves allowed).  Each leaf lands on its template's device, or on
    ``sharding_fn(template)`` where one is given (the JAX package's elastic
    placement hook; one card, so it names a device).  Returns
    (tree, step)."""
    if step is None:
        step = latest_step(store, prefix)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {prefix}")
    base = f"{prefix}/step_{step:08d}"
    meta = json.loads(store.get(f"{base}/{MANIFEST}").decode())
    tmpl = tree_leaves(like)
    if meta["n_leaves"] != len(tmpl):
        raise ValueError(f"checkpoint has {meta['n_leaves']} leaves, template "
                         f"has {len(tmpl)}")
    out = [_leaf(store.get(f"{base}/leaf_{i:05d}.npy"), meta["dtypes"][i],
                 meta["shapes"][i], t, sharding_fn) for i, t in enumerate(tmpl)]
    return tree_unflatten(like, out), step


class CheckpointManager:
    """Interval + on-demand checkpointing with retention and deadline checks."""

    def __init__(self, store, prefix: str, save_interval_steps: int = 100,
                 keep_n: int = 3):
        self.store = store
        self.prefix = prefix
        self.save_interval_steps = save_interval_steps
        self.keep_n = keep_n
        self._pending = None
        self.saves = 0
        self.save_seconds = 0.0

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_interval_steps == 0

    def save(self, step: int, tree, blocking: bool = False, extra_meta=None):
        if self._pending is not None:
            self._pending.wait()  # never two in flight
        t0 = time.monotonic()
        h = save_pytree(self.store, self.prefix, step, tree,
                        blocking=blocking, extra_meta=extra_meta)
        self.save_seconds += time.monotonic() - t0
        self.saves += 1
        self._pending = h
        self._gc()
        return h

    def wait(self):
        if self._pending is not None:
            self._pending.wait()
            self._pending = None

    def fits_deadline(self, tree, deadline_s: float = 120.0) -> bool:
        """Can this tree reach the store before the revocation deadline?"""
        if hasattr(self.store, "transfer_time"):
            return self.store.transfer_time(tree_bytes(tree)) <= deadline_s
        return True

    def restore_latest(self, like, sharding_fn=None):
        return restore_pytree(self.store, self.prefix, like, sharding_fn=sharding_fn)

    def restore(self, like, step: Optional[int] = None, sharding_fn=None):
        """Restore a specific checkpoint step (None = latest): the re-deploy
        path when a revoked trial must resume from the snapshot that
        actually fit the notice deadline, not the newest one."""
        return restore_pytree(self.store, self.prefix, like, step=step,
                              sharding_fn=sharding_fn)

    def _gc(self):
        all_steps = steps(self.store, self.prefix)
        for s in all_steps[: -self.keep_n] if self.keep_n else []:
            base = f"{self.prefix}/step_{s:08d}"
            # delete manifest first so the checkpoint is atomically invalidated
            self.store.delete(f"{base}/{MANIFEST}")
            for key in list(self.store.list(base + "/")):
                self.store.delete(key)
