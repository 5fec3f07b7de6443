"""The per-device cost of a traced program (the port's counterpart of
``repro.launch.hlo_cost``).

The JAX package walks the compiled SPMD module's HLO.  The port has no
HLO: ``CostCounter`` is a ``TorchDispatchMode`` that sees every operator
one rank runs and counts, as ``hlo_cost.module_cost`` does:

  * flops: every matrix product (``mm``, ``addmm``, ``bmm``,
    ``baddbmm``) at 2 |out| |contraction| (``hlo_cost._dot_flops``), and
    each hand-written kernel's operator at its own count
    (``flash_attention_cuda.flash_cost`` and ``flash_bwd_cost``,
    ``mla_attention_cuda.mla_cost`` and ``mla_bwd_cost``,
    ``ssd_chunk_cuda.ssd_chunk_cost`` and ``ssd_chunk_bwd_cost``);
  * bytes: operands + result of each operator that materializes one (views,
    factories of uninitialized storage and waits move none); a kernel's
    operator is one operator, as the HLO walk counts a fusion at its call
    site;
  * collectives by kind ("all-reduce", "all-gather", "reduce-scatter",
    "all-to-all"): the count, the result bytes and the ring-model link
    bytes of ``repro.launch.dryrun.parse_collectives`` at the process
    group's size, both DTensor's collectives and the port's own
    (``collectives.py``'s shard_map bodies);
  * transcendentals: one per ``exp``, ``tanh``, ``log``, ``rsqrt``,
    ``pow`` operator, as the HLO walk counts instructions.

Every count is of one rank's local shapes.  An operator on ``DTensor``s is
not counted itself: the counter lets DTensor run it (it returns
``NotImplemented`` to the dispatcher) and counts the local operators and
collectives DTensor runs for it.  DTensor's own shape propagation, which
runs each operator once at its global shape on fake tensors, is left out.
Loops are the port's Python loops, so each iteration is counted as it runs
(the HLO walk multiplies a while body by its trip count).

With ``memory=True`` the counter also keeps the live bytes of every
storage it sees made (and of those handed to ``track``), each rounded up
to the CUDA caching allocator's 512-byte blocks (a ``meta`` tensor has
no storage on the device and counts nothing; ``wait_tensor``, which
returns its input on a device where the fake kernel makes a copy, counts
as its input's storage), and their peak: the per-device peak of
``torch.cuda.max_memory_allocated`` that the traced program would reach,
with no allocation made.  With ``attribute=True``
it also remembers, for each storage, the operator that made it, its shape
and dtype and the innermost line of the port that called it, and
``live_at_peak()`` lists the storages alive at the peak by those.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import sys
import weakref

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels.flash_attention_cuda import flash_bwd_cost, flash_cost
from repro_torch.kernels.mla_attention_cuda import mla_bwd_cost, mla_cost
from repro_torch.kernels.ssd_chunk_cuda import ssd_chunk_bwd_cost, ssd_chunk_cost

aten = torch.ops.aten

_MATMULS = {aten.mm: 0, aten.addmm: 1, aten.bmm: 0, aten.baddbmm: 1}
_TRANSCENDENTAL = {aten.exp, aten.exp_, aten.tanh, aten.tanh_, aten.log,
                   aten.log_, aten.rsqrt, aten.rsqrt_, aten.pow, aten.pow_}
_NO_BYTES = {aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
             aten.new_empty_strided, aten.detach, aten.alias, aten.lift_fresh,
             aten._local_scalar_dense, aten.sym_size, aten.sym_stride,
             aten.sym_numel, aten.sym_storage_offset}
_BLOCK = 512           # the CUDA caching allocator's rounding of a block
_DEVICE = torch.ops.prim.device.default


def _collective(func, args):
    """(kind, result tensors, process group size) of a collective operator,
    or None."""
    ns, name = func.namespace, func.overloadpacket.__name__
    if ns == "_c10d_functional":
        kind = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all"}.get(name)
        if kind is None:
            return None
        group = dist.distributed_c10d._resolve_process_group(args[-1])
        return kind, None, group.size()
    if ns == "c10d":
        spec = {"allreduce_": ("all-reduce", 0, 1),
                "allgather_": ("all-gather", 0, 2),
                "_allgather_base_": ("all-gather", 0, 2),
                "reduce_scatter_": ("reduce-scatter", 0, 2),
                "_reduce_scatter_base_": ("reduce-scatter", 0, 2),
                "alltoall_base_": ("all-to-all", 0, 2)}.get(name)
        if spec is None:
            return None
        kind, out_i, group_i = spec
        group = dist.ProcessGroup.unbox(args[group_i])
        return kind, args[out_i], group.size()
    return None


def ring_bytes(kind: str, n_bytes: float, group: int) -> float:
    """A collective's link bytes per device under the ring model of
    ``repro.launch.dryrun.parse_collectives`` (``n_bytes`` its result);
    a group of one moves nothing."""
    frac = (group - 1) / group if group >= 1 else 1.0
    return {"all-reduce": 2 * n_bytes * frac, "all-gather": n_bytes * frac,
            "reduce-scatter": n_bytes * group * frac,
            "all-to-all": n_bytes * frac,
            "collective-permute": n_bytes}[kind]


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _kernel_flops(func, args) -> float:
    name = func.overloadpacket.__name__
    if name in ("flash_attention", "flash_attention_lse"):
        q, k, v = args[0], args[1], args[2]
        B, Sq, H, D = q.shape
        q_offset = args[5] if len(args) > 5 else 0
        return flash_cost(B, Sq, k.shape[1], H, D, args[3], q.element_size(), q_offset,
                          v.shape[-1])[0]
    if name == "flash_attention_bwd":
        q, k, v = args[0], args[1], args[2]
        B, Sq, H, D = q.shape
        q_offset = args[7] if len(args) > 7 else 0
        return flash_bwd_cost(B, Sq, k.shape[1], H, D, args[5], q.element_size(),
                              q_offset, v.shape[-1])[0]
    if name in ("mla_attention", "mla_attention_lse", "mla_attention_bwd"):
        q, k, v = args[0], args[1], args[2]
        B, Sq, H, Dk = q.shape
        cost = mla_bwd_cost if name == "mla_attention_bwd" else mla_cost
        return cost(B, Sq, k.shape[1], H, Dk, v.shape[2], args[-2], q.element_size())[0]
    if name in ("ssd_chunk", "ssd_chunk_bwd"):
        x, B_in = args[0], args[3]
        Bb, Q, H, P = x.shape
        groups = 1 if B_in.stride(2) == 0 else H
        cost = ssd_chunk_cost if name == "ssd_chunk" else ssd_chunk_bwd_cost
        return cost(Bb, Q, H, P, B_in.shape[-1], groups)[0]
    return 0.0


@dataclasses.dataclass
class Cost:
    """``hlo_cost.Cost``'s fields, per device."""
    flops: float = 0.0
    bytes: float = 0.0
    transcendentals: float = 0.0
    collectives: dict = dataclasses.field(default_factory=dict)

    def add_collective(self, kind: str, n_bytes: float, group: int):
        slot = self.collectives.setdefault(
            kind, {"count": 0.0, "bytes": 0.0, "ring_bytes": 0.0})
        slot["count"] += 1
        slot["bytes"] += n_bytes
        slot["ring_bytes"] += ring_bytes(kind, n_bytes, group)


class CostCounter(TorchDispatchMode):
    """``with CostCounter() as c: step(...)`` -> ``c.cost`` (a ``Cost``),
    ``c.ops`` (operator -> calls, the kernels' operators among them:
    ``torch.ops.repro_torch.flash_attention.default``, ...), and with
    ``memory=True`` the live and ``peak`` bytes (``attribute=True``: and
    ``live_at_peak()``)."""

    def __init__(self, memory: bool = False, attribute: bool = False):
        super().__init__()
        self.cost = Cost()
        self.ops = collections.Counter()
        self.memory = memory or attribute
        self.attribute = attribute
        self.live = 0
        self.peak = 0
        self._storages = {}   # storage id -> [label, bytes, made, freed, holders]
        self._records = []         # every storage's record (``attribute``)
        self._tick = 0
        self._peak_tick = 0
        self._propagating = 0
        self._patched = None

    # ------------------------------------------------------------ memory
    def track(self, tree) -> int:
        """Count the storages of ``tree``'s tensors (``DTensor``s by their
        local blocks) as live, from before the program; -> their bytes."""
        n = 0
        for t in _tensors(tree):
            n += self._alloc(t.to_local() if isinstance(t, DTensor) else t,
                             "argument")
        return n

    def _alloc(self, t, op=None) -> int:
        if t.device.type == "meta":      # shapes only: no device memory
            return 0
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return 0
        n = -(-st.nbytes() // _BLOCK) * _BLOCK
        self._tick += 1
        label = ((op, tuple(t.shape), str(t.dtype).replace("torch.", ""), _caller())
                 if self.attribute else None)
        rec = [label, n, self._tick, None, 1]     # ..., storages holding it
        self._storages[key] = rec
        if self.attribute:
            self._records.append(rec)
        self.live += n
        if self.live > self.peak:
            self.peak, self._peak_tick = self.live, self._tick
        weakref.finalize(st, self._free, key)
        return n

    def _alias(self, src, out):
        """``out`` counted as the storage of ``src`` (one allocation, alive
        while either is)."""
        rec = self._storages.get(id(src.untyped_storage()))
        st = out.untyped_storage()
        if rec is None or out.device.type == "meta" or id(st) in self._storages:
            self._alloc(out, "wait_tensor")
            return
        rec[4] += 1
        self._storages[id(st)] = rec
        weakref.finalize(st, self._free, id(st))

    def _free(self, key):
        rec = self._storages.pop(key, None)
        if rec is not None:
            rec[4] -= 1
            if rec[4] == 0:
                self._tick += 1
                rec[3] = self._tick
                self.live -= rec[1]

    def live_at_peak(self) -> list:
        """The storages alive at the peak (``attribute=True``), grouped by
        (operator, shape, dtype, the port's line that called it): a list of
        (bytes, count, label), the largest first.  Tracked inputs have the
        operator "argument"."""
        groups = collections.defaultdict(lambda: [0, 0])
        for label, n, made, freed, _ in self._records:
            if made <= self._peak_tick and (freed is None or freed > self._peak_tick):
                g = groups[label]
                g[0] += n
                g[1] += 1
        return sorted(((b, c, lab) for lab, (b, c) in groups.items()),
                      key=lambda r: -r[0])

    # ---------------------------------------------------------- dispatch
    def __enter__(self):
        # DTensor's shape propagation runs the operator at its global
        # shape; it is no part of the rank's program
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        real = ShardingPropagator._propagate_tensor_meta_non_cached

        def propagate(prop, *a, **kw):
            self._propagating += 1
            try:
                return real(prop, *a, **kw)
            finally:
                self._propagating -= 1
        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        self._patched = (ShardingPropagator, real)
        return super().__enter__()

    def __exit__(self, *exc):
        cls, real = self._patched
        cls._propagate_tensor_meta_non_cached = real
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._propagating or func is _DEVICE:
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # DTensor runs it; its local ops come here
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        if self.memory:
            if func.overloadpacket.__name__ == "wait_tensor":
                # returns its input on a device; the fake kernel makes a copy
                self._alias(args[0], out)
            else:
                for t in _tensors(out):
                    self._alloc(t, func.overloadpacket.__name__)
        return out

    def _count(self, func, args, kwargs, out):
        self.ops[func] += 1
        pkt = func.overloadpacket
        c = self.cost
        if pkt in _MATMULS:
            a = args[_MATMULS[pkt]]
            c.flops += 2.0 * out.numel() * a.shape[-1]
        elif func.namespace == "repro_torch":
            c.flops += _kernel_flops(func, args)
        elif pkt in _TRANSCENDENTAL:
            c.transcendentals += 1
        coll = _collective(func, args)
        if coll is not None:
            kind, result, group = coll
            c.add_collective(kind, float(_nbytes(out if result is None else result)),
                             group)
        if func.is_view or pkt in _NO_BYTES or func.namespace == "prim" or (
                pkt.__name__ == "wait_tensor"):
            return
        c.bytes += _nbytes((args, kwargs)) + _nbytes(out)

    def launches(self, name: str) -> int:
        """Calls of the ``repro_torch`` operator ``name`` (a kernel's
        launches on the card)."""
        return sum(n for op, n in self.ops.items()
                   if op.namespace == "repro_torch"
                   and op.overloadpacket.__name__ == name)


_PORT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_HERE = os.path.abspath(__file__)


def _caller() -> str:
    """The innermost frame of the port's code outside this module, as
    "models/blocks.py:241 _sharded_attention"."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if path.startswith(_PORT) and path != _HERE:
            return (f"{os.path.relpath(path, _PORT)}:{f.f_lineno} "
                    f"{f.f_code.co_name}")
        f = f.f_back
    return "?"
