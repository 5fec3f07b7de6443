"""Divisibility-aware sharding policy (the port of ``repro.launch.sharding``).

Maps every parameter / activation / cache tensor to a PartitionSpec given the
mesh, with fallback chains when a preferred dim doesn't divide the axis
(e.g. GQA kv=8 heads on a 16-way model axis -> shard head_dim instead).

Conventions (the JAX package's):
  * params: TP dim over `model`, FSDP dim over `data` (never over `pod` —
    cross-pod stays pure DP);  optimizer moments/master mirror the param spec;
  * train/prefill residual stream: batch over data axes, sequence over
    `model` (Megatron sequence parallelism);
  * decode: batch over data axes when divisible; caches KV-head-sharded when
    possible, else sequence-sharded with the LSE-combine decode
    (ctx.decode_attn = 'distributed').

The specs are ``collectives.P`` tuples, equal entry by entry to the JAX
package's ``PartitionSpec``s; leaf paths are ``jax.tree_util.keystr``
strings (``"['layers']['wq']"``, the port checkpoint's keys), so the same
regexes pick the same leaves.  ``NamedSharding`` pairs a mesh with a spec;
on a ``DeviceMesh`` its ``placements`` are DTensor's (``Shard(dim)`` /
``Replicate()`` per mesh dimension, a dim split by several axes sharded by
each in mesh order, which is JAX's major-to-minor order) and ``place``
cuts a whole tensor to this rank's block, a ``DTensor``.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint.checkpointer import leaf_paths
from repro_torch.collectives import (MeshShape, P, _as_tuple, axis_index,
                                     axis_sizes, to_placements)
from repro_torch.launch.mesh import data_axes_of, model_axis_of
from repro_torch.models.context import ModelCtx
from repro_torch.models.moe import moe_weight_specs
from repro_torch.optim.optimizers import tree_leaves, tree_map, tree_unflatten

STACK_KEYS = ("layers", "moe_layers", "dense_layers", "mamba_layers",
              "enc_layers", "dec_layers", "lstm")


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def _shape(leaf) -> tuple:
    """A leaf's shape; a Python int (an optimizer's step) is a scalar."""
    return tuple(leaf.shape) if hasattr(leaf, "shape") else ()


def map_with_path(fn, tree):
    """``fn(keystr, leaf)`` over a tree of nested dicts and lists, keys as
    ``jax.tree_util.keystr`` writes them (the checkpoint's ``leaf_paths``);
    the tree's structure kept."""
    return tree_unflatten(tree, [fn(k, x) for k, x in leaf_paths(tree)])


# --------------------------------------------------------------- placement
def local_block(t, spec, mesh):
    """This rank's block of the whole tensor ``t`` under ``spec`` (a view):
    a dim split over axes (a1, a2, ...) is cut into their product of equal
    slices and the rank takes the one at its index along them."""
    sizes = axis_sizes(mesh)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        n = math.prod(sizes[a] for a in _as_tuple(entry))
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"{n} ways over {entry}")
        w = t.shape[dim] // n
        t = t.narrow(dim, axis_index(mesh, entry) * w, w)
    return t


def mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    mesh: object
    spec: P

    @property
    def placements(self) -> list:
        return to_placements(self.spec, self.mesh)

    def place(self, t: torch.Tensor) -> DTensor:
        """This rank's block of the whole tensor ``t`` on the mesh's device,
        as a ``DTensor``: in storage of its own (``t`` can be freed), or,
        where the block is the whole of a contiguous ``t`` already there (a
        mesh of one card), in ``t``'s storage, so that placing a model does
        not hold it twice."""
        if isinstance(self.mesh, MeshShape):
            raise TypeError("a MeshShape plans layouts; placing needs a DeviceMesh")
        block = local_block(t, self.spec, self.mesh)
        dev = mesh_device(self.mesh)
        if block.device != dev:
            local = block.to(dev)
        elif block.shape == t.shape and t.is_contiguous():
            local = t.detach()
        else:
            local = block.clone(memory_format=torch.contiguous_format)
        stride = torch.empty(t.shape, device="meta").stride()
        return DTensor.from_local(local.contiguous(), self.mesh, self.placements,
                                  run_check=False, shape=t.shape, stride=stride)


def place(tree, shardings):
    """Every tensor leaf of ``tree`` placed by its ``NamedSharding`` in
    ``shardings`` (a tree of the same structure): a whole tensor is cut to
    this rank's block, a ``DTensor`` (of any mesh) is gathered whole first;
    int leaves stay as they are."""
    def one(x, s):
        if isinstance(x, DTensor):
            x = x.full_tensor()
        return s.place(x) if hasattr(x, "shape") else x
    return tree_map(one, tree, shardings)


def place_state(state, policy: "Policy"):
    """A {params, opt} train state laid out as the JAX package's jitted
    step takes it (``in_shardings``): the parameters by
    ``policy.param_shardings``, the optimizer's moments and master copy
    like their parameters, its step an int."""
    return place(state, policy.state_shardings(state))


def restore_hook(shardings, like):
    """The ``sharding_fn`` of ``checkpointer.restore_pytree`` that places
    each tensor leaf by its ``NamedSharding`` in ``shardings`` (a tree like
    ``like``): the restore walks the leaves in ``tree_leaves`` order and
    asks for the placement of the tensor leaves only."""
    leaves_sh = iter([s for s, t in zip(tree_leaves(shardings), tree_leaves(like))
                      if isinstance(t, torch.Tensor)])
    return lambda tmpl: next(leaves_sh)


def place_batch(batch: dict, policy: "Policy") -> dict:
    """A batch's tensors placed by ``policy.batch_shardings``: the batch dim
    over the data axes where it splits, replicated otherwise."""
    return place(batch, policy.batch_shardings(batch))


def full_state(tree):
    """Every ``DTensor`` leaf gathered whole (``full_tensor``, a collective
    on a mesh of several ranks), other leaves as they are."""
    return map_with_path(
        lambda _, x: x.full_tensor() if isinstance(x, DTensor) else x, tree)


# ------------------------------------------------------------------ policy
class Policy:
    def __init__(self, cfg, mesh, shape_kind: str = "train",
                 global_batch: Optional[int] = None,
                 dp_only_threshold: float = 1e9):
        self.cfg = cfg
        self.mesh = mesh
        self.kind = shape_kind
        self.shape = axis_sizes(mesh)
        self.data_axes = data_axes_of(mesh)
        self.model_axis = model_axis_of(mesh)
        self.dsize = int(math.prod(self.shape[a] for a in self.data_axes))
        self.msize = self.shape[self.model_axis]
        self.fsdp_axis = "data" if "data" in self.shape else None
        self.fsdp_size = self.shape.get("data", 1)

        # models under ~1B params are pure communication when tensor-sharded
        # across a 16-way model axis — replicate their weights and spend
        # every mesh axis on batch (or batch x sequence when the batch
        # doesn't cover the mesh).  Collectives then collapse to the
        # gradient all-reduce.
        self.dp_only = (shape_kind in ("train", "prefill")
                        and cfg.param_count() < dp_only_threshold)
        if self.dp_only:
            self.fsdp_axis = None
            full = self.dsize * self.msize
            if global_batch is not None and global_batch % full == 0:
                self.data_axes = tuple(self.shape)
                self.dsize = full
                self._dp_seq_axis = None
            else:
                self._dp_seq_axis = self.model_axis
        else:
            self._dp_seq_axis = None

    # ------------------------------------------------------------- helpers
    def _fsdp(self, dim: int) -> Optional[str]:
        return self.fsdp_axis if _div(dim, self.fsdp_size) else None

    def _tp(self, dim: int) -> Optional[str]:
        return self.model_axis if _div(dim, self.msize) else None

    def mm_spec(self, shape, tp_dim: int) -> P:
        """2-D matmul weight: TP on ``tp_dim``, FSDP on the other."""
        other = 1 - tp_dim
        spec = [None, None]
        spec[tp_dim] = self._tp(shape[tp_dim])
        spec[other] = self._fsdp(shape[other])
        return P(*spec)

    # ------------------------------------------------------- param policy
    def param_spec(self, path: str, shape) -> P:
        """PartitionSpec for one param leaf.  ``path`` is the keystr."""
        if self.dp_only:
            return P(*([None] * len(shape)))
        stacked = any(f"['{k}']" in path for k in STACK_KEYS)
        core = self._param_spec_core(path, shape[1:] if stacked else shape)
        return P(None, *core) if stacked else core

    def _param_spec_core(self, path: str, shape) -> P:
        cfg = self.cfg
        m = self.model_axis

        if ("moe" in path and "['shared']" not in path
                and re.search(r"\['(w_gate|w_up|w_down|router)'\]", path)):
            strategy = cfg.moe_sharding
            if strategy in ("auto", "ep"):
                strategy = "ep" if _div(cfg.n_experts, self.msize) else "tp"
            specs = moe_weight_specs(cfg, strategy, m, self.fsdp_axis)
            name = re.search(r"\['(w_gate|w_up|w_down|router)'\]", path).group(1)
            # moe_weight_specs already includes the stacked leading None
            return self._check(P(*specs[name][1:]), shape)

        rules = [
            # token table: D over model, vocab REPLICATED — a vocab- or
            # fsdp-sharded table turns the gather into an all-batch
            # gather+mask+psum
            (r"\['embed'\]\['tok'\]", lambda s: P(None, self._tp(s[1]))),
            (r"\['embed'\]\['pos'\]", lambda s: P(None, self._tp(s[1]))),
            (r"\['enc_pos'\]", lambda s: P(None, self._tp(s[1]))),
            (r"\['unembed'\]", lambda s: self.mm_spec(s, 1)),
            (r"\['(wq|wk|wv|w_gate|w_up|wq_b)'\]$", lambda s: self.mm_spec(s, 1)),
            (r"\['(wo|w_down)'\]$", lambda s: self.mm_spec(s, 0)),
            (r"\['wq_a'\]$", lambda s: self.mm_spec(s, 1)),
            (r"\['wkv_a'\]$", lambda s: self.mm_spec(s, 1)),
            (r"\['(wkv_b_k|wkv_b_v)'\]$",
             lambda s: P(self._fsdp(s[0]), self._tp(s[1]), None)),
            (r"\['(wz|wx)'\]$", lambda s: self.mm_spec(s, 1)),
            (r"\['(wB|wC|wdt)'\]$", lambda s: P(self._fsdp(s[0]), None)),
            (r"\['conv_(x|B|C)'\]\['w'\]", lambda s: P(self._tp(s[0]), None)),
            (r"\['conv_(x|B|C)'\]\['b'\]", lambda s: P(self._tp(s[0]))),
            (r"\['(w_ih|w_hh)'\]$", lambda s: self.mm_spec(s, 1)),
        ]
        for pat, fn in rules:
            if re.search(pat, path):
                return self._check(fn(shape), shape)
        # norms, biases, scalars, gates: replicate
        return P(*([None] * len(shape)))

    def _check(self, spec: P, shape) -> P:
        out = []
        for i, ax in enumerate(tuple(spec) + (None,) * (len(shape) - len(spec))):
            if ax is None:
                out.append(None)
            else:
                size = math.prod(self.shape[a] for a in _as_tuple(ax))
                out.append(ax if _div(shape[i], size) else None)
        return P(*out)

    def param_shardings(self, param_shapes):
        """A tree of ``NamedSharding`` matching a parameter tree (tensors,
        on the ``meta`` device or any other)."""
        return map_with_path(
            lambda path, leaf: NamedSharding(self.mesh,
                                             self.param_spec(path, _shape(leaf))),
            param_shapes)

    def state_shardings(self, state_shapes):
        """``NamedSharding``s of a {params, opt} train state (or of a state
        with params only)."""
        param_sh = self.param_shardings(state_shapes["params"])
        out = {"params": param_sh}
        if "opt" in state_shapes:
            out["opt"] = self.opt_state_shardings(state_shapes["opt"], param_sh)
        return out

    def opt_state_shardings(self, opt_shapes, param_shardings):
        """Moments/master mirror the param spec; scalars replicate."""
        pflat = dict(leaf_paths(param_shardings))

        def one(path, leaf):
            # strip the leading ['m'] / ['v'] / ['master'] component
            stripped = re.sub(r"^\['(m|v|master)'\]", "", path)
            if stripped in pflat:
                return pflat[stripped]
            return NamedSharding(self.mesh, P(*([None] * len(_shape(leaf)))))

        return map_with_path(one, opt_shapes)

    # ------------------------------------------------- activations / rules
    def ctx(self, decode: bool = False, batch: Optional[int] = None) -> ModelCtx:
        """The ModelCtx of this policy.  On a ``DeviceMesh`` the process
        groups that the decode plan reduces over are built here, on every
        rank in the same order.  ``batch`` is the global batch: under
        ``decode`` it sizes the plan; otherwise a batch that the data axes
        do not divide (as ``batch_shardings`` leaves it), or a batch of one
        (a dim of one sharded, even over one rank, cannot be flattened with
        the sequence on a ``DTensor``), leaves every rule's batch dim
        whole."""
        cfg = self.cfg
        B_axes = self.data_axes
        if not decode and batch is not None and (batch == 1
                                                 or not _div(batch, self.dsize)):
            B_axes = None
        m = self.model_axis
        rules = {}
        if not decode:
            rules["residual"] = P(B_axes, m, None)
            rules["logits"] = P(B_axes, None, m)      # prefill last-pos logits
            rules["logits_sp"] = P(B_axes, m, None)   # train loss: S-sharded, V-local
        else:
            rules["residual"] = P(B_axes, None, None)
            rules["logits"] = P(B_axes, None, m)

        # attention activations (train/prefill): KV heads over model when
        # they divide; else EXPAND — duplicate KV to the full H heads and
        # shard H (Megatron GQA-under-TP); nothing divides (whisper H=8 <
        # 16): replicate heads
        if cfg.n_heads:
            kv, h = cfg.n_kv_heads, cfg.n_heads
            if _div(kv, self.msize):
                rules["attn_mode"] = "kv"
                rules["attn_q"] = P(B_axes, None, m, None, None)
                rules["attn_kv"] = P(B_axes, None, m, None)
            elif _div(h, self.msize):
                rules["attn_mode"] = "expand"
                rules["attn_q4"] = P(B_axes, None, m, None)
                rules["attn_kv4"] = P(B_axes, None, m, None)
            else:
                rules["attn_mode"] = "replicate"
        if cfg.ssm_state:
            h, p = cfg.ssm_nheads, cfg.ssm_headdim
            if _div(h, self.msize):
                rules["ssm_x"] = P(B_axes, None, m, None)
            elif _div(p, self.msize):
                rules["ssm_x"] = P(B_axes, None, None, m)

        if self.dp_only and not decode:
            seq = self._dp_seq_axis
            rules = {
                "residual": P(B_axes, seq, None),
                "logits": P(B_axes, seq, None),
                "logits_sp": P(B_axes, seq, None),
                "attn_mode": "replicate",
            }

        plan = self.decode_plan(batch) if decode else None
        ctx = ModelCtx(
            mesh=self.mesh, rules=rules, data_axes=self.data_axes,
            fsdp_axis=self.fsdp_axis, model_axis=m,
            remat="none" if decode else "full",
            decode_attn=(plan.mode if plan else "local"),
            decode_plan=plan,
        )
        ctx.policy = self
        if plan is not None and ctx.groups is not None:
            for axes in (plan.seq_axes, plan.b_axes):
                if axes:
                    ctx.groups.group(axes)
        return ctx

    def decode_plan(self, batch: Optional[int]):
        """How to lay out decode KV caches (see module docstring).

        Preference order: shard batch over data + KV heads (or head_dim)
        over model -> plain local decode.  When batch or KV can't shard, the
        sequence dim takes the free axes and decode runs the distributed
        LSE-combine path."""
        cfg = self.cfg
        m = self.model_axis
        b_axes = self.data_axes if (batch and _div(batch, self.dsize)) else None
        if cfg.use_mla:
            # compressed MQA-style cache: no KV-head dim; always seq-shard
            seq = (m,) if b_axes else tuple(self.data_axes) + (m,)
            return DecodePlan(b_axes, None, seq, "distributed")
        kv_axis = (m if _div(cfg.n_kv_heads, self.msize)
                   else ("HD" if _div(cfg.head_dim, self.msize) else None))
        if b_axes and kv_axis:
            return DecodePlan(b_axes, kv_axis, (), "local")
        if kv_axis:  # batch un-shardable (long_500k B=1): seq over data
            return DecodePlan(None, kv_axis, tuple(self.data_axes), "distributed")
        if b_axes:
            return DecodePlan(b_axes, None, (m,), "distributed")
        return DecodePlan(None, None, tuple(self.data_axes) + (m,), "distributed")

    # ----------------------------------------------------- batches / caches
    def batch_shardings(self, batch_shapes):
        def spec(path, leaf):
            shape = _shape(leaf)
            if not shape:
                return NamedSharding(self.mesh, P())
            ba = self.data_axes if _div(shape[0], self.dsize) else None
            return NamedSharding(self.mesh, P(ba, *([None] * (len(shape) - 1))))

        return map_with_path(spec, batch_shapes)

    def cache_shardings(self, cache_shapes, plan: "DecodePlan"):
        """Decode caches.  Leaves are stacked (L, B, S, ...) or (L, B, ...)."""
        m = self.model_axis
        cfg = self.cfg
        B_axes = plan.b_axes
        seq = plan.seq_axes if plan.seq_axes else None

        def spec(path, leaf):
            shape = _shape(leaf)
            nd = len(shape)
            if nd >= 4 and re.search(r"\['(k|v|xk|xv)'\]$", path):
                # (L, B, S, KV, Dh) attention cache
                kv_sp = plan.kv_axis if plan.kv_axis != "HD" else None
                hd_sp = m if plan.kv_axis == "HD" else None
                return NamedSharding(self.mesh, P(None, B_axes, seq, kv_sp, hd_sp))
            if re.search(r"\['(c_kv|k_rope)'\]$", path):
                # (L, B, S, R) compressed MLA cache: sequence-sharded
                return NamedSharding(self.mesh, P(None, B_axes, seq, None))
            if re.search(r"\['state'\]$", path):
                # (L, B, H, P, N) SSM state
                h, pd = cfg.ssm_nheads, cfg.ssm_headdim
                if _div(h, self.msize):
                    return NamedSharding(self.mesh, P(None, B_axes, m, None, None))
                if _div(pd, self.msize):
                    return NamedSharding(self.mesh, P(None, B_axes, None, m, None))
                return NamedSharding(self.mesh, P(None, B_axes, None, None, None))
            if re.search(r"\['conv_(x|B|C)'\]$", path):
                tp = m if _div(shape[-1], self.msize) else None
                return NamedSharding(self.mesh, P(None, B_axes, None, tp))
            return NamedSharding(self.mesh, P(*([None] * nd)))

        return map_with_path(spec, cache_shapes)


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    b_axes: Optional[tuple]        # batch dim axes, or None (replicated)
    kv_axis: Optional[str]         # 'model' | 'HD' (head_dim over model) | None
    seq_axes: tuple                # axes sharding the cache sequence dim
    mode: str                      # 'local' | 'distributed'
