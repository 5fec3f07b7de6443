"""Multi-pod dry run: trace one rank's program of every cell, with no card
and no allocation (the port of ``repro.launch.dryrun``).

For every (architecture x input shape x mesh) cell the JAX package lowers
and compiles the step on fake host devices and reads XLA's memory and cost
analyses.  The port traces the step instead: on a fake world
(``launch.mesh.init_fake_world``, the "fake" process-group backend, this
process the last rank of 256 or 512, whose work sets the step's time)
under ``FakeTensorMode``, the model, the ``Policy``'s placements of the
parameters, optimizer state and batch (that rank's blocks, as
``DTensor``s) and the step run on fake tensors, through
``launch.cost.CostCounter``.

  * train: ``launch.train.make_train_step`` (``Model.loss``, its gradients,
    the AdamW update) under ``policy.ctx()``, the state donated, as the
    JAX package lowers its step with ``donate_argnums=(0,)`` and as the
    ``Trainer`` runs it;
  * prefill: ``Model.prefill`` under ``policy.ctx()``;
  * decode: ``Model.decode_step`` under ``policy.ctx(decode=True,
    batch=B)``, the shard-aware decode of ``Server`` on a mesh: the
    parameters cut to the rank's blocks by ``Policy.param_shardings`` (each
    product split over the mesh by ``models.tp``), the batch and the cache
    cut to the rank's shard by the plan (``Policy.cache_shardings``), as
    the JAX package lowers its decode with ``in_shardings=(param_sh,
    cache_sh, ...)``.

The hand-written kernels are reached through their operators
(``torch.ops.repro_torch.*``), whose shape functions answer for fake
tensors; the ctx's ``kernels="cuda"`` sends every call to them whatever
the trace's device.  The trace's tensors are fake "cuda" tensors where
PyTorch has CUDA and fake "cpu" tensors where it has not (autograd there
cannot take a tensor of a device it was not built for); the program is
the same.

The artifact has the JAX package's keys:

  * ``params_total`` / ``params_matmul_active`` / ``model_flops``
    (``models.model``'s analytic counts);
  * ``hlo_flops_per_device`` / ``hlo_bytes_per_device`` / ``collectives``:
    the counter's totals of the traced program (there is no HLO);
    ``xla_cost_analysis_*`` repeat them (there is no XLA cost analysis);
  * ``memory``: ``argument_size_in_bytes`` (the step's inputs, this rank's
    blocks), ``output_size_in_bytes``, ``alias_size_in_bytes`` (outputs
    in the inputs' storage: the decode's cache, updated in place; the
    train step's donated state, released as the new one is made),
    ``temp_size_in_bytes`` (the peak less the arguments and the outputs
    not in their storage), ``generated_code_size_in_bytes`` (0: nothing is
    compiled), ``peak_memory_in_bytes`` (the counter's peak of live
    storage, in the CUDA caching allocator's blocks) and
    ``hbm_estimate_bytes`` (arguments + outputs + temporaries - aliases,
    which is that peak);
  * ``lower_s``: building the fake state; ``compile_s``: the trace.

Artifacts land in ``artifacts/dryrun_torch/<mesh>/<arch>__<shape>.json``
(the JAX package's ``artifacts/dryrun/`` is not touched) and feed
``launch.roofline``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k --mesh small
  python -m repro_torch.launch.dryrun --all --mesh single,multi
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint.checkpointer import leaf_paths
from repro_torch.collectives import _as_tuple, axis_sizes
from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.launch.cost import CostCounter
from repro_torch.launch.mesh import (init_fake_world, make_production_mesh,
                                     make_small_mesh)
from repro_torch.launch.sharding import Policy, map_with_path
from repro_torch.launch.train import make_train_step
from repro_torch.models import inputs as inputs_lib
from repro_torch.models.model import (Model, _param_shapes, count_params_analytic,
                                      matmul_param_count, model_flops)
from repro_torch.optim import adamw
from repro_torch.optim.optimizers import tree_leaves

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts",
                       "dryrun_torch")

MESH_SIZES = {"single": 256, "multi": 512, "small": 8}


def trace_device_type() -> str:
    """"cuda" where PyTorch has CUDA, else "cpu" (see the module doc)."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def build_mesh(name: str, device_type=None):
    """The named mesh on the running fake world (``init_fake_world`` of
    ``MESH_SIZES[name]`` ranks, or more)."""
    dt = device_type or trace_device_type()
    if name == "single":
        return make_production_mesh(multi_pod=False, device_type=dt)
    if name == "multi":
        return make_production_mesh(multi_pod=True, device_type=dt)
    if name == "small":
        return make_small_mesh(device_type=dt)
    raise ValueError(name)


def _local_shape(shape, spec, mesh):
    sizes = axis_sizes(mesh)
    out = list(shape)
    for dim, entry in enumerate(spec):
        if entry is not None:
            n = math.prod(sizes[a] for a in _as_tuple(entry))
            if out[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                                 f"{n} ways over {entry}")
            out[dim] //= n
    return out


def _fake_placed(tree, shardings, mesh):
    """Every tensor leaf of ``tree`` (shapes only) as a ``DTensor`` of
    ``shardings``' placements whose local block is a fake tensor of this
    rank's shape on the mesh's device; other leaves as they are."""
    dev = torch.device(mesh.device_type)
    flat = dict(leaf_paths(shardings))

    def one(path, x):
        if not isinstance(x, torch.Tensor):
            return x
        sh = flat[path]
        local = torch.empty(_local_shape(x.shape, sh.spec, mesh), dtype=x.dtype,
                            device=dev)
        return DTensor.from_local(local, mesh, sh.placements, run_check=False,
                                  shape=x.shape,
                                  stride=torch.empty(x.shape, device="meta").stride())
    return map_with_path(one, tree)


def _fake_local(tree, spec_of, mesh):
    """Every tensor leaf as a plain fake tensor of this rank's block under
    ``spec_of(path, leaf)`` (the shard-aware decode's local tensors)."""
    dev = torch.device(mesh.device_type)

    def one(path, x):
        if not isinstance(x, torch.Tensor):
            return x
        return torch.empty(_local_shape(x.shape, spec_of(path, x), mesh),
                           dtype=x.dtype, device=dev)
    return map_with_path(one, tree)


def _locals(tree) -> list:
    """The tensors of ``tree`` as this rank holds them (a ``DTensor``'s
    local block)."""
    return [t.to_local() if isinstance(t, DTensor) else t for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def trace_cell(arch: str, shape_name: str, mesh, global_batch=None, seq_len=None,
               attribute: bool = False):
    """Trace one cell -> (artifact, the ``CostCounter``), or (artifact, None)
    for a skipped cell.  ``global_batch`` and ``seq_len`` replace the
    shape's sizes (a cut-down cell); ``attribute``: the counter keeps what
    made each storage (``CostCounter.live_at_peak``)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    B = global_batch or shape.global_batch
    S = seq_len or shape.seq_len
    shape = dataclasses.replace(shape, global_batch=B, seq_len=S)
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": True, "reason": why}, None

    policy = Policy(cfg, mesh, shape.kind, global_batch=B)
    model = Model(cfg)
    params_meta = _param_shapes(cfg)
    param_sh = policy.param_shardings(params_meta)
    counter = CostCounter(memory=True, attribute=attribute)
    t0 = time.monotonic()
    # the abstract inputs, on ``meta`` (the decode's cache from the prefill)
    # and the ctx (its process groups planned with no fake mode about)
    ctx = policy.ctx(decode=True, batch=B) if shape.kind == "decode" else policy.ctx()
    ctx.kernels = "cuda"
    if shape.kind == "train":
        opt = adamw(3e-4, keep_master=(cfg.opt_precision == "fp32"))
        state_meta = {"params": params_meta, "opt": opt.init(params_meta)}
    elif shape.kind == "decode":
        tokens_meta, cache_meta, _ = inputs_lib.decode_input_shapes(cfg, B, S)
    with FakeTensorMode(allow_non_fake_inputs=True), torch.no_grad():
        if shape.kind == "train":
            state = _fake_placed(state_meta, policy.state_shardings(state_meta), mesh)
            batch_meta = inputs_lib.train_batch_shapes(cfg, B, S)
            batch = _fake_placed(batch_meta, policy.batch_shardings(batch_meta), mesh)
            step = make_train_step(model, opt, ctx, donate=True)
            args = (state, batch)

            def run():
                with torch.enable_grad():
                    return step(state, batch)
        elif shape.kind == "prefill":
            params = _fake_placed(params_meta, param_sh, mesh)
            batch_meta = inputs_lib.prefill_batch_shapes(cfg, B, S)
            batch = _fake_placed(batch_meta, policy.batch_shardings(batch_meta), mesh)
            args = (params, batch)

            def run():
                return model.prefill(params, batch, ctx, cache_len=S)
        elif shape.kind == "decode":
            plan = ctx.decode_plan
            cache_sh = dict(leaf_paths(policy.cache_shardings(cache_meta, plan)))
            param_specs = dict(leaf_paths(param_sh))
            params = _fake_local(params_meta, lambda p, x: param_specs[p].spec, mesh)
            cache = _fake_local(cache_meta, lambda p, x: cache_sh[p].spec, mesh)
            b = (plan.b_axes,) if plan.b_axes else (None,)
            tokens = _fake_local({"t": tokens_meta}, lambda p, x: b + (None,), mesh)["t"]
            args = (params, cache, tokens)

            def run():
                return model.decode_step(params, cache, tokens, S - 1, ctx)
        else:
            raise ValueError(shape.kind)
        t_lower = time.monotonic() - t0
        arg_bytes = counter.track(args)
        arg_refs = {id(t.untyped_storage()): (weakref.ref(t.untyped_storage()),
                                              t.untyped_storage().nbytes())
                    for t in _locals(args)}
        t0 = time.monotonic()
        with counter:
            out = run()
        t_trace = time.monotonic() - t0
        out_bytes = sum(t.numel() * t.element_size() for t in _locals(out))
        alias = sum(t.untyped_storage().nbytes() for t in _locals(out)
                    if id(t.untyped_storage()) in arg_refs)
        # a donated argument's storage, released by the step
        alias += sum(n for ref, n in arg_refs.values() if ref() is None)
    peak = counter.peak
    mem = {"argument_size_in_bytes": arg_bytes, "output_size_in_bytes": out_bytes,
           "temp_size_in_bytes": max(peak - arg_bytes - out_bytes + alias, 0),
           "alias_size_in_bytes": alias, "generated_code_size_in_bytes": 0,
           "peak_memory_in_bytes": peak}
    mem["hbm_estimate_bytes"] = (mem["argument_size_in_bytes"]
                                 + mem["output_size_in_bytes"]
                                 + mem["temp_size_in_bytes"]
                                 - mem["alias_size_in_bytes"])
    cost = counter.cost
    art = {
        "arch": arch,
        "shape": shape_name,
        "mesh": {k: int(v) for k, v in axis_sizes(mesh).items()},
        "kind": shape.kind,
        "skipped": False,
        "n_devices": int(mesh.size()),
        "params_total": count_params_analytic(cfg),
        "params_matmul_active": matmul_param_count(cfg),
        "model_flops": model_flops(cfg, shape),
        "hlo_flops_per_device": cost.flops,
        "hlo_bytes_per_device": cost.bytes,
        "xla_cost_analysis_flops": cost.flops,
        "xla_cost_analysis_bytes": cost.bytes,
        "memory": mem,
        "collectives": cost.collectives,
        "collective_bytes_total": float(
            sum(c["bytes"] for c in cost.collectives.values())),
        "collective_ring_bytes": float(
            sum(c["ring_bytes"] for c in cost.collectives.values())),
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_trace, 2),
    }
    return art, counter


def lower_cell(arch: str, shape_name: str, mesh, verbose: bool = True):
    """Trace one cell.  Returns the artifact dict."""
    art, _ = trace_cell(arch, shape_name, mesh)
    if verbose and not art["skipped"]:
        mem = art["memory"]
        print(f"[dryrun] {arch} x {shape_name} x {art['mesh']}: "
              f"peak={mem['peak_memory_in_bytes']/2**30:.2f}GiB/dev "
              f"flops/dev={art['hlo_flops_per_device']:.3e} "
              f"coll={art['collective_bytes_total']/2**20:.1f}MiB "
              f"(build {art['lower_s']:.0f}s, trace {art['compile_s']:.0f}s)")
        print("  memory:", mem)
    return art


def cell_path(mesh_name: str, arch: str, shape_name: str) -> str:
    d = os.path.abspath(os.path.join(ART_DIR, mesh_name))
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{arch}__{shape_name}.json")


def run_cells(archs, shapes, mesh_names, force: bool = False):
    """Every cell on every named mesh, each mesh on a fake world of its
    size that this function starts and ends (it refuses if a process
    group is running).  A failing cell is recorded with its message."""
    results = []
    for mesh_name in mesh_names:
        init_fake_world(MESH_SIZES[mesh_name])
        try:
            mesh = build_mesh(mesh_name)
            for arch in archs:
                for shape_name in shapes:
                    path = cell_path(mesh_name, arch, shape_name)
                    if os.path.exists(path) and not force:
                        print(f"[dryrun] cached: {path}")
                        continue
                    try:
                        art = lower_cell(arch, shape_name, mesh)
                    except Exception as e:  # record failures: they are bugs
                        art = {"arch": arch, "shape": shape_name, "skipped": False,
                               "error": f"{type(e).__name__}: {e}",
                               "traceback": traceback.format_exc()[-4000:]}
                        print(f"[dryrun] FAIL {arch} x {shape_name} x {mesh_name}: {e}")
                    art["mesh_name"] = mesh_name
                    with open(path, "w") as f:
                        json.dump(art, f, indent=1)
                    results.append(art)
        finally:
            dist.destroy_process_group()
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    mesh_names = args.mesh.split(",")
    archs = ARCH_IDS if (args.all or not args.arch) else args.arch.split(",")
    shapes = list(SHAPES) if (args.all or not args.shape) else args.shape.split(",")
    arts = run_cells(archs, shapes, mesh_names, force=args.force)
    n_fail = sum(1 for a in arts if a.get("error"))
    print(f"[dryrun] done: {len(arts)} cells, {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
