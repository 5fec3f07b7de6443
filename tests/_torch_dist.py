"""Spawned gloo ranks for the port's distributed tests, and the rank
workers they run.

Nothing here imports JAX: a spawned child imports torch, the port and this
module only.  ``run_ranks`` starts ``world`` processes with
``torch.multiprocessing.start_processes(..., join=False)``; each starts a
gloo group (``init_method=file://...`` in the test's own temporary
directory, so parallel test workers never race for a port; a 60 s
collective timeout; one intra-op thread), runs a worker and saves what it
returns; the arguments travel through a file beside it.  The parent joins them with a deadline and kills any rank still
alive when it passes, so no rank outlives its test.
"""

from __future__ import annotations

import dataclasses
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DEADLINE_S = 60.0      # a whole spawned run: start, work, exit


def _entry(rank, fn, world, tmp):
    torch.set_num_threads(1)
    args = torch.load(f"{tmp}/args.pt", weights_only=False)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg", rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    try:
        out = fn(rank, *args)
        torch.save(out, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, tmp_path: Path, *args, deadline: float = DEADLINE_S):
    """``fn(rank, *args)`` on ``world`` spawned gloo ranks -> their results,
    by rank.  Raises if a rank raises or the deadline passes."""
    tmp = Path(tmp_path) / f"ranks_{time.monotonic_ns()}"
    tmp.mkdir()
    # the arguments go through a file: a spawned child reads its pipe only
    # once its imports are done, so large arguments would start the ranks
    # one after another
    torch.save(args, tmp / "args.pt")
    ctx = mp.start_processes(_entry, args=(fn, world, str(tmp)), nprocs=world,
                             join=False, start_method="spawn")
    end = time.monotonic() + deadline
    try:
        while not ctx.join(timeout=max(end - time.monotonic(), 0.01)):
            if time.monotonic() >= end:
                raise TimeoutError(f"{world} ranks of {fn.__name__} still running "
                                   f"after {deadline:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert not any(p.is_alive() for p in ctx.processes)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


# ------------------------------------------------------------------ workers
def _cfg(arch):
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(arch, reduced=True), dtype="float32")


def restore_worker(rank, arch, mesh_shape, store_dir, prefix, kinds):
    """``ElasticTrial.restore_onto`` a mesh of ``mesh_shape`` for each
    ``kind`` -> {kind: {leaf path: (local block, the tensor dim each mesh
    dim shards or None)}}."""
    from repro_torch.checkpoint import LocalObjectStore
    from repro_torch.configs.base import get_config
    from repro_torch.launch.elastic import ElasticTrial, slice_mesh
    from repro_torch.launch.mesh import make_small_mesh
    from repro_torch.checkpoint.checkpointer import leaf_paths
    from repro_torch.launch.train import init_state
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw

    cfg = get_config(arch, reduced=True)
    if mesh_shape is None:
        mesh = slice_mesh(4, max_model=2, device_type="cpu")
    else:
        mesh = make_small_mesh(mesh_shape, device_type="cpu")
    opt = adamw(3e-3, keep_master=(cfg.opt_precision == "fp32"))
    like = init_state(Model(cfg), opt, device="meta")
    out = {"mesh": tuple(mesh.mesh.shape), "coord": tuple(mesh.get_coordinate())}
    for kind in kinds:
        trial = ElasticTrial(cfg, LocalObjectStore(store_dir), prefix, kind=kind)
        state, step = trial.restore_onto(mesh, like)
        leaves = {path: (x.to_local(), [getattr(p, "dim", None) for p in x.placements])
                  if isinstance(x, torch.Tensor) else (x, None)
                  for path, x in leaf_paths(state)}
        out[kind] = {"step": step, "leaves": leaves}
    return out


def decode_worker(rank, cases, steps, max_len):
    """For each case (arch, mesh shape, JAX weights as numpy, prompt
    tokens): the port's ``Server`` on a mesh of the shape over the first
    ranks, under ``Policy(cfg, mesh, "decode")``: its generated tokens, then
    the prefill and ``steps - 1`` decode steps replayed on those tokens,
    every step's last-position logits of this rank's batch rows.  Each
    mesh spans every rank."""
    from repro_torch.launch.mesh import make_small_mesh
    from repro_torch.launch.serve import Server
    from repro_torch.launch.sharding import Policy
    from repro_torch.models.model import params_from_numpy

    out = []
    for arch, mesh_shape, params_np, tokens in cases:
        cfg = _cfg(arch)
        mesh = make_small_mesh(mesh_shape, device_type="cpu")
        B = tokens.shape[0]
        ctx = Policy(cfg, mesh, "decode").ctx(decode=True, batch=B)
        params = params_from_numpy(cfg, params_np, device="cpu")
        srv = Server(cfg, params, ctx=ctx, max_len=max_len, device="cpu")
        gen = srv.generate({"tokens": tokens}, steps)
        with torch.inference_mode():
            toks, fed = torch.as_tensor(tokens).long(), gen.long()
            if ctx.decode_plan.b_axes:
                fed = srv._batch_slice(fed)
            logits, cache = srv.prefill(toks)
            lgs = [logits[:, -1]]
            for i in range(steps - 1):
                lg, cache = srv.model.decode_step(srv.params, cache, fed[:, i:i + 1],
                                                  tokens.shape[1] + i, ctx)
                lgs.append(lg[:, -1])
        plan = ctx.decode_plan
        out.append({"tokens": gen, "logits": torch.stack(lgs, 1),
                    "plan": (plan.b_axes, plan.kv_axis, plan.seq_axes, plan.mode),
                    "cache_shapes": {k: tuple(v.shape) for k, v in _leaves(cache)}})
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def int8_worker(rank, grads_np, errors_np):
    """``int8_allreduce`` over the ``data`` axis of a (2,) mesh, each rank
    with its own gradients and residuals."""
    from repro_torch.launch.mesh import make_small_mesh
    from repro_torch.optim.compression import int8_allreduce

    mesh = make_small_mesh((2,), axes=("data",), device_type="cpu")
    g = {k: torch.from_numpy(np.array(v[rank])) for k, v in grads_np.items()}
    e = {k: torch.from_numpy(np.array(v[rank])) for k, v in errors_np.items()}
    mean, err = int8_allreduce(g, "data", e, mesh=mesh)
    return {"mean": mean, "err": err}


def _batch(batch_np, device="cpu"):
    """A numpy batch as tensors: token ids and labels int64, float
    embeddings (whisper's frames, pixtral's patches) in their own type."""
    return {k: (torch.from_numpy(np.array(v)).to(device) if np.asarray(v).dtype.kind == "f"
                else torch.from_numpy(np.array(v)).long().to(device))
            for k, v in batch_np.items()}


def _case_cfg(case):
    from repro_torch.configs.base import get_config
    return dataclasses.replace(get_config(case["arch"], reduced=True), dtype="float32",
                               **case.get("overrides", {}))


def _locals(tree):
    """keystr -> (local block, [tensor dim each mesh dim shards or None])
    of every leaf (an int leaf as it is)."""
    from repro_torch.checkpoint.checkpointer import leaf_paths
    return {path: ((x.to_local().clone(), [getattr(p, "dim", None) for p in x.placements])
                   if isinstance(x, torch.Tensor) else (x, None))
            for path, x in leaf_paths(tree)}


def sharded_worker(rank, mesh_shape, cases):
    """The port's sharded programs on a (data, model) mesh of ``mesh_shape``
    over every rank, one case after another.  A case is a dict: ``arch``
    (and config ``overrides``), ``kind``, JAX weights ``params`` and
    ``batch`` (numpy), ``thr`` (``dp_only_threshold``):

    * "grad": ``launch.train.loss_and_grads`` under ``Policy(cfg, mesh,
      "train", global_batch=B, dp_only_threshold=thr).ctx()`` on the placed
      parameters and batch -> the loss, this rank's gradient blocks, and
      (rank 0) the gradients whole;
    * "prefill": ``Server(cfg, params, ctx=Policy(cfg, mesh, "prefill",
      dp_only_threshold=thr).ctx()).prefill`` -> the last-position logits
      whole, (rank 0) every cache leaf whole, and the cache leaves whose
      placements are not those ``Policy.cache_shardings`` gives them under
      the policy's decode plan for the batch;
    * "steps": ``make_train_step`` on ``place_state`` of the initial
      {params, AdamW state}, one step per batch of ``batches`` -> this
      rank's blocks of the final state and (rank 0) its params whole;
    * "trainer": ``Trainer(cfg, B, S, ctx=policy.ctx())`` (its own
      initial weights, ``params`` unused) saving every 2 steps under
      ``store``: 3 steps, then ``restore(step=2)`` and 1 step again -> the
      losses and this rank's parameter blocks after the steps."""
    from repro_torch.checkpoint.checkpointer import leaf_paths
    from repro_torch.launch.mesh import make_small_mesh
    from repro_torch.launch.serve import Server
    from repro_torch.launch.sharding import (Policy, full_state, place, place_batch,
                                             place_state)
    from repro_torch.launch.train import loss_and_grads, make_train_step
    from repro_torch.models.model import Model, params_from_numpy
    from repro_torch.optim import adamw

    mesh = make_small_mesh(mesh_shape, device_type="cpu")
    out = {}
    for case in cases:
        t0 = time.perf_counter()
        cfg = _case_cfg(case)
        params = (None if case["params"] is None
                  else params_from_numpy(cfg, case["params"], device="cpu"))
        thr = case.get("thr", 1e9)
        res = {}
        if case["kind"] == "grad":
            batch = _batch(case["batch"])
            policy = Policy(cfg, mesh, "train", global_batch=batch["tokens"].shape[0],
                            dp_only_threshold=thr)
            ctx = policy.ctx()
            loss, _, grads = loss_and_grads(Model(cfg), place(
                params, policy.param_shardings(params)), place_batch(batch, policy), ctx)
            res["loss"] = float(loss.full_tensor())
            res["mode"] = ctx.rules.get("attn_mode")
            res["local"] = _locals(grads)
            whole = full_state(grads)
            if rank == 0:
                res["full"] = dict(leaf_paths(whole))
        elif case["kind"] == "prefill":
            batch = _batch(case["batch"])
            batch.pop("labels", None)
            policy = Policy(cfg, mesh, "prefill", dp_only_threshold=thr)
            srv = Server(cfg, params, ctx=policy.ctx(), max_len=case["max_len"],
                         device="cpu")
            logits, cache = srv.prefill(batch["tokens"], batch.get("frames"),
                                        batch.get("patch_embeds"))
            res["logits"] = logits.full_tensor()
            want = dict(leaf_paths(policy.cache_shardings(
                cache, policy.decode_plan(batch["tokens"].shape[0]))))
            res["misplaced"] = [path for path, t in leaf_paths(cache)
                                if list(t.placements) != list(want[path].placements)]
            whole = full_state(cache)
            if rank == 0:
                res["cache"] = dict(leaf_paths(whole))
        elif case["kind"] == "trainer":
            from repro_torch.checkpoint import CheckpointManager, LocalObjectStore
            from repro_torch.launch.train import Trainer
            policy = Policy(cfg, mesh, "train", global_batch=case["B"],
                            dp_only_threshold=thr)
            ckpt = CheckpointManager(LocalObjectStore(case["store"]), "trial",
                                     save_interval_steps=2)
            tr = Trainer(cfg, case["B"], case["S"], seed=0, ckpt=ckpt, val_every=1,
                         ctx=policy.ctx(), device="cpu")
            tr.run_steps(3)
            res["losses"] = list(tr.metrics_vals)
            res["local"] = _locals(tr.state["params"])
            tr.restore(step=2)
            res["restored_step"] = tr.step
            res["replayed"] = [v for _, v in tr.run_steps(1)]
        else:
            batches = [_batch(b) for b in case["batches"]]
            policy = Policy(cfg, mesh, "train", global_batch=batches[0]["tokens"].shape[0],
                            dp_only_threshold=thr)
            opt = adamw(case.get("lr", 3e-3), keep_master=(cfg.opt_precision == "fp32"))
            state = place_state({"params": params, "opt": opt.init(params)}, policy)
            step = make_train_step(Model(cfg), opt, policy.ctx())
            losses = []
            for b in batches:
                state, m = step(state, place_batch(b, policy))
                losses.append(float(m["loss"]))
            res["losses"] = losses
            res["local"] = _locals(state)
            whole = full_state(state["params"])
            if rank == 0:
                res["full"] = dict(leaf_paths(whole))
        res["seconds"] = time.perf_counter() - t0
        out[case["name"]] = res
    return out


def dryrun_cell(arch, shape, mesh_shape=(2, 4)):
    """The port's dry run of one cell in this process: a fake world of
    prod(mesh_shape) ranks (this process the last), the small (data, model)
    mesh on it, ``launch.dryrun.trace_cell`` ->
    (artifact, {kernel operator: calls}).  Meant for a child process of its
    own."""
    torch.set_num_threads(1)
    from repro_torch.launch.dryrun import trace_cell
    from repro_torch.launch.mesh import init_fake_world, make_small_mesh

    init_fake_world(int(np.prod(mesh_shape)))
    try:
        mesh = make_small_mesh(mesh_shape, device_type="cpu")
        art, counter = trace_cell(arch, shape, mesh)
        ops = {name: counter.launches(name)
               for name in ("flash_attention", "flash_attention_lse", "ssd_chunk",
                            "flash_attention_bwd", "ssd_chunk_bwd")}
        return art, ops
    finally:
        dist.destroy_process_group()


def ssm_decode_worker(rank, mesh_shape, cases, steps, max_len):
    """The port's ``Server`` on a (data, model) mesh of ``mesh_shape`` over
    every rank, for each case (a dict: ``name``, ``arch`` and config
    ``overrides``, JAX weights ``params`` and prompt ``tokens`` as numpy,
    whisper's ``frames``, the plan's ``batch``: B, or None for the
    "distributed" plan): the tokens ``generate`` gives under ``Policy(cfg,
    mesh, "decode").ctx(decode=True, batch=batch)``, with no mesh and, with
    ``prefill_ctx``, under ``Policy(cfg, mesh, "prefill").ctx()``; the
    prefill and ``steps - 1`` decode steps replayed on the generated
    tokens (every step's last-position logits of this rank's batch rows)
    and this rank's block of every cache leaf after them."""
    from repro_torch.checkpoint.checkpointer import leaf_paths
    from repro_torch.launch.mesh import make_small_mesh
    from repro_torch.launch.serve import Server
    from repro_torch.launch.sharding import Policy
    from repro_torch.models.model import params_from_numpy

    mesh = make_small_mesh(mesh_shape, device_type="cpu")
    out = {}
    for case in cases:
        cfg = _case_cfg(case)
        params = params_from_numpy(cfg, case["params"], device="cpu")
        tokens = case["tokens"]
        frames = (None if case.get("frames") is None
                  else torch.from_numpy(np.array(case["frames"])))
        batch = {"tokens": tokens, "frames": frames}
        ctx = Policy(cfg, mesh, "decode").ctx(decode=True, batch=case["batch"])
        srv = Server(cfg, params, ctx=ctx, max_len=max_len, device="cpu")
        gen = srv.generate(batch, steps)
        plan = ctx.decode_plan
        with torch.inference_mode():
            toks, fed = torch.as_tensor(tokens).long(), gen.long()
            if plan.b_axes:
                fed = srv._batch_slice(fed)
            logits, cache = srv.prefill(toks, frames)
            lgs = [logits[:, -1]]
            for i in range(steps - 1):
                lg, cache = srv.model.decode_step(srv.params, cache, fed[:, i:i + 1],
                                                  tokens.shape[1] + i, ctx)
                lgs.append(lg[:, -1])
        res = {"tokens": gen, "logits": torch.stack(lgs, 1),
               "plan": (plan.b_axes, plan.kv_axis, plan.seq_axes, plan.mode),
               "cache": {p: t.clone() for p, t in leaf_paths(cache)},
               "plain_tokens": Server(cfg, params, max_len=max_len,
                                      device="cpu").generate(batch, steps)}
        if case.get("prefill_ctx"):
            pre = Server(cfg, params, ctx=Policy(cfg, mesh, "prefill").ctx(),
                         max_len=max_len, device="cpu")
            res["prefill_ctx_tokens"] = pre.generate(batch, steps)
        out[case["name"]] = res
    return out
