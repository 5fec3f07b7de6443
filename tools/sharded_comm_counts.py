"""Collectives of one sharded train step, by kind: the port's on gloo ranks
of the CPU (``torch.distributed.tensor.debug.CommDebugMode`` on rank 0 over
one ``make_train_step`` step: forward, backward, AdamW) beside the JAX
package's compiled step of the same cell (``hlo_cost.module_cost`` of the
jitted step's optimized HLO, ``in_shardings`` as the dry run lays them
out), on fake host devices.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/sharded_comm_counts.py

A cell is a reduced float32 config (B = 4, S = 16) under ``Policy(cfg,
mesh, "train", global_batch=4, dp_only_threshold=0)`` on a (2, 4) mesh.
Counts, not times: the CPU says nothing of a card's collectives.  The
port's counts are DTensor's redistributions and the MoE body's own
collectives (funcol and c10d ops); the JAX counts are the HLO's
collective instructions (a while loop's body counted by its trip count).
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
from datetime import timedelta
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CELLS = [("qwen3-32b", (2, 4)), ("zamba2-1.2b", (2, 4)), ("deepseek-v2-236b", (2, 4))]
B, S = 4, 16


def _port_rank(rank, world, tmp, arch, mesh_shape, params_np, batch_np):
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT / "src"))
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg", rank=rank,
                            world_size=world, timeout=timedelta(seconds=120))
    try:
        from repro_torch.configs.base import get_config
        from repro_torch.launch.mesh import make_small_mesh
        from repro_torch.launch.sharding import Policy, place_batch, place_state
        from repro_torch.launch.train import make_train_step
        from repro_torch.models.model import Model, params_from_numpy
        from repro_torch.optim import adamw

        cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
        mesh = make_small_mesh(mesh_shape, device_type="cpu")
        policy = Policy(cfg, mesh, "train", global_batch=B, dp_only_threshold=0)
        opt = adamw(3e-3, keep_master=(cfg.opt_precision == "fp32"))
        params = params_from_numpy(cfg, params_np, device="cpu")
        state = place_state({"params": params, "opt": opt.init(params)}, policy)
        batch = place_batch({k: torch.from_numpy(np.array(v)).long()
                             for k, v in batch_np.items()}, policy)
        step = make_train_step(Model(cfg), opt, policy.ctx())
        state, _ = step(state, batch)                       # warm-up
        with CommDebugMode() as comm:
            step(state, batch)
        if rank == 0:
            counts = {str(k).split(".")[-1] if not hasattr(k, "__name__") else k.__name__: v
                      for k, v in comm.get_comm_counts().items()}
            Path(f"{tmp}/counts.json").write_text(json.dumps(counts))
    finally:
        dist.destroy_process_group()


def port_counts(arch, mesh_shape, params_np, batch_np) -> dict:
    import torch.multiprocessing as mp
    world = mesh_shape[0] * mesh_shape[1]
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_port_rank, args=(world, tmp, arch, mesh_shape, params_np,
                                             batch_np), nprocs=world, join=True,
                           start_method="spawn")
        return json.loads(Path(f"{tmp}/counts.json").read_text())


def jax_counts(cfg, params_np, batch_np, mesh_shape) -> dict:
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from repro.launch.hlo_cost import module_cost
    from repro.launch.sharding import Policy
    from repro.launch.train import make_train_step
    from repro.models.model import Model
    from repro.optim import adamw

    n = mesh_shape[0] * mesh_shape[1]
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(mesh_shape), ("data", "model"))
    policy = Policy(cfg, mesh, "train", global_batch=B, dp_only_threshold=0)
    opt = adamw(3e-3, keep_master=(cfg.opt_precision == "fp32"))
    state = {"params": params_np}
    state["opt"] = jax.eval_shape(opt.init, params_np)
    psh = policy.param_shardings(params_np)
    state_sh = {"params": psh, "opt": policy.opt_state_shardings(state["opt"], psh)}
    step = jax.jit(make_train_step(Model(cfg), opt, policy.ctx()),
                   in_shardings=(state_sh, policy.batch_shardings(batch_np)),
                   out_shardings=(state_sh, None))
    text = step.lower(state, batch_np).compile().as_text()
    return {k: int(v["count"]) for k, v in module_cost(text, n).collectives.items()}


def main():
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    sys.path.insert(0, str(ROOT / "src"))
    import jax
    import numpy as np
    from repro.configs.base import get_config
    from repro.models.inputs import sample_train_batch
    from repro.models.model import Model

    out = {}
    for arch, mesh_shape in CELLS:
        cfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
        params_np = jax.tree.map(np.asarray, jax.jit(Model(cfg).init)(jax.random.key(0)))
        batch_np = {k: np.asarray(v) for k, v in
                    sample_train_batch(np.random.default_rng(0), cfg, B, S).items()}
        out[arch] = {"mesh": list(mesh_shape),
                     "port": port_counts(arch, mesh_shape, params_np, batch_np),
                     "jax": jax_counts(cfg, params_np, batch_np, mesh_shape)}
        print(arch, mesh_shape, json.dumps(out[arch]), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
