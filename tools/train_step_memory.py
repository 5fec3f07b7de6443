"""The card's memory around bf16 ``Trainer`` steps, on a (1, 1) mesh of a
NCCL group of one and with no mesh.

    python tools/train_step_memory.py [--arch zamba2-1.2b] [--batch 2] [--seq 512]

Needs a CUDA card.  Builds the kernels, then for each path: the memory
allocated after the Trainer is built, after each of two steps
(``torch.cuda.memory_allocated``) and each step's peak
(``max_memory_allocated``), and, from the caching allocator's record of
allocations (``torch.cuda.memory._record_memory_history``), the blocks
still allocated after the second step, summed by the line of the port
that made them ("??" where the allocation carried no Python frame: the
backward's own thread).  This is what ``chip_smoke.py``'s dry-run phase
measures beside the traced peak.
"""

from __future__ import annotations

import argparse
import collections
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _where(frames) -> str:
    port = [f for f in frames if "repro_torch" in f["filename"]]
    f = (port or frames or [{"filename": "??", "line": 0, "name": "??"}])[0]
    return f"{f['filename'].split('src/')[-1]}:{f['line']} {f['name']}"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-1.2b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=512)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import init_world_of_one, make_small_mesh
    from repro_torch.launch.sharding import Policy
    from repro_torch.launch.train import Trainer

    build.build_all()
    cfg = get_config(args.arch)
    for on_mesh in (True, False):
        torch.cuda.memory._record_memory_history(max_entries=1_000_000)
        ctx = None
        if on_mesh:
            init_world_of_one("cuda")
            ctx = Policy(cfg, make_small_mesh((1, 1), device_type="cuda"), "train",
                         global_batch=args.batch).ctx()
        tr = Trainer(cfg, batch=args.batch, seq=args.seq, lr=1e-3, val_every=1,
                     ctx=ctx, device="cuda")
        torch.cuda.synchronize()
        print(f"{cfg.name}, B = {args.batch} x {args.seq}, "
              f"{'(1, 1) mesh' if on_mesh else 'no mesh'}: after the Trainer "
              f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
        for step in (1, 2):
            torch.cuda.reset_peak_memory_stats()
            tr.run_steps(1)
            torch.cuda.synchronize()
            print(f"  after step {step} {torch.cuda.memory_allocated() / 1e9:.3f} GB, "
                  f"its peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        snap = torch.cuda.memory._snapshot()
        torch.cuda.memory._record_memory_history(enabled=None)
        held = collections.Counter()
        for seg in snap["segments"]:
            for b in seg["blocks"]:
                if b["state"] == "active_allocated":
                    held[_where(b.get("frames", []))] += b["size"]
        for where, n in held.most_common(8):
            print(f"    {n / 1e9:8.3f} GB  {where}")
        del tr
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
