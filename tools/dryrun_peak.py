"""What is alive at the traced peak of one rank in a dry-run cell.

    PYTHONPATH=src python tools/dryrun_peak.py --arch qwen3-32b --shape prefill_32k

Traces the cell as ``python -m repro_torch.launch.dryrun`` does (a fake
world of the mesh's size, this process its last rank) with
``CostCounter(attribute=True)`` and prints the storages alive at the
counter's peak, grouped by the operator that made them, their shape and
dtype and the port's line that called it, the largest first, then the
peak and the sum of each operator's groups.  Counts from shapes, no card:
no number here is a measurement of time.
"""

from __future__ import annotations

import argparse
import collections

import torch.distributed as dist

from repro_torch.launch.dryrun import MESH_SIZES, build_mesh, trace_cell
from repro_torch.launch.mesh import init_fake_world


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=sorted(MESH_SIZES))
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    init_fake_world(MESH_SIZES[args.mesh])
    try:
        art, counter = trace_cell(args.arch, args.shape, build_mesh(args.mesh),
                                  attribute=True)
    finally:
        dist.destroy_process_group()
    if counter is None:
        print(f"{args.arch} {args.shape}: skipped ({art['reason']})")
        return
    rows = counter.live_at_peak()
    print(f"{args.arch} {args.shape} on {args.mesh}: traced peak "
          f"{counter.peak / 1e9:.2f} GB a device, {len(rows)} groups alive")
    for n, count, (op, shape, dtype, where) in rows[:args.top]:
        print(f"  {n / 1e9:8.3f} GB  {count:4d} x {op} {list(shape)} {dtype}  {where}")
    by_op = collections.Counter()
    for n, _, (op, *_rest) in rows:
        by_op[op] += n
    print("  by operator: " + ", ".join(f"{op} {n / 1e9:.2f} GB"
                                         for op, n in by_op.most_common(8)))


if __name__ == "__main__":
    main()
