"""Rates and the three-term roofline of the dry run's artifacts (the port of
``repro.launch.roofline``).

Two sets of rates live here, and they mean different things:

* ``PEAK_FLOPS`` / ``HBM_BW`` / ``LINK_BW``: the simulated instance pool's
  per-chip rates.  The tuner bills trials on a simulated pool of TPU v5e
  slices (``core.market.DEFAULT_POOL``), kept identical to the JAX
  package's for parity, and a training trial's virtual seconds a step come
  from these rates (``backends.training._roofline_seconds``).  They are
  data of the simulation, no rate of the card the port runs on.
* ``H100_RATES``: the card's, the H100 SXM data sheet's dense bf16 on the
  tensor cores, HBM3 and NVLink 4 one way (``kernels.hopper``).  The dry
  run's roofline takes them by default.

Per (arch x shape x mesh), from the port's dry-run artifacts
(``launch.dryrun``, ``artifacts/dryrun_torch/<mesh>/``):

    compute    = FLOPs a device      / peak FLOP/s
    memory     = bytes a device      / HBM bytes/s
    collective = collective bytes    / link bytes/s

The counts are ``launch.cost``'s of one rank's traced program.  Also
derived: MODEL_FLOPS = 6 N_active D (train) / 2 N_active D (serve), the
useful-compute ratio MODEL / counted, the dominant term, and the roofline
fraction, MODEL_FLOPS' time at peak over the largest term (for a decode,
one sweep of the per-device arguments through HBM).  ``analyze``,
``table`` and ``pick_hillclimb_targets`` take the rates as arguments; with
the simulated pool's rates they give the JAX package's numbers on the same
artifacts.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

from repro_torch.kernels import hopper

#: simulated pool, per chip: peak bf16 FLOP/s
PEAK_FLOPS = 197e12
#: simulated pool, per chip: HBM bytes/s
HBM_BW = 819e9
#: simulated pool, per link: interconnect bytes/s
LINK_BW = 50e9
#: the simulated pool's rates as (peak FLOP/s, HBM bytes/s, link bytes/s)
POOL_RATES = (PEAK_FLOPS, HBM_BW, LINK_BW)
#: the card's (H100 SXM data sheet): dense bf16, HBM3, NVLink 4 one way
H100_RATES = (hopper.BF16_FLOPS, hopper.HBM_BYTES_PER_S, hopper.NVLINK_BYTES_PER_S)

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "artifacts", "dryrun_torch")


def load_artifacts(mesh: str = "single", art_dir: str = ART_DIR) -> List[dict]:
    out = []
    for p in sorted(glob.glob(os.path.join(art_dir, mesh, "*.json"))):
        with open(p) as f:
            out.append(json.load(f))
    return out


def analyze(art: dict, rates=H100_RATES) -> Optional[dict]:
    """One artifact's roofline row at ``rates`` (peak FLOP/s, HBM bytes/s,
    link bytes/s), or None for a skipped or failed cell."""
    if art.get("skipped") or art.get("error"):
        return None
    peak, hbm, link = rates
    chips = art["n_devices"]
    flops_dev = art["hlo_flops_per_device"]
    bytes_dev = art["hlo_bytes_per_device"]
    coll_dev = art["collective_bytes_total"]
    ring_dev = art["collective_ring_bytes"]

    t_compute = flops_dev / peak
    t_memory = bytes_dev / hbm
    t_coll = coll_dev / link
    t_coll_ring = ring_dev / link

    model_fl = art["model_flops"]
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    # train/prefill: MODEL_FLOPS at peak; decode is bandwidth-bound, its
    # ideal one sweep of the per-device arguments (weights + cache)
    if art["kind"] == "decode":
        t_model = art["memory"]["argument_size_in_bytes"] / hbm
    else:
        t_model = model_fl / (chips * peak)
    return {
        "arch": art["arch"],
        "shape": art["shape"],
        "mesh": art.get("mesh_name", "single"),
        "chips": chips,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "t_collective_ring_s": t_coll_ring,
        "dominant": dominant,
        "model_flops": model_fl,
        "hlo_flops_total": flops_dev * chips,
        "useful_ratio": model_fl / max(flops_dev * chips, 1.0),
        "t_model_ideal_s": t_model,
        "roofline_fraction": t_model / max(bound, 1e-12),
        "hbm_gib": art["memory"]["hbm_estimate_bytes"] / 2 ** 30,
        "collectives": art["collectives"],
    }


def table(mesh: str = "single", rates=H100_RATES, art_dir: str = ART_DIR) -> List[dict]:
    rows = []
    for art in load_artifacts(mesh, art_dir):
        r = analyze(art, rates)
        if r:
            rows.append(r)
    return rows


def format_table(rows: List[dict]) -> str:
    hdr = (f"{'arch':18s} {'shape':12s} {'comp(s)':>9s} {'mem(s)':>9s} "
           f"{'coll(s)':>9s} {'dom':>5s} {'MODEL/HLO':>9s} {'roofline%':>9s} "
           f"{'HBM GiB':>8s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r['arch']:18s} {r['shape']:12s} {r['t_compute_s']:9.3e} "
            f"{r['t_memory_s']:9.3e} {r['t_collective_s']:9.3e} "
            f"{r['dominant'][:4]:>5s} {r['useful_ratio']:9.3f} "
            f"{100 * r['roofline_fraction']:8.1f}% {r['hbm_gib']:8.2f}")
    return "\n".join(lines)


def pick_hillclimb_targets(rows: List[dict]) -> Dict[str, dict]:
    """The worst roofline fraction, the most collective-bound cell, and the
    paper-representative one (qwen1.5-0.5b's train cell: the model the
    end-to-end tuning example trains)."""
    candidates = [r for r in rows if r["roofline_fraction"] > 0]
    worst = min(candidates, key=lambda r: r["roofline_fraction"])
    coll = max(candidates, key=lambda r: r["t_collective_s"] /
               max(r["t_compute_s"], 1e-12))
    rep = next((r for r in rows if r["arch"] == "qwen1.5-0.5b"
                and r["shape"] == "train_4k"), rows[0])
    return {"worst_fraction": worst, "most_collective_bound": coll,
            "paper_representative": rep}


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="the roofline of the port's dry-run "
                                 "artifacts, at the H100's rates by default")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--peak-flops", type=float, default=H100_RATES[0])
    ap.add_argument("--hbm-bw", type=float, default=H100_RATES[1])
    ap.add_argument("--link-bw", type=float, default=H100_RATES[2])
    args = ap.parse_args(argv)
    rows = table(args.mesh, (args.peak_flops, args.hbm_bw, args.link_bw))
    print(format_table(rows))
    print()
    targets = pick_hillclimb_targets(rows)
    for k, r in targets.items():
        print(f"{k}: {r['arch']} x {r['shape']} (dominant={r['dominant']}, "
              f"roofline={100*r['roofline_fraction']:.1f}%)")


if __name__ == "__main__":
    main()
