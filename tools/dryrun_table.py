"""The port's dry run beside the JAX package's, cell by cell, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/dryrun_table.py --mesh single --run

With ``--run`` it first runs both dry runs over every (arch x shape) cell:
the port's (``python -m repro_torch.launch.dryrun --all --force``, into
``artifacts/dryrun_torch/<mesh>/``) and the JAX package's ``lower_cell`` on
a mesh of Auto axes over fake host devices (``jax.make_mesh`` gives
Explicit axes, under which the JAX package's ``constrain`` raises), into
``artifacts/dryrun_jax_auto/<mesh>/``; the JAX package's own
``artifacts/dryrun/`` is not touched.  Then it prints a markdown table, an arch
a row and a shape a column: the port's traced per-device peak in GB
against the card's 80 GB and the JAX package's ``hbm_estimate_bytes``
beside it, its FLOPs a device, the dominant term of its
roofline at the H100's rates (``launch.roofline.H100_RATES``), and the
ratio of its FLOPs a device to the JAX package's count.  Counts from shapes, no card: no time here is a
measurement.

With ``--base ROOT`` (another checkout whose port dry run has been run,
e.g. the parent commit's ``git archive``) it prints instead a line a cell:
the port's traced peak and FLOPs a device in both checkouts, the change of
the peak, and both peaks and FLOPs against the JAX package's.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
JAX_DIR = ROOT / "artifacts" / "dryrun_jax_auto"
SIZES = {"small": (2, 4), "single": (16, 16), "multi": (2, 16, 16)}

_JAX_RUN = """
import json, os, sys, time
import numpy as np
import jax
from jax.sharding import Mesh
from repro.configs.base import ARCH_IDS, SHAPES
from repro.launch import dryrun
shape, out = {shape!r}, {out!r}
axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
n = int(np.prod(shape))
mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(shape), axes)
os.makedirs(out, exist_ok=True)
for arch in ARCH_IDS:
    for name in SHAPES:
        try:
            art = dryrun.lower_cell(arch, name, mesh, verbose=False)
        except Exception as e:
            art = {{"arch": arch, "shape": name, "error": f"{{type(e).__name__}}: {{e}}"}}
        with open(os.path.join(out, f"{{arch}}__{{name}}.json"), "w") as f:
            json.dump(art, f)
        print(arch, name, art.get("hlo_flops_per_device"), flush=True)
"""


def run(mesh: str) -> None:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
                    "--mesh", mesh, "--force"], check=True, env=env, cwd=ROOT)
    n = 1
    for s in SIZES[mesh]:
        n *= s
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
    code = _JAX_RUN.format(shape=SIZES[mesh], out=str(JAX_DIR / mesh))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=ROOT)


def _cell(art, jart, analyze, rates) -> str:
    """'peak GB a device, FLOPs a device, dominant term, FLOPs / JAX's'."""
    if art.get("skipped"):
        return "skipped"
    if art.get("error"):
        return f"failed: {art['error'][:60]}"
    peak = art["memory"]["peak_memory_in_bytes"] / 1e9
    jflops = jart.get("hlo_flops_per_device")
    ratio = (f"{art['hlo_flops_per_device'] / jflops:.2f}x" if jflops
             else f"JAX {jart.get('error', 'not run')[:40]}")
    jmem = jart.get("memory", {}).get("hbm_estimate_bytes")
    jgb = f" (JAX {jmem / 1e9:.1f})" if jmem else ""
    return (f"{peak:.1f}{'!' if peak > 80 else ''} GB{jgb}, "
            f"{art['hlo_flops_per_device']:.2e}, "
            f"{analyze(art, rates)['dominant'][:3]}, {ratio}")


def table(mesh: str) -> str:
    """One row an arch, one column a shape; a cell is the port's traced
    peak GB a device ("!" over the card's 80 GB; the JAX package's estimate
    in brackets), its FLOPs a device, the
    dominant roofline term at the H100's rates, and the FLOPs' ratio to
    the JAX package's count."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import ARCH_IDS, SHAPES
    from repro_torch.launch.roofline import H100_RATES, analyze, load_artifacts

    arts = {(a["arch"], a["shape"]): a for a in load_artifacts(mesh)}
    lines = ["| arch | " + " | ".join(SHAPES) + " |",
             "|---|" + "---|" * len(SHAPES)]
    for arch in ARCH_IDS:
        cells = []
        for shape in SHAPES:
            jpath = JAX_DIR / mesh / f"{arch}__{shape}.json"
            jart = json.loads(jpath.read_text()) if jpath.exists() else {}
            art = arts.get((arch, shape))
            cells.append("not run" if art is None
                         else _cell(art, jart, analyze, H100_RATES))
        lines.append(f"| {arch} | " + " | ".join(cells) + " |")
    return "\n".join(lines)


def _port_arts(root: Path, mesh: str) -> dict:
    d = root / "artifacts" / "dryrun_torch" / mesh
    return {(a["arch"], a["shape"]): a for a in
            (json.loads(p.read_text()) for p in sorted(d.glob("*.json")))}


def against(mesh: str, base: Path) -> str:
    """One line a traced cell: peak GB here and in ``base``, their ratio,
    the peak and FLOPs a device against the JAX package's."""
    new, old = _port_arts(ROOT, mesh), _port_arts(base, mesh)
    lines = ["arch shape: peak GB (base GB, new/base) | peak/JAX (base) | "
             "FLOPs/JAX (base)"]
    for key in sorted(new):
        a, b = new[key], old.get(key, {})
        if a.get("skipped") or "memory" not in a or "memory" not in b:
            continue
        jpath = JAX_DIR / mesh / f"{key[0]}__{key[1]}.json"
        jart = json.loads(jpath.read_text()) if jpath.exists() else {}
        jhbm = jart.get("memory", {}).get("hbm_estimate_bytes")
        jfl = jart.get("hlo_flops_per_device")
        pa, pb = a["memory"]["peak_memory_in_bytes"], b["memory"]["peak_memory_in_bytes"]
        fa, fb = a["hlo_flops_per_device"], b["hlo_flops_per_device"]
        rj = (f"{pa / jhbm:.3f}x ({pb / jhbm:.3f}x)" if jhbm else "no JAX")
        fj = (f"{fa / jfl:.3f}x ({fb / jfl:.3f}x)" if jfl else "no JAX")
        lines.append(f"{key[0]} {key[1]}: {pa / 1e9:.3f} GB ({pb / 1e9:.3f} GB, "
                     f"{pa / pb:.3f}) | {rj} | {fj}")
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single", choices=sorted(SIZES))
    ap.add_argument("--run", action="store_true",
                    help="run both dry runs first (the JAX one on the CPU)")
    ap.add_argument("--base", type=Path, default=None,
                    help="another checkout's root: compare its port artifacts")
    args = ap.parse_args()
    if args.run:
        run(args.mesh)
    print(table(args.mesh) if args.base is None else against(args.mesh, args.base))


if __name__ == "__main__":
    main()
