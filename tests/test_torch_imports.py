"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` load with
``jax`` and ``repro`` unimportable, and no file of theirs imports either."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]

_PROBE = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert not any(k == "jax" or k.startswith(("jax.", "repro.")) for k in sys.modules
               if sys.modules[k] is not None)
print(len(names))
print(" ".join(names))
"""


def test_port_imports_without_jax_or_reference():
    code = _PROBE.format(src=str(ROOT / "src"), root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    count, names = out.stdout.strip().splitlines()[-2:]
    assert int(count) >= 20
    # the training slices' and the service slice's modules load on their
    # own as well
    assert {"repro_torch.optim", "repro_torch.optim.optimizers",
            "repro_torch.core.orchestrator", "repro_torch.service.spec",
            "repro_torch.service.registry", "repro_torch.service.market",
            "repro_torch.service.loop",
            "repro_torch.tuner.equivalence",
            # the model's training path
            "repro_torch.data.pipeline", "repro_torch.optim.schedules",
            "repro_torch.optim.compression", "repro_torch.checkpoint",
            "repro_torch.checkpoint.object_store",
            "repro_torch.checkpoint.checkpointer",
            "repro_torch.launch.train"} <= set(names.split())


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported_modules(path)
           if m == "jax" or m.startswith("jax.") or m == "repro"
           or m.startswith("repro.")]
    assert not bad, f"{path.name} imports {bad}"
