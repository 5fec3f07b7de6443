"""The port's dry run on the production (16, 16) mesh against the JAX
package's, in the cells where the port once computed or held far more a
device than the reference.

The port traces each cell on a fake world of 256 ranks
(``_torch_dist.dryrun_cell``), one cell a spawned child, four children at
a time; the JAX package lowers the same cells with ``lower_cell`` on a
(16, 16) mesh of Auto axes over 256 fake host devices, in a child process
of its own (this process's JAX has the 8 devices of ``tests/conftest.py``;
the child's ``XLA_FLAGS`` asks for 256, this process's are left as they
are).  Counts from shapes, no time.

* FLOPs a device within ``FLOPS_BAND`` of the JAX package's: the decode of
  grok-1-314b and deepseek-v2-236b (each rank runs only its experts, or
  its share of every expert's hidden units, from its block of the
  weights), pixtral-12b's decode (the "HD" plan: q, k and v from the
  rank's block of their weights), and the prefill of the data-parallel-only
  qwen1.5-0.5b, whisper-base and mamba2-130m (each model rank on its own
  sequence block).
* The traced peak at most ``PEAK_RATIO`` times the JAX package's
  ``hbm_estimate_bytes``: qwen1.5-0.5b's train step (the sharded loss's
  gradient stays each rank's block), deepseek-v2-236b's prefill (MLA's
  attention over key chunks), grok-1-314b's decode (the rank's blocks
  of the weights), and, under the tensor-parallel rules with K/V heads that
  do not split the model axis ("expand"), qwen3-32b's prefill (each
  layer's cache in the decode plan's layout as it is made) and
  pixtral-12b's train step (the loss's logits of each rank's sequence
  block, never moved from the vocabulary's split to the sequence's).
"""

import concurrent.futures as cf
import json
import multiprocessing as mp
import os
import subprocess
import sys
from pathlib import Path

import pytest

from _torch_dist import dryrun_cell

MESH = (16, 16)
FLOPS_BAND = (0.75, 1.33)
PEAK_RATIO = 2.0
FLOPS_CELLS = [("grok-1-314b", "decode_32k"), ("deepseek-v2-236b", "decode_32k"),
               ("pixtral-12b", "decode_32k"), ("qwen1.5-0.5b", "prefill_32k"),
               ("whisper-base", "prefill_32k"), ("mamba2-130m", "prefill_32k")]
PEAK_CELLS = [("qwen1.5-0.5b", "train_4k"), ("deepseek-v2-236b", "prefill_32k"),
              ("grok-1-314b", "decode_32k"), ("qwen3-32b", "prefill_32k"),
              ("pixtral-12b", "train_4k")]
# longest first, so that the four children finish together
CELLS = [("deepseek-v2-236b", "prefill_32k"), ("pixtral-12b", "train_4k"),
         ("deepseek-v2-236b", "decode_32k"), ("qwen1.5-0.5b", "prefill_32k"),
         ("grok-1-314b", "decode_32k"), ("mamba2-130m", "prefill_32k"),
         ("pixtral-12b", "decode_32k"), ("qwen1.5-0.5b", "train_4k"),
         ("qwen3-32b", "prefill_32k"), ("whisper-base", "prefill_32k")]
ROOT = Path(__file__).resolve().parents[1]

_JAX_RUN = """
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh
from repro.launch import dryrun
cells = json.loads(sys.argv[1])
mesh = Mesh(np.asarray(jax.devices()[:256]).reshape(16, 16), ("data", "model"))
out = {}
for arch, shape in cells:
    art = dryrun.lower_cell(arch, shape, mesh, verbose=False)
    out[arch + "/" + shape] = {"flops": art["hlo_flops_per_device"],
                               "hbm": art["memory"]["hbm_estimate_bytes"]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs():
    """{cell: (port artifact, JAX {"flops", "hbm"})}."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=256",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    jax_run = subprocess.Popen([sys.executable, "-c", _JAX_RUN, json.dumps(CELLS)],
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True, env=env, cwd=ROOT)
    try:
        ctx = mp.get_context("spawn")
        with cf.ProcessPoolExecutor(max_workers=4, mp_context=ctx) as pool:
            futures = {c: pool.submit(dryrun_cell, *c, MESH) for c in CELLS}
            port = {c: futures[c].result(timeout=600)[0] for c in CELLS}
        out, err = jax_run.communicate(timeout=600)
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
    assert jax_run.returncode == 0, err[-2000:]
    jax_arts = json.loads(out.strip().splitlines()[-1])
    return {c: (port[c], jax_arts["/".join(c)]) for c in CELLS}


@pytest.mark.parametrize("arch,shape", FLOPS_CELLS,
                         ids=[f"{a}-{s}" for a, s in FLOPS_CELLS])
def test_flops_a_device_match_jax(arch, shape, runs):
    art, jart = runs[(arch, shape)]
    assert "error" not in art, art.get("error")
    ratio = art["hlo_flops_per_device"] / jart["flops"]
    print(f"\n{arch} {shape} on {MESH}: FLOPs a device {art['hlo_flops_per_device']:.4e}"
          f" (JAX {jart['flops']:.4e}, {ratio:.3f}x)")
    assert FLOPS_BAND[0] <= ratio <= FLOPS_BAND[1], ratio


@pytest.mark.parametrize("arch,shape", PEAK_CELLS,
                         ids=[f"{a}-{s}" for a, s in PEAK_CELLS])
def test_peak_within_twice_the_jax_estimate(arch, shape, runs):
    art, jart = runs[(arch, shape)]
    assert "error" not in art, art.get("error")
    peak = art["memory"]["peak_memory_in_bytes"]
    print(f"\n{arch} {shape} on {MESH}: traced peak {peak / 1e9:.2f} GB a device "
          f"(JAX estimate {jart['hbm'] / 1e9:.2f} GB, {peak / jart['hbm']:.2f}x)")
    assert peak <= PEAK_RATIO * jart["hbm"], (peak, jart["hbm"])
