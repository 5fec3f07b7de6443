"""The port's dry run (``launch.dryrun.trace_cell``: one rank's program
traced on fake tensors of a fake (2, 4) world) against the JAX package's
``lower_cell`` on an 8-device mesh of Auto axes over ``tests/conftest.py``'s
fake host devices.

The cells are ``tests/test_system.py``'s two (qwen1.5-0.5b and mamba2-130m
``train_4k``), zamba2-1.2b and whisper-base ``decode_32k`` and mamba2-130m
``long_500k``.  Each port cell runs in a child process of its own, which
starts and ends its fake world (the cells run side by side, while this
process compiles the JAX ones).

* Must match: the artifact's keys and the memory dict's, the params and
  ``model_flops`` values (equal), each cell's FLOPs a device within
  0.75-1.33x of ``hlo_flops_per_device``, and each traced kernel
  operator's calls against the model's structure (under remat "full" a
  training step runs every layer's forward twice and its backward, on the
  backward kernels, once; a decode step runs no kernel).
* Printed, not gated: memory and collectives (XLA:CPU widens bf16 to f32
  and fuses; the port's memory is its traced peak).

``repro.launch.dryrun`` sets ``XLA_FLAGS`` at import; the test keeps and
restores the variable around the import.
"""

import concurrent.futures as cf
import multiprocessing as mp
import os

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from _torch_dist import dryrun_cell

CELLS = [("qwen1.5-0.5b", "train_4k"), ("mamba2-130m", "train_4k"),
         ("zamba2-1.2b", "decode_32k"), ("whisper-base", "decode_32k"),
         ("mamba2-130m", "long_500k")]
FLOPS_BAND = (0.75, 1.33)


@pytest.fixture(scope="module")
def runs():
    """{cell: (port artifact, port kernel calls, JAX artifact)}."""
    ctx = mp.get_context("spawn")
    with cf.ProcessPoolExecutor(max_workers=len(CELLS), mp_context=ctx) as pool:
        futures = {c: pool.submit(dryrun_cell, *c) for c in CELLS}
        flags = os.environ.get("XLA_FLAGS")
        try:
            from repro.launch import dryrun as jdry
        finally:
            if flags is None:
                os.environ.pop("XLA_FLAGS", None)
            else:
                os.environ["XLA_FLAGS"] = flags
        mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
        jax_arts = {c: jdry.lower_cell(*c, mesh, verbose=False) for c in CELLS}
        return {c: (*futures[c].result(timeout=600), jax_arts[c]) for c in CELLS}


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_dryrun_cell_matches_jax(arch, shape, runs):
    from repro_torch.configs.base import SHAPES, get_config

    art, ops, jart = runs[(arch, shape)]
    assert "error" not in art and "error" not in jart, (art.get("error"), jart.get("error"))
    assert set(art) == set(jart)
    assert set(art["memory"]) == set(jart["memory"])
    for key in ("params_total", "params_matmul_active", "model_flops", "n_devices",
                "mesh", "kind", "skipped"):
        assert art[key] == jart[key], key
    ratio = art["hlo_flops_per_device"] / jart["hlo_flops_per_device"]
    print(f"\n{arch} {shape}: FLOPs a device {art['hlo_flops_per_device']:.4e} "
          f"(JAX {jart['hlo_flops_per_device']:.4e}, {ratio:.3f}x); peak "
          f"{art['memory']['peak_memory_in_bytes'] / 2**30:.2f} GiB (JAX hbm "
          f"estimate {jart['memory']['hbm_estimate_bytes'] / 2**30:.2f} GiB); "
          f"collectives {art['collectives']} (JAX {jart['collectives']}); "
          f"kernel operators {ops}")
    cfg = get_config(arch)
    sp = SHAPES[shape]
    assert FLOPS_BAND[0] <= ratio <= FLOPS_BAND[1], ratio
    if sp.kind == "train":
        # each layer's backward once, on the backward kernels
        if cfg.family == "ssm":
            chunks = sp.seq_len // cfg.ssm_chunk
            assert ops == {"flash_attention": 0, "flash_attention_lse": 0,
                           "ssd_chunk": 2 * cfg.n_layers * chunks,
                           "flash_attention_bwd": 0, "ssd_chunk_bwd": cfg.n_layers * chunks}
        else:
            assert ops == {"flash_attention": 0, "flash_attention_lse": 2 * cfg.n_layers,
                           "ssd_chunk": 0, "flash_attention_bwd": cfg.n_layers,
                           "ssd_chunk_bwd": 0}
    else:
        # a decode step runs no kernel: its attention and state update are
        # plain PyTorch
        assert ops == {"flash_attention": 0, "flash_attention_lse": 0, "ssd_chunk": 0,
                       "flash_attention_bwd": 0, "ssd_chunk_bwd": 0}
    mem = art["memory"]
    assert mem["peak_memory_in_bytes"] >= mem["argument_size_in_bytes"] > 0
    assert mem["hbm_estimate_bytes"] == mem["peak_memory_in_bytes"]
    if sp.kind == "decode":                      # the cache, updated in place
        assert mem["alias_size_in_bytes"] > 0
