"""The port's ``launch.roofline`` analysis against the JAX package's on the
same dry-run artifacts, with the simulated pool's (v5e) rates passed in:
``analyze`` row for row, ``table`` over a directory of artifacts (skipped
and failed cells left out), ``format_table``'s text and
``pick_hillclimb_targets``' picks equal.  The port's default rates are the
H100's (data sheet), and its pool constants keep the JAX package's values.
"""

import json

import pytest

from repro.launch import roofline as jroof
from repro_torch.kernels import hopper
from repro_torch.launch import roofline as troof


def _art(arch, shape, kind, flops, nbytes, coll, args_b, hbm, chips=256):
    return {"arch": arch, "shape": shape, "kind": kind, "skipped": False,
            "n_devices": chips, "mesh_name": "single",
            "hlo_flops_per_device": flops, "hlo_bytes_per_device": nbytes,
            "collective_bytes_total": coll, "collective_ring_bytes": coll * 1.5,
            "model_flops": flops * chips * 0.7,
            "memory": {"argument_size_in_bytes": args_b, "hbm_estimate_bytes": hbm},
            "collectives": {"all-reduce": {"count": 3.0, "bytes": coll,
                                           "ring_bytes": coll * 1.5}}}


ARTS = [
    _art("qwen1.5-0.5b", "train_4k", "train", 6.6e14, 3.5e13, 2.4e9, 8.6e9, 1.2e12),
    _art("mamba2-130m", "train_4k", "train", 1.5e14, 1.6e13, 5.1e8, 1.8e9, 4.0e11),
    _art("zamba2-1.2b", "decode_32k", "decode", 2.2e11, 4.0e11, 6.2e7, 3.3e10, 4.1e10),
    _art("whisper-base", "prefill_32k", "prefill", 1.0e12, 9.0e10, 9.9e11, 7.0e9, 9.1e9),
    {"arch": "grok-1-314b", "shape": "long_500k", "skipped": True, "reason": "quadratic"},
    {"arch": "grok-1-314b", "shape": "train_4k", "skipped": False, "error": "boom"},
]


@pytest.fixture
def art_dir(tmp_path, monkeypatch):
    (tmp_path / "single").mkdir()
    for a in ARTS:
        (tmp_path / "single" / f"{a['arch']}__{a['shape']}.json").write_text(json.dumps(a))
    monkeypatch.setattr(jroof, "ART_DIR", str(tmp_path))
    return str(tmp_path)


def test_analyze_equals_jax_at_the_pool_rates():
    for art in ARTS:
        assert troof.analyze(art, troof.POOL_RATES) == jroof.analyze(art)


def test_table_format_and_targets_equal_jax(art_dir):
    rows = troof.table("single", troof.POOL_RATES, art_dir)
    jrows = jroof.table("single")
    assert rows == jrows and len(rows) == 4
    assert troof.format_table(rows) == jroof.format_table(jrows)
    assert troof.pick_hillclimb_targets(rows) == jroof.pick_hillclimb_targets(jrows)
    assert troof.load_artifacts("single", art_dir) == jroof.load_artifacts("single")


def test_rates():
    assert troof.POOL_RATES == (jroof.PEAK_FLOPS, jroof.HBM_BW, jroof.LINK_BW)
    assert troof.H100_RATES == (989e12, 3.35e12, 450e9)
    assert troof.H100_RATES[:2] == (hopper.BF16_FLOPS, hopper.HBM_BYTES_PER_S)
    # at the card's rates the compute term of the first cell is its FLOPs
    # over the card's bf16 peak
    row = troof.analyze(ARTS[0])
    assert row["t_compute_s"] == ARTS[0]["hlo_flops_per_device"] / 989e12
