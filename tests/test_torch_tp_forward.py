"""The port's tensor- and sequence-parallel forward and backward against the
JAX package's sharded program, for the dense, ssm, hybrid, audio and vlm
families.

The port runs on spawned gloo ranks (one spawn per mesh for all its cases,
``_torch_dist.sharded_worker``): parameters and batch placed by its
``Policy`` as ``DTensor``s, ``ModelCtx.constrain`` redistributing at the
rule sites, the attention and the SSD chunks on each rank's local shard
under ``local_map``.  The JAX package runs ``jax.jit`` of the same loss and
gradient with the policy's ``in_shardings`` on a ``jax.sharding.Mesh`` of
the same shape over fake host devices (``_jax_sharded``).  Both take the
same ``Policy`` arguments, float32 reduced configs, JAX-initialized weights
(``params_from_numpy``) and the same ``sample_train_batch`` batch (B = 4,
S = 16).

Cases: on (2, 4) with ``dp_only_threshold=0`` (the TP rules), every
attention mode (qwen1.5-0.5b "kv", qwen3-32b "expand", internlm2-20b
"replicate"), ``ssm_x`` over the SSM heads (zamba2-1.2b, mamba2-130m) and
over the head dim (mamba2-130m with ``ssm_headdim=64``: 2 heads do not
split 4 ways, 64 does), audio (whisper-base) and vlm (pixtral-12b); on
(2, 4) under the default policy (DP-only: the residual's sequence over
``model``); on (2, 2), qwen1.5-0.5b under the default policy with the batch
split over ("data", "model") (one dim, two mesh dims) and qwen3-32b and
internlm2-20b in "kv" mode.

Limits, set before the first run: the loss within 1e-5 relative of JAX's
sharded loss; every gradient leaf within 1e-4 of its largest magnitude,
whole and as each rank's local block against JAX's ``addressable_shards``
at the same mesh coordinates (same shape); prefill's last-position logits
under ``Policy(cfg, mesh, "prefill")`` within 1e-4 of JAX's, and every
leaf of its cache within 1e-4 of the larger of 1 and JAX's leaf's largest
magnitude, each placed as ``Policy.cache_shardings`` lays it out under the
decode plan for the batch (JAX's prefill returns its cache in that layout,
``out_shardings``).  The prefill cases include qwen3-32b under the TP
rules, whose K/V heads do not split the model axis ("expand").
"""

import functools

import numpy as np
import pytest
import torch
import _torch_port  # noqa: F401  (one intra-op thread)

import _jax_sharded as J
from _torch_dist import run_ranks, sharded_worker

LOSS_TOL, GRAD_TOL, LOGIT_TOL = 1e-5, 1e-4, 1e-4
B, S = 4, 16
P_SHARDED = {"ssm_headdim": 64}

# name -> (mesh, arch, overrides, dp_only_threshold, attention mode)
GRAD = {
    "qwen-kv": ((2, 4), "qwen1.5-0.5b", {}, 0, "kv"),
    "qwen3-expand": ((2, 4), "qwen3-32b", {}, 0, "expand"),
    "internlm-replicate": ((2, 4), "internlm2-20b", {}, 0, "replicate"),
    "zamba2-ssm-heads": ((2, 4), "zamba2-1.2b", {}, 0, "kv"),
    "mamba2-ssm-heads": ((2, 4), "mamba2-130m", {}, 0, None),
    "mamba2-ssm-headdim": ((2, 4), "mamba2-130m", P_SHARDED, 0, None),
    "whisper-kv": ((2, 4), "whisper-base", {}, 0, "kv"),
    "pixtral-expand": ((2, 4), "pixtral-12b", {}, 0, "expand"),
    "qwen-dp-seq": ((2, 4), "qwen1.5-0.5b", {}, 1e9, "replicate"),
    "zamba2-dp-seq": ((2, 4), "zamba2-1.2b", {}, 1e9, "replicate"),
    "whisper-dp-seq": ((2, 4), "whisper-base", {}, 1e9, "replicate"),
    "qwen-dp-two-axes": ((2, 2), "qwen1.5-0.5b", {}, 1e9, "replicate"),
    "qwen3-kv-2x2": ((2, 2), "qwen3-32b", {}, 0, "kv"),
    "internlm-kv-2x2": ((2, 2), "internlm2-20b", {}, 0, "kv"),
}
# name -> (mesh, arch, overrides, dp_only_threshold)
PREFILL = {
    "qwen-prefill": ((2, 4), "qwen1.5-0.5b", {}, 0),
    "zamba2-prefill": ((2, 4), "zamba2-1.2b", {}, 0),
    "mamba2-prefill": ((2, 4), "mamba2-130m", {}, 1e9),
    "whisper-prefill": ((2, 4), "whisper-base", {}, 0),
    "pixtral-prefill": ((2, 4), "pixtral-12b", {}, 0),
    "internlm-prefill-2x2": ((2, 2), "internlm2-20b", {}, 1e9),
    "qwen3-expand-prefill": ((2, 4), "qwen3-32b", {}, 0),
}


@functools.lru_cache(maxsize=None)
def _inputs(arch, overrides: tuple):
    cfg = J.cfg_of(arch, **dict(overrides))
    return cfg, J.init_numpy(cfg), J.batch_numpy(cfg, B, S)


def _cases(mesh):
    out = []
    for name, (m, arch, ov, thr, _) in GRAD.items():
        if m == mesh:
            _, p, b = _inputs(arch, tuple(ov.items()))
            out.append({"name": name, "kind": "grad", "arch": arch, "overrides": ov,
                        "thr": thr, "params": p, "batch": b})
    for name, (m, arch, ov, thr) in PREFILL.items():
        if m == mesh:
            _, p, b = _inputs(arch, tuple(ov.items()))
            out.append({"name": name, "kind": "prefill", "arch": arch, "overrides": ov,
                        "thr": thr, "params": p, "batch": b, "max_len": S})
    return out


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Every case of a mesh, run on one spawn of its ranks (lazily)."""
    runs = {}

    def get(mesh):
        if mesh not in runs:
            try:
                runs[mesh] = run_ranks(sharded_worker, mesh[0] * mesh[1],
                                       tmp_path_factory.mktemp("ranks"), mesh,
                                       _cases(mesh), deadline=600)
            except Exception as e:      # one spawn a mesh, failed or not
                runs[mesh] = e
        if isinstance(runs[mesh], Exception):
            raise runs[mesh]
        return runs[mesh]
    return get


@functools.lru_cache(maxsize=None)
def _jax_grad(name):
    mesh, arch, ov, thr, _ = GRAD[name]
    cfg, p, b = _inputs(arch, tuple(ov.items()))
    loss, grads, jmesh = J.sharded_loss_and_grads(cfg, p, b, mesh, thr)
    return loss, J.flat(grads), J.blocks(grads, jmesh)


def _close(got, want, scale):
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) <= GRAD_TOL * max(scale, 1e-30)


@pytest.mark.parametrize("name", list(GRAD))
def test_sharded_loss_matches_jax(name, port_runs):
    mesh, _, _, _, mode = GRAD[name]
    got = port_runs(mesh)[0][name]
    want = _jax_grad(name)[0]
    assert got["mode"] == mode
    assert abs(got["loss"] - want) <= LOSS_TOL * abs(want), (got["loss"], want)
    # every rank reduces to the same loss
    assert len({r[name]["loss"] for r in port_runs(mesh)}) == 1


@pytest.mark.parametrize("name", list(GRAD))
def test_sharded_gradients_match_jax(name, port_runs):
    mesh = GRAD[name][0]
    got = port_runs(mesh)[0][name]["full"]
    want = _jax_grad(name)[1]
    assert set(got) == set(want)
    bad = [path for path in want
           if not _close(got[path], want[path], np.max(np.abs(want[path])))]
    assert not bad, bad


@pytest.mark.parametrize("name", list(GRAD))
def test_local_gradient_blocks_match_jax_shards(name, port_runs):
    mesh = GRAD[name][0]
    full, blocks = _jax_grad(name)[1], _jax_grad(name)[2]
    sharded = 0
    for rank, res in enumerate(port_runs(mesh)):
        for path, (local, dims) in res[name]["local"].items():
            want = blocks[path][rank]
            assert tuple(local.shape) == want.shape, (path, rank)
            assert _close(local, want, np.max(np.abs(full[path]))), (path, rank)
            sharded += any(d is not None for d in dims)
    thr = GRAD[name][3]
    assert (sharded > 0) == (thr == 0)    # DP-only replicates every leaf


@functools.lru_cache(maxsize=None)
def _jax_prefill(name):
    mesh, arch, ov, thr = PREFILL[name]
    cfg, p, b = _inputs(arch, tuple(ov.items()))
    return J.prefill(cfg, p, {k: v for k, v in b.items() if k != "labels"}, mesh, thr)


@pytest.mark.parametrize("name", list(PREFILL))
def test_sharded_prefill_matches_jax(name, port_runs):
    mesh = PREFILL[name][0]
    want = _jax_prefill(name)[0]
    got = port_runs(mesh)[0][name]["logits"].numpy()
    assert got.shape == want.shape
    assert float(np.max(np.abs(got - want))) <= LOGIT_TOL


@pytest.mark.parametrize("name", list(PREFILL))
def test_sharded_prefill_cache_matches_jax_in_the_plans_layout(name, port_runs):
    """Every cache leaf within 1e-4 of the largest |value| of JAX's, and
    on every rank each leaf placed as ``Policy.cache_shardings`` lays it
    out (the layout the JAX package's prefill returns its cache in)."""
    runs = port_runs(PREFILL[name][0])
    want = _jax_prefill(name)[1]
    got = runs[0][name]["cache"]
    assert set(got) == set(want)
    bad = [path for path in want
           if not (tuple(got[path].shape) == want[path].shape
                   and float(np.max(np.abs(got[path].double().numpy() - want[path])))
                   <= LOGIT_TOL * max(float(np.max(np.abs(want[path]))), 1.0))]
    assert not bad, bad
    assert all(not r[name]["misplaced"] for r in runs), [r[name]["misplaced"]
                                                         for r in runs]
