"""The port's sharding policy (``repro_torch.launch.sharding``) against the
JAX package's, on a 16x16 mesh of no devices: the port's ``MeshShape``
against JAX's ``AbstractMesh``.

For every arch of ``ARCH_IDS`` and both policy kinds the two packages emit,
leaf for leaf (the same ``keystr`` paths), equal specs for every parameter,
optimizer-state, batch and decode-cache leaf; the attention modes,
``dp_only`` and the decode plans are those of
``tests/test_sharding_policy.py``.  Specs compare exactly, entry by entry;
there is no tolerance.  The port's parameter and optimizer trees are its
own (``Model.init`` and ``adamw`` on the ``meta`` device); the batch and
cache shapes are the JAX package's abstract ones, handed to the port as
``meta`` tensors.
"""

import jax
import numpy as np
import pytest
import torch
import _torch_port  # noqa: F401  (one intra-op thread)

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_config as jget
from repro.launch.sharding import Policy as JPolicy
from repro.models import inputs as jinputs
from repro.models.model import Model as JModel
from repro.optim import adamw as jadamw
from repro_torch.collectives import MeshShape, P
from repro_torch.configs.base import get_config as tget
from repro_torch.checkpoint.checkpointer import leaf_paths
from repro_torch.launch.sharding import DecodePlan, Policy, to_placements
from repro_torch.models.model import Model as TModel
from repro_torch.optim import adamw as tadamw
from test_sharding_policy import _mesh_16x16_abstract

MESH = MeshShape((16, 16), ("data", "model"))
KINDS = ("train", "decode")


def _jax_specs(tree):
    """keystr -> spec tuple of a tree of JAX NamedShardings."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): tuple(s.spec) for p, s in flat}


def _port_specs(tree):
    return {path: tuple(s.spec) for path, s in leaf_paths(tree)}


def _meta(tree):
    """A JAX tree of ShapeDtypeStructs as the port's nested dicts of meta
    tensors (the shapes only matter)."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return torch.empty(tree.shape, device="meta")


@pytest.fixture(scope="module")
def jmesh():
    return _mesh_16x16_abstract()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_specs_equal(arch, kind, jmesh):
    jcfg, tcfg = jget(arch), tget(arch)
    jpol = JPolicy(jcfg, jmesh, kind, global_batch=256)
    tpol = Policy(tcfg, MESH, kind, global_batch=256)
    assert (tpol.dp_only, tpol.data_axes, tpol.dsize, tpol.fsdp_axis) == (
        jpol.dp_only, jpol.data_axes, jpol.dsize, jpol.fsdp_axis)

    jshapes = jax.eval_shape(JModel(jcfg).init, jax.random.key(0))
    jsh = jpol.param_shardings(jshapes)
    tparams = TModel(tcfg).init(None, device="meta")
    tsh = tpol.param_shardings(tparams)
    want, got = _jax_specs(jsh), _port_specs(tsh)
    assert set(got) == set(want)
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, bad

    keep = jcfg.opt_precision == "fp32"
    jopt = jax.eval_shape(jadamw(1e-3, keep_master=keep).init, jshapes)
    topt = tadamw(1e-3, keep_master=keep).init(tparams)
    want = _jax_specs(jpol.opt_state_shardings(jopt, jsh))
    got = _port_specs(tpol.opt_state_shardings(topt, tsh))
    assert set(got) == set(want) and "['step']" in got
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, bad


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_equal(arch, jmesh):
    jcfg, tcfg = jget(arch), tget(arch)
    seq = 64 + (jcfg.n_patches if jcfg.family == "vlm" else 0)
    for batch in (256, 3):
        jpol = JPolicy(jcfg, jmesh, "train")
        tpol = Policy(tcfg, MESH, "train")
        shapes = jinputs.train_batch_shapes(jcfg, batch, seq)
        assert (_port_specs(tpol.batch_shardings(_meta(shapes)))
                == _jax_specs(jpol.batch_shardings(shapes)))
    _, cache, _ = jinputs.decode_input_shapes(jcfg, 2, seq)
    for batch in (128, 1):
        jpol = JPolicy(jcfg, jmesh, "decode")
        tpol = Policy(tcfg, MESH, "decode")
        jplan, tplan = jpol.decode_plan(batch), tpol.decode_plan(batch)
        assert (tplan.b_axes, tplan.kv_axis, tplan.seq_axes, tplan.mode) == (
            jplan.b_axes, jplan.kv_axis, jplan.seq_axes, jplan.mode)
        assert (_port_specs(tpol.cache_shardings(_meta(cache), tplan))
                == _jax_specs(jpol.cache_shardings(cache, jplan)))


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("decode", [False, True])
def test_ctx_rules_equal(arch, decode, jmesh):
    """Every rule of ``Policy.ctx`` (activation specs, ``attn_mode``) and the
    ctx's axes, under the TP policy (dp_only_threshold=0) and the default."""
    for threshold in (0, 1e9):
        jctx = JPolicy(jget(arch), jmesh, "decode" if decode else "train",
                       dp_only_threshold=threshold).ctx(decode=decode, batch=128)
        tctx = Policy(tget(arch), MESH, "decode" if decode else "train",
                      dp_only_threshold=threshold).ctx(decode=decode, batch=128)
        norm = {k: tuple(v) if not isinstance(v, str) else v
                for k, v in jctx.rules.items()}
        assert {k: tuple(v) if not isinstance(v, str) else v
                for k, v in tctx.rules.items()} == norm
        assert (tctx.data_axes, tctx.fsdp_axis, tctx.model_axis, tctx.remat,
                tctx.decode_attn) == (jctx.data_axes, jctx.fsdp_axis,
                                      jctx.model_axis, jctx.remat, jctx.decode_attn)
        assert tctx.groups is None            # a MeshShape has no processes


def test_attention_modes_match_design():
    expect = {
        "phi3-mini-3.8b": "kv", "qwen1.5-0.5b": "kv", "internlm2-20b": "expand",
        "qwen3-32b": "expand", "pixtral-12b": "expand", "grok-1-314b": "expand",
        "zamba2-1.2b": "kv", "whisper-base": "replicate",
    }
    for arch, mode in expect.items():
        ctx = Policy(tget(arch), MESH, "train", dp_only_threshold=0).ctx()
        assert ctx.rules.get("attn_mode") == mode, arch


def test_dp_only_policy_for_small_models():
    for arch, expected in (("qwen1.5-0.5b", True), ("mamba2-130m", True),
                           ("whisper-base", True), ("phi3-mini-3.8b", False),
                           ("grok-1-314b", False)):
        pol = Policy(tget(arch), MESH, "train", global_batch=256)
        assert pol.dp_only == expected, arch
        if expected:
            assert all(a is None for a in pol.param_spec("['unembed']", (1024, 151936)))
            assert pol.dsize == 256
    assert not Policy(tget("qwen1.5-0.5b"), MESH, "decode", global_batch=128).dp_only


def test_decode_plans():
    plan = Policy(tget("deepseek-v2-236b"), MESH, "decode").decode_plan(128)
    assert plan.mode == "distributed" and "model" in plan.seq_axes
    plan = Policy(tget("qwen3-32b"), MESH, "decode").decode_plan(128)
    assert plan.mode == "local" and plan.kv_axis == "HD"
    plan = Policy(tget("phi3-mini-3.8b"), MESH, "decode").decode_plan(128)
    assert plan.mode == "local" and plan.kv_axis == "model"
    plan = Policy(tget("zamba2-1.2b"), MESH, "decode").decode_plan(1)
    assert plan == DecodePlan(None, "model", ("data",), "distributed")


def test_multi_pod_mesh_specs_equal():
    """The 2x16x16 mesh: data axes ('pod', 'data'), FSDP over data only."""
    from jax.sharding import AbstractMesh
    try:
        jm = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    except TypeError:
        jm = AbstractMesh((("pod", 2), ("data", 16), ("model", 16)))
    tm = MeshShape((2, 16, 16), ("pod", "data", "model"))
    for arch in ("qwen3-32b", "deepseek-v2-236b"):
        jpol, tpol = JPolicy(jget(arch), jm, "train"), Policy(tget(arch), tm, "train")
        assert tpol.data_axes == jpol.data_axes == ("pod", "data")
        jshapes = jax.eval_shape(JModel(jget(arch)).init, jax.random.key(0))
        assert (_port_specs(tpol.param_shardings(TModel(tget(arch)).init(None, device="meta")))
                == _jax_specs(jpol.param_shardings(jshapes)))
        assert tuple(tpol.ctx(decode=True, batch=512).rules["residual"]) == tuple(
            jpol.ctx(decode=True, batch=512).rules["residual"])


def test_partition_spec_normalizes_as_jax():
    from jax.sharding import PartitionSpec as JP
    for entries in [((),), (("data",),), (["data", "model"],),
                    (("data", "model"), None), (None, ()), ()]:
        assert tuple(P(*entries)) == tuple(JP(*entries))


def test_placements_of_specs():
    """A dim split by two axes takes both mesh dims in mesh order (JAX's
    major-to-minor); an axis out of mesh order cannot be expressed."""
    from torch.distributed.tensor import Replicate, Shard

    m = MeshShape((2, 2), ("data", "model"))
    assert to_placements(P(None, ("data", "model")), m) == [Shard(1), Shard(1)]
    assert to_placements(P("model", None), m) == [Replicate(), Shard(0)]
    with pytest.raises(ValueError):
        to_placements(P(("model", "data")), m)
    assert np.prod(list(m.shape.values())) == m.size == 4
