"""The port's analytic counts and abstract inputs against the JAX package's.

For every arch of ``ARCH_IDS``: ``count_params_analytic`` (both
``active_only``), ``matmul_param_count`` and ``model_flops`` over every
shape of ``SHAPES`` (and the decode kind) equal the JAX package's with
``==``; they are counted from the shapes of the port's own ``Model.init`` on
the ``meta`` device.  For every (arch, shape): ``train_batch_shapes`` and
``prefill_batch_shapes`` at the shape's batch and length, and, for a decode
shape the arch runs, ``decode_input_shapes`` (the cache from the port's own
prefill on ``meta`` tensors, the JAX package's from ``eval_shape``), equal
in leaf paths, shapes and dtypes.  Token ids, labels and the position are
int64 in the port where the JAX package's are int32.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
import _torch_port  # noqa: F401  (one intra-op thread)

from repro.configs.base import ARCH_IDS, SHAPES, get_config as jget, shape_applicable
from repro.models import inputs as jinputs
from repro.models import model as jmodel
from repro_torch.checkpoint.checkpointer import leaf_paths
from repro_torch.configs.base import SHAPES as TSHAPES, get_config as tget
from repro_torch.models import inputs as tinputs
from repro_torch.models import model as tmodel

_DT = {jnp.dtype(jnp.float32): torch.float32, jnp.dtype(jnp.bfloat16): torch.bfloat16,
       jnp.dtype(jnp.int32): torch.int64}


def _jflat(tree) -> dict:
    return {jax.tree_util.keystr(p): (tuple(x.shape), _DT[jnp.dtype(x.dtype)])
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tflat(tree) -> dict:
    return {p: (tuple(x.shape), x.dtype) for p, x in leaf_paths(tree)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counts_equal_jax(arch):
    jcfg, tcfg = jget(arch), tget(arch)
    for active in (False, True):
        assert (tmodel.count_params_analytic(tcfg, active_only=active)
                == jmodel.count_params_analytic(jcfg, active_only=active))
    assert tmodel.matmul_param_count(tcfg) == jmodel.matmul_param_count(jcfg)
    for name in SHAPES:
        for kind in (None, "decode"):
            assert (tmodel.model_flops(tcfg, TSHAPES[name], kind)
                    == jmodel.model_flops(jcfg, SHAPES[name], kind)), (name, kind)
    # nothing was allocated: the shapes live on the meta device
    assert all(t.is_meta for t in tmodel.tree_leaves(tmodel._param_shapes(tcfg)))


@pytest.mark.parametrize("arch,shape", [(a, s) for a in ARCH_IDS for s in SHAPES])
def test_abstract_inputs_equal_jax(arch, shape):
    jcfg, tcfg = jget(arch), tget(arch)
    sp = SHAPES[shape]
    B, S = sp.global_batch, sp.seq_len
    for jfn, tfn in ((jinputs.train_batch_shapes, tinputs.train_batch_shapes),
                     (jinputs.prefill_batch_shapes, tinputs.prefill_batch_shapes)):
        got = tfn(tcfg, B, S)
        assert _tflat(got) == _jflat(jfn(jcfg, B, S))
        assert all(t.is_meta for t in got.values())
    if sp.kind != "decode" or not shape_applicable(jcfg, sp)[0]:
        return
    jt, jc, jp = jinputs.decode_input_shapes(jcfg, B, S)
    tt, tc, tp = tinputs.decode_input_shapes(tcfg, B, S)
    assert _tflat({"t": tt, "c": tc, "p": tp}) == _jflat({"t": jt, "c": jc, "p": jp})
    assert all(t.is_meta for _, t in leaf_paths(tc))
