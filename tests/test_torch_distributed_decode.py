"""The port's sharded decode and ``int8_allreduce`` over spawned gloo ranks
against the JAX package's ``shard_map`` programs on fake host devices.

Decode: float32 reduced models, JAX-initialized weights carried across by
``params_from_numpy``, 8 prompt tokens and 8 greedy steps.  Each case runs
the port's ``Server`` on a mesh of spawned ranks under
``Policy(cfg, mesh, "decode").ctx(decode=True, batch=B)``, the JAX
``Server`` under the JAX policy's ctx on a ``Mesh`` of the same shape over
fake devices, and both packages' decode with no mesh:

* qwen1.5-0.5b, (2, 2), B=1: KV heads over ``model``, the cache sequence
  over ``data`` (the "kv" plan, distributed);
* qwen1.5-0.5b, (2, 2), B=2: batch over ``data``, KV heads over ``model``
  (local: no sequence collective, the tokens gathered over ``data``);
* qwen3-32b, (1, 4), B=1: KV = 2 heads do not split 4 ways, the head_dim
  does (the "HD" plan, local, the partial scores SUM-reduced over
  ``model``); held against JAX's ``shard_map`` decode too;
* qwen3-32b, (2, 4) on 8 ranks, B=1: the "HD" plan with the cache sequence
  over ``data`` (distributed);
* deepseek-v2 (MLA), (2, 2), B=1: the compressed cache's sequence over
  ``("data", "model")``, one process group of their product; B=2: batch
  over ``data``, sequence over ``model`` (its MoE "ep": each rank its
  experts);
* grok-1 (MoE "tp": its 4 experts split 2 ways by their hidden units, not
  by expert), (2, 2), B=1: KV heads over ``model``, the cache sequence
  over ``data`` (each rank routes the whole batch's tokens, so the
  experts' capacity is the no-mesh decode's).

Each rank keeps its block of the weights (``Server`` cuts them by
``Policy.param_shardings``).

Every rank's logits at every step are within 1e-5 (absolute, float32; the
packages differ by summation order, ~1e-6 seen) of JAX's sharded decode's
and of the port's decode with no mesh; the tokens are equal.

``int8_allreduce`` over a 2-rank ``data`` axis is bit-equal, means and
residuals, to JAX's under ``shard_map`` on 2 fake devices.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_port  # noqa: F401  (one intra-op thread)

from _torch_dist import decode_worker, int8_worker, run_ranks
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP
from repro.configs.base import get_config as jget
from repro.launch.sharding import Policy as JPolicy
from repro.models.model import Model as JModel
from repro.models.shard_compat import shard_map_unchecked
from repro.optim.compression import int8_allreduce as jint8
from repro_torch.configs.base import get_config as tget
from repro_torch.launch.serve import Server as TServer
from repro_torch.models.model import params_from_numpy

TOL = 1e-5
PROMPT, STEPS, MAX_LEN = 8, 8, 24

CASES = [
    ("qwen1.5-0.5b", (2, 2), 1, (None, "model", ("data",), "distributed")),
    ("qwen1.5-0.5b", (2, 2), 2, (("data",), "model", (), "local")),
    ("qwen3-32b", (1, 4), 1, (("data",), "HD", (), "local")),
    ("qwen3-32b", (2, 4), 1, (None, "HD", ("data",), "distributed")),
    ("deepseek-v2-236b", (2, 2), 1, (None, None, ("data", "model"), "distributed")),
    ("deepseek-v2-236b", (2, 2), 2, (("data",), None, ("model",), "distributed")),
    ("grok-1-314b", (2, 2), 1, (None, "model", ("data",), "distributed")),
]


def _cfgs(arch):
    return (dataclasses.replace(jget(arch, reduced=True), dtype="float32"),
            dataclasses.replace(tget(arch, reduced=True), dtype="float32"))


def _id(case):
    arch, shape, batch, _ = case
    return f"{arch}-{shape[0]}x{shape[1]}-B{batch}"


@pytest.fixture(scope="module")
def inputs():
    """(arch, batch) -> the JAX package's weights (key 0) as numpy, and the
    prompts; each arch initialized once."""
    params = {}

    def get(arch, batch):
        jcfg = _cfgs(arch)[0]
        if arch not in params:
            params[arch] = jax.tree.map(
                np.asarray, jax.jit(JModel(jcfg).init)(jax.random.key(0)))
        tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size,
                                                   (batch, PROMPT), dtype=np.int32)
        return params[arch], tokens
    return get


def _jax_mesh(shape):
    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), ("data", "model"))


def _jax_greedy(cfg, params, ctx, tokens):
    """JAX prefill and greedy decode steps (the JAX ``Server``'s) ->
    (tokens (B, STEPS), every step's logits (B, STEPS, V))."""
    m = JModel(cfg)
    pre = jax.jit(lambda p, t: m.prefill(p, {"tokens": t}, ctx, cache_len=MAX_LEN))
    step = jax.jit(lambda p, c, t, pos: m.decode_step(p, c, t, pos, ctx))
    lg, cache = pre(params, jnp.asarray(tokens))
    toks, out = [], [lg[:, -1]]
    for i in range(STEPS - 1):
        toks.append(jnp.argmax(lg[:, -1], axis=-1).astype(jnp.int32)[:, None])
        lg, cache = step(params, cache, toks[-1], jnp.int32(PROMPT + i))
        out.append(lg[:, -1])
    toks.append(jnp.argmax(lg[:, -1], axis=-1).astype(jnp.int32)[:, None])
    return (np.concatenate([np.asarray(t) for t in toks], 1),
            np.stack([np.asarray(x) for x in out], 1))


def _port_local(cfg, params_np, tokens):
    """The port's ``Server`` with no mesh -> (tokens, logits), as above."""
    srv = TServer(cfg, params_from_numpy(cfg, params_np, device="cpu"),
                  max_len=MAX_LEN, device="cpu")
    gen = srv.generate({"tokens": tokens}, STEPS)
    with torch.inference_mode():
        lg, cache = srv.prefill(torch.as_tensor(tokens).long())
        out = [lg[:, -1]]
        for i in range(STEPS - 1):
            lg, cache = srv.model.decode_step(srv.params, cache, gen[:, i:i + 1].long(),
                                              PROMPT + i)
            out.append(lg[:, -1])
    return gen.numpy(), torch.stack(out, 1).numpy()


#: cases one spawn of ranks runs (a spawn must end inside ``run_ranks``'
#: deadline under a loaded host)
SPAWN_CASES = 3


@pytest.fixture(scope="module")
def port_runs(inputs, tmp_path_factory):
    """The port's sharded decode of every case, a spawn of ranks for every
    ``SPAWN_CASES`` cases of a world size: {case id: each rank's result}."""
    done = {}

    def get(case):
        world = np.prod(case[1])
        same = [c for c in CASES if np.prod(c[1]) == world]
        part = same.index(case) // SPAWN_CASES
        cases = same[part * SPAWN_CASES:(part + 1) * SPAWN_CASES]
        if _id(case) not in done:
            res = run_ranks(decode_worker, world, tmp_path_factory.mktemp("ranks"),
                            [(a, s, *inputs(a, b)) for a, s, b, _ in cases],
                            STEPS, MAX_LEN)
            done.update({_id(c): [r[k] for r in res] for k, c in enumerate(cases)})
        return done
    return get


@pytest.mark.parametrize("arch,shape,batch,plan", CASES, ids=[_id(c) for c in CASES])
def test_sharded_decode_matches_jax(arch, shape, batch, plan, inputs, port_runs):
    jcfg, tcfg = _cfgs(arch)
    params, tokens = inputs(arch, batch)
    jctx = JPolicy(jcfg, _jax_mesh(shape), "decode").ctx(decode=True, batch=batch)
    jplan = jctx.decode_plan
    assert (jplan.b_axes, jplan.kv_axis, jplan.seq_axes, jplan.mode) == plan
    jtok, jlog = _jax_greedy(jcfg, params, jctx, tokens)
    want = {"jax_policy": jlog}
    if jctx.decode_attn == "local":          # JAX's shard_map form of the plan
        stok, want["jax_shard_map"] = _jax_greedy(
            jcfg, params, dataclasses.replace(jctx, decode_attn="distributed"), tokens)
        np.testing.assert_array_equal(stok, jtok)
    ltok, want["port_local"] = _port_local(tcfg, params, tokens)
    np.testing.assert_array_equal(ltok, jtok)

    case = (arch, shape, batch, plan)
    ranks = port_runs(case)[_id(case)]
    b_loc = batch // (shape[0] if plan[0] else 1)
    for rank, res in enumerate(ranks):
        assert res["plan"] == plan
        np.testing.assert_array_equal(res["tokens"].numpy(), jtok)
        rows = slice(0, batch)
        if plan[0]:                          # this rank's rows of the batch
            d = rank // shape[1]
            rows = slice(d * b_loc, (d + 1) * b_loc)
        for name, w in want.items():
            err = np.abs(res["logits"].numpy() - w[rows]).max()
            assert err <= TOL, (name, rank, err)
    # the caches were cut: a sequence-sharded plan holds MAX_LEN / shards slots
    n_seq = int(np.prod([dict(zip(("data", "model"), shape))[a] for a in plan[2]]))
    s_len = {s[2] for k, s in ranks[0]["cache_shapes"].items()
             if k.endswith(("/k", "/c_kv"))}
    assert s_len == {MAX_LEN // n_seq}


def test_int8_allreduce_two_ranks_bit_equal_jax(tmp_path):
    rng = np.random.default_rng(7)
    shapes = {"a": (3, 5), "b": (17,), "c": (4, 2, 3)}
    # rank 0's gradients ten times smaller than rank 1's: the scales differ
    grads = {k: (rng.standard_normal((2,) + s)
                 * np.array([0.1, 1.0]).reshape((2,) + (1,) * len(s))).astype(np.float32)
             for k, s in shapes.items()}
    errors = {k: (rng.standard_normal((2,) + s) * 1e-3).astype(np.float32)
              for k, s in shapes.items()}
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    spec = {k: JP("data") for k in shapes}
    jmean, jerr = shard_map_unchecked(
        lambda g, e: jint8(g, "data", e), mesh=mesh, in_specs=(spec, spec),
        out_specs=(spec, spec))(grads, errors)
    ranks = run_ranks(int8_worker, 2, tmp_path, grads, errors)
    for rank, res in enumerate(ranks):
        for k in shapes:
            np.testing.assert_array_equal(res["mean"][k].numpy()[None],
                                          np.asarray(jmean[k])[rank:rank + 1])
            np.testing.assert_array_equal(res["err"][k].numpy()[None],
                                          np.asarray(jerr[k])[rank:rank + 1])
    # the ranks agree on the mean
    for k in shapes:
        assert np.array_equal(ranks[0]["mean"][k].numpy(), ranks[1]["mean"][k].numpy())
