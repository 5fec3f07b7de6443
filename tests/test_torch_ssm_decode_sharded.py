"""The ssm, hybrid and audio families' decode on a mesh: the port's
``Server`` on spawned gloo ranks against the JAX package's jitted
``decode_step`` under ``in_shardings`` (the decode cell of
``repro.launch.dryrun``: the policy's parameter shardings, the cache laid
out by ``Policy.cache_shardings``, the tokens by its batch shardings) on a
mesh of Auto axes over the fake host devices.

Reduced float32 mamba2-130m, zamba2-1.2b and whisper-base, JAX-initialized
weights carried across by ``params_from_numpy``, 8 prompt tokens and 8
greedy steps on meshes (2, 2) and (2, 4), a spawn of ranks for every
``SPAWN_CASES`` cases of a mesh (a spawn must end inside ``run_ranks``'
deadline under a loaded host).  The cases
cover the "local" plan (the batch over "data") and the "distributed" one
(``batch=None``: the attention caches' sequence, and whisper's cross
cache, over "data"), and the three branches of the SSM state's rule on the
(2, 4) mesh: its heads split over "model" (8 heads), only its head dim
does (``ssm_headdim=64``: 2 heads of 64), neither does (``d_model=36,
ssm_expand=1, ssm_headdim=6``: 6 heads of 6).

Checks: every step's logits of each rank's batch rows, and each rank's
block of every cache leaf after the steps, within 1e-5 of their largest
magnitude of JAX's (float32; the packages differ by summation order); the
8 tokens equal to JAX's and to the port's ``Server`` with no mesh; and
``generate`` under a prefill policy's ctx equal to the no-mesh tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import _torch_port  # noqa: F401  (one intra-op thread)

from _jax_sharded import blocks, cfg_of, init_numpy, mesh_of
from _torch_dist import run_ranks, ssm_decode_worker
from jax.sharding import NamedSharding
from repro.launch.sharding import Policy as JPolicy
from repro.models.model import Model as JModel

TOL = 1e-5
PROMPT, STEPS, MAX_LEN = 8, 8, 24
NO_HEADS = {"d_model": 36, "ssm_expand": 1, "ssm_headdim": 6}

CASES = {
    (2, 2): [
        dict(name="mamba2-local", arch="mamba2-130m", B=2, batch=2, prefill_ctx=True,
             plan=(("data",), "model", (), "local")),
        dict(name="mamba2-distributed", arch="mamba2-130m", B=2, batch=None,
             plan=(None, "model", ("data",), "distributed")),
        dict(name="zamba2-local", arch="zamba2-1.2b", B=2, batch=2, prefill_ctx=True,
             plan=(("data",), "model", (), "local")),
        dict(name="zamba2-distributed", arch="zamba2-1.2b", B=2, batch=None,
             plan=(None, "model", ("data",), "distributed")),
        dict(name="whisper-local", arch="whisper-base", B=2, batch=2, prefill_ctx=True,
             plan=(("data",), "model", (), "local")),
        dict(name="whisper-distributed", arch="whisper-base", B=1, batch=None,
             plan=(None, "model", ("data",), "distributed")),
    ],
    (2, 4): [
        dict(name="mamba2-heads", arch="mamba2-130m", B=2, batch=2,
             plan=(("data",), "model", (), "local"), state=2),
        dict(name="mamba2-headdim", arch="mamba2-130m", B=2, batch=2,
             overrides={"ssm_headdim": 64}, plan=(("data",), "model", (), "local"),
             state=3),
        dict(name="mamba2-neither", arch="mamba2-130m", B=1, batch=None,
             overrides=NO_HEADS, plan=(None, "model", ("data",), "distributed"),
             state=None),
        dict(name="zamba2-distributed", arch="zamba2-1.2b", B=1, batch=None,
             plan=(None, "model", ("data",), "distributed"), state=2),
        dict(name="whisper-distributed", arch="whisper-base", B=2, batch=None,
             plan=(None, "model", ("data",), "distributed")),
    ],
}
IDS = [(shape, c["name"]) for shape, cs in CASES.items() for c in cs]
#: cases one spawn of ranks runs
SPAWN_CASES = 3


def _inputs(case):
    cfg = cfg_of(case["arch"], **case.get("overrides", {}))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (case["B"], PROMPT), dtype=np.int32)
    frames = (np.asarray(rng.standard_normal((case["B"], cfg.enc_seq_len, cfg.d_model))
                         * 0.02, np.float32) if cfg.family == "audio" else None)
    return cfg, tokens, frames


def _jax_decode(cfg, params, tokens, frames, mesh_shape, batch):
    """The JAX package's prefill (no mesh) and greedy decode steps jitted
    with the dry run's in/out shardings -> (tokens (B, STEPS), every step's
    logits (B, STEPS, V), the final cache, the mesh)."""
    mesh = mesh_of(mesh_shape)
    policy = JPolicy(cfg, mesh, "decode")
    ctx = policy.ctx(decode=True, batch=batch)
    m = JModel(cfg)
    inp = {"tokens": jnp.asarray(tokens)}
    if frames is not None:
        inp["frames"] = jnp.asarray(frames)
    lg, cache = jax.jit(lambda p, b: m.prefill(p, b, cache_len=MAX_LEN))(params, inp)
    cache_sh = policy.cache_shardings(cache, ctx.decode_plan)
    cache = jax.device_put(cache, cache_sh)
    tok_sh = policy.batch_shardings({"t": jnp.zeros((tokens.shape[0], 1), jnp.int32)})["t"]
    step = jax.jit(lambda p, c, t, pos: m.decode_step(p, c, t, pos, ctx),
                   in_shardings=(policy.param_shardings(params), cache_sh, tok_sh,
                                 NamedSharding(mesh, jax.sharding.PartitionSpec())),
                   out_shardings=(None, cache_sh))
    toks, out = [], [np.asarray(lg[:, -1])]
    for i in range(STEPS - 1):
        toks.append(jnp.argmax(lg[:, -1], axis=-1).astype(jnp.int32)[:, None])
        lg, cache = step(params, cache, toks[-1], jnp.int32(PROMPT + i))
        out.append(np.asarray(lg[:, -1]))
    toks.append(jnp.argmax(lg[:, -1], axis=-1).astype(jnp.int32)[:, None])
    return (np.concatenate([np.asarray(t) for t in toks], 1), np.stack(out, 1), cache,
            mesh)


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """(shape, case name) -> (each rank's results, the JAX weights), a
    spawn of ranks for every ``SPAWN_CASES`` cases of a mesh."""
    done, params = {}, {}

    def get(shape, name):
        part = [c["name"] for c in CASES[shape]].index(name) // SPAWN_CASES
        if (shape, part) not in done:
            cases = []
            for c in CASES[shape][part * SPAWN_CASES:(part + 1) * SPAWN_CASES]:
                cfg, tokens, frames = _inputs(c)
                key = (c["arch"], tuple(sorted(c.get("overrides", {}).items())))
                if key not in params:
                    params[key] = init_numpy(cfg)
                cases.append({**c, "params": params[key], "tokens": tokens,
                              "frames": frames})
            done[(shape, part)] = run_ranks(ssm_decode_worker, int(np.prod(shape)),
                                            tmp_path_factory.mktemp("ranks"), shape,
                                            cases, STEPS, MAX_LEN)
        return done[(shape, part)], params
    return get


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= TOL * scale, (what, err, scale)


@pytest.mark.parametrize("shape,name", IDS, ids=[f"{s[0]}x{s[1]}-{n}" for s, n in IDS])
def test_sharded_ssm_decode_matches_jax(shape, name, port_runs):
    case = next(c for c in CASES[shape] if c["name"] == name)
    ranks, params = port_runs(shape, name)
    cfg, tokens, frames = _inputs(case)
    key = (case["arch"], tuple(sorted(case.get("overrides", {}).items())))
    want_toks, want_logits, cache, mesh = _jax_decode(cfg, params[key], tokens, frames,
                                                      shape, case["batch"])
    jblocks = blocks(cache, mesh)
    B = case["B"]
    for r, res in enumerate(ranks):
        got = res[name]
        assert got["plan"] == case["plan"]
        np.testing.assert_array_equal(got["tokens"].numpy(), want_toks)
        np.testing.assert_array_equal(got["plain_tokens"].numpy(), want_toks)
        if case.get("prefill_ctx"):
            np.testing.assert_array_equal(got["prefill_ctx_tokens"].numpy(), want_toks)
        rows = want_logits
        if case["plan"][0]:                       # this rank's batch rows
            n = shape[0]
            i = r // shape[1]
            rows = want_logits[i * B // n:(i + 1) * B // n]
        _close(got["logits"].numpy(), rows, f"rank {r} logits")
        assert set(got["cache"]) == set(jblocks)
        for path, blk in got["cache"].items():
            _close(blk.numpy(), jblocks[path][r], f"rank {r} cache {path}")
    if "state" in case:
        # the SSM state's shard: heads (dim 2), head dim (dim 3) or whole
        st = [p for p in ranks[0][name]["cache"] if p.endswith("['state']")][0]
        local = ranks[0][name]["cache"][st].shape
        whole = jblocks[st][0].shape
        assert tuple(local) == tuple(whole)
        ssm_shape = (cfg.ssm_nheads, cfg.ssm_headdim)
        split = [d for d in (2, 3) if local[d] < ssm_shape[d - 2]]
        assert split == ([] if case["state"] is None else [case["state"]])
