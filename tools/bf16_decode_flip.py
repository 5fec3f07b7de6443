"""Where a bf16 decode on a mesh parts from the decode with no mesh, in the
JAX package and in the port, on the CPU.

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tools/bf16_decode_flip.py

Two decode attentions are in both packages: ``decode_attention`` (the
softmax, then the product with V) and the flash-decode combine
``distributed_decode_attention`` (the product with the unnormalized
probabilities, then the division by their sum, after the all-reduces over
the sequence shards).  The JAX package runs the first with no mesh and
under a decode plan without sequence axes ("local"), the second under a
plan whose cache sequence is sharded ("distributed"), even when the shard
is the whole cache (a mesh of one device).  The two are equal in exact
arithmetic and differ by float32 rounding, which a bf16 output turns, now
and then, into one bf16 step.

1. The two attentions on the same bf16 inputs, at zamba2-1.2b's
   attention shape (B = 2, a 288-slot cache, 32 heads of 64), in each
   package (the combine on a mesh, or a process group, of one): how many
   output elements differ, and by how much.
2. Greedy bf16 decoding of the reduced zamba2-1.2b (the JAX package's
   weights in both packages), 2 x 32 prompt tokens and 64 new ones: the
   tokens with no mesh against those under each plan on a (1, 1) mesh.

Prints one line a measurement and, last, a JSON object of them all.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs.base import get_config as jget
from repro.launch.sharding import Policy as JPolicy
from repro.models import attention as jattn
from repro.models.model import Model as JModel
from repro.models.shard_compat import shard_map_unchecked
from repro_torch.configs.base import get_config as tget
from repro_torch.launch.mesh import init_world_of_one, make_small_mesh
from repro_torch.launch.serve import Server
from repro_torch.launch.sharding import Policy
from repro_torch.models import attention as tattn
from repro_torch.models.model import params_from_numpy

ARCH = "zamba2-1.2b"
B, SLOTS, KV, DH = 2, 288, 32, 64
PROMPT, NEW, TRIALS = 32, 64, 20


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def attention_pair(mesh, group) -> dict:
    """Part 1: per package, the elements of the two attentions' bf16
    outputs that differ, over ``TRIALS`` random draws."""
    rng = np.random.default_rng(0)
    pos = SLOTS - 1
    spec = JP(None, "data", None, None)

    def jdist(q, k, v):
        return jattn.distributed_decode_attention(q, k, v, pos, ("data",), 0,
                                                  scale=DH ** -0.5)

    jcomb = jax.jit(shard_map_unchecked(jdist, mesh=mesh,
                                        in_specs=(JP(), spec, spec), out_specs=JP()))
    out = {"jax": [0, 0.0], "port": [0, 0.0], "elements": 0}
    for _ in range(TRIALS):
        q, k, v = (_bf16(rng.standard_normal(s).astype(np.float32))
                   for s in ((B, 1, KV, 1, DH), (B, SLOTS, KV, DH), (B, SLOTS, KV, DH)))
        jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
        a = np.asarray(jattn.decode_attention(jq, {"k": jk, "v": jv}, pos)
                       .astype(jnp.float32))
        b = np.asarray(jcomb(jq, jk, jv).astype(jnp.float32))
        tq, tk, tv = (torch.from_numpy(np.array(x)).to(torch.bfloat16) for x in (q, k, v))
        c = tattn.decode_attention(tq, {"k": tk, "v": tv}, pos).float().numpy()
        d = tattn.distributed_decode_attention(tq, tk, tv, pos, group, 0).float().numpy()
        for key, (x, y) in (("jax", (a, b)), ("port", (c, d))):
            out[key][0] += int((x != y).sum())
            out[key][1] = max(out[key][1], float(np.abs(x - y).max()))
        out["elements"] += a.size
    for key in ("jax", "port"):
        n, err = out[key]
        print(f"{key}: decode_attention against distributed_decode_attention (one "
              f"shard), bf16 {B}x{SLOTS}x{KV}x{DH}, {TRIALS} draws: {n} of "
              f"{out['elements']} outputs differ, the largest by {err:.4g}")
    return out


def jax_tokens(cfg, params, tokens, mesh, plan_batch) -> np.ndarray:
    """The JAX package's greedy decode: no mesh (``mesh`` None) or jitted
    under the decode policy's shardings on ``mesh``."""
    m = JModel(cfg)
    lg, cache = jax.jit(lambda p, t: m.prefill(p, {"tokens": t},
                                               cache_len=PROMPT + NEW))(
        params, jnp.asarray(tokens))
    if mesh is None:
        step = jax.jit(lambda p, c, t, pos: m.decode_step(p, c, t, pos))
    else:
        policy = JPolicy(cfg, mesh, "decode")
        ctx = policy.ctx(decode=True, batch=plan_batch)
        cache_sh = policy.cache_shardings(cache, ctx.decode_plan)
        cache = jax.device_put(cache, cache_sh)
        tok_sh = policy.batch_shardings({"t": jnp.zeros((B, 1), jnp.int32)})["t"]
        step = jax.jit(lambda p, c, t, pos: m.decode_step(p, c, t, pos, ctx),
                       in_shardings=(policy.param_shardings(params), cache_sh, tok_sh,
                                     NamedSharding(mesh, JP())),
                       out_shardings=(None, cache_sh))
    toks = []
    for i in range(NEW):
        toks.append(jnp.argmax(lg[:, -1], axis=-1).astype(jnp.int32)[:, None])
        if i < NEW - 1:
            lg, cache = step(params, cache, toks[-1], jnp.int32(PROMPT + i))
    return np.concatenate([np.asarray(t) for t in toks], 1)


def token_runs(jmesh, tmesh) -> dict:
    """Part 2: tokens equal to the no-mesh decode's, per package and plan."""
    jcfg = jget(ARCH, reduced=True)
    tcfg = tget(ARCH, reduced=True)
    assert jcfg.dtype == tcfg.dtype == "bfloat16"
    params = JModel(jcfg).init(jax.random.key(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, params), device="cpu")
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (B, PROMPT),
                                               dtype=np.int32)
    out = {}
    want = jax_tokens(jcfg, params, tokens, None, None)
    plain = Server(tcfg, tparams, max_len=PROMPT + NEW, device="cpu").generate(
        {"tokens": tokens}, NEW).numpy()
    for plan, batch in (("local", B), ("distributed", None)):
        got = jax_tokens(jcfg, params, tokens, jmesh, batch)
        ctx = Policy(tcfg, tmesh, "decode").ctx(decode=True, batch=batch)
        assert ctx.decode_plan.mode == plan
        port = Server(tcfg, tparams, ctx=ctx, max_len=PROMPT + NEW,
                      device="cpu").generate({"tokens": tokens}, NEW).numpy()
        out[plan] = {"jax": int((got == want).sum()), "port": int((port == plain).sum()),
                     "tokens": int(want.size)}
        print(f"{ARCH} reduced, bf16, {B} x {PROMPT} prompts, {NEW} tokens, the "
              f"'{plan}' plan on a (1, 1) mesh against no mesh: JAX package "
              f"{out[plan]['jax']} of {want.size} tokens equal, port "
              f"{out[plan]['port']} of {want.size}")
    out["port_no_mesh_equals_jax_no_mesh"] = int((plain == want).sum())
    return out


def main():
    torch.set_num_threads(1)
    init_world_of_one("cpu")
    tmesh = make_small_mesh((1, 1), device_type="cpu")
    jmesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    group = torch.distributed.new_group([0])
    res = {"attention": attention_pair(jmesh, group),
           "tokens": token_runs(jmesh, tmesh)}
    torch.distributed.destroy_process_group()
    print(json.dumps(res))


if __name__ == "__main__":
    main()
