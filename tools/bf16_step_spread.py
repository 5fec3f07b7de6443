"""How far one bf16 train step of the port lies from the JAX package's, and
how far each package's bf16 step lies from its own float32 step, on the
reduced grok-1, deepseek-v2 and pixtral-12b at their full configs'
optimizer precision.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/bf16_step_spread.py [--lr 1e-3]

Both packages start from the same bf16 weights (the JAX package's
initialization; the float32 step takes them cast up, exactly) and take the
same batch.  For each part of the new state (the parameters, both moments,
the master copy) it prints the worst leaf's |port - JAX| / |JAX| in bf16,
beside |JAX bf16 - JAX float32| / |JAX float32| and |port bf16 - port
float32| / |port float32| on the same leaf, and the largest ratio of the
first to the second over the part's leaves.  On the CPU; no time.
"""

from __future__ import annotations

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_config as jget
from repro.launch.train import make_train_step as jmake
from repro.models.context import null_ctx as jnull
from repro.models.model import Model as JModel
from repro.optim import adamw as jadamw
from repro_torch.checkpoint.checkpointer import leaf_paths
from repro_torch.configs.base import get_config as tget
from repro_torch.launch.train import batch_to, make_train_step
from repro_torch.models.context import null_ctx
from repro_torch.models.inputs import sample_train_batch
from repro_torch.models.model import Model as TModel, params_from_numpy
from repro_torch.optim import adamw

ARCHS = ("grok-1-314b", "deepseek-v2-236b", "pixtral-12b")
B, S = 2, 24
PARTS = ("['params']", "['opt']['m']", "['opt']['v']", "['opt']['master']")


def step(arch, dtype, jp_bf16, lr):
    """One step of both packages -> (JAX state, port state) as
    {keystr: float64 numpy}."""
    prec = jget(arch).opt_precision
    jc = dataclasses.replace(jget(arch, reduced=True), opt_precision=prec, dtype=dtype)
    tc = dataclasses.replace(tget(arch, reduced=True), opt_precision=prec, dtype=dtype)
    jp = jax.tree.map(lambda x: x.astype(jnp.float32) if (dtype == "float32" and x.dtype
                                                         == jnp.bfloat16) else x, jp_bf16)
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu")
    n = S + (tc.n_patches if tc.family == "vlm" else 0)
    batch = sample_train_batch(np.random.default_rng(13), tc, B, n)
    jb = {k: (jnp.asarray(np.asarray(v.float()), dtype=jnp.dtype(str(v.dtype)[6:]))
              if isinstance(v, torch.Tensor) else jnp.asarray(v)) for k, v in batch.items()}
    jo, to = jadamw(lr, keep_master=prec == "fp32"), adamw(lr, keep_master=prec == "fp32")
    js, _ = jax.jit(jmake(JModel(jc), jo, jnull(attn_chunk=8, remat="none")))(
        {"params": jp, "opt": jo.init(jp)}, jb)
    ts, _ = make_train_step(TModel(tc), to, null_ctx(attn_chunk=8, remat="none"))(
        {"params": tp, "opt": to.init(tp)}, batch_to(batch, "cpu"))
    return ({jax.tree_util.keystr(p): np.asarray(x, np.float64)
             for p, x in jax.tree_util.tree_flatten_with_path(js)[0]},
            {p: t.double().numpy() for p, t in leaf_paths(ts) if isinstance(t, torch.Tensor)})


def rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lr", type=float, default=1e-3)
    args = ap.parse_args()
    for arch in ARCHS:
        jc = dataclasses.replace(jget(arch, reduced=True), dtype="bfloat16")
        jp = jax.jit(JModel(jc).init)(jax.random.key(4))
        j16, t16 = step(arch, "bfloat16", jp, args.lr)
        j32, t32 = step(arch, "float32", jp, args.lr)
        print(f"{arch} ({jget(arch).opt_precision}), lr {args.lr}:")
        for part in PARTS:
            rows = [(rel(t16[p], j16[p]), rel(j16[p], j32[p]), rel(t16[p], t32[p]), p)
                    for p in j16 if p.startswith(part) and p in t16]
            if not rows:
                continue
            worst = max(rows)
            ratio = max(r[0] / max(r[1], 1e-12) for r in rows)
            print(f"  {part}: port against JAX {worst[0]:.3g} ({worst[3]}); there JAX "
                  f"bf16 against float32 {worst[1]:.3g}, the port's {worst[2]:.3g}; "
                  f"largest ratio over the part {ratio:.3g}")


if __name__ == "__main__":
    main()
