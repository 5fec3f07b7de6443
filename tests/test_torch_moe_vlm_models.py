"""The port's last model families against the JAX package: the reduced
deepseek-v2-236b (moe with MLA attention and a shared expert, one dense
layer first), grok-1-314b (moe, GQA) and pixtral-12b (vlm: stub patch
embeddings ahead of the tokens).

The JAX package initializes the weights, ``params_from_numpy`` carries them
across, and both packages take the same batches (bit-equal, patch
embeddings and the -1 label pad included).  On this CPU host attention
runs the flash kernel's plain version (grok-1, pixtral) or MLA's plain
attention (deepseek-v2).

Tolerances, float32: logits within 1e-4 (rtol and atol); the loss, its
cross-entropy and its aux term within 1e-5 relative; each gradient leaf
within 1e-3 of its largest magnitude; prefill and decode against the full
forward within the reference test's 2e-4 and 3e-4
(``tests/test_models_equiv.py::test_decode_matches_full_forward``, with
``capacity_factor = n_experts`` as there); greedy tokens equal.  bf16:
logits within 5 % of their largest magnitude (the packages round bf16 at
different places).

One train step at the full config's optimizer precision (grok-1 and
deepseek-v2 ``moments_fp32``: bf16 parameters and float32 moments, no
master; pixtral-12b ``fp32``: a float32 master), ``make_train_step`` with
``adamw(keep_master=cfg.opt_precision == "fp32")`` against the JAX
package's on the same weights and batch, lr 1e-3 (``chip_smoke.py``'s
training lr).  In float32 the loss, the new parameters, both moments and
the master copy agree within 1e-2 of each leaf's largest magnitude
(measured before this bound was set: moments ~3e-6, parameters ~6e-4,
where Adam's first update of a near-zero gradient, +-lr whatever its size,
flips sign between the two summation orders).  In bf16 the loss agrees
within 1e-2 relative (C4's bound) and the new parameters and the master
copy within 1e-2 of each leaf's norm; at lr 1e-3 that bound cannot see the
update, so the step's change of each of those leaves (new - old) is held
against the JAX package's change, |port - JAX| within 0.75 of |JAX| (a
missing update is 1, a reversed one 2; measured before the bound was set:
at most 0.56, deepseek-v2's dense ``ln1`` scale, where the bf16
gradients' rounding flips the sign of Adam's first update, +-lr, on some
elements).  The moments are not held in bf16: they are the two packages'
bf16 gradients, which part by 10-31 % of a leaf's norm, about as far as
the JAX package's own bf16 step lies from its float32 step
(``tools/bf16_step_spread.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_port  # noqa: F401  (one intra-op thread)

from repro.configs.base import get_config as jget
from repro.launch.train import make_train_step as jmake_train_step
from repro.launch.serve import Server as JServer
from repro.models.context import null_ctx as jnull
from repro.models.inputs import sample_train_batch as jsample
from repro.models.model import Model as JModel
from repro.optim import adamw as jadamw
from repro_torch.configs.base import get_config as tget
from repro_torch.launch.serve import Server as TServer
from repro_torch.checkpoint.checkpointer import leaf_paths
from repro_torch.launch.train import batch_to, make_train_step
from repro_torch.models.context import null_ctx
from repro_torch.models.inputs import sample_train_batch
from repro_torch.models.model import Model as TModel
from repro_torch.models.model import params_from_numpy
from repro_torch.optim import adamw
from repro_torch.optim.optimizers import tree_leaves, tree_map

ARCHS = ["deepseek-v2-236b", "grok-1-314b", "pixtral-12b"]
LOGIT_TOL, LOSS_RTOL, GRAD_TOL = 1e-4, 1e-5, 1e-3
PREFILL_TOL, DECODE_TOL, BF16_REL_TOL = 2e-4, 3e-4, 5e-2
B, S, MAX_LEN, STEPS = 2, 24, 40, 8
# the full configs' optimizer precision (tests below set it on the reduced)
OPT_PRECISION = {"deepseek-v2-236b": "moments_fp32", "grok-1-314b": "moments_fp32",
                 "pixtral-12b": "fp32"}
STEP_TOL, STEP_LR, STEP_CHANGE_TOL = 1e-2, 1e-3, 0.75


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


def _bits(x):
    """A batch leaf's raw bits: bf16 as uint16 (torch or ml_dtypes)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _jbatch(batch):
    """The port's batch for the JAX package: numpy ids, the stub embeddings
    in their own dtype."""
    return {k: jnp.asarray(np.asarray(v.float()), dtype=jnp.dtype(str(v.dtype)[6:]))
            if isinstance(v, torch.Tensor) else jnp.asarray(v)
            for k, v in batch.items()}


def _pair(arch, dtype="float32", **kw):
    jc = dataclasses.replace(jget(arch, reduced=True), dtype=dtype, **kw)
    tc = dataclasses.replace(tget(arch, reduced=True), dtype=dtype, **kw)
    jp = jax.jit(JModel(jc).init)(jax.random.key(1))
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param)


def _prompt(tc, seed, n):
    """A prefill batch of n positions (pixtral: n_patches of them patches)."""
    batch = sample_train_batch(np.random.default_rng(seed), tc, B, n)
    return {k: v for k, v in batch.items() if k != "labels"}


# ----------------------------------------------------- tree, counts, batches


def test_init_has_the_jax_tree_shapes_and_dtypes(pair):
    jc, tc, jp, _ = pair
    got = _flat(TModel(tc).init(torch.Generator().manual_seed(0), device="cpu"))
    want = _flat(jax.eval_shape(JModel(jc).init, jax.random.key(0)))
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        assert str(got[key].dtype)[6:] == str(w.dtype), key
    want_top = {"embed", "ln_f", "unembed"} | (
        {"moe_layers"} | ({"dense_layers"} if tc.first_k_dense else set())
        if tc.family == "moe" else {"layers"})
    assert {k.split("/")[1] for k in got} == want_top


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_param_counts_equal_the_jax_package(arch):
    t, j = tget(arch), jget(arch)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    if t.n_experts:
        assert t.active_param_count() < t.param_count()
    tr, jr = tget(arch, reduced=True), jget(arch, reduced=True)
    assert (tr.param_count(), tr.active_param_count()) == (
        jr.param_count(), jr.active_param_count())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 5])
def test_sample_batch_bit_equal(arch, dtype, seed):
    tc = dataclasses.replace(tget(arch, reduced=True), dtype=dtype)
    jc = dataclasses.replace(jget(arch, reduced=True), dtype=dtype)
    got = sample_train_batch(np.random.default_rng(seed), tc, 3, 20)
    want = jsample(np.random.default_rng(seed), jc, 3, 20)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)
    if tc.family == "vlm":
        assert list(got) == ["tokens", "patch_embeds", "labels"]
        assert got["patch_embeds"].dtype == getattr(torch, dtype)
        assert got["tokens"].shape == (3, 20 - tc.n_patches)
        assert (got["labels"][:, :tc.n_patches] == -1).all()
        assert got["labels"].shape == (3, 20)


# --------------------------------------------------- forward, loss, grads


def test_forward_logits_and_aux_agree(pair):
    jc, tc, jp, tp = pair
    batch = sample_train_batch(np.random.default_rng(6), tc, B, S)
    ctx = jnull(attn_chunk=8, remat="none")
    jl, jaux = jax.jit(lambda p, b: JModel(jc).forward(p, b, ctx))(jp, _jbatch(batch))
    with torch.no_grad():
        tl, aux = TModel(tc).forward(tp, batch_to(batch, "cpu"),
                                     null_ctx(attn_chunk=8, remat="none"))
    assert tuple(tl.shape) == jl.shape == (B, S, tc.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    assert float(aux) == pytest.approx(float(jaux), rel=LOSS_RTOL, abs=1e-9)
    assert (float(aux) > 0) == (tc.family == "moe")


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_gradients_agree(pair, remat):
    jc, tc, jp, tp = pair
    batch = sample_train_batch(np.random.default_rng(3), tc, B, S)
    batch["labels"][0, -5:] = -1
    ctx = jnull(attn_chunk=8, remat="none")
    (jl, jparts), jg = jax.jit(jax.value_and_grad(
        lambda p: JModel(jc).loss(p, _jbatch(batch), ctx), has_aux=True))(jp)
    params = tree_map(lambda p: p.detach().requires_grad_(True), tp)
    tl, parts = TModel(tc).loss(params, batch_to(batch, "cpu"),
                                null_ctx(attn_chunk=8, remat=remat))
    tg = torch.autograd.grad(tl, tree_leaves(params))
    assert float(tl.detach()) == pytest.approx(float(jl), rel=LOSS_RTOL)
    for k in ("xent", "aux"):
        assert float(parts[k].detach()) == pytest.approx(float(jparts[k]),
                                                         rel=LOSS_RTOL, abs=1e-9), k
    jg = jax.tree.leaves(jg)
    assert len(tg) == len(jg) == len(tree_leaves(tp))
    for i, (a, b) in enumerate(zip(tg, jg)):
        b = np.asarray(b)
        assert a.shape == b.shape, i
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a.numpy() - b).max() <= GRAD_TOL * scale, i


def test_bf16_logits_within_the_stated_bound(pair):
    arch = pair[1].name.replace("-reduced", "")
    jc, tc, jp, tp = _pair(arch, "bfloat16")
    batch = sample_train_batch(np.random.default_rng(8), tc, B, S)
    jl, _ = jax.jit(JModel(jc).forward)(jp, _jbatch(batch))
    with torch.no_grad():
        tl, _ = TModel(tc).forward(tp, batch_to(batch, "cpu"))
    assert tl.dtype == torch.bfloat16
    want = np.asarray(jl, np.float32)
    err = np.abs(tl.float().numpy() - want).max()
    assert err <= BF16_REL_TOL * np.abs(want).max(), err


# ------------------------------------------------- prefill, decode, serving


@pytest.fixture(scope="module")
def served(pair):
    """Both packages' prefill (cache padded to MAX_LEN) and 8 teacher-forced
    decode steps."""
    jc, tc, jp, tp = pair
    jm, tm = JModel(jc), TModel(tc)
    pre = _prompt(tc, 0, S)
    n = tc.n_patches + pre["tokens"].shape[1] if tc.family == "vlm" else S
    feed = np.random.default_rng(1).integers(0, jc.vocab_size, size=(STEPS, B, 1),
                                             dtype=np.int32)
    jl, jcache = jax.jit(lambda p, b: jm.prefill(p, b, cache_len=MAX_LEN))(
        jp, _jbatch(pre))
    with torch.no_grad():
        tl, tcache = tm.prefill(tp, batch_to(pre, "cpu"), cache_len=MAX_LEN)
        out = {"prefill": (jl, tl, _flat(jax.tree.map(np.asarray, jcache)),
                           {k: v.clone() for k, v in _flat(tcache).items()}),
               "decode": []}
        step = jax.jit(jm.decode_step)
        for i, tk in enumerate(feed):
            jl, jcache = step(jp, jcache, jnp.asarray(tk), jnp.int32(n + i))
            tl, tcache = tm.decode_step(tp, tcache, torch.as_tensor(tk).long(), n + i)
            out["decode"].append((jl, tl))
    out["final_cache"] = (_flat(jax.tree.map(np.asarray, jcache)), _flat(tcache))
    return out


def test_prefill_logits_and_every_cache_leaf_agree(pair, served):
    tc = pair[1]
    jl, tl, jcache, tcache = served["prefill"]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    assert jcache.keys() == tcache.keys()
    tops = {k.split("/")[1] for k in tcache}
    if tc.family == "moe":
        assert tops == ({"dense", "moe"} if tc.first_k_dense else {"moe"})
        assert {k.split("/")[-1] for k in tcache} == (
            {"c_kv", "k_rope"} if tc.use_mla else {"k", "v"})
    for key in jcache:
        assert tuple(tcache[key].shape) == jcache[key].shape, key
        assert tcache[key].shape[2] == MAX_LEN, key
        np.testing.assert_allclose(tcache[key].numpy(), jcache[key],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL, err_msg=key)


def test_decode_logits_agree_over_eight_steps(served):
    for i, (jl, tl) in enumerate(served["decode"]):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL, err_msg=f"step {i}")
    jcache, tcache = served["final_cache"]
    for key in jcache:
        np.testing.assert_allclose(tcache[key].numpy(), jcache[key],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL, err_msg=key)


def test_server_tokens_equal_the_jax_server(pair):
    jc, tc, jp, tp = pair
    pre = _prompt(tc, 9, tc.n_patches + 13 if tc.family == "vlm" else 13)
    want = np.asarray(JServer(jc, jp, max_len=MAX_LEN).generate(_jbatch(pre), 10))
    got = TServer(tc, tp, max_len=MAX_LEN, device="cpu").generate(pre, 10)
    assert got.dtype == torch.int32 and got.shape == (B, 10)
    np.testing.assert_array_equal(got.numpy(), want)
    if tc.family == "vlm":       # the patches count against max_len
        with pytest.raises(ValueError, match="exceeds max_len"):
            TServer(tc, tp, max_len=tc.n_patches + 13 + 9,
                    device="cpu").generate(pre, 10)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """Incremental decode (prefill S - 1 + one decode step) == the full
    forward, on the port alone (the reference test, run on the port)."""
    tc = dataclasses.replace(tget(arch, reduced=True), dtype="float32")
    if tc.n_experts:
        tc = dataclasses.replace(tc, capacity_factor=float(tc.n_experts))
    m = TModel(tc)
    tp = m.init(torch.Generator().manual_seed(2), device="cpu")
    batch = batch_to(sample_train_batch(np.random.default_rng(0), tc, B, S), "cpu")
    ctx = null_ctx(attn_chunk=8, remat="none")
    with torch.no_grad():
        full, _ = m.forward(tp, batch, ctx)
        pre = {k: v for k, v in batch.items() if k != "labels"}
        pre["tokens"] = pre["tokens"][:, :-1]
        lg_pre, cache = m.prefill(tp, pre, ctx, cache_len=S)
        np.testing.assert_allclose(lg_pre[:, -1].numpy(), full[:, -2].numpy(),
                                   rtol=PREFILL_TOL, atol=PREFILL_TOL)
        lg_dec, _ = m.decode_step(tp, cache, batch["tokens"][:, -1:], S - 1, ctx)
    np.testing.assert_allclose(lg_dec[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=DECODE_TOL, atol=DECODE_TOL)


# --------------------------------------------- one step, the configs' optimizer


def _one_step(arch, dtype):
    """One train step of both packages on the reduced ``arch`` in
    ``dtype`` at its full config's ``opt_precision``, from the same JAX
    weights and batch -> (JAX state and metrics as ``flat``-style numpy
    dicts keyed like the port's ``leaf_paths``, the port's, and the
    weights both started from, keyed as the new parameters)."""
    prec = OPT_PRECISION[arch]
    assert tget(arch).opt_precision == jget(arch).opt_precision == prec
    jc, tc, jp, tp = _pair(arch, dtype, opt_precision=prec)
    n = S + (tc.n_patches if tc.family == "vlm" else 0)
    batch = sample_train_batch(np.random.default_rng(13), tc, B, n)
    jo = jadamw(STEP_LR, keep_master=(prec == "fp32"))
    to = adamw(STEP_LR, keep_master=(tc.opt_precision == "fp32"))
    jstate, jm = jax.jit(jmake_train_step(JModel(jc), jo, jnull(attn_chunk=8,
                                                                remat="none")))(
        {"params": jp, "opt": jo.init(jp)}, _jbatch(batch))
    tstate, tm = make_train_step(TModel(tc), to, null_ctx(attn_chunk=8, remat="none"))(
        {"params": tp, "opt": to.init(tp)}, batch_to(batch, "cpu"))
    want = {jax.tree_util.keystr(p): np.asarray(x, np.float64)
            for p, x in jax.tree_util.tree_flatten_with_path(jstate)[0]}
    got = {p: t.detach().double().numpy() for p, t in leaf_paths(tstate)
           if isinstance(t, torch.Tensor)}
    old = {jax.tree_util.keystr(p): np.asarray(x, np.float64)
           for p, x in jax.tree_util.tree_flatten_with_path({"params": jp})[0]}
    return want, float(jm["loss"]), got, float(tm["loss"]), tstate, old


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_at_the_configs_optimizer_precision(arch, dtype):
    want, jloss, got, tloss, tstate, old = _one_step(arch, dtype)
    master = OPT_PRECISION[arch] == "fp32"
    assert ("master" in tstate["opt"]) == master
    assert all(t.dtype == torch.float32 for t in tree_leaves(tstate["opt"]["m"]))
    assert tstate["params"]["embed"]["tok"].dtype == getattr(torch, dtype)
    assert set(got) == {p for p in want if not p.endswith("['step']")}
    assert abs(tloss - jloss) <= STEP_TOL * abs(jloss), (tloss, jloss)
    held = ("['params']", "['opt']['master']")
    if dtype == "float32":
        held += ("['opt']['m']", "['opt']['v']")
    bad = []
    for path, w in want.items():
        if not path.startswith(held):
            continue
        if dtype == "float32":
            err, scale = np.abs(got[path] - w).max(), np.abs(w).max()
        else:
            err, scale = np.linalg.norm(got[path] - w), np.linalg.norm(w)
        if not (got[path].shape == w.shape and err <= STEP_TOL * max(scale, 1e-30)):
            bad.append((path, float(err / max(scale, 1e-30))))
        if dtype == "bfloat16":
            # the master copy started as the parameters cast up
            w0 = old["['params']" + path.removeprefix("['opt']['master']")
                     .removeprefix("['params']")]
            dw = np.linalg.norm(w - w0)
            if not (dw > 0 and np.linalg.norm((got[path] - w0) - (w - w0))
                    <= STEP_CHANGE_TOL * dw):
                bad.append((path, "change", float(np.linalg.norm(got[path] - w)
                                                  / max(dw, 1e-30))))
    assert not bad, bad
