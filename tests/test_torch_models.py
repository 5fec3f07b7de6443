"""The port's model stack and server against the JAX package.

Reduced qwen1.5-0.5b (dense), mamba2-130m (ssm) and zamba2-1.2b (hybrid):
the JAX package initializes the weights, ``params_from_numpy`` carries them
across, and both packages prefill, decode and serve the same tokens.  On
this CPU host the port's kernels take their plain versions.

Tolerances: float32 logits and every cache leaf within 1e-4 (rtol and atol;
the two differ by summation order, ~2e-6 seen); greedy tokens equal.  In
bfloat16 the packages round at different places (XLA fuses elementwise
chains in float32 and rounds once, eager PyTorch rounds after every op), so
zamba2's logits (|logit| up to ~3.3) are held within 0.1 absolute, about
25 bf16 ulps at that scale (0.047 seen).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_port  # noqa: F401  (one intra-op thread)

from repro.configs.base import get_config as jget
from repro.launch.serve import Server as JServer
from repro.models.model import Model as JModel
from repro.models.model import count_params_analytic as jcount
from repro_torch.configs.base import ARCH_IDS, registry
from repro_torch.configs.base import get_config as tget
from repro_torch.models import blocks
from repro_torch.models.context import ModelCtx
from repro_torch.models.inputs import sample_train_batch
from repro_torch.models.model import Model as TModel
from repro_torch.models.model import count_params_analytic, params_from_numpy
from repro_torch.launch.serve import Server as TServer

ARCHS = ["qwen1.5-0.5b", "mamba2-130m", "zamba2-1.2b"]
TOL = 1e-4
BF16_LOGIT_TOL = 0.1
PROMPT, MAX_LEN, STEPS = 37, 48, 8


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _pair(arch, dtype="float32"):
    jc = dataclasses.replace(jget(arch, reduced=True), dtype=dtype)
    tc = dataclasses.replace(tget(arch, reduced=True), dtype=dtype)
    jp = jax.jit(JModel(jc).init)(jax.random.key(1))
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    """Both packages' prefill and 8 teacher-forced decode steps."""
    arch = request.param
    jc, tc, jp, tp = _pair(arch)
    jm, tm = JModel(jc), TModel(tc)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jc.vocab_size, size=(2, PROMPT), dtype=np.int32)
    feed = rng.integers(0, jc.vocab_size, size=(STEPS, 2, 1), dtype=np.int32)
    jl, jcache = jax.jit(lambda p, b: jm.prefill(p, b, cache_len=MAX_LEN))(
        jp, {"tokens": jnp.asarray(toks)})
    tl, tcache = tm.prefill(tp, {"tokens": torch.as_tensor(toks).long()},
                            cache_len=MAX_LEN)
    out = {"arch": arch, "jc": jc, "tc": tc, "jp": jp, "tp": tp,
           "prefill": (jl, tl, _flat(jax.tree.map(np.asarray, jcache)),
                       {k: v.clone() for k, v in _flat(tcache).items()}),
           "decode": []}
    step = jax.jit(jm.decode_step)
    for i, tk in enumerate(feed):
        jl, jcache = step(jp, jcache, jnp.asarray(tk), jnp.int32(PROMPT + i))
        tl, tcache = tm.decode_step(tp, tcache, torch.as_tensor(tk).long(),
                                    PROMPT + i)
        out["decode"].append((jl, tl))
    out["final_cache"] = (_flat(jax.tree.map(np.asarray, jcache)), _flat(tcache))
    return out


def test_prefill_logits_and_every_cache_leaf_agree(run):
    jl, tl, jcache, tcache = run["prefill"]
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=TOL, atol=TOL)
    assert jcache.keys() == tcache.keys()
    for key in jcache:
        assert tuple(tcache[key].shape) == jcache[key].shape, key
        assert str(tcache[key].dtype).split(".")[-1] == str(jcache[key].dtype), key
        np.testing.assert_allclose(_f32(tcache[key]), _f32(jcache[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)


def test_decode_logits_agree_over_eight_steps(run):
    for i, (jl, tl) in enumerate(run["decode"]):
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=TOL, atol=TOL,
                                   err_msg=f"step {i}")
    jcache, tcache = run["final_cache"]
    for key in jcache:
        np.testing.assert_allclose(_f32(tcache[key]), _f32(jcache[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)


def test_server_tokens_equal_the_jax_server(run):
    rng = np.random.default_rng(5)
    batch = sample_train_batch(rng, run["tc"], 2, 16)
    jbatch = {"tokens": jnp.asarray(batch["tokens"])}
    want = np.asarray(JServer(run["jc"], run["jp"], max_len=MAX_LEN).generate(
        jbatch, max_new_tokens=8))
    got = TServer(run["tc"], run["tp"], max_len=MAX_LEN, device="cpu").generate(
        batch, max_new_tokens=8)
    assert got.dtype == torch.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_forward_logits_agree(run):
    rng = np.random.default_rng(6)
    toks = rng.integers(0, run["jc"].vocab_size, size=(2, 21), dtype=np.int32)
    jl, _ = jax.jit(JModel(run["jc"]).forward)(run["jp"],
                                               {"tokens": jnp.asarray(toks)})
    tl, aux = TModel(run["tc"]).forward(run["tp"],
                                        {"tokens": torch.as_tensor(toks).long()})
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=TOL, atol=TOL)
    assert float(aux) == 0.0


def test_sample_batch_equals_the_jax_package(run):
    from repro.models.inputs import sample_train_batch as jsample
    a = sample_train_batch(np.random.default_rng(7), run["tc"], 3, 11)
    b = jsample(np.random.default_rng(7), run["jc"], 3, 11)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(a[k], np.asarray(b[k]))


def test_init_has_the_jax_tree_shapes_and_dtypes(run):
    """``Model.init`` draws its own numbers, into the JAX package's pytree:
    the same keys, shapes and dtypes, and the scalars that are constants
    (A_log, D_skip, norm scales) equal."""
    jc, tc = run["jc"], run["tc"]
    want = _flat(jax.tree.map(np.asarray, run["jp"]))
    got = _flat(TModel(tc).init(torch.Generator().manual_seed(0), device="cpu"))
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        assert str(got[key].dtype).split(".")[-1] == str(w.dtype), key
        if key.endswith(("A_log", "D_skip", "scale")):
            np.testing.assert_allclose(_f32(got[key]), _f32(w), rtol=1e-6)
    assert count_params_analytic(tc) == jcount(jc)


def test_full_width_param_counts_equal_the_jax_package():
    for arch in ARCHS:
        assert tget(arch).param_count() == jget(arch).param_count(), arch


def test_bf16_zamba2_logits_within_the_stated_bound():
    jc, tc, jp, tp = _pair("zamba2-1.2b", "bfloat16")
    toks = np.random.default_rng(8).integers(0, jc.vocab_size, size=(2, 37),
                                             dtype=np.int32)
    jl, jcache = jax.jit(JModel(jc).prefill)(jp, {"tokens": jnp.asarray(toks)})
    tl, tcache = TModel(tc).prefill(tp, {"tokens": torch.as_tensor(toks).long()})
    assert tl.dtype == torch.bfloat16
    err = np.abs(_f32(tl) - _f32(jl)).max()
    assert err <= BF16_LOGIT_TOL, err
    # the SSD state is float32 in both: the rounding above is upstream of it
    np.testing.assert_allclose(_f32(tcache["mamba"]["state"]),
                               _f32(jcache["mamba"]["state"]), rtol=0.1, atol=0.1)


def test_registry_resolves_every_arch_and_unported_families_raise():
    """Every arch's config equals the JAX package's, and every arch, reduced
    and at full width, constructs a port ``Model``: no family is left
    unported (an unknown family is a ValueError)."""
    assert list(registry()) == ARCH_IDS
    for arch in ARCH_IDS:
        assert tget(arch) == dataclasses.replace(
            tget(arch), **dataclasses.asdict(jget(arch)))
        for cfg in (tget(arch), tget(arch, reduced=True)):
            assert TModel(cfg).cfg is cfg
    with pytest.raises(ValueError, match="family 'video'"):
        TModel(dataclasses.replace(tget("qwen1.5-0.5b", reduced=True),
                                   family="video"))


def test_distributed_decode_and_mla_raise():
    """decode_attn="distributed" with no mesh runs the local decode, as in
    the JAX package (its distributed path needs a mesh; the port's sharded
    decode is held in tests/test_torch_distributed_decode.py); MLA's
    ``init_attn`` builds the JAX package's tree."""
    cfg = tget("qwen1.5-0.5b", reduced=True)
    tp = TModel(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    lp = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    h = torch.randn(1, 1, 64, generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    outs = []
    for ctx in (ModelCtx(decode_attn="distributed"), ModelCtx()):
        cache = {"k": torch.zeros(1, 8, 4, 16, dtype=torch.bfloat16),
                 "v": torch.zeros(1, 8, 4, 16, dtype=torch.bfloat16)}
        outs.append(blocks.attn_decode(h, lp, cfg, ctx, cache, 3))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1]["k"], outs[1][1]["k"]) and outs[0][1]["k"][:, 3].abs().sum() > 0
    with pytest.raises(ValueError, match="decode_attn"):
        ModelCtx(decode_attn="sharded")
    from repro.models.blocks import init_attn as jinit_attn
    ds = tget("deepseek-v2-236b", reduced=True)
    p_mla = blocks.init_attn(torch.Generator().manual_seed(0), ds, "cpu")
    got = _flat(p_mla)
    want = _flat(jax.eval_shape(lambda k: jinit_attn(k, jget("deepseek-v2-236b",
                                                             reduced=True)),
                                jax.random.key(0)))
    assert got.keys() == want.keys() and "/wkv_b_k" in got
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        assert str(got[key].dtype)[6:] == str(w.dtype), key
    h = torch.randn(1, 1, ds.d_model, generator=torch.Generator().manual_seed(2)).to(
        torch.bfloat16)
    outs = []
    for ctx in (ModelCtx(decode_attn="distributed"), ModelCtx()):
        mla_cache = {"c_kv": torch.zeros(1, 8, ds.kv_lora_rank, dtype=torch.bfloat16),
                     "k_rope": torch.zeros(1, 8, ds.qk_rope_head_dim,
                                           dtype=torch.bfloat16)}
        outs.append(blocks.attn_decode(h, p_mla, ds, ctx, mla_cache, 0)[0])
    assert torch.equal(outs[0], outs[1])


def test_kernels_ref_ctx_gives_the_same_answer_on_the_cpu():
    """ctx.kernels='ref' forces the plain versions, which the CPU takes
    anyway: the same logits, bit for bit."""
    cfg = dataclasses.replace(tget("zamba2-1.2b", reduced=True), dtype="float32")
    m = TModel(cfg)
    tp = m.init(torch.Generator().manual_seed(3), device="cpu")
    toks = {"tokens": torch.randint(0, cfg.vocab_size, (2, 20),
                                    generator=torch.Generator().manual_seed(4))}
    a, _ = m.prefill(tp, toks)
    b, _ = m.prefill(tp, toks, ModelCtx(kernels="ref"))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    cfg = tget("zamba2-1.2b", reduced=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TModel(cfg).init(torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TServer(cfg, {}, max_len=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy(cfg, {})


def test_two_group_hybrid_prefill_matches_the_jax_package():
    """ssm_groups = 2: each group's B and C are copied to its heads (the
    copy path; one group takes a head-stride-0 view).  The reduced zamba2's
    float32 prefill logits and every cache leaf within 1e-4 of the JAX
    package's."""
    jc = dataclasses.replace(jget("zamba2-1.2b", reduced=True),
                             dtype="float32", ssm_groups=2)
    tc = dataclasses.replace(tget("zamba2-1.2b", reduced=True),
                             dtype="float32", ssm_groups=2)
    jp = jax.jit(JModel(jc).init)(jax.random.key(2))
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(9).integers(0, jc.vocab_size, size=(2, PROMPT),
                                             dtype=np.int32)
    jl, jcache = jax.jit(lambda p, b: JModel(jc).prefill(p, b, cache_len=MAX_LEN))(
        jp, {"tokens": jnp.asarray(toks)})
    tl, tcache = TModel(tc).prefill(tp, {"tokens": torch.as_tensor(toks).long()},
                                    cache_len=MAX_LEN)
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=TOL, atol=TOL)
    jflat, tflat = _flat(jax.tree.map(np.asarray, jcache)), _flat(tcache)
    assert jflat.keys() == tflat.keys()
    for key in jflat:
        np.testing.assert_allclose(_f32(tflat[key]), _f32(jflat[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)
