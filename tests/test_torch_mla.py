"""The port's Multi-head Latent Attention (``repro_torch.models.mla``)
against the JAX package's (``repro.models.mla``).

Reduced deepseek-v2 in float32, the JAX package's weights carried across by
``params_from_numpy``, the same inputs from a numpy seed:

* ``mla_prefill``'s output and both cache leaves (``c_kv``, ``k_rope``)
  within 1e-4 (rtol and atol);
* the materialized form (``ctx.rules["mla_materialized"]``) equals the
  absorbed form on the port within the reference's 2e-4
  (``tests/test_models_equiv.py::test_mla_train_equals_absorbed``), and
  the JAX package's materialized form within 1e-4;
* ``mla_decode``, step by step after a prefill, its outputs and the
  updated cache within 1e-4;
* the gradients of the absorbed form against ``jax.grad``'s, each leaf
  within 1e-3 of its largest magnitude.

The absorbed form's attention (one shared 576-wide key head and a 512-wide
value at full width) runs MLA's own kernels on the card; the materialized
form runs ``attention.attention``, the flash kernels on the card (q and k
qk_nope + qk_rope wide, v v_head_dim wide), their plain versions
(``FlashAttention``) on the CPU: a test here holds that it goes through
``kops.flash_attention``.  Two tests marked ``cuda`` show the routes on a
card: the absorbed prefill launches one MLA attention kernel and no flash
kernel, the materialized form one flash forward (and, with a gradient, one
flash backward call), the decode none; and ``kops.flash_attention`` at
D = 576 raises.
They need no JAX: this module imports it only where a test compares with
the JAX package, so ``python -m pytest -q -m cuda tests/test_torch_mla.py``
runs where JAX is not installed.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config as tget
from repro_torch.models import mla
from repro_torch.models.context import ModelCtx, null_ctx
from repro_torch.models.model import params_from_numpy
from repro_torch.optim.optimizers import tree_leaves, tree_map

TOL, EQUIV_TOL, GRAD_TOL = 1e-4, 2e-4, 1e-3
ARCH = "deepseek-v2-236b"
B, S = 2, 32


@pytest.fixture(scope="module")
def J():
    """The JAX package's side: its mla module, config, weights and ctx."""
    jax = pytest.importorskip("jax")
    import _torch_port  # noqa: F401  (one intra-op thread)
    from repro.configs.base import get_config as jget
    from repro.models import mla as jmla
    from repro.models.context import null_ctx as jnull
    jc = dataclasses.replace(jget(ARCH, reduced=True), dtype="float32")
    jp = jmla.init_mla(jax.random.key(0), jc)
    tc = dataclasses.replace(tget(ARCH, reduced=True), dtype="float32")
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu")
    return dataclasses.make_dataclass("J", ["jax", "jmla", "jnull", "jc", "jp",
                                            "tc", "tp"])(
        jax, jmla, jnull, jc, jp, tc, tp)


def _x(seed, S_=S):
    return np.random.default_rng(seed).standard_normal(
        (B, S_, 64)).astype(np.float32) * 0.1


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


def test_init_has_the_jax_tree(J):
    """``init_mla`` draws its own numbers into the JAX package's tree: the
    same keys, shapes and dtypes (``wkv_b_k`` and ``wkv_b_v`` (R, H, .))."""
    got = _flat(mla.init_mla(torch.Generator().manual_seed(0), J.tc, "cpu"))
    want = _flat(J.jax.tree.map(np.asarray, J.jp))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape and str(got[k].dtype)[6:] == str(w.dtype), k
    assert tuple(got["/wkv_b_k"].shape) == (J.tc.kv_lora_rank, J.tc.n_heads,
                                            J.tc.qk_nope_head_dim)
    assert tuple(got["/wkv_b_v"].shape) == (J.tc.kv_lora_rank, J.tc.n_heads,
                                            J.tc.v_head_dim)


def test_prefill_output_and_cache_match_the_jax_package(J):
    x = _x(1)
    pos = np.arange(S)
    jo, jcache = J.jmla.mla_prefill(J.jax.numpy.asarray(x), J.jp, J.jc, pos,
                                    J.jnull(attn_chunk=16))
    with torch.no_grad():
        o, cache = mla.mla_prefill(torch.from_numpy(x), J.tp, J.tc,
                                   torch.arange(S), null_ctx())
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=TOL, atol=TOL)
    assert set(cache) == set(jcache) == {"c_kv", "k_rope"}
    for k in cache:
        assert tuple(cache[k].shape) == jcache[k].shape
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)


def test_materialized_form_equals_the_absorbed_form(J):
    """The reference's test_mla_train_equals_absorbed, run on the port, and
    the port's materialized form against the JAX package's."""
    x = _x(2)
    pos = torch.arange(S)
    ctx = ModelCtx(attn_chunk=16, rules={"mla_materialized": True})
    with torch.no_grad():
        o_train = mla.mla_train(torch.from_numpy(x), J.tp, J.tc, pos, ctx)
        o_pre, cache = mla.mla_prefill(torch.from_numpy(x), J.tp, J.tc, pos,
                                       null_ctx(attn_chunk=16))
        o_default = mla.mla_train(torch.from_numpy(x), J.tp, J.tc, pos,
                                  null_ctx(attn_chunk=16))
    np.testing.assert_allclose(o_train.numpy(), o_pre.numpy(), rtol=EQUIV_TOL,
                               atol=EQUIV_TOL)
    torch.testing.assert_close(o_default, o_pre, rtol=0, atol=0)
    assert tuple(cache["c_kv"].shape) == (B, S, J.tc.kv_lora_rank)
    jctx = J.jnull(attn_chunk=16)
    jctx.rules = {"mla_materialized": True}
    jo = J.jmla.mla_train(J.jax.numpy.asarray(x), J.jp, J.jc, np.arange(S), jctx)
    np.testing.assert_allclose(o_train.numpy(), np.asarray(jo), rtol=TOL, atol=TOL)


def test_decode_matches_the_jax_package_step_by_step(J):
    """Prefill 12 tokens into a 20-slot cache, then 8 decode steps, each
    step's output and the whole cache after it against the JAX package's."""
    jnp = J.jax.numpy
    P, L, steps = 12, 20, 8
    xs = _x(3, P + steps)
    jo, jc0 = J.jmla.mla_prefill(jnp.asarray(xs[:, :P]), J.jp, J.jc, np.arange(P),
                                 J.jnull())
    jcache = {k: jnp.pad(v, ((0, 0), (0, L - P), (0, 0))) for k, v in jc0.items()}
    with torch.no_grad():
        _, c0 = mla.mla_prefill(torch.from_numpy(xs[:, :P]), J.tp, J.tc,
                                torch.arange(P), null_ctx())
        cache = {k: torch.cat([v, v.new_zeros(B, L - P, v.shape[-1])], 1)
                 for k, v in c0.items()}
        for i in range(steps):
            x = xs[:, P + i:P + i + 1]
            jout, jcache = J.jmla.mla_decode(jnp.asarray(x), J.jp, J.jc, jcache,
                                             jnp.int32(P + i), J.jnull())
            out, cache = mla.mla_decode(torch.from_numpy(x), J.tp, J.tc, cache,
                                        P + i, null_ctx())
            np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=TOL,
                                       atol=TOL, err_msg=f"step {i}")
    for k in cache:
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)


def test_init_mla_cache_and_distributed_decode(J):
    cache = mla.init_mla_cache(J.tc, B, 16, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        "c_kv": (B, 16, J.tc.kv_lora_rank), "k_rope": (B, 16, J.tc.qk_rope_head_dim)}
    # decode_attn="distributed" with no mesh is the local decode, as in the
    # JAX package (the sharded one: tests/test_torch_distributed_decode.py)
    x = torch.from_numpy(_x(1)[:, :1])
    got = mla.mla_decode(x, J.tp, J.tc, {k: v.clone() for k, v in cache.items()}, 0,
                         ModelCtx(decode_attn="distributed"))
    want = mla.mla_decode(x, J.tp, J.tc, {k: v.clone() for k, v in cache.items()}, 0,
                          null_ctx())
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(got[1][k], want[1][k]) for k in cache)


def test_absorbed_gradients_match_jax_grad(J):
    jnp = J.jax.numpy
    x = _x(4)

    def jloss(p, x):
        return jnp.sum(J.jmla.mla_train(x, p, J.jc, np.arange(S), J.jnull()) ** 2)

    jgp, jgx = J.jax.grad(jloss, argnums=(0, 1))(J.jp, jnp.asarray(x))
    p = tree_map(lambda t: t.detach().requires_grad_(True), J.tp)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = mla.mla_train(xt, p, J.tc, torch.arange(S), null_ctx())
    got = torch.autograd.grad(torch.sum(out ** 2), [xt] + tree_leaves(p))
    want = [np.asarray(jgx)] + [np.asarray(g) for g in J.jax.tree.leaves(jgp)]
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert tuple(a.shape) == b.shape, i
        assert np.abs(a.numpy() - b).max() <= GRAD_TOL * max(np.abs(b).max(), 1e-30), i


def test_materialized_form_goes_through_the_flash_operator(J, monkeypatch):
    """On the CPU the materialized form's attention is one call of
    ``kops.flash_attention`` a layer (q and k qk_nope + qk_rope wide, v
    v_head_dim wide, the scale over the q/k width, the key chunk
    ``attn_chunk``), the plain ``FlashAttention`` with a gradient, and no
    call of ``attention.plain_attention``; its output and gradients are
    the JAX package's (``test_chunked_route_matches_the_jax_package``)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models import attention as attn_lib
    calls, real = [], kops.flash_attention

    def counted(q, k, v, *args, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), tuple(v.shape), args, kw))
        return real(q, k, v, *args, **kw)

    def refused(*args, **kw):
        raise AssertionError("plain_attention on the materialized route")

    monkeypatch.setattr(kops, "flash_attention", counted)
    monkeypatch.setattr(attn_lib, "plain_attention", refused)
    tc = J.tc
    p = tree_map(lambda t: t.detach().requires_grad_(True), J.tp)
    xt = torch.from_numpy(_x(3)).requires_grad_(True)
    ctx = ModelCtx(attn_chunk=16, rules={"mla_materialized": True}, remat="none")
    out = mla.mla_train(xt, p, tc, torch.arange(S), ctx)
    dk, dv = tc.qk_nope_head_dim + tc.qk_rope_head_dim, tc.v_head_dim
    H = tc.n_heads
    assert calls == [((B, S, H, dk), (B, S, H, dk), (B, S, H, dv), (True, mla._scale(tc)),
                      {"chunk": 16, "force": None, "q_offset": 0})]
    assert out.grad_fn is not None and dk != dv
    grads = torch.autograd.grad(torch.sum(out ** 2), [xt] + tree_leaves(p))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


CHUNK = 20
S_LONG = 4 * CHUNK       # four key chunks: the reference's flash VJP route


@pytest.mark.parametrize("materialized", [False, True])
def test_chunked_route_matches_the_jax_package(J, materialized):
    """At S = 4 x ``attn_chunk`` both packages route MLA's attention through
    their chunked flash VJP: the port's output and gradients (the input's
    and every weight's) against the JAX package's, and, under
    ``CostCounter(memory=True)``, no tensor of the port's forward and
    backward has both an S-long query dim and an S-long key dim."""
    from repro_torch.launch.cost import CostCounter
    jnp = J.jax.numpy
    x = _x(6, S_LONG)
    rules = {"mla_materialized": True} if materialized else {}

    def jloss(p, x):
        jctx = J.jnull(attn_chunk=CHUNK)
        jctx.rules = dict(rules)
        return jnp.sum(J.jmla.mla_train(x, p, J.jc, np.arange(S_LONG), jctx) ** 2)

    jo = J.jmla.mla_train(jnp.asarray(x), J.jp, J.jc, np.arange(S_LONG),
                          J.jnull(attn_chunk=CHUNK))
    jgp, jgx = J.jax.grad(jloss, argnums=(0, 1))(J.jp, jnp.asarray(x))

    class Shapes(CostCounter):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            seen.extend(tuple(t.shape) for t in torch.utils._pytree.tree_leaves(out)
                        if isinstance(t, torch.Tensor))
            return out

    seen = []
    p = tree_map(lambda t: t.detach().requires_grad_(True), J.tp)
    xt = torch.from_numpy(x).requires_grad_(True)
    ctx = ModelCtx(attn_chunk=CHUNK, rules=dict(rules), remat="none")
    with Shapes(memory=True) as c:
        out = mla.mla_train(xt, p, J.tc, torch.arange(S_LONG), ctx)
        got = torch.autograd.grad(torch.sum(out ** 2), [xt] + tree_leaves(p))
    if not materialized:
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo), rtol=TOL,
                                   atol=TOL)
    want = [np.asarray(jgx)] + [np.asarray(g) for g in J.jax.tree.leaves(jgp)]
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert tuple(a.shape) == b.shape, i
        assert np.abs(a.numpy() - b).max() <= GRAD_TOL * max(np.abs(b).max(), 1e-30), i
    assert seen and c.peak > 0
    assert not [s for s in seen if sum(d == S_LONG for d in s) >= 2], \
        "an (S, S) score tensor was made"


# --------------------------------------------------------------- on a card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_mla_route_launches_no_flash_kernel(dtype, card):
    """The reduced deepseek-v2's MLA on the card, each route with its own
    kernels: the absorbed prefill launches one MLA attention kernel and no
    flash kernel, the decode step none; the materialized form one flash
    forward (on the route of its type: bf16 ``wgmma`` or 3xTF32) and, with
    a gradient, one flash backward call and no MLA kernel.  The card's
    answers are the CPU's: the prefill's output and the materialized
    form's within 1e-4 in float32 and 5e-2 of the largest in bf16, the
    materialized form's gradients (the input's and every attention
    leaf's) within 1e-3 of each largest in float32 and 5e-2 in bf16."""
    from repro_torch.kernels import flash_attention_cuda as kfa
    from repro_torch.kernels import mla_attention_cuda as kmla
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(tget(ARCH, reduced=True), dtype=str(dtype)[6:])
    p = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    lp = tree_map(lambda t: t[0], p["moe_layers"]["attn"])
    lp_card = tree_map(lambda t: t.to(card), lp)
    x = torch.from_numpy(_x(5)).to(dtype)
    mat = ModelCtx(rules={"mla_materialized": True}, remat="none")
    f32 = dtype == torch.float32

    def close(a, b, tol):
        a, b = a.detach().cpu().float(), b.detach().float()
        assert (a - b).abs().max().item() <= tol * max(b.abs().max().item(), 1e-30)

    fa = (kfa.LAUNCHES, kfa.WGMMA_LAUNCHES, kfa.TF32_LAUNCHES, kfa.BWD_LAUNCHES)
    mla_before = kmla.LAUNCHES
    with torch.no_grad():
        o, cache = mla.mla_prefill(x.to(card), lp_card, cfg, torch.arange(S, device=card),
                                   null_ctx())
        torch.cuda.synchronize()
        assert kfa.LAUNCHES == fa[0] and kmla.LAUNCHES == mla_before + 1
        o_mat = mla.mla_train(x.to(card), lp_card, cfg, torch.arange(S, device=card), mat)
        torch.cuda.synchronize()
        assert kfa.LAUNCHES == fa[0] + 1 and kmla.LAUNCHES == mla_before + 1
        assert (kfa.TF32_LAUNCHES if f32 else kfa.WGMMA_LAUNCHES) == fa[2 if f32 else 1] + 1
        cache = {k: torch.cat([v, v.new_zeros(B, 1, v.shape[-1])], 1)
                 for k, v in cache.items()}
        mla.mla_decode(x[:, :1].to(card), lp_card, cfg, cache, S, null_ctx())
        torch.cuda.synchronize()
        o_cpu, _ = mla.mla_prefill(x, lp, cfg, torch.arange(S), null_ctx())
        o_mat_cpu = mla.mla_train(x, lp, cfg, torch.arange(S), mat)
    assert kfa.LAUNCHES == fa[0] + 1 and kmla.LAUNCHES == mla_before + 1
    for a, b in ((o, o_cpu), (o_mat, o_mat_cpu)):
        if f32:
            assert (a.cpu() - b).abs().max().item() <= 1e-4
        else:
            close(a, b, 5e-2)

    grads = {}
    for dev, leaves in ((card, lp_card), ("cpu", lp)):
        pp = tree_map(lambda t: t.detach().requires_grad_(True), leaves)
        xt = x.to(dev).requires_grad_(True)
        n0 = (kfa.LAUNCHES, kfa.BWD_LAUNCHES, kmla.LAUNCHES)
        out = mla.mla_train(xt, pp, cfg, torch.arange(S, device=dev), mat)
        grads[str(dev)] = torch.autograd.grad(out.float().pow(2).sum(), [xt] + tree_leaves(pp))
        if dev == card:
            torch.cuda.synchronize()
            assert (kfa.LAUNCHES - n0[0], kfa.BWD_LAUNCHES - n0[1], kmla.LAUNCHES - n0[2]) \
                == (1, 1, 0)
    for a, b in zip(grads["cuda"], grads["cpu"]):
        close(a, b, 1e-3 if f32 else 5e-2)


@pytest.mark.cuda
def test_flash_kernel_refuses_mlas_576_wide_head(card):
    from repro_torch.kernels import ops as kops
    q = torch.randn(2, 64, 1, 576, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 576"):
        kops.flash_attention(q, q, q, True)
