"""The backwards of the two kernels the model trains through, against the
JAX package's rules, on the CPU.

Flash attention: ``ref.flash_attention_fwd_lse`` against the forward of the
JAX package's custom VJP (``models.attention._chunked_fwd``, o and lse),
``ref.flash_attention_bwd`` against its backward (``_flash_bwd_rule``, by
``jax.vjp`` of ``flash_attention_vjp``), and ``FlashAttention`` on the CPU
through the port's ``models.attention.attention`` (GQA by
``repeat_interleave``) against ``jax.vjp`` of the JAX ``attention``: causal
and not, a key chunk that divides S and one that does not (one chunk, where
the JAX package takes its naive path: the same function), G = 1 and 2.
Tolerances: float32 1e-5, bfloat16 4e-2 (the Pallas kernel's bf16 one).

The SSD chunk: ``SsdChunk`` (forward ``ref.ssd_chunk_ref``, backward
``ref.ssd_chunk_bwd``) against ``jax.vjp`` of the JAX ``_chunk_scan_step``,
and the port's ``ssd_chunked`` against the JAX one with B and C of head
stride 0 and a padded tail (the gradient of the one group's B and C summed
over the heads by autograd of the ``expand``), within 1e-4 as the chunk's
forward (of each leaf's largest magnitude, or 1, where the chunks' sums
make the gradient large); finite at large decay, as
``tests/test_models_equiv.py`` holds the JAX side.  The kernels' own forwards are held on the card
(``test_torch_kernels_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_port  # noqa: F401  (one intra-op thread)

from repro.models import attention as jattn
from repro.models import ssd as jssd
from repro_torch.kernels import flash_attention_cuda as kfa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_chunk_cuda as kss
from repro_torch.models import attention as tattn
from repro_torch.models import ssd as tssd

TOL = {"float32": 1e-5, "bfloat16": 4e-2}
SSD_TOL = 1e-4
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(rng, shape, dtype, scale=1.0):
    j = jnp.asarray(rng.standard_normal(shape) * scale, JDT[dtype])
    return j, torch.from_numpy(np.array(j, np.float32)).to(TDT[dtype])


def _close(got, want, dtype, what=""):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol,
                               err_msg=what)


# ------------------------------------------------------------ flash attention


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,chunk", [(64, 16), (64, 64), (48, None)])
def test_fwd_lse_matches_the_chunked_forward(S, chunk, causal, dtype):
    rng = np.random.default_rng(S + int(causal))
    B, H, D = 2, 3, 16
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (B, S, H, D), dtype) for _ in range(3))
    c = chunk or S
    jo, jlse = jattn._chunked_fwd(jq[:, :, :, None], jk, jv, causal, c, 0, D ** -0.5)
    o, lse = ref.flash_attention_fwd_lse(tq, tk, tv, causal, None, chunk)
    assert o.dtype == TDT[dtype] and lse.dtype == torch.float32
    assert lse.shape == (B, H, S)
    _close(o, jo[:, :, :, 0], dtype, "o")
    _close(lse, jlse[:, :, 0], "float32", "lse")
    _close(o, ref.flash_attention_ref(tq, tk, tv, causal).float(), dtype, "against ref")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chunk", [16, 64])
def test_bwd_rule_matches_the_jax_rule(chunk, causal, dtype):
    """ref.flash_attention_bwd on the JAX forward's own residuals."""
    rng = np.random.default_rng(chunk + 2 * int(causal))
    B, S, H, D = 2, 64, 2, 16
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (_pair(rng, (B, S, H, D), dtype)
                                                for _ in range(4))
    scale = D ** -0.5
    jo, jlse = jattn._chunked_fwd(jq[:, :, :, None], jk, jv, causal, chunk, 0, scale)
    want = jattn._flash_bwd_rule(causal, chunk, 0, scale,
                                 (jq[:, :, :, None], jk, jv, jo, jlse),
                                 jdo[:, :, :, None])
    tlse = torch.from_numpy(np.array(jlse[:, :, 0]))
    got = ref.flash_attention_bwd(tq, tk, tv, tlse, tdo, causal, scale, chunk)
    for name, g, w in zip("qkv", got, (want[0][:, :, :, 0], want[1], want[2])):
        assert g.dtype == TDT[dtype]
        _close(g, w, dtype, f"d{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,chunk", [(64, 16), (48, 20)])
@pytest.mark.parametrize("G", [1, 2])
def test_function_matches_the_jax_vjp(G, S, chunk, causal, dtype):
    """FlashAttention on the CPU, through the model's attention (GQA by
    repeat_interleave), against jax.vjp of the JAX attention: its flash VJP
    where the chunk divides S, its naive path where it does not."""
    rng = np.random.default_rng(G * 100 + S + int(causal))
    B, KV, D = 2, 2, 16
    jq, tq = _pair(rng, (B, S, KV, G, D), dtype)
    (jk, tk), (jv, tv) = (_pair(rng, (B, S, KV, D), dtype) for _ in range(2))
    jdo, tdo = _pair(rng, (B, S, KV, G, D), dtype)
    jo, vjp = jax.vjp(lambda q, k, v: jattn.attention(q, k, v, causal, chunk=chunk),
                      jq, jk, jv)
    want = vjp(jdo)
    tq, tk, tv = (t.requires_grad_(True) for t in (tq, tk, tv))
    before = kfa.LAUNCHES
    o = tattn.attention(tq, tk, tv, causal, chunk=chunk)
    assert kfa.LAUNCHES == before           # the CPU runs the plain version
    assert o.grad_fn is not None and o.dtype == TDT[dtype]
    _close(o, jo, dtype, "o")
    got = torch.autograd.grad(o, (tq, tk, tv), tdo)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape
        _close(g, w, dtype, f"d{name}")


@pytest.mark.parametrize("chunk", [None, 100])
def test_bwd_on_near_uniform_attention_against_float64(chunk):
    """Near-uniform attention with Sq != Sk (keys that nearly agree, as
    whisper's cross-attention over its frames), where dq cancels to far
    below |o|: the backward within 1e-4 of float64 autograd of the naive
    attention (~6e-6 seen), and, with the lse rounded by 1e-3 on each row,
    the key gradients still sum to zero over the keys (attention does not
    change when every key moves by one vector): D is taken from the
    probabilities the backward recomputes."""
    gen = torch.Generator().manual_seed(4)
    B, Sq, Sk, H, D = 2, 32, 300, 2, 16
    q, do = (torch.randn(B, Sq, H, D, generator=gen) for _ in range(2))
    k = torch.randn(1, 1, H, D, generator=gen) + 0.1 * torch.randn(
        B, Sk, H, D, generator=gen)
    v = torch.randn(B, Sk, H, D, generator=gen)
    q64, k64, v64 = (t.double().requires_grad_(True) for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q64, k64) * D ** -0.5
    o64 = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v64)
    want = torch.autograd.grad(o64, (q64, k64, v64), do.double())
    lse = torch.logsumexp(s.detach(), -1).float()
    got = ref.flash_attention_bwd(q, k, v, lse, do, False, None, chunk)
    for name, g, w in zip("qkv", got, want):
        assert ((g.double() - w).abs().max() / w.abs().max()).item() <= 1e-4, name
    rounded = lse + 1e-3 * torch.randn(lse.shape, generator=gen)
    dk = ref.flash_attention_bwd(q, k, v, rounded, do, False, None, chunk)[1]
    assert (dk.sum(1).abs().max() / dk.abs().max()).item() <= 1e-5


def test_ops_routes_by_grad_mode():
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 8, 2, 16, generator=gen, requires_grad=True)
               for _ in range(3))
    o = ops.flash_attention(q, k, v)
    assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
    o_ref = ops.flash_attention(q, k, v, force="ref")       # plain autograd
    assert "FlashAttention" not in type(o_ref.grad_fn).__name__
    torch.testing.assert_close(o, o_ref, rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).grad_fn is None
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.flash_attention(q, k, v, force="cuda")


# ----------------------------------------------------------------- SSD chunk


def _ssd_pair(rng, B, Q, H, P, N, dt_lo=0.001, dt_hi=0.1, a_lo=0.5, a_hi=2.0):
    arrs = [rng.standard_normal((B, Q, H, P)), rng.uniform(dt_lo, dt_hi, (B, Q, H)),
            -rng.uniform(a_lo, a_hi, (H,)), rng.standard_normal((B, Q, H, N)),
            rng.standard_normal((B, Q, H, N)), rng.standard_normal((B, H, P, N))]
    arrs = [a.astype(np.float32) for a in arrs]
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("B,Q,H,P,N", [(2, 32, 3, 8, 4), (1, 16, 2, 16, 8)])
def test_ssd_function_matches_the_jax_vjp(B, Q, H, P, N):
    rng = np.random.default_rng(Q + H)
    j, t = _ssd_pair(rng, B, Q, H, P, N)
    jdy = jnp.asarray(rng.standard_normal((B, Q, H, P)), jnp.float32)
    jds = jnp.asarray(rng.standard_normal((B, H, P, N)), jnp.float32)
    x, dt, A, Bm, Cm, st = j
    (jst, jy), vjp = jax.vjp(lambda s, x_, d_, b_, c_, a_: jssd._chunk_scan_step(
        s, (x_, d_, b_, c_), a_), st, x, dt, Bm, Cm, A)
    jg = dict(zip(("state", "x", "dt", "B", "C", "A"), vjp((jds, jdy))))
    t = [a.requires_grad_(True) for a in t]
    y, new = ops.ssd_chunk(*t)
    assert type(y.grad_fn).__name__ == "SsdChunkBackward"
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=SSD_TOL,
                               atol=SSD_TOL)
    got = torch.autograd.grad((y, new), t, (torch.from_numpy(np.asarray(jdy)),
                                            torch.from_numpy(np.asarray(jds))))
    for name, g in zip(("x", "dt", "A", "B", "C", "state"), got):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[name]), rtol=SSD_TOL,
                                   atol=SSD_TOL, err_msg=name)


@pytest.mark.parametrize("large_decay", [False, True])
def test_ssd_chunked_with_stride0_bc_and_a_padded_tail(large_decay):
    """The model's hand-over: one group's B and C expanded over the heads
    (head stride 0, never copied by the Function), S = 37 padded to 3
    chunks of 16; gradients of x, dt, A, the group's B and C and the
    incoming state against the JAX package's ssd_chunked."""
    rng = np.random.default_rng(int(large_decay))
    Bb, S, H, P, N, Q = 1, 37, 3, 4, 5, 16
    dt_lo, dt_hi = (2.0, 4.0) if large_decay else (0.001, 0.1)
    x = rng.standard_normal((Bb, S, H, P)).astype(np.float32)
    dt = rng.uniform(dt_lo, dt_hi, (Bb, S, H)).astype(np.float32)
    A = -rng.uniform(1.0, 1.5, (H,)).astype(np.float32)
    Bg, Cg = (rng.standard_normal((Bb, S, 1, N)).astype(np.float32) for _ in range(2))
    st = rng.standard_normal((Bb, H, P, N)).astype(np.float32)

    def jloss(x_, dt_, A_, Bg_, Cg_, st_):
        y, s = jssd.ssd_chunked(x_, dt_, A_, jnp.broadcast_to(Bg_, (Bb, S, H, N)),
                                jnp.broadcast_to(Cg_, (Bb, S, H, N)), chunk=Q,
                                state=st_)
        return jnp.sum(y ** 2) + jnp.sum(s ** 2)

    arrs = (x, dt, A, Bg, Cg, st)
    jval, jgrads = jax.value_and_grad(jloss, argnums=tuple(range(6)))(
        *map(jnp.asarray, arrs))
    t = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    Bexp, Cexp = (g.expand(Bb, S, H, N) for g in t[3:5])
    assert Bexp.stride(2) == 0
    y, s = tssd.ssd_chunked(t[0], t[1], t[2], Bexp, Cexp, Q, state=t[5])
    val = torch.sum(y ** 2) + torch.sum(s ** 2)
    got = torch.autograd.grad(val, t)
    assert np.isfinite(float(jval)) and np.isfinite(float(val))
    rtol = SSD_TOL
    assert float(val) == pytest.approx(float(jval), rel=rtol)
    for name, g, w in zip(("x", "dt", "A", "B", "C", "state"), got, jgrads):
        assert torch.isfinite(g).all(), name
        assert g.shape == w.shape, name
        scale = max(float(np.abs(np.asarray(w)).max()), 1.0)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=rtol * scale, err_msg=name)


def test_ssd_function_keeps_the_views_it_is_given():
    """SsdChunk saves B and C as the stride-0 views they are and hands
    autograd a full (B,Q,H,N) gradient, summed over the heads."""
    rng = np.random.default_rng(3)
    _, t = _ssd_pair(rng, 1, 8, 4, 2, 3)
    base = torch.from_numpy(rng.standard_normal((1, 8, 1, 3)).astype(np.float32))
    base.requires_grad_(True)
    Bv = base.expand(1, 8, 4, 3)
    y, s = kss.SsdChunk.apply(t[0], t[1], t[2], Bv, t[4], t[5], False)
    saved = y.grad_fn.saved_tensors
    assert saved[3].stride(2) == 0 and saved[3].data_ptr() == base.data_ptr()
    (g,) = torch.autograd.grad(y.sum() + s.sum(), base)
    Bc = Bv.detach().clone().requires_grad_(True)
    y2, s2 = ref.ssd_chunk_ref(t[0], t[1], t[2], Bc, t[4], t[5])
    (g2,) = torch.autograd.grad(y2.sum() + s2.sum(), Bc)
    torch.testing.assert_close(g, g2.sum(dim=2, keepdim=True), rtol=1e-5, atol=1e-5)
