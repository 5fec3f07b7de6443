"""Flash attention with v narrower than q and k, on the CPU: the plain
versions the kernels are held to at MLA's materialized head widths, against
the JAX package's flash attention.

* ``ref.flash_attention_fwd_lse`` (o and lse) and ``ref.flash_attention_ref``
  against the forward of the JAX package's custom VJP
  (``models.attention._chunked_fwd``), and ``ref.flash_attention_bwd``
  against ``jax.vjp`` of its ``attention`` (``flash_attention_vjp`` where the
  key chunk divides S, its naive path where it does not: the same
  function), at (Dk, Dv) = (24, 16) (the reduced deepseek-v2's
  qk_nope + qk_rope and v_head_dim) and (192, 128) (deepseek-v2's), causal
  and not, S a multiple of the chunk and not.  o and lse within 1e-5, each
  gradient within 1e-4 of its largest magnitude.  ``FlashAttention`` on the
  CPU (``models.attention.attention``, which the materialized form calls)
  is held the same way.
* The kernels' pairs: ``kernel_pair`` takes the built pairs as they are,
  pads the reduced pair (24, 16) to the narrowest built pair that covers
  it, and refuses a pair of one width that is not built and a pair no
  built pair covers (MLA's absorbed (576, 512)).  The operators' shape
  functions give o (B, Sq, H, Dv) and the backward's gradients their
  inputs' shapes, and the cost counter counts them at ``flash_cost`` /
  ``flash_bwd_cost`` with v's width.
* The cost functions: at Dv = D (or Dv not given) exactly the counts of
  one width, 4 D FLOPs a pair forward and 10 D backward; at (192, 128)
  2 (Dk + Dv) and 2 (3 Dk + 2 Dv), and the bounds at deepseek-v2's training
  shape and its 4K pretraining length on the H100's data-sheet rates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import _torch_port  # noqa: F401  (one intra-op thread)
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention_cuda as kfa
from repro_torch.kernels import ref
from repro_torch.launch.cost import CostCounter
from repro_torch.models import attention as tattn

O_TOL = 1e-5          # o and lse, float32
GRAD_TOL = 1e-4       # of each gradient's largest magnitude
PAIRS = [(24, 16), (192, 128)]
# (S, chunk): the chunk divides S (the JAX flash VJP) or does not (its
# naive path; the port's plain versions take one chunk)
LENGTHS = [(32, 16), (40, 16)]


def _inputs(seed, B, S, H, Dk, Dv):
    rng = np.random.default_rng(seed)
    shapes = [(B, S, H, Dk), (B, S, H, Dk), (B, S, H, Dv), (B, S, H, Dv)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(got, want, tol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol, err_msg=what)


def _rel_close(got, want, what):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= GRAD_TOL * max(np.abs(want).max(), 1e-30), (what, err)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,chunk", LENGTHS)
@pytest.mark.parametrize("Dk,Dv", PAIRS)
def test_plain_forward_and_lse_match_the_jax_flash_forward(Dk, Dv, S, chunk, causal):
    B, H = 2, 2
    q, k, v, _ = _inputs(Dk + S + int(causal), B, S, H, Dk, Dv)
    scale = Dk ** -0.5
    c = chunk if S % chunk == 0 else S
    jo, jlse = jattn._chunked_fwd(jnp.asarray(q)[:, :, :, None], jnp.asarray(k),
                                  jnp.asarray(v), causal, c, 0, scale)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = ref.flash_attention_fwd_lse(tq, tk, tv, causal, None, chunk)
    assert tuple(o.shape) == (B, S, H, Dv) and tuple(lse.shape) == (B, H, S)
    _close(o, jo[:, :, :, 0], O_TOL, "o")
    _close(lse, jlse[:, :, 0], O_TOL, "lse")
    _close(ref.flash_attention_ref(tq, tk, tv, causal), jo[:, :, :, 0], O_TOL, "ref o")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,chunk", LENGTHS)
@pytest.mark.parametrize("Dk,Dv", PAIRS)
def test_plain_backward_matches_the_jax_vjp(Dk, Dv, S, chunk, causal):
    """``ref.flash_attention_bwd`` from the plain forward's lse, and
    ``FlashAttention`` on the CPU through ``models.attention.attention``,
    against ``jax.vjp`` of the JAX package's ``attention``."""
    B, H = 2, 2
    q, k, v, do = _inputs(2 * Dk + S + int(causal), B, S, H, Dk, Dv)
    scale = Dk ** -0.5
    jo, vjp = jax.vjp(lambda q, k, v: jattn.attention(q, k, v, causal, chunk=chunk,
                                                      scale=scale),
                      jnp.asarray(q)[:, :, :, None], jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do)[:, :, :, None])
    want = (want[0][:, :, :, 0], want[1], want[2])
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    _, lse = ref.flash_attention_fwd_lse(tq, tk, tv, causal, scale, chunk)
    got = ref.flash_attention_bwd(tq, tk, tv, lse, tdo, causal, scale, chunk)
    for name, g, w in zip("qkv", got, want):
        _rel_close(g, w, f"plain d{name}")

    tq, tk, tv = (t.clone().requires_grad_(True) for t in (tq, tk, tv))
    before = kfa.LAUNCHES
    o = tattn.attention(tq[:, :, :, None], tk, tv, causal, scale=scale, chunk=chunk)
    assert kfa.LAUNCHES == before and o.grad_fn is not None
    assert tuple(o.shape) == (B, S, H, 1, Dv)
    _close(o[:, :, :, 0], jo[:, :, :, 0], O_TOL, "attention o")
    got = torch.autograd.grad(o, (tq, tk, tv), tdo[:, :, :, None])
    for name, g, w in zip("qkv", got, want):
        _rel_close(g, w, f"FlashAttention d{name}")


def test_kernel_pairs_pad_the_reduced_pair_and_refuse_the_rest():
    for pair in kfa.HEAD_DIMS:
        assert kfa.kernel_pair(*pair) == pair
    assert (192, 128) in kfa.HEAD_DIMS
    assert kfa.kernel_pair(24, 16) == (32, 32)     # the reduced deepseek-v2
    assert kfa.kernel_pair(72, 64) == (96, 96)
    with pytest.raises(ValueError, match="head dim 24"):
        kfa.kernel_pair(24, 24)
    with pytest.raises(ValueError, match="head dim 576"):
        kfa.kernel_pair(576, 576)
    for pair in ((576, 512), (200, 128), (192, 136)):
        with pytest.raises(ValueError, match="head dims"):
            kfa.kernel_pair(*pair)


@pytest.mark.parametrize("Dk,Dv", PAIRS)
def test_operators_take_v_of_its_own_width(Dk, Dv):
    """The forward and backward operators on fake CUDA tensors: shapes of
    the plain versions, v's width refused where it is not (B, Sk, H, Dv) or
    do's where it is not v's, one operator a call at the costs with Dv."""
    B, Sq, Sk, H = 2, 24, 40, 3
    with FakeTensorMode():
        q = torch.empty(B, Sq, H, Dk, device="cuda")
        k = torch.empty(B, Sk, H, Dk, device="cuda")
        v = torch.empty(B, Sk, H, Dv, device="cuda")
        do = torch.empty(B, Sq, H, Dv, device="cuda")
        ops = torch.ops.repro_torch
        with CostCounter() as c:
            o = ops.flash_attention(q, k, v, True, None)
            o2, lse = ops.flash_attention_lse(q, k, v, False, 0.5)
            dq, dk, dv = ops.flash_attention_bwd(q, k, v, lse, do, True, None)
        for got, want in ((o, (B, Sq, H, Dv)), (o2, (B, Sq, H, Dv)), (lse, (B, H, Sq)),
                          (dq, q.shape), (dk, k.shape), (dv, v.shape)):
            assert tuple(got.shape) == tuple(want)
        with pytest.raises(ValueError, match="must be"):
            ops.flash_attention(q, k, torch.empty(B, 1, H, Dv, device="cuda"), True, None)
        with pytest.raises(ValueError, match="do is"):
            ops.flash_attention_bwd(q, k, v, lse, q, True, None)
    assert c.cost.flops == (kfa.flash_cost(B, Sq, Sk, H, Dk, True, 4, Dv=Dv)[0]
                            + kfa.flash_cost(B, Sq, Sk, H, Dk, False, 4, Dv=Dv)[0]
                            + kfa.flash_bwd_cost(B, Sq, Sk, H, Dk, True, 4, Dv=Dv)[0])


@pytest.mark.parametrize("B,Sq,Sk,H,D,causal,elem,q_offset", [
    (2, 512, 512, 32, 64, True, 2, 0), (2, 1280, 1280, 32, 128, True, 4, 0),
    (2, 1500, 1500, 8, 64, False, 2, 0), (1, 200, 333, 4, 96, True, 4, 37),
    (3, 7, 90, 2, 16, True, 2, 50)])
def test_cost_functions_at_one_width_are_unchanged(B, Sq, Sk, H, D, causal, elem, q_offset):
    pairs = kfa.causal_pairs(Sq, Sk, q_offset) if causal else Sq * Sk
    fwd = (4.0 * B * H * pairs * D, elem * B * H * D * (2 * Sq + 2 * Sk))
    bwd = (10.0 * B * H * pairs * D, elem * B * H * D * (3 * Sq + 4 * Sk) + 4 * B * H * Sq)
    assert kfa.flash_cost(B, Sq, Sk, H, D, causal, elem, q_offset) == fwd
    assert kfa.flash_cost(B, Sq, Sk, H, D, causal, elem, q_offset, Dv=D) == fwd
    assert kfa.flash_bwd_cost(B, Sq, Sk, H, D, causal, elem, q_offset) == bwd
    assert kfa.flash_bwd_cost(B, Sq, Sk, H, D, causal, elem, q_offset, Dv=D) == bwd
    assert (kfa.flash_bound_ms(B, Sq, Sk, H, D, causal, elem, q_offset=q_offset)
            == kfa.flash_bound_ms(B, Sq, Sk, H, D, causal, elem, q_offset=q_offset, Dv=D))
    assert (kfa.flash_bwd_bound_ms(B, Sq, Sk, H, D, causal, elem, q_offset)
            == kfa.flash_bwd_bound_ms(B, Sq, Sk, H, D, causal, elem, q_offset, Dv=D))


# deepseek-v2's (Dk, Dv) = (192, 128), 128 heads, causal: (B, S) -> the
# bounds in µs (bf16 forward, bf16 backward, float32 forward, float32
# backward) and what bounds each
BOUNDS = {(2, 256): ((25.0, "bytes"), (45.2, "bytes"), (50.1, "bytes"), (90.2, "bytes")),
          (1, 4096): ((695, "operations"), (1807, "operations"), (4170, "operations"),
                      (10800, "operations"))}


@pytest.mark.parametrize("B,S", list(BOUNDS))
def test_cost_functions_at_mlas_materialized_pair(B, S):
    H, Dk, Dv = 128, 192, 128
    pairs = S * (S + 1) // 2
    for elem in (2, 4):
        assert kfa.flash_cost(B, S, S, H, Dk, True, elem, Dv=Dv) == (
            2.0 * B * H * pairs * (Dk + Dv), elem * B * H * 2 * S * (Dk + Dv))
        assert kfa.flash_bwd_cost(B, S, S, H, Dk, True, elem, Dv=Dv) == (
            2.0 * B * H * pairs * (3 * Dk + 2 * Dv),
            elem * B * H * S * (4 * Dk + 3 * Dv) + 4 * B * H * S)
    if (B, S) == (2, 256):
        assert kfa.flash_cost(B, S, S, H, Dk, True, 2, Dv=Dv)[1] == 83_886_080
        # the float32 backward's operations bound, under its bytes bound
        ops_us = kfa.flash_bwd_cost(B, S, S, H, Dk, True, 4, Dv=Dv)[0] / (495e12 / 3) * 1e6
        assert round(ops_us, 1) == 84.9
    got = (kfa.flash_bound_ms(B, S, S, H, Dk, True, 2, Dv=Dv),
           kfa.flash_bwd_bound_ms(B, S, S, H, Dk, True, 2, Dv=Dv),
           kfa.flash_bound_ms(B, S, S, H, Dk, True, 4, Dv=Dv),
           kfa.flash_bwd_bound_ms(B, S, S, H, Dk, True, 4, Dv=Dv))
    for (ms, by), (us, want_by) in zip(got, BOUNDS[(B, S)]):
        assert by == want_by
        assert abs(ms * 1e3 - us) <= 0.005 * us, (ms * 1e3, us)
