"""The port's attention kernel path against the JAX package's Pallas kernel.

On this CPU host ``ops.flash_attention`` takes its plain version
(``repro_torch.kernels.ref.flash_attention_ref``); the Pallas kernel runs in
interpret mode as ``tests/test_kernels.py`` runs it, and the JAX package's
own oracle beside it.  Tolerances are the Pallas kernel's: 3e-5 in float32,
4e-2 in bfloat16.  The CUDA kernel itself is held to the plain version on
the card (``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_port  # noqa: F401  (one intra-op thread)

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention_cuda as kfa
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as tattn

TOL = {"float32": 3e-5, "bfloat16": 4e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(rng.standard_normal(shape), JDT[dtype])
    return j, torch.from_numpy(np.array(j, np.float32)).to(TDT[dtype])


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("B,S,H,D,bq,bk", [
    (2, 64, 3, 16, 16, 16),
    (1, 128, 2, 32, 32, 16),
    (2, 48, 1, 8, 16, 16),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas_and_oracle(B, S, H, D, bq, bk, causal,
                                                   dtype):
    rng = np.random.default_rng(0)
    (jq, q), (jk, k), (jv, v) = (_pair(rng, (B, S, H, D), dtype) for _ in range(3))
    before = kfa.LAUNCHES
    got = ops.flash_attention(q, k, v, causal)
    assert kfa.LAUNCHES == before            # the CPU takes the plain version
    assert got.dtype == TDT[dtype] and got.shape == (B, S, H, D)
    _close(got, flash_attention_pallas(jq, jk, jv, causal=causal, block_q=bq,
                                       block_k=bk, interpret=True), dtype)
    _close(got, jref.flash_attention_ref(jq, jk, jv, causal), dtype)


@pytest.mark.parametrize("Sq,Sk", [(1, 1), (37, 37), (5, 29), (29, 5)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ragged_lengths_match_oracle(Sq, Sk, causal):
    """Lengths that are no block multiple (the kernel masks the tail), and
    Sq != Sk with the causal mask's zero offset."""
    rng = np.random.default_rng(1)
    jq, q = _pair(rng, (2, Sq, 3, 16), "float32")
    (jk, k), (jv, v) = (_pair(rng, (2, Sk, 3, 16), "float32") for _ in range(2))
    _close(ops.flash_attention(q, k, v, causal, scale=0.3),
           jref.flash_attention_ref(jq, jk, jv, causal, scale=0.3), "float32")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 2])
def test_model_attention_matches_naive_gqa(G, causal):
    """``models.attention.attention`` (K/V expanded to the query heads, then
    the kernel path) against the JAX package's naive GQA attention."""
    rng = np.random.default_rng(2)
    jq, q = _pair(rng, (2, 24, 2, G, 16), "float32")
    (jk, k), (jv, v) = (_pair(rng, (2, 24, 2, 16), "float32") for _ in range(2))
    got = tattn.attention(q, k, v, causal)
    assert got.shape == (2, 24, 2, G, 16)
    _close(got, jattn.naive_attention(jq, jk, jv, causal), "float32")
    _close(tattn.naive_attention(q, k, v, causal),
           jattn.naive_attention(jq, jk, jv, causal), "float32")


def test_decode_attention_matches_reference():
    rng = np.random.default_rng(3)
    jq, q = _pair(rng, (2, 1, 2, 2, 16), "float32")
    (jk, k), (jv, v) = (_pair(rng, (2, 20, 2, 16), "float32") for _ in range(2))
    for pos in (0, 7, 19):
        _close(tattn.decode_attention(q, {"k": k, "v": v}, pos),
               jattn.decode_attention(jq, {"k": jk, "v": jv}, jnp.int32(pos)),
               "float32")


def test_dispatch_modes_on_the_cpu():
    q = torch.randn(1, 8, 2, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.flash_attention(q, q, q, force="cuda")
    with pytest.raises(ValueError, match="unknown"):
        ops.flash_attention(q, q, q, force="pallas")
    torch.testing.assert_close(ops.flash_attention(q, q, q, force="ref"),
                               ref.flash_attention_ref(q, q, q))


def test_tma_strides_take_views_as_they_are():
    """The bf16 route's tensor maps read (B, S, H, D) views through their
    strides: contiguous tensors, slices in S and H and a (B, H, S, D)
    tensor transposed to (B, S, H, D) need no copy."""
    wide = torch.zeros(2, 96, 8, 64, dtype=torch.bfloat16)
    assert kfa.tma_strides(wide) == [96 * 8 * 64, 8 * 64, 64]
    assert kfa.tma_strides(wide[:, 10:50, :4]) == [96 * 8 * 64, 8 * 64, 64]
    bhsd = torch.zeros(2, 4, 70, 16, dtype=torch.bfloat16)
    assert kfa.tma_strides(bhsd.transpose(1, 2)) == [4 * 70 * 16, 16, 70 * 16]
    # a dimension of length 1 is never stepped: any stride will do
    one = torch.zeros(1, 5, 1, 32, dtype=torch.bfloat16)
    assert kfa.tma_strides(one) == [32, 32, 32]


def test_tma_strides_refuse_what_a_tensor_map_cannot_take():
    """A base off 16 bytes or a stride not a multiple of 16 bytes: the
    wrapper copies such a tensor (``.contiguous()``) before the launch."""
    flat = torch.zeros(1 + 2 * 8 * 2 * 16, dtype=torch.bfloat16)
    assert kfa.tma_strides(flat[1:].view(2, 8, 2, 16)) is None
    padded = torch.zeros(2, 8, 2, 20, dtype=torch.bfloat16)[..., :16]
    assert kfa.tma_strides(padded) is None
    assert kfa.tma_strides(padded.contiguous()) == [8 * 2 * 16, 2 * 16, 16]
    expanded = torch.zeros(2, 1, 2, 16, dtype=torch.bfloat16).expand(2, 8, 2, 16)
    assert kfa.tma_strides(expanded) is None


def test_readable_copies_what_the_kernels_cannot_read():
    """A view the kernels take passes as it is; a contiguous view at an odd
    offset (which ``.contiguous()`` would return as it is) and a view with
    strides off 16 bytes come back as aligned contiguous copies with their
    strides.  Both dtypes follow the same rule."""
    for dt in (torch.float32, torch.bfloat16):
        wide = torch.randn(2, 96, 8, 64).to(dt)
        view = wide[:, 10:50, :4]
        assert kfa._readable(view)[0] is view
        flat = torch.randn(1 + 2 * 8 * 2 * 16).to(dt)
        for bad in (flat[1:].view(2, 8, 2, 16),
                    torch.randn(2, 8, 2, 17).to(dt)[..., 1:]):
            got, strides = kfa._readable(bad)
            assert got.data_ptr() % 16 == 0 and got.is_contiguous()
            assert strides == [8 * 2 * 16, 2 * 16, 16]
            assert torch.equal(got, bad)


@pytest.mark.parametrize("Sq,Sk,q_offset", [(8, 48, 0), (8, 48, 17), (8, 48, 40),
                                            (16, 32, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_offset_matches_the_jax_package(Sq, Sk, q_offset, dtype):
    """A block of queries whose first row sits at ``q_offset`` against the
    whole sequence's keys: ``ops.flash_attention``'s plain version (the
    kernel's mask, q_offset + qpos >= kpos) against the JAX package's
    ``naive_attention`` with the same offset, forward and, through
    ``FlashAttention``, gradients."""
    rng = np.random.default_rng(Sq + q_offset)
    (jq, q), (jk, k), (jv, v) = (_pair(rng, (2, s, 3, 16), dtype)
                                 for s in (Sq, Sk, Sk))
    got = ops.flash_attention(q, k, v, True, q_offset=q_offset)
    want = jattn.naive_attention(jq[:, :, :, None], jk, jv, True, q_offset)[:, :, :, 0]
    _close(got, want, dtype)
    if dtype == "float32":
        q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
        o = ops.flash_attention(q, k, v, True, chunk=16, q_offset=q_offset)
        (o * o).sum().backward()

        def loss(a, b, c):
            o = jattn.naive_attention(a[:, :, :, None], b, c, True, q_offset)
            return (o * o).sum()
        for g, jg in zip((q.grad, k.grad, v.grad), jax.grad(loss, (0, 1, 2))(jq, jk, jv)):
            np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("Sq,Sk,q_offset", [(8, 48, 0), (8, 48, 17), (8, 48, 40),
                                            (16, 16, 0), (48, 8, 0), (5, 9, 7)])
def test_causal_pairs_count_the_kept_pairs(Sq, Sk, q_offset):
    """``causal_pairs`` (the dry run's and the bound's count of a causal
    call's work) equals the pairs the mask keeps."""
    keep = (torch.arange(Sq)[:, None] + q_offset >= torch.arange(Sk)[None, :])
    assert kfa.causal_pairs(Sq, Sk, q_offset) == int(keep.sum())
