"""MLA's absorbed attention as the port routes it (``ops.mla_attention``,
``MlaAttention``), against the JAX package's ``attention.attention`` at
MLA's layout, on the CPU.

``MlaAttention`` on the CPU runs the plain versions (``mla_fwd_lse_ref``
and ``mla_bwd_ref``: ``ref.flash_attention_fwd_lse`` and
``ref.flash_attention_bwd`` at one K/V head).  Its output and the
gradients of q, k and v are held against ``jax.vjp`` of
``attention.attention(q[:, :, None], k[:, :, None], v[:, :, None], ...)``
as ``mla_prefill`` calls it, on both of the reference's routes (S a
multiple of the chunk: its chunked flash VJP; not: its naive path), causal
and not, at the reduced deepseek-v2's widths (H = 4, Dk = 40, Dv = 32) and
at H = 8, Dk = 72, Dv = 64: inputs from a numpy seed, float32, within 1e-5
of each output's largest magnitude.  Also: ``latent_attention`` on the CPU
is the plain attention it was, bit for bit; the kernels' wrappers refuse
CPU tensors and shapes outside their contract (with the shape in the
message); their operators give fake and ``meta`` inputs the plain
versions' shapes and the dry run's counter their FLOPs; the kernels'
shared-memory plan (``mla_smem_bytes``, ``mla_bwd_smem_bytes``) fits a
block at every width the wrappers take.  The kernels themselves are held on
the card (``tests/test_torch_kernels_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_port  # noqa: F401  (one intra-op thread)

from repro.models import attention as jattn
from repro_torch.kernels import hopper
from repro_torch.kernels import mla_attention_cuda as kmla
from repro_torch.kernels import ops
from repro_torch.launch.cost import CostCounter
from repro_torch.models import attention as tattn
from repro_torch.models import mla
from repro_torch.models.context import ModelCtx, null_ctx

TOL = 1e-5
SCALE = 0.3
WIDTHS = [(4, 40, 32), (8, 72, 64)]          # (H, Dk, Dv)
ROUTES = {"chunked": (16, 8), "naive": (13, 8)}   # (S, chunk)


def _inputs(seed, B, S, H, Dk, Dv):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, S, H, Dk), (B, S, Dk), (B, S, Dv), (B, S, H, Dv)))


def _rel(a, b):
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,Dk,Dv", WIDTHS)
def test_plain_route_matches_the_jax_attention(H, Dk, Dv, causal, route):
    S, chunk = ROUTES[route]
    q, k, v, do = _inputs(H + Dk + S, 2, S, H, Dk, Dv)

    def jfn(q, k, v):
        return jattn.attention(q[:, :, None], k[:, :, None], v[:, :, None], causal=causal,
                               chunk=chunk, scale=SCALE)[:, :, 0]

    jo, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    to = ops.mla_attention(tq, tk, tv, causal, SCALE, chunk=chunk)
    assert type(to.grad_fn).__name__ == "MlaAttentionBackward"
    tgrads = torch.autograd.grad(to, (tq, tk, tv), torch.from_numpy(do))
    assert to.shape == (2, S, H, Dv)
    assert _rel(to.detach(), jo) <= TOL
    for name, t, j in zip(("dq", "dk", "dv"), tgrads, jgrads):
        assert t.shape == j.shape, name
        assert _rel(t, j) <= TOL, name


@pytest.mark.parametrize("causal", [True, False])
def test_the_forward_without_grad_is_the_plain_forward(causal):
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(3, 2, 13, 4, 40, 32))
    o = ops.mla_attention(q, k, v, causal, SCALE)
    o_ref, lse = kmla.mla_fwd_lse_ref(q, k, v, causal, SCALE)
    assert o.grad_fn is None and torch.equal(o, o_ref)
    assert lse.shape == (2, 4, 13) and lse.dtype == torch.float32
    assert torch.equal(ops.mla_attention(q, k, v, causal, SCALE, force="ref"), o_ref)


@pytest.mark.parametrize("S,chunk", [(16, 8), (13, 8)])
def test_latent_attention_on_the_cpu_is_unchanged(S, chunk):
    """On the CPU ``latent_attention`` is ``attention.plain_attention`` as
    before the kernels (the reference's chunked-or-naive routing), forward
    and gradients, bit for bit; ``kernels="cuda"`` sends it to the kernel
    wrappers, which refuse CPU tensors."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(9, 2, S, 4, 40, 32))
    ctx = null_ctx(attn_chunk=chunk)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = mla.latent_attention(*leaves, True, SCALE, ctx)
    g_got = torch.autograd.grad(got, leaves, do)
    leaves2 = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = tattn.plain_attention(leaves2[0][:, :, None], leaves2[1][:, :, None],
                                 leaves2[2][:, :, None], True, chunk, scale=SCALE)[:, :, 0]
    g_want = torch.autograd.grad(want, leaves2, do)
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(g_got, g_want))
    assert "Mla" not in type(got.grad_fn).__name__
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        with torch.no_grad():
            mla.latent_attention(q, k, v, True, SCALE, ModelCtx(kernels="cuda"))


def test_the_wrappers_refuse_cpu_tensors_and_inputs_that_need_grad():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(4, 1, 8, 4, 40, 32))
    lse = torch.zeros(1, 4, 8)
    for fn, args in ((kmla.mla_attention_cuda, (q, k, v)),
                     (kmla.mla_attention_lse_cuda, (q, k, v)),
                     (kmla.mla_attention_bwd_cuda, (q, k, v, lse, do))):
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            fn(*args)
    with pytest.raises(RuntimeError, match="ops.mla_attention"):
        kmla.mla_attention_cuda(q.requires_grad_(True), k, v)


def _meta(*shapes, dtype=torch.float32):
    return [torch.empty(s, dtype=dtype, device="meta") for s in shapes]


@pytest.mark.parametrize("shapes,match", [
    (((1, 8, 4, 584), (1, 8, 584), (1, 8, 512)), r"q \(1, 8, 4, 584\).*Dk <= 576"),
    (((1, 8, 4, 576), (1, 8, 576), (1, 8, 520)), r"v \(1, 8, 520\).*Dv <= 512"),
    (((1, 8, 4, 44), (1, 8, 44), (1, 8, 32)), r"q \(1, 8, 4, 44\).*multiples of 8"),
    (((1, 8, 4, 40), (1, 9, 40), (1, 8, 32)), r"k \(1, 9, 40\)"),
    (((1, 8, 4, 40), (2, 8, 40), (2, 8, 32)), r"k \(2, 8, 40\)"),
    (((1, 8, 4, 40), (1, 8, 4, 40), (1, 8, 32)), r"k \(1, 8, 4, 40\)"),
    (((1, 8, 4, 40), (1, 0, 40), (1, 0, 32)), r"no keys"),
])
def test_shapes_outside_the_contract_raise_with_the_shape(shapes, match):
    q, k, v = _meta(*shapes)
    with pytest.raises(ValueError, match=match):
        torch.ops.repro_torch.mla_attention(q, k, v, True, None)
    with pytest.raises(ValueError, match=match):
        kmla.mla_attention_lse_cuda(q, k, v)


def test_types_outside_the_contract_raise():
    q, k = _meta((1, 8, 4, 40), (1, 8, 40))
    v16, = _meta((1, 8, 32), dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        kmla.mla_attention_cuda(q, k, v16)
    q16, k16 = _meta((1, 8, 4, 40), (1, 8, 40), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        kmla.mla_attention_cuda(q16, k16, v16)
    q, k, v, do, lse = _meta((1, 8, 4, 40), (1, 8, 40), (1, 8, 32), (1, 8, 4, 40), (1, 4, 8))
    with pytest.raises(ValueError, match=r"do is \(1, 8, 4, 40\)"):
        kmla.mla_attention_bwd_cuda(q, k, v, lse, do)
    do, lse = _meta((1, 8, 4, 32), (1, 8, 4))
    with pytest.raises(ValueError, match=r"lse is \(1, 8, 4\)"):
        kmla.mla_attention_bwd_cuda(q, k, v, lse, do)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_operators_give_the_plain_versions_shapes_and_their_flops(dtype):
    B, Sq, Sk, H, Dk, Dv = 2, 24, 24, 4, 40, 32
    q, k, v, do = _meta((B, Sq, H, Dk), (B, Sk, Dk), (B, Sk, Dv), (B, Sq, H, Dv), dtype=dtype)
    with CostCounter() as c:
        o = kmla.mla_attention_cuda(q, k, v, True, SCALE)
        o2, lse = kmla.mla_attention_lse_cuda(q, k, v, False, SCALE)
        dq, dk, dv = kmla.mla_attention_bwd_cuda(q, k, v, lse, do, True, SCALE)
    assert o.shape == o2.shape == (B, Sq, H, Dv) and o.dtype == dtype
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert dq.dtype == dk.dtype == dv.dtype == dtype
    n = dtype.itemsize
    assert c.cost.flops == (kmla.mla_cost(B, Sq, Sk, H, Dk, Dv, True, n)[0]
                            + kmla.mla_cost(B, Sq, Sk, H, Dk, Dv, False, n)[0]
                            + kmla.mla_bwd_cost(B, Sq, Sk, H, Dk, Dv, True, n)[0])


def test_cost_and_bound_at_deepseek_v2s_shape():
    """One forward call at (B, S, H, Dk, Dv) = (2, 256, 128, 576, 512),
    causal: 18.3 GFLOP over the kept (query, key) pairs, 71.6 MB of bf16
    moved; bounded by bytes in bf16 (42.9 us), by the 3xTF32 rate in
    float32 (111.1 us).  The backward's five products and its bytes."""
    B, S, H, Dk, Dv = 2, 256, 128, 576, 512
    pairs = S * (S + 1) // 2
    flops, n_bytes = kmla.mla_cost(B, S, S, H, Dk, Dv, True, 2)
    assert flops == 2.0 * B * H * pairs * (Dk + Dv)
    assert n_bytes == 2 * B * (S * H * Dk + S * Dk + S * Dv + S * H * Dv)
    assert kmla.mla_bound_ms(B, S, S, H, Dk, Dv, True, 2)[1] == "bytes"
    assert kmla.mla_bound_ms(B, S, S, H, Dk, Dv, True, 2)[0] == pytest.approx(0.0429, rel=1e-2)
    assert kmla.mla_bound_ms(B, S, S, H, Dk, Dv, True, 4) == (
        pytest.approx(0.1111, rel=1e-2), "operations")
    bflops, bbytes = kmla.mla_bwd_cost(B, S, S, H, Dk, Dv, True, 2)
    assert bflops == 2.0 * B * H * pairs * (3 * Dk + 2 * Dv)
    assert bbytes == 2 * B * (2 * S * H * Dk + 2 * S * Dk + 2 * S * Dv + S * H * Dv) + \
        4 * B * H * S
    assert kmla.mla_cost(B, S, S, H, Dk, Dv, False, 2)[0] == 2.0 * B * H * S * S * (Dk + Dv)


@pytest.mark.parametrize("launch", ["forward", "backward"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_shared_memory_plan_fits_a_block_at_every_width(launch, dtype):
    """The kernels' shared memory, mirrored in Python, at every Dk <= 576 and
    Dv <= 512 the wrappers take (multiples of 8), is at most the 227 KB a
    block may take, and at the widest it is the source header's plan."""
    fn = kmla.mla_smem_bytes if launch == "forward" else kmla.mla_bwd_smem_bytes
    sizes = {(Dk, Dv): fn(Dk, Dv, dtype) for Dk in range(8, kmla.MAX_DK + 1, 8)
             for Dv in range(8, kmla.MAX_DV + 1, 8)}
    assert max(sizes.values()) <= hopper.SMEM_PER_BLOCK == 232_448
    widest = {("forward", torch.bfloat16): 1024 + 72 * 1024 + 2 * (36 + 32) * 1024,
              ("backward", torch.bfloat16): 1024 + (72 + 64 + 36 + 32 + 8 + 4) * 1024,
              ("forward", torch.float32): 1024 + 6 * 32 * 1024 + 2 * 16 * 1024,
              ("backward", torch.float32): 1024 + 7 * 32 * 1024}[launch, dtype]
    assert sizes[576, 512] == max(sizes.values()) == widest
