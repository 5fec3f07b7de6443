"""The port's audio family (whisper-base) against the JAX package.

Reduced whisper-base: the JAX package initializes the weights,
``params_from_numpy`` carries them across.  The stub ``frames`` and whole
batches are bit-equal; the float32 forward, ``Model.loss`` and every
gradient leaf agree; prefill of S - 1 tokens and one decode step reproduce
the full forward (the JAX package's own
``test_models_equiv.py::test_decode_matches_full_forward``, run on the
port); the ``Server``'s greedy tokens equal the JAX ``Server``'s; and the
parameter counts equal at full width.  On this CPU host attention runs the
flash kernel's plain version: the encoder's non-causal self-attention over
Se = 30 frames and the decoder's cross-attention (Sq = prompt, Sk = 30) are
the first callers with Sq != Sk inside a model.

Tolerances, float32: the loss within 1e-5 relative and each gradient leaf
within 1e-3 of its largest magnitude (the card's limits for the same
comparison, ``chip_smoke.py``); logits within 1e-4; prefill and decode
against the full forward within the reference test's 2e-4 and 3e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_port  # noqa: F401  (one intra-op thread)

from repro.configs.base import get_config as jget
from repro.data.pipeline import SyntheticLMDataset as JData
from repro.launch.serve import Server as JServer
from repro.models.context import null_ctx as jnull
from repro.models.inputs import sample_train_batch as jsample
from repro.models.model import Model as JModel
from repro.models.model import count_params_analytic as jcount
from repro_torch.configs.base import get_config as tget
from repro_torch.data.pipeline import SyntheticLMDataset as TData
from repro_torch.launch.serve import Server as TServer
from repro_torch.launch.train import batch_to
from repro_torch.models.context import null_ctx
from repro_torch.models.inputs import sample_train_batch
from repro_torch.models.model import Model as TModel
from repro_torch.models.model import count_params_analytic, params_from_numpy
from repro_torch.optim.optimizers import tree_leaves, tree_map

ARCH = "whisper-base"
LOSS_RTOL, GRAD_TOL, LOGIT_TOL = 1e-5, 1e-3, 1e-4
PREFILL_TOL, DECODE_TOL = 2e-4, 3e-4
B, S, CHUNK = 2, 24, 8


def _bits(x):
    """A batch leaf's raw bits: bf16 as uint16 (torch or ml_dtypes)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _jbatch(batch):
    return {k: jnp.asarray(_bits(v)) if k != "frames" else
            jnp.asarray(np.asarray(v.float()), dtype=jnp.dtype(str(v.dtype)[6:]))
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def pair():
    jc = dataclasses.replace(jget(ARCH, reduced=True), dtype="float32")
    tc = dataclasses.replace(tget(ARCH, reduced=True), dtype="float32")
    jp = jax.jit(JModel(jc).init)(jax.random.key(2))
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp


# ----------------------------------------------------------- the batches


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("seed", [0, 5])
def test_frames_and_batches_bit_equal(reduced, seed):
    jc, tc = jget(ARCH, reduced=reduced), tget(ARCH, reduced=reduced)
    want = jsample(np.random.default_rng(seed), jc, 1, 12)
    got = sample_train_batch(np.random.default_rng(seed), tc, 1, 12)
    assert list(got) == list(want) == ["tokens", "frames", "labels"]
    assert got["frames"].dtype == torch.bfloat16
    assert tuple(got["frames"].shape) == (1, tc.enc_seq_len, tc.d_model)
    for k in want:
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))


@pytest.mark.parametrize("step", [0, 3])
def test_dataset_batches_and_stream_bit_equal(step):
    from repro_torch.data.pipeline import prefetch
    jd = JData(jget(ARCH, reduced=True), 4, 32, seed=1)
    td = TData(tget(ARCH, reduced=True), 4, 32, seed=1)
    want = jd.get_batch(step)
    it = prefetch(td.iter_from(step), depth=2)
    for got in (td.get_batch(step), next(td.iter_from(step)), next(it)):
        for k in want:
            np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))
    dev = batch_to(td.get_batch(step), "cpu")
    assert dev["frames"].dtype == torch.bfloat16 and dev["tokens"].dtype == torch.int64


# --------------------------------------------------- forward, loss, grads


def test_forward_logits_agree(pair):
    jc, tc, jp, tp = pair
    batch = TData(tc, B, S, seed=4).get_batch(0)
    ctx = jnull(attn_chunk=CHUNK, remat="none")
    jl, _ = jax.jit(lambda p, b: JModel(jc).forward(p, b, ctx))(jp, _jbatch(batch))
    with torch.no_grad():
        tl, aux = TModel(tc).forward(tp, batch_to(batch, "cpu"),
                                     null_ctx(attn_chunk=CHUNK, remat="none"))
    assert float(aux) == 0.0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_gradients_agree(pair, remat):
    jc, tc, jp, tp = pair
    batch = TData(tc, B, 32, seed=3).get_batch(1)
    batch["labels"][0, :5] = -1
    ctx = jnull(attn_chunk=16, remat="none")
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: JModel(jc).loss(p, _jbatch(batch), ctx), has_aux=True))(jp)
    params = tree_map(lambda p: p.detach().requires_grad_(True), tp)
    tl, _ = TModel(tc).loss(params, batch_to(batch, "cpu"),
                            null_ctx(attn_chunk=16, remat=remat))
    tg = torch.autograd.grad(tl, tree_leaves(params))
    assert float(tl.detach()) == pytest.approx(float(jl), rel=LOSS_RTOL)
    jg = jax.tree.leaves(jg)
    assert len(tg) == len(jg) == len(tree_leaves(tp))
    for i, (a, b) in enumerate(zip(tg, jg)):
        b = np.asarray(b)
        assert a.shape == b.shape, i
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a.numpy() - b).max() <= GRAD_TOL * scale, i


def test_decode_matches_full_forward(pair):
    """Incremental decode (prefill S - 1 + one decode step) == full
    forward, on the port alone."""
    _, tc, _, tp = pair
    m = TModel(tc)
    batch = batch_to(sample_train_batch(np.random.default_rng(0), tc, B, S), "cpu")
    ctx = null_ctx(attn_chunk=CHUNK, remat="none")
    with torch.no_grad():
        full, _ = m.forward(tp, batch, ctx)
        pre = {"tokens": batch["tokens"][:, :-1], "frames": batch["frames"]}
        lg_pre, cache = m.prefill(tp, pre, ctx, cache_len=S)
        # the cross K/V keep the frames' length; the self K/V are padded
        assert cache["xk"].shape[2] == tc.enc_seq_len and cache["k"].shape[2] == S
        np.testing.assert_allclose(lg_pre[:, -1].numpy(), full[:, -2].numpy(),
                                   rtol=PREFILL_TOL, atol=PREFILL_TOL)
        lg_dec, _ = m.decode_step(tp, cache, batch["tokens"][:, -1:], S - 1, ctx)
    np.testing.assert_allclose(lg_dec[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=DECODE_TOL, atol=DECODE_TOL)


def test_prefill_and_cache_agree_with_the_jax_package(pair):
    jc, tc, jp, tp = pair
    batch = sample_train_batch(np.random.default_rng(6), tc, B, 17)
    pre = {k: v for k, v in batch.items() if k != "labels"}
    jl, jcache = jax.jit(lambda p, b: JModel(jc).prefill(p, b, cache_len=32))(
        jp, _jbatch(pre))
    tl, tcache = TModel(tc).prefill(tp, batch_to(pre, "cpu"), cache_len=32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    assert set(tcache) == set(jcache) == {"k", "v", "xk", "xv"}
    for k in tcache:
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_server_tokens_equal_the_jax_server(pair):
    jc, tc, jp, tp = pair
    batch = sample_train_batch(np.random.default_rng(9), tc, B, 13)
    pre = {k: v for k, v in batch.items() if k != "labels"}
    want = np.asarray(JServer(jc, jp, max_len=32).generate(_jbatch(pre), 10))
    got = TServer(tc, tp, max_len=32, device="cpu").generate(pre, 10)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="exceeds max_len"):
        TServer(tc, tp, max_len=16, device="cpu").generate(pre, 10)


def test_param_counts_and_init_tree_equal_the_jax_package(pair):
    jc, tc, jp, _ = pair
    for reduced in (True, False):
        assert count_params_analytic(tget(ARCH, reduced=reduced)) == \
            jcount(jget(ARCH, reduced=reduced))
    got = TModel(tc).init(torch.Generator().manual_seed(0), device="cpu")
    want = jax.tree.map(np.asarray, jp)
    assert len(tree_leaves(got)) == len(jax.tree.leaves(want))
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert tuple(a.shape) == b.shape and str(a.dtype)[6:] == str(b.dtype)
    assert set(got) == {"embed", "enc_pos", "enc_layers", "ln_enc",
                        "dec_layers", "ln_f", "unembed"}
    assert set(got["ln_f"]) == {"scale", "bias"}         # a LayerNorm
