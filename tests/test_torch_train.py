"""The port's model training path against the JAX package's.

The data pipeline (batches bit-equal), the schedules, ``sgd`` and the int8
compression against ``repro.optim``; ``Model.loss``, one step's gradients
and three ``Trainer`` steps on the reduced qwen1.5-0.5b (dense), mamba2-130m
(ssm) and zamba2-1.2b (hybrid) in float32, with the JAX package's weights
carried across by ``params_from_numpy``; ``remat="full"`` against
``"none"``.  On this CPU host the port's attention and SSD chunks run their
plain versions through the kernels' autograd Functions; the kernels' own
forwards are held against those on the card (``test_torch_kernels_cuda.py``,
``chip_smoke.py``).

The configs' own bf16 with a float32 master (what the training backend's
trials run) is held too: ``Trainer`` steps of reduced qwen1.5-0.5b,
mamba2-130m and whisper-base from the JAX package's weights, the losses
within 1e-2 relative.  Reason, written before the first run: both round
activations to bf16 (eps 2^-8 = 3.9e-3) at different places (XLA fuses
elementwise chains in float32 and rounds once, eager PyTorch rounds after
every op); the per-element differences of about one ulp average out in the
mean loss, and Adam's first steps, of about the learning rate whatever a
gradient's size, carry them on without growing them past that.

Tolerances, float32: the loss within 1e-5 relative (~3e-7 seen); each
gradient leaf within 1e-4 of its largest magnitude (~4e-6 seen: the two
differ by summation order); Trainer losses over three AdamW steps within
1e-5 relative.  Schedules within 1e-6 relative (the cosine's float32 ``cos``
may differ by one ulp between the two libraries); ``sgd`` and the int8
compression within 1e-6 (the quantized payloads equal).
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
from repro.launch.train import Trainer as JTrainer
from repro.models.context import null_ctx as jnull
from repro.models.model import Model as JModel
from repro.optim import compression as jcomp
from repro.optim import schedules as jsched
from repro.optim.optimizers import sgd as jsgd
from repro_torch.configs.base import get_config as tget
from repro_torch.data.pipeline import SyntheticLMDataset as TData
from repro_torch.data.pipeline import prefetch
from repro_torch.launch.train import Trainer as TTrainer
from repro_torch.launch.train import batch_to, make_train_step
from repro_torch.models.context import ModelCtx, null_ctx
from repro_torch.models.model import Model as TModel
from repro_torch.models.model import params_from_numpy
from repro_torch.optim import compression as tcomp
from repro_torch.optim import optimizers
from repro_torch.optim import schedules as tsched
from repro_torch.optim.optimizers import adamw, sgd as tsgd
from repro_torch.optim.optimizers import tree_leaves, tree_map

ARCHS = ["qwen1.5-0.5b", "mamba2-130m", "zamba2-1.2b"]
BF16_ARCHS = ["qwen1.5-0.5b", "mamba2-130m", "whisper-base"]
BF16_TRAINER_RTOL = 1e-2
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
TRAINER_RTOL = 1e-5
SCHED_RTOL = 1e-6
OPT_TOL = 1e-6
BATCH, SEQ, CHUNK = 2, 32, 16


def _pair(arch):
    jc = dataclasses.replace(jget(arch, reduced=True), dtype="float32")
    tc = dataclasses.replace(tget(arch, reduced=True), dtype="float32")
    jp = jax.jit(JModel(jc).init)(jax.random.key(1))
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param)


def _jloss_and_grads(jc, jp, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ctx = jnull(attn_chunk=CHUNK, remat="none")
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p: JModel(jc).loss(p, jb, ctx), has_aux=True))(jp)
    return float(loss), aux, [np.asarray(g) for g in jax.tree.leaves(grads)]


@pytest.fixture(scope="module")
def ref_step(pair):
    """The JAX package's loss and gradients on a batch with masked labels."""
    jc, tc, jp, tp = pair
    batch = TData(tc, BATCH, SEQ, seed=3).get_batch(0)
    batch["labels"][0, :5] = -1
    return batch, _jloss_and_grads(jc, jp, batch)


def _tloss_and_grads(tc, tp, batch, remat="none"):
    params = tree_map(lambda p: p.detach().requires_grad_(True), tp)
    loss, aux = TModel(tc).loss(params, batch_to(batch, "cpu"),
                                null_ctx(attn_chunk=CHUNK, remat=remat))
    grads = torch.autograd.grad(loss, tree_leaves(params))
    return float(loss.detach()), aux, [g.numpy() for g in grads]


# ------------------------------------------------------------- pipeline


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seed,step,dp", [(0, 0, 0), (0, 7, 0), (3, 1, 0),
                                          (11, 250, 1), (1 << 20, 2, 3)])
def test_dataset_batches_bit_equal(arch, seed, step, dp):
    jd = JData(jget(arch, reduced=True), 8, 24, seed=seed, dp_rank=dp, dp_size=4)
    td = TData(tget(arch, reduced=True), 8, 24, seed=seed, dp_rank=dp, dp_size=4)
    want, got = jd.get_batch(step), td.get_batch(step)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == (2, 24)
        np.testing.assert_array_equal(got[k], want[k])


def test_dataset_stream_and_prefetch_replay_the_same_batches():
    cfg = tget("zamba2-1.2b", reduced=True)
    data = TData(cfg, 2, 16, seed=5)
    it = data.iter_from(3)
    direct = [next(it) for _ in range(4)]
    src = data.iter_from(3)
    fetched = [next(p) for p in [prefetch(src, depth=2)] for _ in range(4)]
    for a, b, step in zip(direct, fetched, range(3, 7)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(a[k], data.get_batch(step)[k])
    with pytest.raises(ValueError, match="multiple of dp_size"):
        TData(cfg, 3, 16, dp_size=2)


# ------------------------------------------------------- optimizer parts

SCHEDULES = {
    "constant": lambda m: m.constant_schedule(3e-3),
    "exp_staircase": lambda m: m.exponential_decay_schedule(0.1, 0.7, 5),
    "exp_smooth": lambda m: m.exponential_decay_schedule(0.1, 0.7, 5, staircase=False),
    "cosine_warmup": lambda m: m.cosine_warmup_schedule(3e-3, 10, 100),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_the_reference(name):
    fj, ft = SCHEDULES[name](jsched), SCHEDULES[name](tsched)
    for s in range(0, 130):
        want = float(fj(jnp.int32(s)))
        assert ft(s) == pytest.approx(want, rel=SCHED_RTOL, abs=0.0), s
        assert ft(torch.tensor(s)) == ft(s)


def _tree(rng, scale):
    return {"w": (rng.standard_normal((5, 4)) * scale).astype(np.float32),
            "b": [(rng.standard_normal(4) * scale).astype(np.float32),
                  (rng.standard_normal((2, 3)) * scale).astype(np.float32)]}


def _close(t_tree, j_tree, tol=OPT_TOL):
    for a, b in zip(tree_leaves(t_tree), jax.tree.leaves(j_tree)):
        np.testing.assert_allclose(a.numpy() if isinstance(a, torch.Tensor) else a,
                                   np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("momentum,clip,sched", [(0.0, None, False),
                                                 (0.9, None, False),
                                                 (0.9, 0.5, True),
                                                 (0.0, 0.5, True)])
def test_sgd_matches_the_reference(momentum, clip, sched):
    rng = np.random.default_rng(int(momentum * 10) + (clip is not None))
    params = _tree(rng, 1.0)
    grads = [_tree(rng, 2.0) for _ in range(3)]
    lr = (lambda m: m.exponential_decay_schedule(0.05, 0.5, 2)) if sched else None
    jo = jsgd(lr(jsched) if sched else 0.05, momentum=momentum, grad_clip=clip)
    to = tsgd(lr(tsched) if sched else 0.05, momentum=momentum, grad_clip=clip)
    jp, tp = jax.tree.map(jnp.asarray, params), tree_map(torch.as_tensor, params)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js, jm = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, tm = to.update(tree_map(torch.as_tensor, g), ts, tp)
        _close(tp, jp)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=SCHED_RTOL)
        if clip is not None:
            assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                           rel=OPT_TOL)
    assert ts["step"] == int(js["step"]) == 3
    if momentum:
        _close(ts["mu"], js["mu"])


def test_int8_compression_matches_the_reference():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((64, 32)) * 3.0).astype(np.float32)
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    tq, ts = tcomp.quantize_int8(torch.as_tensor(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    np.testing.assert_array_equal(tcomp.dequantize_int8(tq, ts).numpy(),
                                  np.asarray(jcomp.dequantize_int8(jq, js)))
    g = _tree(rng, 0.01)
    je = jcomp.init_error(jax.tree.map(jnp.asarray, g))
    te = tcomp.init_error(tree_map(torch.as_tensor, g))
    for _ in range(5):
        jm, je = jcomp.int8_allreduce(jax.tree.map(jnp.asarray, g), None, je)
        tm, te = tcomp.int8_allreduce(tree_map(torch.as_tensor, g), None, te)
        _close(tm, jm)
        _close(te, je)
    # a named axis needs the mesh that names it (over a mesh of ranks:
    # tests/test_torch_distributed_decode.py)
    with pytest.raises(ValueError, match="DeviceMesh"):
        tcomp.int8_allreduce(tree_map(torch.as_tensor, g), "pod", te)


@pytest.mark.parametrize("base", ["sgd", "adamw"])
def test_compressed_optimizer_matches_the_reference(base):
    from repro.optim.optimizers import adamw as jadamw
    rng = np.random.default_rng(7)
    params = _tree(rng, 1.0)
    mk = {"sgd": lambda m: m(0.05, momentum=0.9), "adamw": lambda m: m(3e-3)}[base]
    jo = jcomp.compressed(mk(jsgd if base == "sgd" else jadamw))
    to = tcomp.compressed(mk(tsgd if base == "sgd" else adamw))
    jp, tp = jax.tree.map(jnp.asarray, params), tree_map(torch.as_tensor, params)
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(4):
        g = _tree(rng, 0.1)
        jp, js, _ = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, _ = to.update(tree_map(torch.as_tensor, g), ts, tp)
        _close(tp, jp)
        _close(ts["err"], js["err"])


# ------------------------------------------------------------- the model


def test_loss_matches_the_reference(pair, ref_step):
    _, tc, _, tp = pair
    batch, (jl, jaux, _) = ref_step
    with torch.no_grad():
        tl, taux = TModel(tc).loss(tp, batch_to(batch, "cpu"), null_ctx())
    assert np.isfinite(jl)
    assert float(tl) == pytest.approx(jl, rel=LOSS_RTOL)
    assert float(taux["xent"]) == pytest.approx(float(jaux["xent"]), rel=LOSS_RTOL)
    assert float(taux["aux"]) == float(jaux["aux"]) == 0.0


def test_one_steps_gradients_match_the_reference(pair, ref_step):
    _, tc, _, tp = pair
    batch, (jl, _, jg) = ref_step
    tl, _, tg = _tloss_and_grads(tc, tp, batch)
    assert tl == pytest.approx(jl, rel=LOSS_RTOL)
    assert len(tg) == len(jg)
    for i, (a, b) in enumerate(zip(tg, jg)):
        assert a.shape == b.shape, i
        scale = max(np.abs(b).max(), 1e-30)
        assert np.abs(a - b).max() <= GRAD_TOL * scale, (i, np.abs(a - b).max(), scale)


def test_full_remat_gives_the_gradients_of_none(pair):
    _, tc, _, tp = pair
    batch = TData(tc, BATCH, SEQ, seed=6).get_batch(2)
    l0, _, g0 = _tloss_and_grads(tc, tp, batch, remat="none")
    l1, _, g1 = _tloss_and_grads(tc, tp, batch, remat="full")
    assert l1 == l0
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_trainer_three_steps_match_the_jax_trainer(pair):
    jc, tc, jp, tp = pair
    jt = JTrainer(jc, batch=BATCH, seq=SEQ, seed=2, val_every=1)
    jt.state = {"params": jax.tree.map(jnp.asarray, jp), "opt": jt.optimizer.init(jp)}
    tt = TTrainer(tc, batch=BATCH, seq=SEQ, seed=2, val_every=1, device="cpu")
    tt.state = {"params": tp, "opt": tt.optimizer.init(tp)}
    jt.run_steps(3)
    tt.run_steps(3)
    assert tt.metrics_steps == jt.metrics_steps == [1, 2, 3]
    np.testing.assert_allclose(tt.metrics_vals, jt.metrics_vals, rtol=TRAINER_RTOL)
    assert tt.state["opt"]["step"] == 3 and tt.mean_step_time() > 0


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bf16_trainer_matches_the_jax_trainer(arch):
    """C4: the config's bf16 and float32 master, five Trainer steps."""
    jc, tc = jget(arch, reduced=True), tget(arch, reduced=True)
    assert jc.dtype == tc.dtype == "bfloat16" and tc.opt_precision == "fp32"
    jp = jax.jit(JModel(jc).init)(jax.random.key(3))
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu")
    jt = JTrainer(jc, batch=BATCH, seq=SEQ, seed=2, val_every=1)
    jt.state = {"params": jp, "opt": jt.optimizer.init(jp)}
    tt = TTrainer(tc, batch=BATCH, seq=SEQ, seed=2, val_every=1, device="cpu")
    tt.state = {"params": tp, "opt": tt.optimizer.init(tp)}
    assert tt.state["opt"]["master"]["embed"]["tok"].dtype == torch.float32
    jt.run_steps(5)
    tt.run_steps(5)
    assert np.isfinite(tt.metrics_vals).all()
    np.testing.assert_allclose(tt.metrics_vals, jt.metrics_vals,
                               rtol=BF16_TRAINER_RTOL)
    assert tree_leaves(tt.state["params"])[0].dtype == torch.bfloat16


def test_train_step_reports_the_references_metrics():
    jc, tc, jp, tp = _pair("qwen1.5-0.5b")
    batch = TData(tc, BATCH, SEQ, seed=8).get_batch(0)
    from repro.launch.train import make_train_step as jmake
    from repro.optim import adamw as jadamw
    jctx, tctx = jnull(attn_chunk=CHUNK, remat="none"), null_ctx(attn_chunk=CHUNK,
                                                                  remat="none")
    jo, to = jadamw(3e-3), adamw(3e-3)
    _, jm = jax.jit(jmake(JModel(jc), jo, jctx))(
        {"params": jp, "opt": jo.init(jp)}, {k: jnp.asarray(v) for k, v in batch.items()})
    state = {"params": tp, "opt": to.init(tp)}
    new, tm = make_train_step(TModel(tc), to, tctx)(state, batch_to(batch, "cpu"))
    assert set(tm) == set(jm) == {"loss", "xent", "aux", "lr", "grad_norm"}
    for k in ("loss", "xent", "aux", "grad_norm"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=LOSS_RTOL, abs=1e-12), k
    assert state["opt"]["step"] == 0 and new["opt"]["step"] == 1
    assert all(not p.requires_grad for p in tree_leaves(new["params"]))


@pytest.mark.parametrize("keep_master", [True, False])
def test_donated_step_equals_the_functional_step(keep_master):
    """``make_train_step(..., donate=True)`` (the Trainer's, as the JAX
    Trainer donates its state) computes the functional step's numbers,
    bit for bit, and leaves the given state's dicts holding None."""
    tc = tget("qwen1.5-0.5b", reduced=True)
    assert tc.dtype == "bfloat16"
    opt = adamw(3e-3, keep_master=keep_master)
    params = TModel(tc).init(torch.Generator().manual_seed(5), device="cpu")
    batch = batch_to(TData(tc, BATCH, SEQ, seed=4).get_batch(0), "cpu")
    ctx = null_ctx(attn_chunk=CHUNK, remat="none")
    state = {"params": params, "opt": opt.init(params)}
    copy = tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, state)
    want, wm = make_train_step(TModel(tc), opt, ctx)(state, batch)
    got, gm = make_train_step(TModel(tc), opt, ctx, donate=True)(copy, batch)
    assert set(got["opt"]) == set(want["opt"]) == ({"step", "m", "v", "master"}
                                                   if keep_master else {"step", "m", "v"})
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert (a == b) if isinstance(a, int) else torch.equal(a, b)
    assert float(gm["grad_norm"]) == float(wm["grad_norm"])
    assert all(x is None for x in tree_leaves(copy["params"]) + tree_leaves(
        {k: v for k, v in copy["opt"].items() if k != "step"}))
    assert all(isinstance(x, torch.Tensor) for x in tree_leaves(state["params"]))


def _sliced_case(keep_master, seed=0):
    """An AdamW update's inputs: bf16 leaves over a cut of 50 elements
    (13 x 7, 7 rows a slice: the first axis not a multiple; 9 x 2 x 4; a
    stacked layer axis of 1 over 13 x 7, sliced under it; 2 x 3 x 40, a
    slice a row) and one under it (3), after one step so that the moments
    and the master are not zeros.  The gradients are multiples of 1/4 up to
    1, so that their float32 squares sum exactly in any order: the clip
    (0.5, which scales them) is the same whole or sliced."""
    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen).to(torch.bfloat16)  # noqa: E731
    params = {"a": rnd(13, 7), "c": [rnd(9, 2, 4)], "b": rnd(3),
              "s": {"stacked": rnd(1, 13, 7), "rows": rnd(2, 3, 40)}}
    opt = adamw(1e-2, keep_master=keep_master, weight_decay=0.1, grad_clip=0.5)
    grads = lambda: tree_map(  # noqa: E731
        lambda p: (torch.randint(-4, 5, p.shape, generator=gen) / 4).to(torch.bfloat16),
        params)
    params, state, _ = opt.update(grads(), opt.init(params), params)
    return opt, params, state, grads()


def _copy(tree):
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)


def _bit_equal(a, b):
    return all((x == y) if isinstance(x, int) else torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("keep_master", [True, False])
def test_sliced_update_equals_the_whole_leaf_update(keep_master, donate, monkeypatch):
    """A leaf over ``SLICE_ELEMS`` is updated a first-axis slice at a time,
    bit-equal to the whole-leaf update (the cut patched to 50 elements);
    donated, the new moments, master and parameters of a sliced leaf are
    the old leaves' storage, and a leaf under the cut takes the whole-leaf
    path (new tensors)."""
    opt, params, state, grads = _sliced_case(keep_master)
    want = opt.update(_copy(grads), _copy(state), _copy(params))
    monkeypatch.setattr(optimizers, "SLICE_ELEMS", 50)
    p, st, g = _copy(params), _copy(state), _copy(grads)
    trees = {"params": p, "m": st["m"], "v": st["v"]}
    if keep_master:
        trees["master"] = st["master"]
    before = {k: [t.data_ptr() for t in tree_leaves(tr)] for k, tr in trees.items()}
    got = opt.update(g, st, p, donate=donate)
    if donate:
        assert tree_leaves(p) == [None] * 5
    del p, st, g, trees
    assert _bit_equal(got[:2], want[:2])
    assert float(got[2]["grad_norm"]) == float(want[2]["grad_norm"])
    assert 0.5 < float(want[2]["grad_norm"])          # the clip scales
    new = {"params": got[0], **{k: got[1][k] for k in before if k != "params"}}
    # leaf order (sorted keys): a, b (under the cut), c, s/rows, s/stacked
    for k, ptrs in before.items():
        now = [t.data_ptr() for t in tree_leaves(new[k])]
        assert [a == b for a, b in zip(now, ptrs)] == [donate, False] + [donate] * 3, k


@pytest.mark.parametrize("keep_master", [True, False])
def test_sliced_update_writes_no_leaf_that_someone_else_holds(keep_master, monkeypatch):
    """Donated, a sliced leaf that the caller still holds (a name, or a
    view of its storage) is not written in place: the caller's tensors keep
    their values and the update is the functional one's, bit for bit."""
    opt, params, state, grads = _sliced_case(keep_master, seed=1)
    want = opt.update(_copy(grads), _copy(state), _copy(params))
    monkeypatch.setattr(optimizers, "SLICE_ELEMS", 50)
    p, st, g = _copy(params), _copy(state), _copy(grads)
    p_c = p["c"][0].data_ptr()
    held, view = p["a"], st["m"]["s"]["stacked"][0, 2:5]
    held_was, view_was = held.clone(), view.clone()
    got = opt.update(g, st, p, donate=True)
    assert torch.equal(held, held_was) and torch.equal(view, view_was)
    assert got[0]["a"].data_ptr() != held.data_ptr()
    assert got[1]["m"]["s"]["stacked"].data_ptr() != view.data_ptr() - 2 * 7 * 4
    assert got[0]["c"][0].data_ptr() == p_c      # held by no one else: in place
    assert _bit_equal(got[:2], want[:2])


def test_global_norm_sums_a_large_leaf_a_slice_at_a_time(monkeypatch):
    """The clip's norm sums a leaf over the cut a slice at a time (no
    float32 copy of the whole leaf): within float32 rounding of the
    whole-leaf sum, and the same bits for leaves under the cut."""
    gen = torch.Generator().manual_seed(3)
    grads = {"big": torch.randn(1, 40, 33, generator=gen).to(torch.bfloat16),
             "small": [torch.randn(5, generator=gen)]}
    whole = float(optimizers.global_norm(grads))
    small = float(optimizers.global_norm({"small": grads["small"]}))
    monkeypatch.setattr(optimizers, "SLICE_ELEMS", 100)
    assert len(optimizers._slices((1, 40, 33))) == 14
    assert float(optimizers.global_norm(grads)) == pytest.approx(whole, rel=1e-6)
    assert float(optimizers.global_norm({"small": grads["small"]})) == small


def test_entry_points_default_to_the_card_and_check_their_flags():
    cfg = tget("zamba2-1.2b", reduced=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TTrainer(cfg, batch=2, seq=16)
    with pytest.raises(ValueError, match="remat"):
        ModelCtx(remat="partial")
    tr = TTrainer(cfg, batch=2, seq=16, device="cpu")
    with pytest.raises(RuntimeError, match="no CheckpointManager"):
        tr.save()
