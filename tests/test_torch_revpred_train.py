"""The port's RevPred training against the JAX package's.

``adamw`` (``repro_torch.optim``) against ``repro.optim.optimizers.adamw``;
the losses; one ``train_model`` step of each predictor from the JAX
package's initial parameters (loss, every gradient leaf, the updated
parameters); two epochs (the batch order, the final parameters, the
accuracy); ``RevPred.train`` for logreg, whose zero init makes the two
packages' runs the same computation; ``build_revpred`` for the learned
kinds.  Inputs come from numpy seeds or ``build_dataset`` on a small market.
On the CPU the LSTM stack trains by autograd of its plain version; its
backward kernel is held against that on the card
(``test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_port  # noqa: F401  (one intra-op thread)

import repro.core.revpred as jr
import repro_torch.core.revpred as tr
from repro.core.market import SpotMarket as JMarket
from repro.optim.optimizers import adamw as jadamw
from repro_torch.core.market import SpotMarket as TMarket
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.optimizers import tree_leaves

# three AdamW steps, float32: 1e-6 relative, and 1e-6 of the leaf's largest
# magnitude where a moment's two terms cancel (XLA contracts b1*m + (1-b1)*g
# into one FMA, and one rounding of an addend is then a large relative
# difference of a small result)
OPT_RTOL = 1e-6
LOSS_TOL = 1e-6
GRAD_TOL = 1e-5     # of each gradient leaf's largest magnitude
STEP_TOL = 1e-6     # one step's updated parameters
FINAL_TOL = 1e-4    # after two epochs (4 steps)

KINDS = {
    "revpred": (jr.init_revpred, jr.revpred_logits, tr.revpred_logits, True),
    "tributary": (jr.init_tributary, jr.tributary_logits, tr.tributary_logits, True),
    "logreg": (jr.init_logreg, jr.logreg_logits, tr.logreg_logits, False),
}


def _tree(rng, scale):
    return {"fc": {"w": (rng.standard_normal((5, 4)) * scale).astype(np.float32),
                   "b": (rng.standard_normal(4) * scale).astype(np.float32)},
            "lstm": [{"w_ih": (rng.standard_normal((3, 8)) * scale).astype(np.float32)},
                     {"w_ih": (rng.standard_normal((2, 8)) * scale).astype(np.float32)}]}


@pytest.mark.parametrize("clip_active", [True, False])
@pytest.mark.parametrize("keep_master", [True, False])
def test_adamw_matches_reference(clip_active, keep_master):
    rng = np.random.default_rng(int(clip_active) * 2 + int(keep_master))
    params = _tree(rng, 1.0)
    grads = [_tree(rng, 2.0 if clip_active else 0.01) for _ in range(3)]
    lr = (lambda step: 3e-3 / step) if keep_master else 3e-3
    jo = jadamw(lr, weight_decay=1e-4, grad_clip=1.0, keep_master=keep_master)
    to = tadamw(lr, weight_decay=1e-4, grad_clip=1.0, keep_master=keep_master)
    jp, tp = jax.tree.map(jnp.asarray, params), tr.params_from_numpy(params, "cpu")
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js, jm = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, tm = to.update(tr.params_from_numpy(g, "cpu"), ts, tp)
        gn = float(jm["grad_norm"])
        assert (gn > 1.0) == clip_active
        np.testing.assert_allclose(float(tm["grad_norm"]), gn, rtol=OPT_RTOL)
    keys = ["m", "v"] + (["master"] if keep_master else [])
    pairs = list(zip(jax.tree.leaves(jax.tree.map(np.asarray, jp)),
                     tree_leaves(tr.params_to_numpy(tp))))
    for k in keys:
        pairs += zip(jax.tree.leaves(jax.tree.map(np.asarray, js[k])),
                     tree_leaves(tr.params_to_numpy(ts[k])))
    for a, b in pairs:
        np.testing.assert_allclose(b, a, rtol=OPT_RTOL,
                                   atol=OPT_RTOL * float(np.abs(a).max()))
    assert ts["step"] == int(js["step"]) == 3


@pytest.mark.parametrize("pos_frac", [0.1, 0.37])
def test_losses_match_reference(pos_frac):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal(300) * 4).astype(np.float32)
    labels = (rng.random(300) < pos_frac).astype(np.float32)
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    jy, ty = jnp.asarray(labels), torch.from_numpy(labels)
    np.testing.assert_allclose(float(tr.weighted_bce(tl, ty, pos_frac)),
                               float(jr.weighted_bce(jl, jy, pos_frac)),
                               rtol=LOSS_TOL)
    want = -jnp.mean(jy * jax.nn.log_sigmoid(jl) + (1 - jy) * jax.nn.log_sigmoid(-jl))
    np.testing.assert_allclose(float(tr.bce(tl, ty)), float(want), rtol=LOSS_TOL)


@pytest.fixture(scope="module")
def data():
    """~690 Algorithm-2 samples of one market of a small market, and a
    held-out day."""
    m = JMarket(days=3, seed=3)
    inst = m.pool[1]
    trace = m.traces[inst.name]
    train = jr.build_dataset(trace, inst.od_price, 0, 2 * 1440, "algo2",
                             np.random.default_rng(0), stride=4)
    held = jr.build_dataset(trace, inst.od_price, 2 * 1440, 3 * 1440 - 70,
                            "random", np.random.default_rng(1), stride=2)
    return train, held


def _jax_init(kind):
    return jax.tree.map(np.asarray, KINDS[kind][0](jax.random.key(5)))


def _jax_loss_and_grads(kind, params, batch, pf):
    _, jfn, _, weighted = KINDS[kind]

    def loss_fn(p):
        lg = jfn(p, jnp.asarray(batch["hist"]), jnp.asarray(batch["present"]))
        y = jnp.asarray(batch["label"])
        if weighted:
            return jr.weighted_bce(lg, y, pf)
        return -jnp.mean(y * jax.nn.log_sigmoid(lg)
                         + (1 - y) * jax.nn.log_sigmoid(-lg))
    loss, grads = jax.value_and_grad(loss_fn)(jax.tree.map(jnp.asarray, params))
    return float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("kind", list(KINDS))
def test_one_train_step_matches_reference(kind, data):
    """One step from the JAX package's initial parameters: the loss, every
    gradient leaf and the updated parameters."""
    train, _ = data
    bs = 256
    batch = {k: v[:bs] for k, v in train.items()}
    _, jfn, tfn, weighted = KINDS[kind]
    init = _jax_init(kind)
    pf = min(max(float(np.mean(batch["label"])), 1e-3), 1 - 1e-3)
    jloss, jgrads = _jax_loss_and_grads(kind, init, batch, pf)

    p = tr.tree_map(lambda t: t.requires_grad_(True), tr.params_from_numpy(init, "cpu"))
    lg = tfn(tr._grouped(p), torch.from_numpy(batch["hist"])[None],
             torch.from_numpy(batch["present"])[None])[0]
    y = torch.from_numpy(batch["label"])
    loss = tr.weighted_bce(lg, y, pf) if weighted else tr.bce(lg, y)
    grads = torch.autograd.grad(loss, tree_leaves(p))
    np.testing.assert_allclose(loss.item(), jloss, rtol=LOSS_TOL)
    for g, j in zip(grads, jax.tree.leaves(jgrads)):
        assert g.shape == j.shape
        assert float(np.abs(g.numpy() - j).max()) <= GRAD_TOL * float(np.abs(j).max())

    losses = []
    tp, tpf = tr.train_model(tfn, tr.params_from_numpy(init, "cpu"), batch,
                             epochs=1, seed=2, weighted=weighted, device="cpu",
                             on_step=losses.append)
    jp, jpf = jr.train_model(jfn, jax.tree.map(jnp.asarray, init), batch,
                             epochs=1, seed=2, weighted=weighted)
    assert tpf == jpf and len(losses) == 1
    np.testing.assert_allclose(float(losses[0]), jloss, rtol=LOSS_TOL)
    for a, b in zip(tree_leaves(tr.params_to_numpy(tp)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jp))):
        np.testing.assert_allclose(a, b, rtol=0, atol=STEP_TOL)


def _jax_batches(n, bs, epochs, seed):
    """The reference's batch order: default_rng(seed).permutation(n) per
    epoch, the last partial batch dropped."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(epochs):
        order = rng.permutation(n)
        out += [order[i:i + bs] for i in range(0, n - bs + 1, bs)]
    return out


@pytest.mark.parametrize("kind", list(KINDS))
def test_two_epochs_match_reference(kind, data):
    """~690 samples, two epochs of two full batches: the port steps through
    the reference's batches in its order (each step's loss is the loss of
    that batch, recomputed here), ends within 1e-4 of the reference's
    parameters, and its accuracy on a held-out day is the reference's or
    one sample from it."""
    train, held = data
    _, jfn, tfn, weighted = KINDS[kind]
    init = _jax_init(kind)
    n = len(train["label"])
    losses = []
    tp, pf = tr.train_model(tfn, tr.params_from_numpy(init, "cpu"), train,
                            epochs=2, seed=4, weighted=weighted, device="cpu",
                            on_step=losses.append)
    jp, jpf = jr.train_model(jfn, jax.tree.map(jnp.asarray, init), train,
                             epochs=2, seed=4, weighted=weighted)
    assert pf == jpf
    batches = _jax_batches(n, 256, 2, 4)
    assert len(losses) == len(batches) == 4 and n % 256
    # replay the reference's order: the first step's loss is the loss of
    # its first batch from the initial parameters
    first = {k: v[batches[0]] for k, v in train.items()}
    np.testing.assert_allclose(float(losses[0]),
                               _jax_loss_and_grads(kind, init, first, pf)[0],
                               rtol=LOSS_TOL)
    for a, b in zip(tree_leaves(tr.params_to_numpy(tp)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jp))):
        np.testing.assert_allclose(a, b, rtol=0, atol=FINAL_TOL)
    use_eq3 = kind == "revpred"
    acc_t = tr.evaluate(tr.TrainedPredictor(tfn, tp, pf, use_eq3, device="cpu"),
                        held)["accuracy"]
    acc_j = jr.evaluate(jr.TrainedPredictor(jfn, jp, jpf, use_eq3), held)["accuracy"]
    assert abs(acc_t - acc_j) <= 1.0 / len(held["label"]) + 1e-12


def test_logreg_train_equals_reference():
    """Logreg starts from zeros in both packages, so ``RevPred.train`` is
    the same computation: each market's pos_frac exactly, predictions
    within 1e-5."""
    jm, tm = JMarket(days=3, seed=3), TMarket(days=3, seed=3)
    a = jr.RevPred.train(jm, 2 * 1440, kind="logreg", epochs=2, stride=4)
    b = tr.RevPred.train(tm, 2 * 1440, kind="logreg", epochs=2, stride=4,
                         device="cpu")
    rng = np.random.default_rng(3)
    for inst in jm.pool:
        pa, pb = a.predictors[inst.name], b.predictors[inst.name]
        assert pa.pos_frac == pb.pos_frac and pa.use_eq3 == pb.use_eq3
        d = jr.build_dataset(jm.traces[inst.name], inst.od_price, 2 * 1440,
                             3 * 1440 - 70, "random", rng, stride=7)
        np.testing.assert_allclose(pb.predict(d["hist"], d["present"]),
                                   pa.predict(d["hist"], d["present"]), atol=1e-5)
        assert jr.evaluate(pa, d) == tr.evaluate(pb, d)


@pytest.mark.parametrize("kind", ["revpred", "tributary", "logreg"])
def test_build_revpred_builds_the_learned_kinds(kind):
    import repro_torch.sweep.spec as ts
    market = TMarket(days=2, seed=1)
    spec = ts.ScenarioSpec(workload="LoR", market_seed=1, revpred=kind)
    rp = ts.build_revpred(spec, market, train_minutes=1440, epochs=1,
                          stride=4, device="cpu")
    assert isinstance(rp, tr.RevPred) and set(rp.predictors) == \
        {i.name for i in market.pool}
    ps = rp.predict_pool(market.pool, 600.0,
                         [1.05 * market.price(i, 600.0) for i in market.pool])
    assert all(0.0 <= p <= 1.0 for p in ps)


def test_torch_initialised_revpred_beats_chance_on_held_out_data():
    """As tests/test_revpred.py:74 holds the reference's training: a
    torch-initialised RevPred trained on the CPU is no worse on a held-out
    day than the majority class less 0.15, and better than a coin."""
    market = TMarket(days=4, seed=5)
    inst = market.pool[0]
    trace = market.traces[inst.name]
    train = tr.build_dataset(trace, inst.od_price, 0, 3 * 1440, "algo2",
                             np.random.default_rng(0), stride=4)
    held = tr.build_dataset(trace, inst.od_price, 3 * 1440, 4 * 1440 - 70,
                            "random", np.random.default_rng(1), stride=2)
    init = tr.init_revpred(torch.Generator().manual_seed(0), device="cpu")
    params, pf = tr.train_model(tr.revpred_logits, init, train, epochs=3,
                                seed=0, device="cpu")
    m = tr.evaluate(tr.TrainedPredictor(tr.revpred_logits, params, pf, True,
                                        device="cpu"), held)
    base = max(m["pos_rate"], 1 - m["pos_rate"])
    assert m["accuracy"] >= base - 0.15 and m["accuracy"] > 0.5


def test_training_entry_points_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tr.train_model(tr.logreg_logits, tr.init_logreg(device="cpu"),
                       {"hist": np.zeros((1, 59, 6), np.float32),
                        "present": np.zeros((1, 7), np.float32),
                        "label": np.zeros(1, np.float32)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tr.RevPred.train(TMarket(days=2, seed=1), 1440, kind="logreg")


def test_params_to_numpy_inverts_params_from_numpy():
    tree = _jax_init("revpred")
    back = tr.params_to_numpy(tr.params_from_numpy(tree, "cpu"))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
