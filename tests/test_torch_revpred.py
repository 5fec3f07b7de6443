"""The port's RevPred against the JAX package's.

Feature engineering, dataset construction, the Eq. 3 de-skew and the oracle
are numpy in both packages and must agree exactly.  The forwards take the
JAX package's weights through ``params_from_numpy`` and agree within 1e-4 on
the logits (float32 products summed in another order, over 59 recurrent
steps); ``predict_pool``'s probabilities agree within 1e-5.  The JAX side's
LSTM cell is its plain reference (``repro.kernels.ops`` on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import jax_revpred, jax_revpred_params, torch_revpred

import repro.core.revpred as jr
import repro_torch.core.revpred as tr
from repro.core.market import SpotMarket as JMarket
from repro_torch.core.market import SpotMarket as TMarket

LOGIT_TOL = 1e-4
P_TOL = 1e-5


@pytest.fixture(scope="module")
def markets():
    return JMarket(days=3, seed=3), TMarket(days=3, seed=3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_features_and_deltas_exact(markets, seed):
    jm, tm = markets
    inst = jm.pool[seed]
    trace = jm.traces[inst.name]
    assert np.array_equal(jr.trace_features(trace, inst.od_price),
                          tr.trace_features(trace, inst.od_price))
    ts = np.arange(60, 3000, 41)
    assert np.array_equal(jr.algorithm2_deltas(trace, ts),
                          tr.algorithm2_deltas(trace, ts))
    assert jr.algorithm2_delta(trace, 30) == tr.algorithm2_delta(trace, 30)
    assert jr.label_revoked(trace, 500, 1.1 * float(trace[500])) == \
        tr.label_revoked(trace, 500, 1.1 * float(trace[500]))


@pytest.mark.parametrize("mode", ["algo2", "random"])
def test_build_dataset_exact(markets, mode):
    jm, _ = markets
    inst = jm.pool[2]
    trace = jm.traces[inst.name]
    a = jr.build_dataset(trace, inst.od_price, 0, 2000, mode,
                         np.random.default_rng(4), stride=5)
    b = tr.build_dataset(trace, inst.od_price, 0, 2000, mode,
                         np.random.default_rng(4), stride=5)
    for k in ("hist", "present", "label"):
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_eq3_deskew_and_sliding_max_exact():
    rng = np.random.default_rng(0)
    p = rng.random(50)
    pf = rng.random(50)
    use = rng.random(50) < 0.5
    assert np.array_equal(jr._eq3_deskew(p, pf, use), tr._eq3_deskew(p, pf, use))
    arr = rng.standard_normal(1000).astype(np.float32)
    assert np.array_equal(jr._sliding_max(arr, 60), tr._sliding_max(arr, 60))


def test_oracle_exact(markets):
    jm, tm = markets
    a, b = jr.OracleRevPred(jm), tr.OracleRevPred(tm)
    rng = np.random.default_rng(1)
    for _ in range(200):
        k = int(rng.integers(len(jm.pool)))
        t = float(rng.uniform(0, 3 * 86400))
        mp = float(jm.price(jm.pool[k], t) * rng.uniform(0.9, 1.2))
        assert a.predict(jm.pool[k], t, mp) == b.predict(tm.pool[k], t, mp)
    assert np.array_equal(a.pool_fm_minute(100), b.pool_fm_minute(100),
                          equal_nan=True)


def _data(markets, n=5):
    jm, _ = markets
    inst = jm.pool[1]
    d = jr.build_dataset(jm.traces[inst.name], inst.od_price, 0, 3000,
                         "random", np.random.default_rng(2), stride=7)
    return d["hist"][:n], d["present"][:n]


def _grouped(tree):
    return tr.tree_map(lambda t: t[None], tree)


@pytest.mark.parametrize("hidden", [16, 32])
@pytest.mark.parametrize("kind", ["revpred", "tributary", "logreg"])
def test_logits_with_jax_weights(markets, kind, hidden):
    hist, present = _data(markets)
    key = jax.random.key(hidden)
    if kind == "revpred":
        jp, jf, tf = jr.init_revpred(key, hidden), jr.revpred_logits, tr.revpred_logits
    elif kind == "tributary":
        jp, jf, tf = jr.init_tributary(key, hidden), jr.tributary_logits, tr.tributary_logits
    else:   # logreg initializes at zero: give it weights that matter
        jp = {"w": jnp.asarray(np.random.default_rng(hidden).standard_normal(7),
                               jnp.float32), "b": jnp.asarray(0.3, jnp.float32)}
        jf, tf = jr.logreg_logits, tr.logreg_logits
    want = np.asarray(jf(jp, jnp.asarray(hist), jnp.asarray(present)))
    tp = tr.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    got = tf(_grouped(tp), torch.from_numpy(hist)[None],
             torch.from_numpy(present)[None])[0]
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_grouped_forward_matches_vmap(markets):
    """Stacked per-market weights along G: the JAX package's vmapped
    forward, one batch-1 row per group."""
    hist, present = _data(markets, n=4)
    keys = [jax.random.key(k) for k in range(4)]
    jps = [jr.init_revpred(k, 16) for k in keys]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *jps)
    want = np.asarray(jax.vmap(jr.revpred_logits)(
        stacked, jnp.asarray(hist[:, None]), jnp.asarray(present[:, None])))
    tp = tr.params_from_numpy(jax.tree.map(np.asarray, stacked), "cpu")
    got = tr.revpred_logits(tp, torch.from_numpy(hist[:, None]),
                            torch.from_numpy(present[:, None]))
    np.testing.assert_allclose(got.numpy(), want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_trained_predictor_predict(markets):
    hist, present = _data(markets, n=6)
    jp = jr.init_revpred(jax.random.key(5), 32)
    a = jr.TrainedPredictor(jr.revpred_logits, jp, 0.3, True)
    b = tr.TrainedPredictor(tr.revpred_logits,
                            tr.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
                            0.3, True, device="cpu")
    np.testing.assert_allclose(b.predict(hist, present), a.predict(hist, present),
                               rtol=P_TOL, atol=P_TOL)


def test_predict_pool_matches_jax(markets):
    jm, tm = markets
    params = jax_revpred_params(jm, hidden=16)
    a, b = jax_revpred(jm, params), torch_revpred(tm, params)
    rng = np.random.default_rng(9)
    for _ in range(4):
        t = float(rng.uniform(2 * 3600, 2.5 * 86400))
        mps = [float(jm.price(i, t) * rng.uniform(0.95, 1.3)) for i in jm.pool]
        pa = a.predict_pool(jm.pool, t, mps)
        pb = b.predict_pool(tm.pool, t, mps)
        np.testing.assert_allclose(pb, pa, rtol=P_TOL, atol=P_TOL)
        # a subset of the pool, answered from the cache and a fresh forward
        sub = [0, 3, 5]
        pa2 = a.predict_pool([jm.pool[k] for k in sub], t + 60.0,
                             [mps[k] for k in sub])
        pb2 = b.predict_pool([tm.pool[k] for k in sub], t + 60.0,
                             [mps[k] for k in sub])
        np.testing.assert_allclose(pb2, pa2, rtol=P_TOL, atol=P_TOL)
    assert set(a._p_cache) == set(b._p_cache)
    # the per-market path agrees with the grouped one
    inst, t = tm.pool[2], 3 * 3600.0
    p_one = b.predictors[inst.name].predict(*[x[None] for x in b._sample(inst, 180, 9.0)])
    np.testing.assert_allclose(p_one[0], b.predict_pool([inst], t, [9.0])[0],
                               rtol=P_TOL, atol=P_TOL)


def test_init_revpred_distribution():
    """Truncated-normal fan-in init: the JAX package's shapes, values inside
    +-2/sqrt(fan_in), std near its truncated-normal value, seeded."""
    want = jax.tree.map(np.shape, jr.init_revpred(jax.random.key(0), 32))
    p = tr.init_revpred(torch.Generator().manual_seed(0), 32, device="cpu")
    assert tr.tree_map(lambda t: tuple(t.shape), p) == want
    w = p["lstm"][1]["w_hh"]
    assert float(w.abs().max()) <= 2.0 / np.sqrt(32) + 1e-6
    # std of N(0,1) truncated at +-2 is 0.8796
    assert abs(float(w.std()) * np.sqrt(32) - 0.8796) < 0.03
    q = tr.init_revpred(torch.Generator().manual_seed(0), 32, device="cpu")
    assert torch.equal(p["fc2"]["w"], q["fc2"]["w"])
    assert all(float(lp["b"].abs().max()) == 0.0 for lp in p["lstm"])


def test_device_defaults_to_the_card():
    """Without a card, an entry point that was not asked for the CPU raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    m = TMarket(days=1, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tr.RevPred(m, {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tr.init_revpred(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tr.TrainedPredictor(tr.logreg_logits, {}, 0.5)
