"""The port's numpy modules against the JAX package's: market traces,
ledger billing and refunds, the search space, the simulated trials and
their step-time jitter table, the provisioner, and whole tuning runs with
the oracle predictor.  The arithmetic is copied unchanged, so every
comparison is exact (``==`` / ``np.array_equal``), never a tolerance."""

import numpy as np
import pytest
from _torch_port import run_outcome

import repro.core.market as jm
import repro.core.provisioner as jprov
import repro.core.trial as jt
import repro.tuner as jtu
import repro.tuner.space as jsp
import repro_torch.core.market as tm
import repro_torch.core.provisioner as tprov
import repro_torch.core.trial as tt
import repro_torch.tuner as ttu
import repro_torch.tuner.space as tsp
from repro.core.revpred import OracleRevPred as JOracle
from repro_torch.core.revpred import OracleRevPred as TOracle


@pytest.mark.parametrize("seed,days", [(3, 12), (0, 2), (11, 4.5)])
def test_traces_byte_equal(seed, days):
    a = jm.SpotMarket(days=days, seed=seed)
    b = tm.SpotMarket(days=days, seed=seed)
    assert [i.name for i in a.pool] == [i.name for i in b.pool]
    for inst in a.pool:
        x, y = a.traces[inst.name], b.traces[inst.name]
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_csv_traces_equal():
    rows = ["Timestamp,InstanceType,SpotPrice", "90000,v5e-1,2.0",
            "100000,v5e-1,4.0", "0,v5e-1,1.0", "1970-01-01T00:00:00Z,v5e-4,3.0",
            "1970-01-01T10:00:00Z,v5e-4,5.5"]
    text = "\n".join(rows)
    a = jm.load_csv_traces(text, jm.DEFAULT_POOL[:2], 60)
    b = tm.load_csv_traces(text, tm.DEFAULT_POOL[:2], 60)
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k], b[k])


@pytest.mark.parametrize("ledger", ["scalar", "columnar"])
def test_ledger_billing_and_refunds_equal(ledger):
    """The same random acquire/release traffic through both packages'
    markets: identical rows, revocation times, records and totals."""
    a = jm.SpotMarket(days=4, seed=3, ledger=ledger)
    b = tm.SpotMarket(days=4, seed=3, ledger=ledger)
    rng = np.random.default_rng(7)
    live = []
    for _ in range(300):
        if live and rng.random() < 0.45:
            row, t0 = live.pop(int(rng.integers(len(live))))
            t1 = t0 + float(rng.uniform(60.0, 3 * jm.HOUR))
            revoked = bool(rng.random() < 0.5)
            assert (a.ledger.release_row(row, t1, revoked)
                    == b.ledger.release_row(row, t1, revoked))
            assert a.ledger.record(row) == b.ledger.record(row)
        else:
            k = int(rng.integers(len(a.pool)))
            t = float(rng.integers(0, 3 * 24 * 60)) * jm.MINUTE
            mp = float(a.price(a.pool[k], t) * rng.uniform(0.9, 1.3))
            ra = a.ledger.acquire_row(a.pool[k], mp, t)
            rb = b.ledger.acquire_row(b.pool[k], mp, t)
            assert ra == rb
            live.append((ra[0], t))
    assert a.billed == b.billed and a.refunded == b.refunded
    t = 5000.0 * jm.MINUTE
    assert a.pool_prices(t) == b.pool_prices(t)
    assert a.pool_avgs(t) == b.pool_avgs(t)


def test_acquire_batch_multi_equal():
    a = jm.SpotMarket(days=3, seed=11)
    b = tm.SpotMarket(days=3, seed=11)
    rng = np.random.default_rng(5)
    t = 30 * jm.MINUTE
    jobs = []
    for _ in range(40):
        k = int(rng.integers(len(a.pool)))
        jobs.append((k, float(a.price(a.pool[k], t) * rng.uniform(0.85, 1.5))))
    ga = jm.acquire_batch_multi([(a, a.pool[k], mp, t) for k, mp in jobs])
    gb = tm.acquire_batch_multi([(b, b.pool[k], mp, t) for k, mp in jobs])
    assert ga == gb


@pytest.mark.parametrize("w_seed,tick_s", [(0, 10.0), (1234, 10.0), (7, 7.5)])
def test_jitter_table_equal(w_seed, tick_s):
    ja = jt._jitter_ticks(w_seed, tick_s, 9000)
    tb = tt._jitter_ticks(w_seed, tick_s, 9000)
    assert ja.dtype == tb.dtype and ja.tobytes() == tb.tobytes()
    times = np.arange(0, 5000, 37, dtype=np.int64)
    assert np.array_equal(jt._seed_states(w_seed, times),
                          tt._seed_states(w_seed, times))
    assert tt._vec_seed_ok()
    # the pre-seeded shim reproduces the literal SeedSequence draw
    want = np.random.default_rng(np.random.SeedSequence([w_seed, 4321])).normal(1.0, 0.02)
    st = tt._seed_states(w_seed, np.array([4321], np.int64))[0]
    shim = tt._PreSeed()
    shim.words = st
    assert np.random.Generator(np.random.PCG64(shim)).normal(1.0, 0.02) == want


@pytest.mark.parametrize("wi", range(4))
def test_sim_backend_equal(wi):
    wa, wb = jt.WORKLOADS[wi], tt.WORKLOADS[wi]
    assert wa.name == wb.name and wa.hp_grid() == wb.hp_grid()
    ba = jt.SimTrialBackend(jm.DEFAULT_POOL)
    bb = tt.SimTrialBackend(tm.DEFAULT_POOL)
    for sa, sb in zip(jt.make_trials(wa)[:6], tt.make_trials(wb)[:6]):
        assert sa.key == sb.key and sa.hp == sb.hp
        assert ba.true_final(sa) == bb.true_final(sb)
        ve = wa.val_every
        assert ba.metric_range(sa, 1, 40) == bb.metric_range(sb, 1, 40)
        assert ba.metric_at(sa, 17 * ve) == bb.metric_at(sb, 17 * ve)
        for ia, ib in zip(jm.DEFAULT_POOL, tm.DEFAULT_POOL):
            assert ba.base_step_time(sa, ia) == bb.base_step_time(sb, ib)
            assert ba.step_time(sa, ia, 1234.0) == bb.step_time(sb, ib, 1234.0)
            assert np.array_equal(ba.noisy_step_times(sa, ia, 3, 40, 10.0),
                                  bb.noisy_step_times(sb, ib, 3, 40, 10.0))


def test_search_space_equal():
    def space(m):
        return m.SearchSpace((("lr", m.LogUniform(1e-4, 1e-1)),
                              ("bs", m.Choice([32, 64, 128])),
                              ("depth", m.IntUniform(0, 6)),
                              ("mom", m.Uniform(0.5, 0.99))))
    a, b = space(jsp), space(tsp)
    ca = a.sample(np.random.default_rng(3), 20)
    cb = b.sample(np.random.default_rng(3), 20)
    assert ca == cb
    assert [a.config_hash(c) for c in ca] == [b.config_hash(c) for c in cb]
    assert np.array_equal(a.encode(ca), b.encode(cb))
    assert a.decode(a.encode(ca)) == b.decode(b.encode(cb))
    grid_a = jsp.SearchSpace.from_legacy(jt.WORKLOADS[1].hp_space).grid()
    grid_b = tsp.SearchSpace.from_legacy(tt.WORKLOADS[1].hp_space).grid()
    assert grid_a == grid_b


def test_provisioner_choices_equal():
    """Eq.-2 argmin with the oracle predictor: the same candidate draws and
    the same choices, call after call."""
    ma, mb = jm.SpotMarket(days=3, seed=5), tm.SpotMarket(days=3, seed=5)
    pa = jprov.Provisioner(ma, JOracle(ma), jprov.PerfModel(ma.pool), seed=2)
    pb = tprov.Provisioner(mb, TOracle(mb), tprov.PerfModel(mb.pool), seed=2)
    sa = jt.make_trials(jt.WORKLOADS[1])[:4]
    sb = tt.make_trials(tt.WORKLOADS[1])[:4]
    for k in range(30):
        t = 3600.0 + 997.0 * k
        x, y = sa[k % 4], sb[k % 4]
        ca, cb = pa.best_instance(t, x), pb.best_instance(t, y)
        assert (ca.inst.name, ca.max_price, ca.p_revoke, ca.step_cost) == \
            (cb.inst.name, cb.max_price, cb.p_revoke, cb.step_cost)
        fa, fb = pa.best_fused(t, x), pb.best_fused(t, y)
        assert (fa.inst.name, fa.max_price, fa.step_cost) == \
            (fb.inst.name, fb.max_price, fb.step_cost)
        pa.perf.update(ca.inst, x, 1.0 + 0.01 * k)
        pb.perf.update(cb.inst, y, 1.0 + 0.01 * k)


@pytest.mark.parametrize("exact_ticks", [False, True])
@pytest.mark.parametrize("wi,market_seed", [(0, 3), (2, 5)])
def test_oracle_runs_equal(wi, market_seed, exact_ticks):
    """Whole tuning runs on the numpy path (oracle predictor, ASHA: no
    tensors anywhere) give the same billing, events and ranking."""
    ma = jm.SpotMarket(days=12, seed=market_seed)
    mb = tm.SpotMarket(days=12, seed=market_seed)
    ea = jtu.build_engine(ma, jt.SimTrialBackend(ma.pool), JOracle(ma),
                          exact_ticks=exact_ticks)
    eb = ttu.build_engine(mb, tt.SimTrialBackend(mb.pool), TOracle(mb),
                          exact_ticks=exact_ticks)
    ra = jtu.Tuner(ea, jtu.ASHAScheduler(eta=2),
                   jtu.GridSearcher(jt.WORKLOADS[wi])).run()
    rb = ttu.Tuner(eb, ttu.ASHAScheduler(eta=2),
                   ttu.GridSearcher(tt.WORKLOADS[wi])).run()
    assert run_outcome(ea, ra) == run_outcome(eb, rb)
    assert ra.true_rank == rb.true_rank and ra.cost == rb.cost
