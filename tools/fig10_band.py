"""The fig10 band that ``chip_smoke.py`` (``FIG10_BAND``) holds the port's
fig10 rows to, from the JAX package's own spread over init keys.

The port's RevPred draws its initial weights with ``torch`` and cannot
reproduce ``jax.random``, so its fig10 rows are held to the spread that the
JAX package itself shows when only the init key changes.  This script trains
fig10's three predictors with ``RevPred.train``'s recipe
(``benchmarks/fig10_revpred.py``: ``SpotMarket(days=12, seed=3)``, 9 days,
``epochs=4``, ``stride=5``; held-out days with ``default_rng(1)``,
``stride=2``; the integrated ``build_spottune`` run) once per key offset:
offset 0 is the golden key (``stable_hash(name)``), offsets 1-3 add
``7919 * offset`` to it.  It prints each offset's ten rows, each row's
standard deviation over offsets 1-3 (ddof 1) and the band:

    golden +- (max(3 x std, floor) + |offset 0 - golden|)

with the golden from ``BENCH_simcore.json``, the floor 0.03 in accuracy and
F1 and 5 % of the golden in the integrated rows, and logreg (zero init,
deterministic) at golden +- 0.005.

    PYTHONPATH=src:. JAX_PLATFORMS=cpu python tools/fig10_band.py

runs the four offsets in four processes on the CPU (about 2.5 minutes each).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
KINDS = ("revpred", "tributary", "logreg")
ROWS = ["revpred_accuracy", "revpred_f1", "tributary_accuracy", "tributary_f1",
        "logreg_accuracy", "logreg_f1", "integrated_revpred_cost_usd",
        "integrated_revpred_pcr", "integrated_tributary_cost_usd",
        "integrated_tributary_pcr"]
OFFSETS = (0, 1, 2, 3)


def train(market, train_minutes, kind, epochs, seed, stride, offset):
    """``repro.core.revpred.RevPred.train`` with the init key moved by
    ``offset``."""
    import jax
    from repro.core import revpred as jr
    from repro.core.market import stable_hash

    fns = {"revpred": (jr.revpred_logits, jr.init_revpred, "algo2", True, True),
           "tributary": (jr.tributary_logits, jr.init_tributary, "random",
                         False, True),
           "logreg": (jr.logreg_logits, jr.init_logreg, "random", False, False)}
    logit_fn, init_fn, sampling, use_eq3, weighted = fns[kind]
    preds = {}
    rng = np.random.default_rng(seed)
    for inst in market.pool:
        key = jax.random.key((stable_hash(inst.name) + 7919 * offset) & 0x7FFFFFFF)
        data = jr.build_dataset(market.traces[inst.name], inst.od_price, 0,
                                train_minutes, sampling, rng, stride)
        p, pf = jr.train_model(logit_fn, init_fn(key), data, epochs=epochs,
                               seed=seed, weighted=weighted)
        preds[inst.name] = jr.TrainedPredictor(logit_fn, p, pf, use_eq3)
    return jr.RevPred(market, preds)


def rows_for(offset: int) -> dict:
    """fig10's ten rows with the init key moved by ``offset``."""
    from repro.core import revpred as jr
    from repro.core.market import SpotMarket
    from repro.core.orchestrator import build_spottune
    from repro.core.trial import WORKLOADS, SimTrialBackend, make_trials

    market = SpotMarket(days=12, seed=3)
    train_min = 9 * 1440
    eval_lo, eval_hi = train_min, 12 * 1440 - 70
    out = {}
    for kind in KINDS:
        rp = train(market, train_min, kind, 4, 0, 5, offset)
        accs, f1s = [], []
        rng = np.random.default_rng(1)
        for inst in market.pool:
            data = jr.build_dataset(market.traces[inst.name], inst.od_price,
                                    eval_lo, eval_hi, "random", rng, stride=2)
            m = jr.evaluate(rp.predictors[inst.name], data)
            accs.append(m["accuracy"])
            f1s.append(m["f1"])
        out[f"{kind}_accuracy"] = float(np.mean(accs))
        out[f"{kind}_f1"] = float(np.mean(f1s))
        if kind != "logreg":
            m = SpotMarket(days=12, seed=3)
            rp.market, rp._p_cache = m, {}
            res = build_spottune(make_trials(WORKLOADS[0]), m,
                                 SimTrialBackend(m.pool), rp, theta=0.7,
                                 mcnt=3, seed=0).run()
            out[f"integrated_{kind}_cost_usd"] = float(res.cost)
            out[f"integrated_{kind}_pcr"] = float(res.pcr() * 1e6)
    return out


def golden() -> dict:
    bench = json.loads((ROOT / "BENCH_simcore.json").read_text())
    vals = {r["name"]: r["value"] for r in bench["suites"]["fig10"]["rows"]}
    return {name: vals[f"fig10_{name}"] for name in ROWS}


def bands(readings: dict, gold: dict) -> dict:
    """{row: (std over offsets 1-3, drift, low, high)}."""
    out = {}
    for name in ROWS:
        if name.startswith("logreg"):
            half, std, drift = 0.005, 0.0, 0.0
        else:
            std = float(np.std([readings[o][name] for o in OFFSETS[1:]], ddof=1))
            drift = abs(readings[0][name] - gold[name])
            floor = (0.05 * gold[name] if name.startswith("integrated")
                     else 0.03)
            half = max(3 * std, floor) + drift
        out[name] = (std, drift, round(gold[name] - half, 4),
                     round(gold[name] + half, 4))
    return out


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--offset":
        print(json.dumps(rows_for(int(sys.argv[2]))))
        return
    procs = {o: subprocess.Popen([sys.executable, __file__, "--offset", str(o)],
                                 stdout=subprocess.PIPE, text=True)
             for o in OFFSETS}
    readings = {}
    for o, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"offset {o} failed (exit {proc.returncode})")
        readings[o] = json.loads(out.strip().splitlines()[-1])
    gold = golden()
    band = bands(readings, gold)
    print(f"{'row':30s} {'golden':>8s} " + " ".join(f"{'key+' + str(o):>9s}"
                                                     for o in OFFSETS)
          + f" {'std(1-3)':>9s} {'drift':>8s}  band")
    for name in ROWS:
        std, drift, lo, hi = band[name]
        print(f"{name:30s} {gold[name]:8.4f} "
              + " ".join(f"{readings[o][name]:9.4f}" for o in OFFSETS)
              + f" {std:9.4f} {drift:8.4f}  [{lo}, {hi}]")
    print(json.dumps({"readings": readings,
                      "band": {n: [b[2], b[3]] for n, b in band.items()}}))


if __name__ == "__main__":
    main()
