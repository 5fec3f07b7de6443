"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
nvcc, holds each kernel against its plain PyTorch version on the card, and
drives the port's two paths through them:

* the SpotTune tuning loop (12-day market, 16 trials, theta=0.7, mcnt=3) with
  a RevPred whose LSTM stack is one ``lstm_stack`` launch per forward (the
  ``lstm_cell`` kernel is held against its plain version alone), repeated on
  the CPU through the plain versions and compared;
* the fig9_sweep1000 grid (1000 replicas) through ``SweepRunner`` on the
  card, whose SoA rounds run the ``soa_step`` kernel (the EWMA fold and the
  per-replica boundary min), repeated on the CPU and compared replica by
  replica, and a 20-replica sweep with RevPreds that reaches lstm_stack
  and soa_step;
* the multi-tenant tuning service: three tenants' fig9-shaped studies (300
  replicas, each with its own 12-day market) under demand contention and
  max-min fairness through ``TuningService(device="cuda")``, whose studies'
  SoA rounds run soa_step, repeated on the CPU and compared (logs, demand
  impulses, records, billing, every replica), beside ``SweepRunner`` on the
  same specs and under the profiler; a learned-RevPred study whose
  predictors the service trains on the card (lstm_stack's training kernels)
  and infers through lstm_stack, its CPU run on the same weights; the
  equivalence harness (``compare_service_modes`` for five policies,
  ``compare_sweep_modes``, ``compare_ledger_modes``, ``compare_runs``) on
  the card; SLAQ and EarlyCurve on Fig. 11's curves, card against CPU;
* the model server: zamba2-1.2b at full width (random weights from a seed)
  through ``Server(device="cuda")``, 4 prompts of 512 tokens and 32 greedy
  tokens each, whose prefill runs the ``flash_attention`` kernel (the
  shared attention block, 7 times, on its bf16 ``wgmma`` route; the
  float32 run takes its 3xTF32 ``wgmma`` route, and fails unless every
  launch does) and the ``ssd_chunk`` kernel (every
  Mamba layer, 38 x 2 chunks, 3xTF32 on the tensor cores, B and C handed
  over with head stride 0), repeated on the card through the plain
  versions (bf16 and float32) and compared, and the reduced zamba2 on the
  card against the CPU;
* RevPred training (fig10): the LSTM stack's training kernels
  (``lstm_stack_fwd_train``, ``lstm_stack_bwd``) held against autograd of
  the plain version, then ``RevPred.train`` for revpred, tributary and
  logreg on the card, their held-out accuracy and F1 and the integrated
  ``build_spottune`` runs, each row held to a band around the JAX
  package's (BENCH_simcore.json), one market's training on the card
  against the CPU, and the training's profile and timing beside cuDNN:
  each training kernel's plan (rows a block, blocks, waves over the SMs,
  shared memory; more than one wave at the training batch fails), its card
  time per call and per dependent diagonal, its bound, and forward +
  backward through autograd broken down into the two kernels, the weight
  gradients' GEMMs and the rest;
* phi3-mini-3.8b at full width (random bf16 weights from a seed): its
  prefill runs flash attention at head dim 96, through the kernels and the
  plain versions, bf16 and float32 (every float32 launch on the 3xTF32
  route).
* the model's training path, last: flash attention's log-sum-exp (both
  routes) against the plain one and the kernels' autograd Functions
  (``FlashAttention``, ``SsdChunk``: kernel forwards, plain backwards)
  against autograd of the plain forwards; float32 zamba2-1.2b at full width
  (B = 2, S = 512), one ``Model.loss`` and its gradients through the
  kernels (7 flash and 76 ssd_chunk launches) and through the plain
  versions, every leaf compared; the config's bf16 with a float32 master,
  5 steps of ``make_train_step`` with ``adamw`` (ms a step, peak memory,
  launches a step, the card's idle share and the backward's share of its
  busy time under the profiler); the plain backwards timed at the training
  shapes beside SDPA's backward and their bounds; ``Trainer`` on the card
  against the CPU on the reduced zamba2 and qwen1.5-0.5b, a checkpoint
  restart on the card, and the full-width state's checkpoint size against
  fig12's store rates.

It profiles the card during the sweep and the serving run and times every
kernel beside its plain version, its bound and a PyTorch call where one
exists (card times from the launches the profiler saw, each printed beside
the launches the calls issued); soa_step also beside its floor, one row of
the recorded round's longest window folded alone; both flash routes at
zamba2's and phi3's prefill shapes beside ``scaled_dot_product_attention``.  Every phase is fatal on failure.  The last line of standard output
is

    {"ok": true, "device": {"platform": "gpu", "kind": "<card>", "count": 1}}

It needs a CUDA card and the rest of the repository: without either it
exits with a non-zero code and prints no result.  It imports nothing of JAX
and nothing of the JAX package ``repro``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

F32_TOL = 1e-5       # the Pallas kernel's tolerances (tests/test_kernels.py)
BF16_TOL = 3e-2
FORWARD_TOL = 1e-4   # whole RevPred forward, kernel against plain, float32
P_CACHE_TOL = 1e-5   # card run against CPU run, per revocation probability
H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12           # float32 outside the tensor cores


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def cuda_ms(fn, iters: int = 2000, warmup: int = 50) -> float:
    """Mean milliseconds per call on the card, by CUDA events around a run
    of back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_intervals(prof):
    """(start_us, end_us, name) of every kernel the profiler saw on the card.
    The spans of a traced step (``ProfilerStep#n``) that the profiler draws
    on the card's timeline are no kernels and are left out."""
    import torch
    out = []
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and not e.name.startswith("ProfilerStep")):
            out.append((e.time_range.start, e.time_range.end, e.name))
    return out


def busy_us(intervals) -> float:
    """Length of the union of the intervals: time the card was busy."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e, _ in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def card_launches(fn, iters: int, warmup: int = 20):
    """{kernel name: (launches seen, card us summed)} over ``iters`` calls
    of ``fn`` traced by torch.profiler.  The trace opens with a step of
    ``iters`` calls whose events the profiler discards: in its first
    moments it misses launches (one trace saw 31 of 50)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    seen = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: seen.extend(device_intervals(p))) as prof:
        for _ in range(2):
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            prof.step()
    by = {}
    for s, e, nm in seen:
        n, t = by.get(nm, (0, 0.0))
        by[nm] = (n + 1, t + e - s)
    return by


def device_us_per_call(fn, iters: int = 200, warmup: int = 20, what: str = ""):
    """Mean microseconds of card time per call (kernels only, launch gaps
    excluded), from a torch.profiler trace; None if the trace has no device
    events.  Built from the launches the profiler saw, never from a sum
    over the calls issued: per kernel name the mean time of a launch seen,
    times the name's launches per call (those seen over the calls issued,
    rounded, at least 1).  Prints each name's launches seen beside the
    launches the calls issued."""
    by = card_launches(fn, iters, warmup)
    if not by:
        return None
    total, parts = 0.0, []
    for nm, (n, t) in sorted(by.items(), key=lambda kv: -kv[1][1]):
        per_call = max(1, round(n / iters))
        total += t / n * per_call
        parts.append(f"{nm[:48]} {n} of {per_call * iters}")
    print(f"  card time {what or 'per call'}: {total:.2f} us from the launches "
          f"seen over {iters} calls: " + "; ".join(parts[:4])
          + (f"; {len(parts) - 4} more names" if len(parts) > 4 else ""))
    return total


def cell_inputs(G, B, I, H, dtype, device, seed=0):
    import torch
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device, dtype)

    return (rnd(G, B, I), rnd(G, B, H), rnd(G, B, H),
            rnd(G, I, 4 * H, scale=0.3), rnd(G, H, 4 * H, scale=0.3),
            rnd(G, 4 * H, scale=0.1))


def cell_bound_ms(G, B, I, H, elem_bytes=4):
    """Least time for one cell call: each input read once and each output
    written once over the HBM rate, against the float32 operations (two
    products and the elementwise tail) over the float32 peak."""
    n_bytes = elem_bytes * (G * B * I + 4 * G * B * H        # x, h, c, h', c'
                            + G * (I + H + 1) * 4 * H)       # w_ih, w_hh, b
    flops = G * B * (2 * (I + H) * 4 * H + 4 * H + 10 * H)
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# (I, T, H, G, B): RevPred's history (I = 6, T = 59) and Tributary's
# (I = 7, T = 60), hidden 16 and 32, one group, the 6-market pool and a
# 40-row cross-replica batch, batch 1 and 4
STACK_SHAPES = [(I, T, H, G, B) for I, T in ((6, 59), (7, 60)) for H in (16, 32)
                for G in (1, 6, 40) for B in (1, 4)]
STACK_LAYERS = 3


def stack_inputs(G, B, T, I, H, dtype, device, seed=0):
    """Seeded xs (G,B,T,I) and three layers of weights and biases."""
    import torch
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device, dtype)

    layers = []
    for n in range(STACK_LAYERS):
        d = I if n == 0 else H
        layers.append({"w_ih": rnd(G, d, 4 * H, scale=d ** -0.5),
                       "w_hh": rnd(G, H, 4 * H, scale=H ** -0.5),
                       "b": rnd(G, 4 * H, scale=0.1)})
    return rnd(G, B, T, I), layers


def stack_bound_ms(G, B, T, I, H, elem_bytes=4):
    """Least time for one stack call: x, every layer's weights and the
    output moved once over the HBM rate, against the float32 operations
    (both products and the elementwise tail, every step of every layer)
    over the float32 peak.  It ignores that the steps depend on each
    other: STACK_LAYERS x T of them run one after another."""
    ins = [I] + [H] * (STACK_LAYERS - 1)
    n_bytes = elem_bytes * (G * B * T * I + G * B * H
                            + G * sum((i + H + 1) * 4 * H for i in ins))
    flops = G * B * T * sum(2 * (i + H) * 4 * H + 4 * H + 10 * H for i in ins)
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


class ForwardCounter:
    """Counts RevPred / Tributary LSTM-stack forwards by wrapping
    ``revpred._run_lstm_stack`` (the forwards look it up at call time); the
    wrapper calls straight through, so the kernels' counts are untouched."""

    def __enter__(self):
        from repro_torch.core import revpred as rp
        self.mod, self.saved, self.n = rp, rp._run_lstm_stack, 0

        def counted(*args, **kwargs):
            self.n += 1
            return self.saved(*args, **kwargs)

        rp._run_lstm_stack = counted
        return self

    def __exit__(self, *exc):
        self.mod._run_lstm_stack = self.saved
        return False


def untrained_revpred(market, device, hidden=32, pos_frac=0.2):
    """A RevPred with freshly initialized (untrained) weights, one generator
    seed per market."""
    import torch
    from repro_torch.core.revpred import (RevPred, TrainedPredictor,
                                          init_revpred, revpred_logits)
    preds = {}
    for k, inst in enumerate(market.pool):
        params = init_revpred(torch.Generator().manual_seed(k), hidden,
                              device=device)
        preds[inst.name] = TrainedPredictor(revpred_logits, params, pos_frac,
                                            True, device=device)
    return RevPred(market, preds, device=device)


def run_scenario(device):
    """The quickstart scenario through the port's entry points."""
    from repro_torch.core.market import SpotMarket
    from repro_torch.core.trial import WORKLOADS, SimTrialBackend
    from repro_torch.tuner import (GridSearcher, SpotTuneScheduler, Tuner,
                                   build_engine)
    market = SpotMarket(days=12, seed=3)
    revpred = untrained_revpred(market, device)
    engine = build_engine(market, SimTrialBackend(market.pool), revpred)
    t0 = time.perf_counter()
    res = Tuner(engine, SpotTuneScheduler(theta=0.7, mcnt=3, device=device),
                GridSearcher(WORKLOADS[0])).run()
    if device == "cuda":
        import torch
        torch.cuda.synchronize()
    return engine, revpred, res, time.perf_counter() - t0


# (F, L, N, R): benchmarks/soa_kernel.py's two shapes, a 1000-replica round,
# and the empty edges (no fold row, no boundary row, neither)
SOA_SHAPES = [(32, 8, 128, 8), (128, 16, 512, 16), (128, 16, 32000, 1000),
              (0, 4, 64, 4), (16, 4, 0, 3), (0, 0, 0, 2)]
SOA_ALPHAS = (0.5, 0.3, 0.1)
H100_F64_FLOPS = 34e12           # float64 outside the tensor cores, data sheet


def soa_inputs(F, L, N, R, alpha, seed=8):
    """Seeded SoA-round inputs as numpy, shaped like benchmarks/soa_kernel.py:
    ragged windows with lens 0 and ``first`` rows, 20 % not-running rows."""
    import numpy as np
    rng = np.random.default_rng(seed)
    obs = rng.uniform(0.5, 2.0, size=(F, L))
    lens = rng.integers(0, L + 1, size=F).astype(np.int64)
    m0 = rng.uniform(0.5, 2.0, size=F)
    first = rng.random(F) < 0.3
    if F >= 2:
        lens[0], first[0] = 0, True
        lens[1], first[1] = L, True
    ewma = np.full(F, alpha)
    next_k = rng.integers(0, 10_000, size=N).astype(np.int64)
    next_k[rng.random(N) < 0.2] = 1 << 60
    row_rep = np.sort(rng.integers(0, R, size=N)).astype(np.int64)
    if N >= R:
        row_rep[:R] = np.arange(R)
        row_rep = np.sort(row_rep)
    return obs, lens, m0, first, ewma, next_k, row_rep


def soa_bound_ms(lens, F, L, N, R):
    """Least time for one fused call on these inputs: the observations the
    fold reads (sum of the windows), the per-row fold inputs and output,
    next_k and row_rep, and the R-slot result, each moved once over the HBM
    rate; against 3 float64 operations per observation and one compare per
    boundary row over the float64 peak.  N = R = 0 is the fold-only entry
    point."""
    import numpy as np
    n_obs = int(np.clip(lens, 0, L).sum())
    n_bytes = 8 * n_obs + F * (8 + 8 + 1 + 8 + 8) + N * 16 + R * 8
    ops = 3 * n_obs + N
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F64_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


class SweepRecorder:
    """Keeps the ``SoaSweep`` a run builds, the inputs of its fused kernel
    calls and the shapes of its fold-only calls, by wrapping the stepper's
    two entry points; the wrappers call straight through, so the kernels'
    own counts are untouched."""

    def __enter__(self):
        from repro_torch.sweep import soa as soa_mod
        self.mod = soa_mod
        self.sweeps, self.fused, self.fold = [], [], []
        self.saved = (soa_mod.SoaSweep.run, soa_mod.soa_step_fused,
                      soa_mod.ewma_fold)
        run, fused, fold = self.saved
        rec = self

        def run_kept(sweep):
            rec.sweeps.append(sweep)
            return run(sweep)

        def fused_kept(obs, lens, m0, first, ewma, next_k, row_rep, n_reps,
                       device):
            # next_k is updated in place by later rounds: keep a copy
            rec.fused.append((obs, lens, m0, first, ewma, next_k.copy(),
                              row_rep.copy(), int(n_reps)))
            return fused(obs, lens, m0, first, ewma, next_k, row_rep, n_reps,
                         device=device)

        def fold_kept(obs, lens, m0, first, ewma, device):
            rec.fold.append(obs.shape)
            return fold(obs, lens, m0, first, ewma, device=device)

        soa_mod.SoaSweep.run = run_kept
        soa_mod.soa_step_fused = fused_kept
        soa_mod.ewma_fold = fold_kept
        return self

    def __exit__(self, *exc):
        (self.mod.SoaSweep.run, self.mod.soa_step_fused,
         self.mod.ewma_fold) = self.saved
        return False


def fig9_grid(engine_seeds=range(10)):
    """The fig9_sweep1000 grid of benchmarks/run.py: 4 workloads x 25 market
    seeds x 10 engine seeds, oracle RevPred, theta=0.7."""
    from repro_torch.core.trial import WORKLOADS
    from repro_torch.sweep import scenario_grid
    names = [w.name for w in WORKLOADS]
    return scenario_grid(names[:4], range(100, 125), revpred="oracle",
                         theta=0.7, engine_seed=engine_seeds)


def replica_view(rr):
    """What the card run and the CPU run must agree on, per replica."""
    r = rr.result
    return (r.cost, r.refunded, r.jct, list(r.predicted_rank),
            list(r.true_rank), dict(r.per_trial_steps), rr.metrics)


def revpred_sweep(device):
    """20 replicas (4 workloads x market seeds 100-104, SpotTune theta=0.7,
    12-day markets) built with ``build_replica`` around untrained RevPreds,
    one per market seed shared by that seed's replicas, stepped by
    ``SoaSweep`` on ``device``."""
    from repro_torch.backends import make_backend
    from repro_torch.core.market import SpotMarket
    from repro_torch.core.trial import WORKLOADS
    from repro_torch.sweep import build_replica, scenario_grid
    from repro_torch.sweep.soa import SoaSweep
    names = [w.name for w in WORKLOADS]
    specs = scenario_grid(names[:4], range(100, 105), scheduler="spottune",
                          theta=0.7, days=12.0, revpred="revpred")
    backend = make_backend("sim")
    rps, tuners = {}, []
    for spec in specs:
        market = SpotMarket(days=spec.days, seed=spec.market_seed)
        rp = rps.get(spec.market_seed)
        if rp is None:
            rp = rps[spec.market_seed] = untrained_revpred(market, device)
        tuners.append(build_replica(spec, market, backend, rp, device=device))
    t0 = time.perf_counter()
    SoaSweep(tuners, device=device).run()
    if device == "cuda":
        import torch
        torch.cuda.synchronize()
    return tuners, rps, time.perf_counter() - t0


def soa_phases(torch) -> dict:
    """The sweep slice: the soa_step kernel against its plain versions, the
    1000-replica sweep on the card and on the CPU, the RevPred sweep, the
    profile and the kernel's timing.  Returns the kernel's JSON row."""
    import collections

    import numpy as np
    from repro_torch.kernels import lstm_cell as klc
    from repro_torch.kernels import ref, soa_step
    from repro_torch.kernels import soa_step_cuda as ksc
    from repro_torch.sweep import SweepRunner, clear_shared_caches

    # ------------------------------------ kernel against plain, bit-exact
    phase("soa_step kernel against its plain versions")
    checked, soa_err = 0, 0.0
    for F, L, N, R in SOA_SHAPES:
        for alpha in SOA_ALPHAS:
            obs, lens, m0, first, ewma, next_k, row_rep = soa_inputs(
                F, L, N, R, alpha)
            m, seg = soa_step.soa_step_fused(obs, lens, m0, first, ewma,
                                             next_k, row_rep, R, device="cuda")
            fold = soa_step.ewma_fold(obs, lens, m0, first, ewma,
                                      device="cuda")
            want_m = soa_step.ewma_fold_ref(obs, lens, m0, first, ewma)
            want_seg = np.full(R, soa_step._BIG, np.int64)
            np.minimum.at(want_seg, row_rep, next_k)
            cuda_args = [torch.from_numpy(a).cuda() for a in
                         (obs, lens, m0, first, ewma, next_k, row_rep)]
            pm, pseg = ref.soa_step_fused_ref(*cuda_args, R)
            cm, cseg = ref.soa_step_fused_ref(
                *[torch.from_numpy(a) for a in
                  (obs, lens, m0, first, ewma, next_k, row_rep)], R)
            folds = [fold, soa_step.ewma_fold_sorted(obs, lens, m0, first,
                                                     ewma),
                     pm.cpu().numpy(), cm.numpy()]
            segs = [pseg.cpu().numpy(), cseg.numpy()]
            starts = np.searchsorted(row_rep, np.arange(R))
            if N and np.all(np.diff(np.append(starts, N)) > 0):
                segs.append(soa_step.segmented_min_ref(next_k, starts))
            ok = (np.array_equal(m, want_m) and np.array_equal(seg, want_seg)
                  and all(np.array_equal(m, f) for f in folds)
                  and all(np.array_equal(seg, s) for s in segs))
            if F:
                soa_err = max(soa_err, float(np.abs(m - want_m).max()))
            if N:
                soa_err = max(soa_err, float(np.abs(seg - want_seg).max()))
            if not ok:
                fail(f"soa_step F={F} L={L} N={N} R={R} alpha={alpha}: not "
                     "bit-exact to ewma_fold_ref / ewma_fold_sorted / "
                     "segmented_min_ref / the plain PyTorch versions")
            checked += 1
    torch.cuda.synchronize()
    print(f"{checked} cases ({len(SOA_SHAPES)} shapes incl. F=0, N=0, lens=0 "
          f"and first rows, x alpha {SOA_ALPHAS}): kernel (fused and "
          f"fold-only) equal by np.array_equal to ewma_fold_ref, "
          f"ewma_fold_sorted, segmented_min_ref and the plain PyTorch "
          f"versions on card and CPU; max abs err {soa_err}")

    # -------------------------------------- the 1000-replica sweep, card
    phase("sweep on the card: fig9_sweep1000, SweepRunner(device='cuda')")
    grid = fig9_grid()
    with SweepRecorder() as rec:
        ksc.LAUNCHES = ksc.FOLD_LAUNCHES = 0
        soa_step.H2D_BYTES = soa_step.D2H_BYTES = 0
        # every 1000-replica run starts from cold caches (traces, fits),
        # so the card run, the CPU run and the profiled run do equal work
        clear_shared_caches()
        t0 = time.perf_counter()
        card = SweepRunner(device="cuda").run(grid, mode="soa")
        torch.cuda.synchronize()
        card_wall = time.perf_counter() - t0
        launches, fold_launches = ksc.LAUNCHES, ksc.FOLD_LAUNCHES
        h2d, d2h = soa_step.H2D_BYTES, soa_step.D2H_BYTES
    fused_launches = launches - fold_launches
    rounds = rec.sweeps[0]._round_no if rec.sweeps else 0
    print(f"{len(grid)} replicas in {card_wall:.3f} s = "
          f"{len(grid) / card_wall:.2f} replicas/s (mode {card.mode}); "
          f"{rounds} rounds")
    print(f"soa_step launches {launches}: fused {fused_launches}, fold-only "
          f"{fold_launches}; copies H2D {h2d} bytes, D2H {d2h} bytes")
    if card.mode != "soa" or fused_launches <= 0:
        fail("the 1000-replica sweep launched the fused soa_step kernel no "
             "time")
    if not all(math.isfinite(r.result.cost) and r.result.cost > 0
               and len(r.result.predicted_rank) == len(r.result.true_rank) > 0
               for r in card.replicas):
        fail("card sweep: a replica has a non-finite cost or an empty rank")
    def shape(call):
        return call[0].shape + (len(call[5]), call[7])

    shapes = collections.Counter(shape(c) for c in rec.fused)
    common, n_common = shapes.most_common(1)[0]
    by_f = sorted(rec.fused, key=lambda c: c[0].shape[0])
    timed = by_f[len(by_f) // 2]
    if n_common > 1:
        timed = next(c for c in rec.fused if shape(c) == common)
    F, L, N, R = shape(timed)
    fold_rows = [c[0].shape[0] for c in rec.fused]
    print(f"{len(shapes)} distinct fused round shapes (F, L, N, R) over "
          f"{len(rec.fused)} fused launches; commonest {common} in {n_common}; "
          f"F median {int(np.median(fold_rows))}, max {max(fold_rows)}; "
          f"fold-only launches: F median "
          f"{int(np.median([s[0] for s in rec.fold])) if rec.fold else 0}")
    print(f"timed below: the inputs of the "
          f"{'commonest' if n_common > 1 else 'median (by F)'} fused round, "
          f"(F, L, N, R) = {(F, L, N, R)}, sum(lens) "
          f"{int(np.clip(timed[1], 0, L).sum())}")

    # -------------------------------------------------- the same, on CPU
    phase("the same grid on the CPU (plain path)")
    clear_shared_caches()
    t0 = time.perf_counter()
    cpu = SweepRunner(device="cpu").run(grid, mode="soa")
    cpu_wall = time.perf_counter() - t0
    diff = [r.spec for r, c in zip(card.replicas, cpu.replicas)
            if replica_view(r) != replica_view(c)]
    print(f"cpu wall {cpu_wall:.3f} s ({len(grid) / cpu_wall:.2f} "
          f"replicas/s); {len(grid) - len(diff)} of {len(grid)} replicas "
          "equal on cost, refund, JCT, predicted and true rank, per-trial "
          "steps and metric histories")
    for spec in diff[:10]:
        print(f"  differs: {spec.workload} market {spec.market_seed} "
              f"engine {spec.engine_seed}")
    if diff:
        fail(f"{len(diff)} replicas differ between the card and the CPU")

    # ------------------------------------------- RevPred sweep, card/CPU
    phase("sweep with RevPred on the card (untrained weights)")
    klc.LAUNCHES = klc.STACK_LAUNCHES = 0
    ksc.LAUNCHES = ksc.FOLD_LAUNCHES = 0
    with ForwardCounter() as fwd:
        rp_tuners, rp_card, rp_wall = revpred_sweep("cuda")
    rp_cell, rp_stack, rp_soa = klc.LAUNCHES, klc.STACK_LAUNCHES, ksc.LAUNCHES
    print(f"{len(rp_tuners)} replicas in {rp_wall:.3f} s; lstm_stack launches "
          f"{rp_stack} for {fwd.n} RevPred forwards, lstm_cell launches "
          f"{rp_cell}, soa_step launches {rp_soa} "
          f"(fold-only {ksc.FOLD_LAUNCHES}); RevPred queries "
          f"{sum(len(rp._p_cache) for rp in rp_card.values())}")
    if rp_stack <= 0 or rp_stack != fwd.n or rp_cell != 0 or rp_soa <= 0:
        fail("the RevPred sweep did not launch lstm_stack once per forward "
             "(and lstm_cell no time) and soa_step")
    cpu_tuners, rp_cpu, rp_cpu_wall = revpred_sweep("cpu")
    p_err, n_common = 0.0, 0
    for seed, rp in rp_card.items():
        other = rp_cpu[seed]._p_cache
        for k, p in rp._p_cache.items():
            if k in other:
                n_common += 1
                p_err = max(p_err, abs(p - other[k]))
    same_cost = all(a.result.cost == b.result.cost
                    and a.result.refunded == b.result.refunded
                    and a.result.predicted_rank == b.result.predicted_rank
                    for a, b in zip(rp_tuners, cpu_tuners))
    print(f"cpu wall {rp_cpu_wall:.3f} s; {n_common} common RevPred queries, "
          f"max abs diff {p_err:.3g} (tol {P_CACHE_TOL}); costs, refunds and rankings "
          f"equal: {same_cost}")
    if not n_common or not p_err <= P_CACHE_TOL or not same_cost:
        fail("the RevPred sweep differs between the card and the CPU")

    # ---------------------------------------------- profile of the sweep
    phase("the 1000-replica sweep on the card under torch.profiler")
    from torch.profiler import ProfilerActivity, profile
    clear_shared_caches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        SweepRunner(device="cuda").run(grid, mode="soa")
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    iv = device_intervals(prof)
    busy = busy_us(iv) / 1e6
    by_kind = collections.defaultdict(float)
    n_soa, soa_s = 0, 0.0
    for s0, s1, nm in iv:
        d = (s1 - s0) / 1e6
        if "soa_step_kernel" in nm:
            kind = "soa_step kernel"
            n_soa += 1
            soa_s += d
        elif "lstm_stack_kernel" in nm or "lstm_cell_kernel" in nm:
            kind = "lstm kernels"
        elif "memcpy" in nm.lower():
            kind = "copies (" + ("H2D" if "HtoD" in nm else "D2H") + ")"
        elif "memset" in nm.lower():
            kind = "memset"
        else:
            kind = "other kernels (EarlyCurve LM fits, torch.full)"
        by_kind[kind] += d
    print(f"profiled wall {prof_wall:.3f} s (profiler on); {len(iv)} device "
          f"events; card busy {busy:.4f} s = {100 * busy / prof_wall:.2f}% "
          f"of the profiled wall, idle {100 * (1 - busy / prof_wall):.2f}%; "
          f"busy against the unprofiled wall {card_wall:.3f} s: "
          f"{100 * busy / card_wall:.2f}%")
    for kind, v in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {v * 1e3:10.3f} ms  {100 * v / max(busy, 1e-12):6.2f}% of "
              f"busy  {kind}")
    sweep_us = soa_s / n_soa * 1e6 if n_soa else None
    print(f"soa_step kernel: {n_soa} launches, {soa_s * 1e3:.3f} ms, "
          f"{sweep_us} us of card time per call over the sweep's rounds")

    # ------------------------------------------------------------- timing
    phase("soa_step timing on a fused round of the sweep (CUDA events)")
    host = timed[:7]
    lens = host[1]
    T = [torch.from_numpy(a).cuda() for a in host]
    m_k, seg_k = ksc.soa_step_fused_cuda(*T, R)
    m_p, seg_p = ref.soa_step_fused_ref(*T, R)
    round_equal = bool(torch.equal(m_k, m_p) and torch.equal(seg_k, seg_p)
                       and torch.equal(ksc.ewma_fold_cuda(*T[:5]), m_p))
    print(f"the recorded round: kernel (fused and fold-only) equal to the "
          f"plain version by torch.equal: {round_equal}")
    if not round_equal:
        fail("soa_step on the recorded round is not bit-exact to its plain "
             "version")
    # the floor: one row as long as the round's longest, folded alone (its
    # dependent float64 chain of max(lens) steps, plus the launch)
    n_max = int(np.clip(lens, 0, L).max())
    i_max = int(np.argmax(np.clip(lens, 0, L)))
    chain = [T[0][i_max:i_max + 1, :n_max].contiguous(),
             torch.tensor([n_max], dtype=torch.int64, device="cuda"),
             T[2][i_max:i_max + 1].clone(),
             torch.zeros(1, dtype=torch.bool, device="cuda"),
             T[4][i_max:i_max + 1].clone()]
    chain_us = device_us_per_call(lambda: ksc.ewma_fold_cuda(*chain))
    chain_ok = torch.equal(ksc.ewma_fold_cuda(*chain),
                           ref.ewma_fold_torch_ref(*chain))
    print(f"chain floor: one row of max(lens) = {n_max} observations folded "
          f"alone: {chain_us} us of card time (equal to plain: {chain_ok})")
    if not chain_ok:
        fail("soa_step's single-row fold is not bit-exact to its plain version")
    ms = cuda_ms(lambda: ksc.soa_step_fused_cuda(*T, R), iters=2000)
    ms_copies = cuda_ms(lambda: soa_step.soa_step_fused(*host, R,
                                                        device="cuda"),
                        iters=500)
    # the plain version is ~7 launches per window column: a few calls do
    plain_ms = cuda_ms(lambda: ref.soa_step_fused_ref(*T, R), iters=20,
                       warmup=3)
    ms_b = cuda_ms(lambda: ksc.soa_step_fused_cuda(*T, R), iters=2000)
    ms_copies_b = cuda_ms(lambda: soa_step.soa_step_fused(*host, R,
                                                          device="cuda"),
                          iters=500)
    plain_ms_b = cuda_ms(lambda: ref.soa_step_fused_ref(*T, R), iters=20,
                         warmup=3)
    fold_ms = cuda_ms(lambda: ksc.ewma_fold_cuda(*T[:5]), iters=2000)

    def library_call():
        seg = torch.full((R,), int(soa_step._BIG), dtype=torch.int64,
                         device="cuda")
        return seg.scatter_reduce_(0, T[6], T[5], "amin")

    lib_seg = library_call()
    lib_ok = torch.equal(lib_seg, ksc.soa_step_fused_cuda(*T, R)[1])
    library_ms = cuda_ms(library_call, iters=2000)
    dev_us = device_us_per_call(lambda: ksc.soa_step_fused_cuda(*T, R))
    plain_dev_us = device_us_per_call(lambda: ref.soa_step_fused_ref(*T, R),
                                      iters=10, warmup=2)
    fold_dev_us = device_us_per_call(lambda: ksc.ewma_fold_cuda(*T[:5]))
    bound_ms, bound_by = soa_bound_ms(lens, F, L, N, R)
    fold_bound_ms, fold_bound_by = soa_bound_ms(lens, F, L, 0, 0)
    print(f"(F, L, N, R) = {(F, L, N, R)}, float64 fold + int64 min: kernel "
          f"{ms:.5f} / {ms_b:.5f} ms, with the copies to and from the card "
          f"{ms_copies:.5f} / {ms_copies_b:.5f} ms, plain {plain_ms:.5f} / "
          f"{plain_ms_b:.5f} ms, fold-only entry {fold_ms:.5f} ms; bound "
          f"{bound_ms:.3g} ms ({bound_by})")
    print(f"card time per call (profiler): kernel {dev_us} us, plain "
          f"{plain_dev_us} us; fold-only entry {fold_dev_us} us against its "
          f"bound {fold_bound_ms:.3g} ms ({fold_bound_by})")
    print(f"library: torch.full + scatter_reduce_('amin') for the min half "
          f"alone {library_ms:.5f} ms (equal to the kernel's min: {lib_ok}); "
          "no single PyTorch call computes the fold")
    return {
        "name": "soa_step", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/soa_step.cu",
        "replaces": "src/repro/kernels/soa_step.py:163 (soa_step_fused); "
                    "src/repro/kernels/soa_step.py:185 (ewma_fold, Pallas "
                    "branch)",
        "launches": launches, "fused_launches": fused_launches,
        "fold_launches": fold_launches,
        "max_abs_err": soa_err,
        "ms": ms, "kernel_ms": ms, "ms_with_copies": ms_copies,
        "plain_ms": plain_ms, "fold_only_ms": fold_ms,
        "fold_only_device_us": fold_dev_us, "fold_only_bound_ms": fold_bound_ms,
        "chain_floor_us": chain_us, "chain_floor_len": n_max,
        "recorded_round_equal": round_equal,
        "fold_only_bound_by": fold_bound_by,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
        "library": "torch.full + scatter_reduce_ amin, the min half alone",
        "shape": {"F": F, "L": L, "N": N, "R": R},
        "device_us": dev_us, "plain_device_us": plain_dev_us,
        "sweep_device_us_per_call": sweep_us,
        "revpred_sweep": {"replicas": len(rp_tuners), "wall_s": rp_wall,
                          "forwards": fwd.n, "lstm_stack_launches": rp_stack,
                          "lstm_cell_launches": rp_cell,
                          "soa_step_launches": rp_soa,
                          "cpu_wall_s": rp_cpu_wall, "max_p_diff": p_err},
        "sweep": {"replicas": len(grid), "wall_s": card_wall,
                  "replicas_per_s": len(grid) / card_wall,
                  "cpu_wall_s": cpu_wall, "rounds": rounds,
                  "h2d_bytes": h2d, "d2h_bytes": d2h,
                  "card_busy_s": busy, "profiled_wall_s": prof_wall},
    }


# ---------------------------------------------------------------------------
# the tuning service (slice 9)
# ---------------------------------------------------------------------------

SERVICE_TENANTS = ("alice", "bob", "carol")
SERVICE_MARKET_SEEDS = 25        # a tenant's market seeds, as fig9's grid
# fig9 runs 10 engine seeds: the contended service costs markets x impulses
# x window (every market replays every tenant's demand impulses): about a
# minute a run at one seed (300 replicas) on the H100 machine's host, and
# 2 or 3 seeds (600, 900) would take several minutes a run (PERF.md §4)
SERVICE_ENGINE_SEEDS = 1
SERVICE_IMPACT = 0.04
SERVICE_POLICY = ("maxmin", {"max_active": 2})
SLAQ_RTOL = 1e-4   # the port's EarlyCurve against the JAX package's
#                    (tests/test_torch_earlycurve.py RTOL)


def service_studies():
    """Each tenant's fig9-shaped study: 4 workloads x 25 market seeds of its
    own (alice 100-124, bob 125-149, carol 150-174) x the engine seeds,
    oracle RevPred, theta=0.7, 12-day markets."""
    from repro_torch.core.trial import WORKLOADS
    from repro_torch.sweep import scenario_grid
    names = [w.name for w in WORKLOADS][:4]
    out = []
    for k, tenant in enumerate(SERVICE_TENANTS):
        lo = 100 + k * SERVICE_MARKET_SEEDS
        out.append((tenant, scenario_grid(
            names, range(lo, lo + SERVICE_MARKET_SEEDS), revpred="oracle",
            theta=0.7, engine_seed=range(SERVICE_ENGINE_SEEDS))))
    return out


def run_service(device, studies, contention=True, policy=SERVICE_POLICY):
    """Submit the studies to a fresh ``TuningService`` on ``device`` (cold
    caches) and pump it to the end.  -> (service, study ids, wall s)."""
    import torch
    from repro_torch.service import StudySpec, TuningService
    from repro_torch.sweep import clear_shared_caches
    clear_shared_caches()
    svc = TuningService(policy=policy[0], policy_params=dict(policy[1]),
                        contention=contention, impact=SERVICE_IMPACT,
                        device=device)
    ids = [svc.submit(StudySpec(tenant=t, specs=tuple(specs)))
           for t, specs in studies]
    t0 = time.perf_counter()
    svc.run_until_complete()
    if device == "cuda":
        torch.cuda.synchronize()
    return svc, ids, time.perf_counter() - t0


def service_view(svc, ids):
    """What a card run and a CPU run of the service must agree on: the
    interleaving, the admissions, the demand impulses, and per study its
    status, streamed records (no wall fields), each market's billing and
    refunds, each replica's ``replica_view`` and engine events."""
    studies = []
    for sid in ids:
        rec = svc.registry.get(sid)
        studies.append((
            rec.status.name, rec.records,
            [(m.billed, m.refunded) for m in rec.markets],
            [replica_view(rr) for rr in rec.result.replicas]
            if rec.result is not None else None,
            [t.engine.events for t in rec.tuners]))
    return (svc.step_log, svc.admission_log,
            None if svc.env is None else svc.env.events, studies)


def service_differences(a, b) -> list:
    names = ("step_log", "admission_log", "env.events")
    out = [n for n, x, y in zip(names, a[:3], b[:3]) if x != y]
    for k, (sa, sb) in enumerate(zip(a[3], b[3])):
        for n, x, y in zip(("status", "records", "billing", "replica_view",
                            "engine events"), sa, sb):
            if x != y:
                out.append(f"study {k}: {n}")
    return out


class RevPredWeights:
    """Makes the learned-RevPred study's card run and CPU run use the same
    weights: wraps the runner's ``build_revpred`` so the card run trains
    each (market seed, engine seed)'s predictor as the runner would (on the
    card, through the LSTM stack's training kernels) and keeps it, and the
    CPU run gets the kept weights moved to the CPU instead of training."""

    def __init__(self):
        self.kept = {}

    def __enter__(self):
        from repro_torch.core import revpred as rp
        from repro_torch.sweep import runner as runner_mod
        self.mod, self.saved = runner_mod, runner_mod.build_revpred
        build, kept = self.saved, self.kept

        def build_kept(spec, market, **kw):
            key = (spec.market_seed, spec.engine_seed)
            src = kept.get(key)
            if src is None:
                kept[key] = build(spec, market, **kw)
                return kept[key]
            dev = kw["device"]
            return rp.RevPred(market, {
                n: rp.TrainedPredictor(
                    p.logit_fn, rp.tree_map(lambda t: t.detach().cpu(),
                                            p.params),
                    p.pos_frac, p.use_eq3, device=dev)
                for n, p in src.predictors.items()}, device=dev)

        runner_mod.build_revpred = build_kept
        return self

    def __exit__(self, *exc):
        self.mod.build_revpred = self.saved
        return False


def fig11_curves():
    """Fig. 11's recipe (benchmarks/fig11_earlycurve.py): every trial's
    simulated curve cut at theta = 0.7, the final as the target; the first
    four workloads and Fig. 11(b)'s ResNet analogue.  -> [(steps, vals,
    target, true final)]."""
    import numpy as np
    from repro_torch.core.market import DEFAULT_POOL
    from repro_torch.core.trial import WORKLOADS, SimTrialBackend, make_trials
    be = SimTrialBackend(DEFAULT_POOL)
    out = []
    for w in WORKLOADS[:4] + WORKLOADS[5:6]:
        steps = np.arange(w.val_every, w.max_trial_steps + 1, w.val_every)
        for tr in make_trials(w):
            curve = be.curve(tr)
            cut = int(0.7 * len(curve))
            out.append((steps[:cut], curve[:cut], w.max_trial_steps,
                        float(curve[-1])))
    return out


def service_phases(torch) -> dict:
    """The service slice: the three-tenant contended service on the card
    (under the profiler) and on the CPU, beside the plain sweep of the same
    specs; a learned-RevPred study; the equivalence harness on the card;
    SLAQ and EarlyCurve on the card against the CPU.  Returns the launch
    counts and numbers for the kernels' JSON rows."""
    import collections

    import numpy as np
    from repro_torch.core.earlycurve import EarlyCurve, SLAQPredictor
    from repro_torch.core.trial import WORKLOADS
    from repro_torch.kernels import lstm_cell as klc
    from repro_torch.kernels import soa_step_cuda as ksc
    from repro_torch.sweep import SweepRunner, clear_shared_caches, scenario_grid
    from repro_torch.tuner import equivalence as eq

    out = {}
    studies = service_studies()
    n_rep = sum(len(s) for _, s in studies)

    # ------------------------------------ the contended service, card
    phase(f"main path: the tuning service on the card ({len(studies)} "
          f"tenants, {n_rep} replicas, contended, impact {SERVICE_IMPACT}, "
          f"{SERVICE_POLICY[0]} max_active "
          f"{SERVICE_POLICY[1]['max_active']})")
    print(f"each tenant: 4 workloads x {SERVICE_MARKET_SEEDS} market seeds x "
          f"{SERVICE_ENGINE_SEEDS} engine seed(s), oracle RevPred, theta 0.7, "
          "12-day markets (fig9's 10 engine seeds cut to 1, PERF.md §4)")
    print("under torch.profiler (CUDA activity only: the run is host-bound, "
          "and a second contended run would cost the script another minute)")
    from torch.profiler import ProfilerActivity, profile
    klc.LAUNCHES = klc.STACK_LAUNCHES = 0
    ksc.LAUNCHES = ksc.FOLD_LAUNCHES = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        card, ids, card_wall = run_service("cuda", studies)
    launches, fold_launches = ksc.LAUNCHES, ksc.FOLD_LAUNCHES
    fused = launches - fold_launches
    applied = sum(m._cursor for sid in ids
                  for m in card.registry.get(sid).markets)
    done = [card.registry.get(sid).status.name for sid in ids]
    print(f"{n_rep} replicas in {card_wall:.3f} s = "
          f"{n_rep / card_wall:.2f} replicas/s; {len(card.step_log)} pumps, "
          f"{len(card.admission_log)} admissions; demand impulses recorded "
          f"{len(card.env.events)}, applied {applied} (impulse x market); "
          f"studies {done}")
    print(f"soa_step launches {launches}: fused {fused}, fold-only "
          f"{fold_launches}; lstm_stack {klc.STACK_LAUNCHES}, lstm_cell "
          f"{klc.LAUNCHES}")
    iv = device_intervals(prof)
    busy = busy_us(iv) / 1e6
    by_kind = collections.defaultdict(float)
    for s0, s1, nm in iv:
        kind = ("soa_step kernel" if "soa_step_kernel" in nm
                else "copies" if "memcpy" in nm.lower()
                else "other kernels (EarlyCurve LM fits, fills)")
        by_kind[kind] += (s1 - s0) / 1e6
    print(f"{len(iv)} device events; card busy {busy:.4f} s = "
          f"{100 * busy / card_wall:.2f}% of the wall, idle "
          f"{100 * (1 - busy / card_wall):.2f}%")
    for kind, v in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {v * 1e3:10.3f} ms  {100 * v / max(busy, 1e-12):6.2f}% of "
              f"busy  {kind}")
    if fused <= 0 or any(d != "DONE" for d in done):
        fail("the service did not finish every study or launched the fused "
             "soa_step kernel no time")
    if not all(math.isfinite(rr.result.cost) and rr.result.cost > 0
               for sid in ids
               for rr in card.registry.get(sid).result.replicas):
        fail("service on the card: a replica has a non-finite cost")
    out["service"] = {"replicas": n_rep, "wall_s": card_wall,
                      "replicas_per_s": n_rep / card_wall,
                      "pumps": len(card.step_log),
                      "impulses": len(card.env.events),
                      "impulses_applied": applied,
                      "soa_step_fused_launches": fused,
                      "soa_step_fold_launches": fold_launches,
                      "card_busy_s": busy, "idle_share": 1 - busy / card_wall}
    card_view = service_view(card, ids)
    del card

    # ----------------------------------------------- the same, on CPU
    phase("the same service on the CPU (plain path)")
    cpu, cpu_ids, cpu_wall = run_service("cpu", studies)
    diff = service_differences(card_view, service_view(cpu, cpu_ids))
    print(f"cpu wall {cpu_wall:.3f} s ({n_rep / cpu_wall:.2f} replicas/s); "
          f"card and CPU equal on step_log, admission_log, env.events and, "
          f"per study, status, streamed records, each market's billed and "
          f"refunded, each replica's replica_view and engine events: "
          f"{not diff}")
    for d in diff[:10]:
        print(f"  differs: {d}")
    if diff:
        fail(f"the service differs between the card and the CPU: {diff[:5]}")
    out["service"]["cpu_wall_s"] = cpu_wall
    del cpu, card_view

    # ------------------------------ the multiplexing's cost, on the card
    phase("the same specs on the card without the service: "
          "SweepRunner(device='cuda'), and the service uncontended")
    specs = [s for _, grid in studies for s in grid]
    clear_shared_caches()
    t0 = time.perf_counter()
    plain_sweep = SweepRunner(device="cuda").run(specs, mode="soa")
    torch.cuda.synchronize()
    sweep_wall = time.perf_counter() - t0
    off, off_ids, off_wall = run_service("cuda", studies, contention=False)
    # uncontended, every replica's outcome is the plain sweep's
    by_spec = {id(s): rr for rr, s in zip(plain_sweep.replicas, specs)}
    off_diff = sum(
        replica_view(rr) != replica_view(by_spec[id(s)])
        for sid in off_ids
        for rr, s in zip(off.registry.get(sid).result.replicas,
                         off.registry.get(sid).specs))
    print(f"SweepRunner: {len(specs)} replicas in {sweep_wall:.3f} s = "
          f"{len(specs) / sweep_wall:.2f} replicas/s (mode "
          f"{plain_sweep.mode}); the service uncontended {off_wall:.3f} s "
          f"({len(off.step_log)} pumps), contended {card_wall:.3f} s: "
          f"{off_wall / sweep_wall:.3f}x and {card_wall / sweep_wall:.3f}x "
          f"the sweep's wall")
    print(f"uncontended service replicas differing from the sweep's: "
          f"{off_diff} of {len(specs)}")
    if plain_sweep.mode != "soa" or off_diff:
        fail("the uncontended service differs from the plain sweep")
    out["service"].update(sweep_wall_s=sweep_wall,
                          uncontended_wall_s=off_wall)
    del off, plain_sweep

    # -------------------------------------- a learned-RevPred study
    phase("main path: a learned-RevPred study through the service "
          "(RevPred trained on the card; the CPU run takes its weights)")
    learned = [("dave", scenario_grid(["LoR"], (100, 101), revpred="revpred",
                                      theta=0.7, engine_seed=range(2)))]
    klc.LAUNCHES = klc.STACK_LAUNCHES = 0
    klc.TRAIN_LAUNCHES = klc.BWD_LAUNCHES = 0
    ksc.LAUNCHES = ksc.FOLD_LAUNCHES = 0
    with RevPredWeights() as weights, ForwardCounter() as fwd:
        l_card, l_ids, l_wall = run_service("cuda", learned)
        n_fwd = fwd.n
        l_launches = {"lstm_stack": klc.STACK_LAUNCHES,
                      "lstm_cell": klc.LAUNCHES,
                      "lstm_stack_fwd_train": klc.TRAIN_LAUNCHES,
                      "lstm_stack_bwd": klc.BWD_LAUNCHES,
                      "soa_step": ksc.LAUNCHES,
                      "soa_step_fold_only": ksc.FOLD_LAUNCHES}
        l_cpu, l_cpu_ids, l_cpu_wall = run_service("cpu", learned)
    print(f"{len(learned[0][1])} replicas (LoR x market seeds 100-101 x 2 "
          f"engine seeds, revpred='revpred', contended) in {l_wall:.3f} s on "
          f"the card, {len(weights.kept)} RevPreds trained there; launches "
          f"{l_launches} for {n_fwd} RevPred forwards (training included)")
    if (l_launches["lstm_stack_fwd_train"] <= 0
            or l_launches["lstm_stack_bwd"] <= 0
            or l_launches["lstm_stack"] <= 0 or l_launches["lstm_cell"] != 0
            or l_launches["soa_step"] <= 0):
        fail("the learned-RevPred study did not launch lstm_stack, its "
             "training kernels and soa_step (or launched lstm_cell)")
    p_err, n_common = 0.0, 0
    for sid, cid in zip(l_ids, l_cpu_ids):
        for ta, tb in zip(l_card.registry.get(sid).tuners,
                          l_cpu.registry.get(cid).tuners):
            pa = ta.engine.prov.revpred._p_cache
            pb = tb.engine.prov.revpred._p_cache
            for k, p in pa.items():
                if k in pb:
                    n_common += 1
                    p_err = max(p_err, abs(p - pb[k]))
    l_diff = service_differences(service_view(l_card, l_ids),
                                 service_view(l_cpu, l_cpu_ids))
    print(f"cpu wall {l_cpu_wall:.3f} s with the card's weights; {n_common} "
          f"common RevPred queries, max abs diff {p_err:.3g} (tol "
          f"{P_CACHE_TOL}); card and CPU runs equal (logs, impulses, "
          f"records, billing, replica views, events): {not l_diff}")
    if not n_common or not p_err <= P_CACHE_TOL or l_diff:
        fail(f"the learned-RevPred study differs between the card and the "
             f"CPU: {l_diff[:5]}")
    out["learned"] = dict(l_launches, forwards=n_fwd, wall_s=l_wall,
                          cpu_wall_s=l_cpu_wall, max_p_diff=p_err,
                          replicas=len(learned[0][1]))
    del l_card, l_cpu

    # ------------------------------------ equivalence harness, card
    phase("the equivalence harness on the card (device='cuda')")
    names = [w.name for w in WORKLOADS][:4]
    sub = dict(revpred="oracle", theta=0.7, engine_seed=range(2))
    checks = []
    for pol in ("spottune", "asha", "hyperband", "pbt", "adaptive"):
        grid = scenario_grid(names, range(100, 105), scheduler=pol, **sub)
        checks.append((f"compare_service_modes {pol} ({len(grid)} replicas)",
                       lambda g=grid: eq.compare_service_modes(
                           g, device="cuda")))
    grid = scenario_grid(names, range(100, 105), **sub)
    for tables in (True, False):
        checks.append((f"compare_sweep_modes use_tables={tables} "
                       f"({len(grid)} replicas)",
                       lambda t=tables: eq.compare_sweep_modes(
                           grid, use_tables=t, device="cuda")))
    checks.append((f"compare_ledger_modes ({len(grid)} replicas)",
                   lambda: eq.compare_ledger_modes(grid, device="cuda")))
    checks.append(("compare_runs LoR, 8-day market seed 3, 6 trials",
                   lambda: eq.compare_runs(WORKLOADS[0], market_seed=3,
                                           days=8.0, n_trials=6,
                                           device="cuda")))
    ksc.LAUNCHES = 0
    eq_bad = []
    for what, fn in checks:
        t0 = time.perf_counter()
        diffs = fn()
        print(f"{what}: {diffs[:3]}{' ...' if len(diffs) > 3 else ''} "
              f"({time.perf_counter() - t0:.2f} s)")
        if diffs:
            eq_bad.append(what)
    print(f"soa_step launches over the harness: {ksc.LAUNCHES}")
    if eq_bad or ksc.LAUNCHES <= 0:
        fail(f"the equivalence harness found differences on the card: "
             f"{eq_bad}")
    out["equivalence_checks"] = len(checks)

    # ------------------------------------------- SLAQ and EarlyCurve
    phase("SLAQ and EarlyCurve on Fig. 11's curves, card against CPU")
    curves = fig11_curves()
    preds = {}
    for dev in ("cuda", "cpu"):
        for name, pred in (("earlycurve", EarlyCurve(device=dev)),
                           ("slaq", SLAQPredictor(device=dev))):
            t0 = time.perf_counter()
            preds[name, dev] = np.array([pred.predict_final(s, v, tgt)
                                         for s, v, tgt, _ in curves])
            if dev == "cuda":
                torch.cuda.synchronize()
            print(f"{name} on {dev}: {len(curves)} curves in "
                  f"{time.perf_counter() - t0:.3f} s")
    truth = np.array([c[3] for c in curves])
    slaq_rel = 0.0
    for name in ("earlycurve", "slaq"):
        a, b = preds[name, "cuda"], preds[name, "cpu"]
        rel = float(np.max(np.abs(a - b) / np.abs(b)))
        err = np.abs(a - truth) / truth
        print(f"{name}: card against CPU max rel diff {rel:.3g} (tol "
              f"{SLAQ_RTOL}); error against the true final mean "
              f"{err.mean():.4f}, max {err.max():.4f}")
        if not (np.all(np.isfinite(a)) and rel <= SLAQ_RTOL):
            fail(f"{name} on the card differs from the CPU by {rel:.3g}")
        if name == "slaq":
            slaq_rel = rel
        out[f"{name}_err_mean"] = float(err.mean())
    out["slaq_card_cpu_rel"] = slaq_rel
    return out


FLASH_TOL = {"float32": 3e-5, "bfloat16": 4e-2}   # tests/test_kernels.py:53
SSD_TOL = 1e-4                                     # tests/test_kernels.py:72
# dt·|A| near 100: |cum| reaches ~6e3, where the float32 prefix sum's
# order-dependent rounding (~4e-4) comes out of the exp as relative error
SSD_LARGE_DECAY_TOL = 1e-2
# kernel run against the plain run of the bf16 model on the card: the two
# differ by float32 summation order inside the kernels, which flips a bf16
# rounding here and there; 45 blocks carry those flips to the output
SERVE_REL_TOL = 5e-2    # of the largest |value|: prefill logits, SSD states
# phi3's float32 prefill logits, kernels against plain, absolute: the port's
# float32 prefill-logit tolerance against the JAX package
# (tests/test_torch_models.py)
PHI3_F32_LOGIT_TOL = 1e-4
H100_BF16_FLOPS = 989e12         # dense bf16 on the tensor cores, data sheet
H100_TF32_FLOPS = 495e12         # dense TF32 on the tensor cores, data sheet
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW, SERVE_MAX_LEN = (
    "zamba2-1.2b", 4, 512, 32, 1024)


def flash_bound_ms(B, Sq, Sk, H, D, causal, elem_bytes, ffma=False):
    """Least time for one attention call: q, k, v read once and o written
    once over the HBM rate, against the two products' multiply-adds over the
    peak of the kernel's arithmetic, counting only the (query, key) pairs
    the mask keeps: bf16 on the tensor cores, float32 at the 3xTF32 rate
    (three TF32 products per float32 product, 495 / 3 TFLOP/s), or with
    ``ffma`` at the float32 rate outside the tensor cores, the bound of the
    float32 FFMA kernel the 3xTF32 one replaced."""
    n_bytes = elem_bytes * B * H * D * (2 * Sq + 2 * Sk)
    if causal:
        pairs = sum(min(i + 1, Sk) for i in range(Sq))
    else:
        pairs = Sq * Sk
    flops = 4.0 * B * H * pairs * D
    peak = (H100_BF16_FLOPS if elem_bytes == 2 else H100_F32_FLOPS if ffma
            else H100_TF32_FLOPS / 3)
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")



def ssd_bound_ms(B, Q, H, P, N, groups=None):
    """Least time for one SSD chunk (float32): x, dt, A and the state read
    once, y and the new state written once, and B and C read once per head
    (``groups=None``, what the FFMA kernel of PRs 13-14 was given) or once
    per group; against the lower-triangle score products (once per head,
    or once per (batch, group)), the output products, the state term and
    the state update.  With ``groups=None`` the operations run at the
    float32 peak outside the tensor cores (the FFMA kernel's bound); with
    groups at the 3xTF32 rate, three TF32 products per float32 product on
    the tensor cores (495 / 3 TFLOP/s)."""
    bc_heads = H if groups is None else groups
    n_bytes = 4 * (B * Q * H * (2 * P + 1) + 2 * B * Q * bc_heads * N + H
                   + 2 * B * H * P * N)
    tri = Q * (Q + 1) // 2
    flops = 2.0 * B * (bc_heads * tri * N + H * tri * P + 2 * H * Q * P * N)
    peak = H100_F32_FLOPS if groups is None else H100_TF32_FLOPS / 3
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def flash_timing(torch, q, k, v, what: str, plain_card=False) -> dict:
    """The flash kernel (causal) on (q, k, v) beside its plain version and
    ``scaled_dot_product_attention`` on the same inputs: CUDA-events ms per
    call (kernel and plain twice, in turns), card time per call of the
    kernel and of SDPA (and of the plain version with ``plain_card``) from
    the launches the profiler saw, the kernel's max abs error against the
    plain version and SDPA's against the kernel, and the kernel's bound
    (float32 also at the FFMA rate of the kernel it replaced)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention_cuda as kfa
    from repro_torch.kernels import ref

    B, S, H, D = q.shape
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def kern():
        return kfa.flash_attention_cuda(q, k, v, True)

    def plain():
        return ref.flash_attention_ref(q, k, v, True)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    r = {"ms": cuda_ms(kern, iters=200), "plain_ms": cuda_ms(plain, iters=50)}
    r["ms_b"], r["plain_ms_b"] = cuda_ms(kern, iters=200), cuda_ms(plain, iters=50)
    r["library_ms"] = cuda_ms(sdpa, iters=200)
    r["device_us"] = device_us_per_call(kern, iters=50, what=f"of the kernel, {what}")
    r["library_device_us"] = device_us_per_call(
        sdpa, iters=50, what=f"of scaled_dot_product_attention, {what}")
    r["plain_device_us"] = (device_us_per_call(plain, iters=10, warmup=2,
                                               what=f"of the plain version, {what}")
                            if plain_card else None)
    o = kern()
    r["err"] = (o.float() - plain().float()).abs().max().item()
    r["library_err"] = (sdpa().transpose(1, 2).float() - o.float()).abs().max().item()
    r["bound_ms"], r["bound_by"] = flash_bound_ms(B, S, S, H, D, True, q.element_size())
    ffma = ""
    if q.dtype == torch.float32:
        r["bound_ms_ffma"], r["bound_by_ffma"] = flash_bound_ms(
            B, S, S, H, D, True, 4, ffma=True)
        ffma = (f", at the FFMA rate of the float32 kernel it replaced "
                f"{r['bound_ms_ffma']:.4g} ms "
                f"({r['bound_by_ffma']})")
    print(f"flash_attention {what} (B,S,H,D) = {(B, S, H, D)} causal: kernel "
          f"{r['ms']:.4f} / {r['ms_b']:.4f} ms, plain {r['plain_ms']:.4f} / "
          f"{r['plain_ms_b']:.4f} ms, scaled_dot_product_attention "
          f"{r['library_ms']:.4f} ms (CUDA events); card time per call: kernel "
          f"{r['device_us']} us, scaled_dot_product_attention "
          f"{r['library_device_us']} us, plain {r['plain_device_us']} us; bound "
          f"{r['bound_ms']:.4g} ms ({r['bound_by']}){ffma}; max abs err "
          f"{r['err']:.3g} against the plain version, SDPA {r['library_err']:.3g} "
          f"from the kernel")
    return r


def serve_phases(torch) -> tuple:
    """The model-server slice: both kernels against their plain versions,
    zamba2-1.2b served at full width on the card through the kernels and
    through the plain versions (bf16, then float32), the reduced zamba2 on
    the card against the CPU, the profile and the kernels' timing.  Returns
    the JSON rows of flash attention's two routes (bf16, float32) and of
    ssd_chunk."""
    import dataclasses

    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention_cuda as kfa
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_chunk_cuda as kss
    from repro_torch.launch.serve import Server
    from repro_torch.models.context import ModelCtx
    from repro_torch.models.model import Model, tree_leaves, tree_map

    gen = torch.Generator().manual_seed(11)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to("cuda", dtype)

    names = {torch.float32: "float32", torch.bfloat16: "bfloat16"}

    # --------------------------------------- flash kernel against plain
    phase("flash_attention kernel against its plain version")
    cfg = get_config(SERVE_ARCH)
    B, S, H, D = SERVE_BATCH, SERVE_PROMPT, cfg.n_heads, cfg.head_dim
    # (B, Sq, Sk, H, D, dtype, causal): zamba2's prefill and phi3's (head
    # dim 96) in both types; the bf16 kernel at every head dim, S in
    # (1, 200, 333, 512) with Sk = Sq and Sk = Sq + 37; the float32 3xTF32
    # kernel at every head dim, S in (1, 200, 333), Sk = Sq and Sq + 37
    p3 = get_config(PHI3_ARCH)
    cases = [(B, S, S, H, D, dt, c) for dt in (torch.bfloat16, torch.float32)
             for c in (True, False)]
    cases += [(PHI3_BATCH, PHI3_PROMPT, PHI3_PROMPT, p3.n_heads,
               p3.d_model // p3.n_heads, dt, c)
              for dt in (torch.bfloat16, torch.float32) for c in (True, False)]
    cases += [(2, s, sk, 4, d, torch.bfloat16, c)
              for d in (16, 32, 64, 96, 128) for s in (1, 200, 333, 512)
              for sk in (s, s + 37) for c in (True, False)]
    cases += [(2, s, sk, 4, d, torch.float32, c) for d in kfa.HEAD_DIMS
              for s in (1, 200, 333) for sk in (s, s + 37)
              for c in (True, False)]
    flash_err = {"float32": 0.0, "bfloat16": 0.0}

    def check_flash(q, k, v, causal, what, scale=None):
        o = kfa.flash_attention_cuda(q, k, v, causal, scale)
        want = ref.flash_attention_ref(q, k, v, causal, scale)
        torch.cuda.synchronize()
        e = (o.float() - want.float()).abs().max().item()
        tol = FLASH_TOL[names[q.dtype]]
        if not (o.shape == q.shape and e <= tol):
            fail(f"flash_attention {names[q.dtype]} {what} causal={causal}: "
                 f"max abs err {e:.3g} > {tol}")
        flash_err[names[q.dtype]] = max(flash_err[names[q.dtype]], e)

    wg0, tf0 = kfa.WGMMA_LAUNCHES, kfa.TF32_LAUNCHES
    for b_, s_, sk_, h_, d_, dt, causal in cases:
        q = randn(b_, s_, h_, d_, dtype=dt)
        k, v = (randn(b_, sk_, h_, d_, dtype=dt) for _ in range(2))
        check_flash(q, k, v, causal, f"B={b_} Sq={s_} Sk={sk_} H={h_} D={d_}")
    # strided views: q sliced in S and H, v a (B, H, S, D) tensor transposed,
    # and the model's own layout (attention.py's q, k, v of one projection)
    for dt in (torch.bfloat16, torch.float32):
        wide = randn(2, 96, 8, 64, dtype=dt)
        q = wide[:, 10:50, :4]
        k = randn(2, 70, 4, 64, dtype=dt)
        v = randn(2, 4, 70, 64, dtype=dt).transpose(1, 2)
        for causal in (True, False):
            check_flash(q, k, v, causal, "strided q and v", scale=0.2)
        qkv = randn(2, 100, 3 * 4 * 64, dtype=dt).view(2, 100, 3, 4, 64)
        check_flash(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], True,
                    "q, k, v slices of one (B, S, 3, H, D) tensor")
    n_wg, n_tf = kfa.WGMMA_LAUNCHES - wg0, kfa.TF32_LAUNCHES - tf0
    n_bf16 = sum(1 for c in cases if c[5] == torch.bfloat16) + 3
    n_f32 = len(cases) + 6 - n_bf16
    if (n_wg, n_tf) != (n_bf16, n_f32):
        fail(f"the bf16 cases launched the bf16 kernel {n_wg} times (want "
             f"{n_bf16}), the float32 cases the 3xTF32 kernel {n_tf} times "
             f"(want {n_f32})")
    print(f"{len(cases) + 6} cases (zamba2's prefill B={B} S={S} H={H} D={D} "
          f"and {PHI3_ARCH}'s B={PHI3_BATCH} S={PHI3_PROMPT} H={p3.n_heads} "
          f"D={p3.d_model // p3.n_heads} in both types, causal and not; at D "
          f"in {kfa.HEAD_DIMS} bf16 with S in (1, 200, 333, 512) and f32 with "
          f"S in (1, 200, 333), Sk = S and S + 37; strided views in both "
          f"types): max abs err f32 {flash_err['float32']:.3g} (tol "
          f"{FLASH_TOL['float32']}), bf16 {flash_err['bfloat16']:.3g} (tol "
          f"{FLASH_TOL['bfloat16']}); every bf16 case ran the bf16 wgmma "
          f"kernel ({n_wg} launches), every f32 case the 3xTF32 wgmma kernel "
          f"({n_tf} launches)")

    # ----------------------------------------- ssd kernel against plain
    phase("ssd_chunk kernel against its plain version")
    Q, SH, SP, SN = cfg.ssm_chunk, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state

    def ssd_inputs(b_, q_, h_, p_, n_, dt_scale=1.0):
        dt = (torch.rand(b_, q_, h_, generator=gen) * 0.099 + 0.001) * dt_scale
        A = -(torch.rand(h_, generator=gen) * 1.5 + 0.5)
        return (randn(b_, q_, h_, p_), dt.cuda(), A.cuda(), randn(b_, q_, h_, n_),
                randn(b_, q_, h_, n_), randn(b_, h_, p_, n_))

    def stride0(args):
        """B and C as the model hands them over for one group: a (B,Q,N)
        tensor expanded over the heads (head stride 0)."""
        x, dt, A, Bm, Cm, st = args
        return (x, dt, A, Bm[:, :, :1].expand_as(Bm), Cm[:, :, :1].expand_as(Cm),
                st)

    # (shape, dt scale, B and C with head stride 0, chunk slice of S = 2Q)
    ssd_cases = [((B, Q, SH, SP, SN), 1.0, True, False),
                 ((B, Q, SH, SP, SN), 1.0, False, False),
                 ((2, Q, 8, SP, SN), 1.0, True, True),
                 ((1, Q, 4, SP, 128), 1.0, True, False),
                 ((2, 200, 3, SP, SN), 1.0, True, False),
                 ((2, 32, 3, 8, 4), 1.0, False, False),
                 ((1, 64, 2, 16, 8), 1.0, False, False),
                 ((3, 16, 1, 4, 4), 1.0, False, False),
                 ((2, 64, 3, 16, 8), 1000.0, False, False)]
    ssd_err = 0.0
    for shape, dt_scale, s0, sliced in ssd_cases:
        if sliced:
            b_, q_, h_, p_, n_ = shape
            x, dt, A, Bm, Cm, st = ssd_inputs(b_, 2 * q_, h_, p_, n_)
            sl = slice(q_, 2 * q_)
            args = (x[:, sl], dt[:, sl], A, Bm[:, sl], Cm[:, sl], st)
        else:
            args = ssd_inputs(*shape, dt_scale=dt_scale)
        if s0:
            args = stride0(args)
        y, st = kss.ssd_chunk_cuda(*args)
        y2, st2 = ref.ssd_chunk_ref(*args)
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(y).all() and torch.isfinite(st).all())
        tol = SSD_TOL if dt_scale == 1.0 else SSD_LARGE_DECAY_TOL
        ok = all(torch.allclose(a, b_, rtol=tol, atol=tol)
                 for a, b_ in ((y, y2), (st, st2)))
        e = max((y - y2).abs().max().item(), (st - st2).abs().max().item())
        r = max(((y - y2).abs() / y2.abs().clamp_min(1e-6)).max().item(),
                ((st - st2).abs() / st2.abs().clamp_min(1e-6)).max().item())
        what = (f"{shape} dt x {dt_scale}" + (", B/C head stride 0" if s0 else "")
                + (", a chunk slice of S = 2Q" if sliced else ""))
        if not (finite and ok):
            fail(f"ssd_chunk {what}: finite {finite}, max abs err {e:.3g} "
                 f"(rtol = atol = {tol})")
        if dt_scale == 1.0:
            ssd_err = max(ssd_err, e)
            print(f"  {what}: max abs err {e:.3g}")
        else:
            print(f"dt x {dt_scale} (dt|A| up to ~200): finite; max abs err "
                  f"{e:.3g}, max rel err {r:.3g} (rtol = atol = {tol})")
    print(f"{len(ssd_cases) - 1} cases (zamba2's chunk (B,Q,H,P,N) = "
          f"{(B, Q, SH, SP, SN)} with B/C of head stride 0 and per head, a "
          f"chunk slice of the stride-0 view, N = 128, Q = 200, and "
          f"tests/test_kernels.py's three shapes) agree within rtol = atol = "
          f"{SSD_TOL}; max abs err {ssd_err:.3g}")

    # -------------------------------------- the main path: the server
    phase(f"main path: {SERVE_ARCH} served at full width on the card")
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"{cfg.name}: {n_params:,} parameters ({cfg.dtype}), {cfg.n_layers} "
          f"Mamba2 layers (d_model {cfg.d_model}, {SH} SSD heads x {SP}, "
          f"d_state {SN}, chunk {Q}) + the shared attention block x "
          f"{model.n_shared_invocations} ({H} heads x {D}); random weights "
          f"from seed 0, init {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(SERVE_BATCH, SERVE_PROMPT))
    server = Server(cfg, params, max_len=SERVE_MAX_LEN, device="cuda")
    plain = Server(cfg, params, ctx=ModelCtx(kernels="ref"),
                   max_len=SERVE_MAX_LEN, device="cuda")
    server.generate({"tokens": toks[:, :64]}, 2)         # warm-up
    torch.cuda.synchronize()
    kfa.LAUNCHES = kfa.WGMMA_LAUNCHES = kss.LAUNCHES = 0
    t0 = time.perf_counter()
    out = server.generate({"tokens": toks}, SERVE_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    fa_launches, ss_launches = kfa.LAUNCHES, kss.LAUNCHES
    fa_wgmma = kfa.WGMMA_LAUNCHES
    want_fa = model.n_shared_invocations
    want_ss = cfg.n_layers * -(-SERVE_PROMPT // Q)
    print(f"generate: {SERVE_BATCH} x {SERVE_PROMPT} prompt tokens -> "
          f"{tuple(out.shape)} tokens in {gen_s * 1e3:.1f} ms")
    print(f"launches per prefill: flash_attention {fa_launches}, all of them "
          f"the bf16 wgmma kernel: {fa_wgmma == fa_launches} (want "
          f"{want_fa}), ssd_chunk {ss_launches} (want {cfg.n_layers} x "
          f"{-(-SERVE_PROMPT // Q)} = {want_ss})")
    if fa_launches != want_fa or fa_wgmma != want_fa or ss_launches != want_ss:
        fail("the server's prefill did not launch each kernel once per "
             "attention block / SSD chunk, the bf16 attention through the "
             "wgmma kernel")
    if not (out.shape == (SERVE_BATCH, SERVE_NEW) and int(out.min()) >= 0
            and int(out.max()) < cfg.vocab_size):
        fail("generated tokens out of range")

    dev_tok = torch.as_tensor(toks, device="cuda").long()
    with torch.inference_mode():
        def prefill_ms(srv, n=3):
            srv.prefill(dev_tok)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(n):
                srv.prefill(dev_tok)
            torch.cuda.synchronize()
            return (time.perf_counter() - t) / n * 1e3
        pre_ms = prefill_ms(server)
        pre_plain_ms = prefill_ms(plain)
        pre_ms_b = prefill_ms(server)
        lg_k, cache_k = server.prefill(dev_tok)
        lg_r, cache_r = plain.prefill(dev_tok)
        torch.cuda.synchronize()
    decode_ms = (gen_s * 1e3 - pre_ms) / (SERVE_NEW - 1)
    print(f"prefill {pre_ms:.2f} / {pre_ms_b:.2f} ms through the kernels, "
          f"{pre_plain_ms:.2f} ms through the plain versions; decode "
          f"{decode_ms:.3f} ms per token step (generate less one prefill); "
          f"{SERVE_BATCH * SERVE_NEW / gen_s:.1f} generated tokens/s, "
          f"{SERVE_BATCH * SERVE_PROMPT / pre_ms * 1e3:.0f} prompt tokens/s")

    phase("the same weights and prompts through the plain versions (bf16)")
    out_r = plain.generate({"tokens": toks}, SERVE_NEW)
    torch.cuda.synchronize()
    lg_k, lg_r = lg_k.float()[:, -1], lg_r.float()[:, -1]
    lg_err = (lg_k - lg_r).abs().max().item()
    lg_tol = SERVE_REL_TOL * lg_r.abs().max().item()
    st_k, st_r = cache_k["mamba"]["state"], cache_r["mamba"]["state"]
    st_err = (st_k - st_r).abs().max().item()
    st_tol = SERVE_REL_TOL * st_r.abs().max().item()
    top2 = lg_r.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    sure = margin > lg_tol
    first_ok = bool((out[:, 0] == out_r[:, 0])[sure].all())
    same = int((out == out_r).sum())
    print(f"prefill logits: max abs diff {lg_err:.4g} (tol {lg_tol:.4g} = "
          f"{SERVE_REL_TOL} x max |logit| {lg_r.abs().max().item():.4g}); final "
          f"SSD states ({tuple(st_r.shape)}): max abs diff {st_err:.4g} (tol "
          f"{st_tol:.4g})")
    print(f"first token: top-2 margins {[round(m, 4) for m in margin.tolist()]}; "
          f"{int(sure.sum())} of {SERVE_BATCH} above the tolerance, equal there: "
          f"{first_ok}; {same} of {out.numel()} generated tokens agree")
    if not (lg_err <= lg_tol and st_err <= st_tol and first_ok):
        fail("the bf16 server through the kernels and through the plain "
             "versions disagree beyond the stated tolerance")

    phase("the same in float32, through the kernels and the plain versions")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    del cache_k, cache_r
    s32 = Server(cfg32, p32, max_len=SERVE_MAX_LEN, device="cuda")
    s32_r = Server(cfg32, p32, ctx=ModelCtx(kernels="ref"),
                   max_len=SERVE_MAX_LEN, device="cuda")
    kfa.LAUNCHES = kfa.TF32_LAUNCHES = kss.LAUNCHES = 0
    out32 = s32.generate({"tokens": toks}, SERVE_NEW)
    torch.cuda.synchronize()
    l32 = (kfa.LAUNCHES, kss.LAUNCHES)
    tf32_launches = kfa.TF32_LAUNCHES
    out32_r = s32_r.generate({"tokens": toks}, SERVE_NEW)
    with torch.inference_mode():
        lg32_k = s32.prefill(dev_tok)[0].float()[:, -1]
        lg32_r = s32_r.prefill(dev_tok)[0].float()[:, -1]
        pre32_ms, pre32_plain_ms = prefill_ms(s32), prefill_ms(s32_r)
    torch.cuda.synchronize()
    same32 = int((out32 == out32_r).sum())
    lg32_err = (lg32_k - lg32_r).abs().max().item()
    bf16_dev = (lg_r - lg32_r).abs().max().item()
    print(f"full depth ({cfg.n_layers} layers), float32 weights cast from the "
          f"bf16 ones; launches (flash_attention, ssd_chunk) {l32}, flash on "
          f"the 3xTF32 route {tf32_launches} (want {want_fa}); {same32} of "
          f"{out32.numel()} tokens equal; prefill logits kernels against "
          f"plain: max abs diff {lg32_err:.4g}; prefill {pre32_ms:.2f} ms "
          f"through the kernels, {pre32_plain_ms:.2f} ms plain")
    print(f"bf16 rounding alone: the plain bf16 run's prefill logits are "
          f"{bf16_dev:.4g} (max abs) from the plain float32 run's")
    if not l32[0] == tf32_launches == want_fa:
        fail(f"the float32 prefill launched flash {l32[0]} times, "
             f"{tf32_launches} of them on the 3xTF32 route (want {want_fa})")
    if same32 != out32.numel():
        fail("float32 serving through the kernels and the plain versions "
             "generated different tokens")
    del p32, s32, s32_r

    phase("reduced zamba2 (float32) on the card against the CPU")
    rcfg = dataclasses.replace(get_config(SERVE_ARCH, reduced=True),
                               dtype="float32")
    rparams = Model(rcfg).init(torch.Generator().manual_seed(0), device="cpu")
    rtoks = np.random.default_rng(1).integers(0, rcfg.vocab_size, size=(4, 100))
    r_card = Server(rcfg, tree_map(lambda t: t.cuda(), rparams), max_len=160,
                    device="cuda").generate({"tokens": rtoks}, 32)
    r_cpu = Server(rcfg, rparams, max_len=160, device="cpu").generate(
        {"tokens": rtoks}, 32)
    r_same = bool(torch.equal(r_card.cpu(), r_cpu))
    print(f"{rcfg.name}: 4 x 100 prompt tokens, 32 new: card and CPU tokens "
          f"equal: {r_same}")
    if not r_same:
        fail("the reduced zamba2 generates different tokens on card and CPU")

    # ------------------------------------------------ where the time goes
    phase(f"{SERVE_ARCH} prefill and decode under torch.profiler")
    from torch.profiler import ProfilerActivity, profile
    spans = {}
    with torch.inference_mode():
        for what in ("prefill", "decode"):
            logits, cache = server.prefill(dev_tok)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                if what == "prefill":
                    server.prefill(dev_tok)
                else:
                    for i in range(SERVE_NEW - 1):
                        tok, cache = server.step(cache, tok, SERVE_PROMPT + i)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            iv = device_intervals(prof)
            spans[what] = (wall, iv)
    kern_us = {}
    for what, (wall, iv) in spans.items():
        busy = busy_us(iv) / 1e6
        by = {}
        for s0, s1, nm in iv:
            key = ("flash_attention kernel" if "flash_attention" in nm
                   else "ssd_chunk kernel" if "ssd_chunk_kernel" in nm
                   else "gemm" if "gemm" in nm.lower() or "cutlass" in nm.lower()
                   or "sm90" in nm.lower() else "other")
            n, tsum = by.get(key, (0, 0.0))
            by[key] = (n + 1, tsum + (s1 - s0) / 1e6)
        print(f"{what}: wall {wall * 1e3:.2f} ms (profiler on), {len(iv)} "
              f"kernels, card busy {busy * 1e3:.2f} ms = "
              f"{100 * busy / wall:.2f}%, idle {100 * (1 - busy / wall):.2f}%")
        for key, (n, tsum) in sorted(by.items(), key=lambda kv: -kv[1][1]):
            print(f"  {tsum * 1e3:9.3f} ms  {100 * tsum / max(busy, 1e-12):6.2f}% "
                  f"of busy  {n:6d} launches  {key}")
            if key.endswith("kernel"):
                kern_us[key] = tsum / n * 1e6
    print(f"card time per call over the prefill: flash_attention "
          f"{kern_us.get('flash_attention kernel')} us, ssd_chunk "
          f"{kern_us.get('ssd_chunk kernel')} us")

    # -------------------------------------------------------------- timing
    phase("flash_attention and ssd_chunk timing at zamba2's shapes "
          "(CUDA events, card time)")
    fa = {}
    for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        q, k, v = (randn(B, S, H, D, dtype=dt) for _ in range(3))
        fa[name] = flash_timing(torch, q, k, v, f"{name}, {SERVE_ARCH}'s prefill",
                                plain_card=True)
        if not fa[name]["err"] <= FLASH_TOL[names[dt]]:
            fail(f"flash_attention {name} at {SERVE_ARCH}'s prefill shape: max abs "
                 f"err {fa[name]['err']:.3g} > {FLASH_TOL[names[dt]]}")
        del q, k, v
    # as the prefill hands them over: B and C of head stride 0 (one group)
    args = stride0(ssd_inputs(B, Q, SH, SP, SN))
    per_head = args[:3] + tuple(t.contiguous() for t in args[3:5]) + args[5:]
    ss_ms = cuda_ms(lambda: kss.ssd_chunk_cuda(*args), iters=200)
    ss_plain = cuda_ms(lambda: ref.ssd_chunk_ref(*args), iters=30)
    ss_ms_b = cuda_ms(lambda: kss.ssd_chunk_cuda(*args), iters=200)
    ss_plain_b = cuda_ms(lambda: ref.ssd_chunk_ref(*args), iters=30)
    ss_dev = device_us_per_call(lambda: kss.ssd_chunk_cuda(*args), iters=50)
    ss_dev_ph = device_us_per_call(lambda: kss.ssd_chunk_cuda(*per_head),
                                   iters=50)
    ss_dev_b = device_us_per_call(lambda: kss.ssd_chunk_cuda(*args), iters=50)
    ss_plain_dev = device_us_per_call(lambda: ref.ssd_chunk_ref(*args),
                                      iters=10, warmup=2)
    ss_bound, ss_by = ssd_bound_ms(B, Q, SH, SP, SN, groups=cfg.ssm_groups)
    ss_bound_ffma, ss_by_ffma = ssd_bound_ms(B, Q, SH, SP, SN)
    print(f"ssd_chunk (B,Q,H,P,N) = {(B, Q, SH, SP, SN)} f32, B/C head stride "
          f"0: kernel {ss_ms:.4f} / {ss_ms_b:.4f} ms, plain {ss_plain:.4f} / "
          f"{ss_plain_b:.4f} ms; bound {ss_bound:.4g} ms ({ss_by}, 3xTF32 "
          f"rate, B/C and C.B^T once per group), the FFMA bound of PRs 13-14 "
          f"{ss_bound_ffma:.4g} ms ({ss_by_ffma}); card time per call "
          f"(profiler): kernel {ss_dev} / {ss_dev_b} us (B/C per head: "
          f"{ss_dev_ph} us), plain {ss_plain_dev} us; no single PyTorch call "
          f"computes the chunk")
    serve = {"arch": cfg.name, "batch": SERVE_BATCH, "prompt": SERVE_PROMPT,
             "new_tokens": SERVE_NEW, "prefill_ms": pre_ms,
             "prefill_plain_ms": pre_plain_ms, "decode_ms_per_token": decode_ms,
             "generated_tokens_per_s": SERVE_BATCH * SERVE_NEW / gen_s,
             "prefill_busy_ms": busy_us(spans["prefill"][1]) / 1e3,
             "prefill_wall_ms": spans["prefill"][0] * 1e3,
             "decode_busy_ms": busy_us(spans["decode"][1]) / 1e3,
             "decode_wall_ms": spans["decode"][0] * 1e3,
             "bf16_logit_err": lg_err, "bf16_state_err": st_err,
             "f32_logit_err": lg32_err, "bf16_plain_vs_f32_logit_dev": bf16_dev,
             "bf16_tokens_equal": same, "f32_tokens_equal": same32,
             "f32_prefill_ms": pre32_ms, "f32_prefill_plain_ms": pre32_plain_ms}
    flash_row = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:77 "
                    "(flash_attention_pallas)",
        "kernel": "flash_attention_wgmma_kernel (bf16 wgmma, TMA)",
        "launches": fa_launches, "wgmma_launches": fa_wgmma,
        "max_abs_err": flash_err["bfloat16"],
        "ms": fa["bf16"]["ms"], "plain_ms": fa["bf16"]["plain_ms"],
        "bound_ms": fa["bf16"]["bound_ms"], "bound_by": fa["bf16"]["bound_by"],
        "library_ms": fa["bf16"]["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention",
        "library_device_us": fa["bf16"]["library_device_us"],
        "shape": {"B": B, "S": S, "H": H, "D": D, "dtype": "bfloat16",
                  "causal": True},
        "device_us": fa["bf16"]["device_us"],
        "plain_device_us": fa["bf16"]["plain_device_us"],
        "prefill_device_us": kern_us.get("flash_attention kernel"),
        "serve": serve,
    }
    # the float32 route, a kernel of its own: its launches are the float32
    # prefill's (the counts set to 0 before it)
    f32 = fa["f32"]
    flash_f32_row = {
        "name": "flash_attention_f32", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:77 "
                    "(flash_attention_pallas, float32)",
        "kernel": "flash_attention_tf32_kernel (3xTF32 wgmma)",
        "launches": tf32_launches, "max_abs_err": flash_err["float32"],
        "ms": f32["ms"], "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"], "library_ms": f32["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention",
        "shape": {"B": B, "S": S, "H": H, "D": D, "dtype": "float32",
                  "causal": True},
        **{k: v for k, v in f32.items()
           if k not in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    }
    ssd_row = {
        "name": "ssd_chunk", "route": "cuda", "cuda_route": "wgmma-3xtf32",
        "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:55 (ssd_chunk_pallas)",
        "launches": ss_launches, "max_abs_err": ssd_err,
        "ms": ss_ms, "plain_ms": ss_plain, "bound_ms": ss_bound,
        "bound_by": ss_by, "bound_ms_ffma": ss_bound_ffma,
        "bound_by_ffma": ss_by_ffma, "library_ms": None,
        "bc_head_stride": int(args[3].stride(2)),
        "shape": {"B": B, "Q": Q, "H": SH, "P": SP, "N": SN, "dtype": "float32"},
        "device_us": ss_dev, "device_us_b": ss_dev_b,
        "device_us_bc_per_head": ss_dev_ph, "plain_device_us": ss_plain_dev,
        "prefill_device_us": kern_us.get("ssd_chunk kernel"),
    }
    return flash_row, flash_f32_row, ssd_row


# ------------------------------------------------------------------------
# the training slice: the LSTM stack's backward, fig10, card against CPU
# ------------------------------------------------------------------------

# (G, B, T, I, H, layers): RevPred's and Tributary's training batches (the
# batch of train_model is always full), B = 255 and 257 (not a multiple of
# the plan's 2 rows a block), two groups at the training batch (4 rows a
# block), then B in (1, 7), H = 16, one and two layers
BWD_CASES = [(1, 256, 59, 6, 32, 3), (1, 256, 60, 7, 32, 3),
             (1, 255, 59, 6, 32, 3), (1, 257, 60, 7, 32, 3),
             (2, 256, 59, 6, 32, 3),
             (1, 1, 59, 6, 32, 3), (1, 7, 60, 7, 32, 3), (1, 7, 59, 6, 16, 3),
             (1, 7, 59, 6, 32, 1), (1, 7, 59, 6, 32, 2)]
GRAD_TOL = 1e-5     # of each gradient leaf's largest magnitude (float32)
TRAIN_BS = 256      # train_model's batch
# fig10 (benchmarks/fig10_revpred.py): 12-day market of seed 3, 9 days of
# training, 4 epochs, stride 5; 3 held-out days, default_rng(1), stride 2
FIG10_TRAIN_DAYS, FIG10_EVAL_DAYS, FIG10_EPOCHS, FIG10_STRIDE = 9, 3, 4, 5
# BENCH_simcore.json's fig10 rows: the JAX package's results on the CPU of
# its development container (not a card's)
FIG10_GOLDEN = {
    "revpred_accuracy": 0.644, "revpred_f1": 0.3018,
    "tributary_accuracy": 0.528, "tributary_f1": 0.5029,
    "logreg_accuracy": 0.6347, "logreg_f1": 0.0,
    "integrated_revpred_cost_usd": 19.36, "integrated_revpred_pcr": 3.3112,
    "integrated_tributary_cost_usd": 20.894, "integrated_tributary_pcr": 3.0679,
}
# Bands written before the first timed run, printed by tools/fig10_band.py
# with the readings they come from (PERF.md, fig10): golden +- (max(3 x
# spread, floor) + drift).  spread: the standard deviation of the JAX
# package's own fig10 rows over three other init keys on the CPU; drift: how
# far its rerun with the golden key lands from the golden on that CPU;
# floor: 0.03 in accuracy and F1, 5 % of the golden for the integrated rows
# (three keys do not show a discrete simulation's tails).  Logreg is
# deterministic (zero init): golden +- 0.005.
FIG10_BAND = {
    "revpred_accuracy": (0.6124, 0.6756), "revpred_f1": (0.2282, 0.3754),
    "tributary_accuracy": (0.4912, 0.5648), "tributary_f1": (0.4278, 0.5780),
    "logreg_accuracy": (0.6297, 0.6397), "logreg_f1": (-0.005, 0.005),
    "integrated_revpred_cost_usd": (11.3872, 27.3328),
    "integrated_revpred_pcr": (1.7374, 4.8850),
    "integrated_tributary_cost_usd": (19.5300, 22.2580),
    "integrated_tributary_pcr": (2.8636, 3.2722),
}
# one market's revpred trained on the card (kernels) and on the CPU (plain
# versions) from one initialisation: float32 sums in other orders, 40 steps
TRAIN_LOSS_RTOL = 1e-4      # per-step loss, relative
TRAIN_PARAM_ATOL = 1e-3     # final parameters


def grad_case(G, B, T, I, H, L, seed=0):
    """Seeded float32 inputs on the card: xs and every layer's weights
    requiring grad, and an upstream gradient dh of the top layer's last h."""
    import torch
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda()

    xs = rnd(G, B, T, I).requires_grad_(True)
    layers = [{"w_ih": rnd(G, I if n == 0 else H, 4 * H,
                           scale=(I if n == 0 else H) ** -0.5).requires_grad_(True),
               "w_hh": rnd(G, H, 4 * H, scale=H ** -0.5).requires_grad_(True),
               "b": rnd(G, 4 * H, scale=0.1).requires_grad_(True)}
              for n in range(L)]
    return xs, layers, rnd(G, B, H)


def lstm_train_bound_ms(G, B, T, I, H, L):
    """Least times of the training kernels' work, float32: (forward with
    save bound, its limit, backward bound, its limit, forward + backward
    bound, its limit).  The forward reads xs and the weights and writes the
    top layer's last h and every layer's saved gates, c and h; it computes
    both products and ~14 H elementwise operations per (layer, step, row).
    The backward reads every layer's saved gates and c and the weights and
    writes dgates; it computes dh_{t-1} = dgates . W_hh^T (t > 0) and,
    above layer 0, dx_t = dgates . W_ih^T, and ~20 H elementwise operations
    per (layer, step, row).  The whole training call takes xs, the weights
    and dh in and gives h and every gradient out; it adds the weight
    gradients' products."""
    n = G * B * T
    ins = [I] + [H] * (L - 1)
    w_floats = G * sum((i + H + 1) * 4 * H for i in ins)
    rec = 2 * 4 * H * H
    fwd_bytes = 4 * (n * I + w_floats + G * B * H + L * n * 6 * H)
    fwd_ops = sum(n * (2 * (i + H) * 4 * H + 14 * H) for i in ins)
    bwd_bytes = 4 * (L * n * 5 * H + L * n * 4 * H + w_floats + G * B * H)
    bwd_ops = L * n * 20 * H + L * G * B * (T - 1) * rec + (L - 1) * n * rec
    wgrad_ops = sum(n * 2 * (i + H) * 4 * H + n * 4 * H for i in ins)
    pair_bytes = 4 * (n * I + 2 * w_floats + 2 * G * B * H)
    pair_ops = fwd_ops + bwd_ops + wgrad_ops

    def bound(n_bytes, ops):
        t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
        t_ops = ops / H100_F32_FLOPS * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    return bound(fwd_bytes, fwd_ops) + bound(bwd_bytes, bwd_ops) + \
        bound(pair_bytes, pair_ops)


def fig10_steps(market, train_minutes, epochs, stride, bs=TRAIN_BS):
    """train_model's steps for one kind over the pool: build_dataset's
    sample count per market (it depends on the window only), full batches
    per epoch."""
    import numpy as np
    n = len(np.arange(60, train_minutes - 61, stride))
    return len(market.pool) * epochs * (n // bs)


def fig10_run(device):
    """fig10 through the port's entry points on ``device``: RevPred.train
    for the three kinds, their accuracy and F1 on the held-out days averaged
    over the pool, and the integrated SpotTune runs of revpred and
    tributary through ``build_spottune``.  -> (rows, predictors, wall s)."""
    import numpy as np
    import torch
    from repro_torch.core.market import SpotMarket
    from repro_torch.core.orchestrator import build_spottune
    from repro_torch.core.revpred import RevPred, build_dataset, evaluate
    from repro_torch.core.trial import WORKLOADS, SimTrialBackend, make_trials
    market = SpotMarket(days=FIG10_TRAIN_DAYS + FIG10_EVAL_DAYS, seed=3)
    train_min = FIG10_TRAIN_DAYS * 1440
    eval_lo, eval_hi = train_min, (FIG10_TRAIN_DAYS + FIG10_EVAL_DAYS) * 1440 - 70
    rows, preds, walls = {}, {}, {}
    for kind in ("revpred", "tributary", "logreg"):
        t0 = time.perf_counter()
        rp = RevPred.train(market, train_min, kind=kind, epochs=FIG10_EPOCHS,
                           stride=FIG10_STRIDE, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        walls[kind] = time.perf_counter() - t0
        preds[kind] = rp
        accs, f1s = [], []
        rng = np.random.default_rng(1)
        for inst in market.pool:
            data = build_dataset(market.traces[inst.name], inst.od_price,
                                 eval_lo, eval_hi, "random", rng, stride=2)
            m = evaluate(rp.predictors[inst.name], data)
            accs.append(m["accuracy"])
            f1s.append(m["f1"])
        rows[f"{kind}_accuracy"] = float(np.mean(accs))
        rows[f"{kind}_f1"] = float(np.mean(f1s))
    trials = make_trials(WORKLOADS[0])
    for kind in ("revpred", "tributary"):
        m = SpotMarket(days=FIG10_TRAIN_DAYS + FIG10_EVAL_DAYS, seed=3)
        rp = preds[kind]
        rp.market = m          # the same traces (same seed), a fresh ledger
        rp._p_cache = {}
        res = build_spottune(trials, m, SimTrialBackend(m.pool), rp, theta=0.7,
                             mcnt=3, seed=0, device=device).run()
        rows[f"integrated_{kind}_cost_usd"] = float(res.cost)
        rows[f"integrated_{kind}_pcr"] = float(res.pcr() * 1e6)
    return rows, preds, walls, market


def train_kernel_kind(name: str) -> str:
    """The part of a training step a card kernel belongs to, by its name."""
    low = name.lower()
    return ("lstm_stack_bwd" if "lstm_stack_bwd_kernel" in name
            else "lstm_stack_fwd_train" if "lstm_stack_fwd_train_kernel" in name
            else "lstm_stack" if "lstm_stack_kernel" in name
            else "gemm" if "gemm" in low or "sm90" in low or "cutlass" in low
            else "other")


def launch_card_us(fn, kind: str, iters: int = 50, warmup: int = 20):
    """(mean card time of one launch of the training kernel ``kind``, the
    launches of it the profiler saw) over ``iters`` calls of ``fn``: the
    mean is taken over the launches seen, not over the calls."""
    by = card_launches(fn, iters, warmup)
    hits = [(n, t) for nm, (n, t) in by.items() if train_kernel_kind(nm) == kind]
    n = sum(h[0] for h in hits)
    return (sum(h[1] for h in hits) / n if n else None), n


def train_phases(torch) -> tuple:
    """The training slice: the stack's backward against autograd of its
    plain version, fig10 on the card (the slice's main path), one market's
    training on the card against the CPU, the profile and the timing.
    Returns the two training kernels' JSON rows."""
    import numpy as np
    from repro_torch.core import revpred as rp
    from repro_torch.kernels import lstm_cell as klc
    from repro_torch.kernels import ops, ref

    # ------------------------------- the backward against its plain version
    phase("lstm_stack backward (training kernels) against autograd of the "
          "plain version")
    bwd_err = saved_err = 0.0
    for G, B, T, I, H, L in BWD_CASES:
        xs, layers, dh = grad_case(G, B, T, I, H, L)
        flat = [xs] + [lp[k] for lp in layers for k in ("w_ih", "w_hh", "b")]
        before = klc.TRAIN_LAUNCHES, klc.BWD_LAUNCHES
        got = torch.autograd.grad(ops.lstm_stack(xs, layers), flat, dh)
        launched = (klc.TRAIN_LAUNCHES - before[0], klc.BWD_LAUNCHES - before[1])
        want = torch.autograd.grad(ref.lstm_stack_ref(xs, layers), flat, dh)
        with torch.no_grad():
            saved = klc.lstm_stack_fwd_train_cuda(xs, layers)
            plain = ref.lstm_stack_fwd_train_ref(xs, layers)
            dg = klc.lstm_stack_bwd_cuda(dh, plain[1], plain[2], layers)
            dg_ref = ref.lstm_stack_bwd_ref(dh, plain[1], plain[2], layers)
        torch.cuda.synchronize()
        e = max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
                for a, b in zip(got, want))
        e_dg = (dg - dg_ref).abs().max().item() / dg_ref.abs().max().item()
        e_sv = max((a - b).abs().max().item() for a, b in zip(saved, plain))
        what = f"G={G} B={B} T={T} I={I} H={H} layers={L}"
        if not (e <= GRAD_TOL and e_dg <= GRAD_TOL and e_sv <= F32_TOL
                and launched == (1, 1)):
            fail(f"lstm_stack backward {what}: gradients {e:.3g} of their "
                 f"largest (tol {GRAD_TOL}), dgates {e_dg:.3g}, saved state "
                 f"{e_sv:.3g} (tol {F32_TOL}), launches {launched}")
        bwd_err, saved_err = max(bwd_err, e, e_dg), max(saved_err, e_sv)
        print(f"  {what}: gradient leaves within {e:.3g} of their largest, "
              f"dgates {e_dg:.3g}, saved gates/c/h {e_sv:.3g}")
    print(f"{len(BWD_CASES)} cases agree with autograd of ref.lstm_stack_ref "
          f"(tol {GRAD_TOL} of each leaf's largest magnitude): max {bwd_err:.3g}")
    bf = grad_case(1, 2, 10, 6, 16, 3)
    try:
        ops.lstm_stack(bf[0].detach().bfloat16().requires_grad_(True),
                       [{k: v.detach().bfloat16().requires_grad_(True)
                         for k, v in lp.items()} for lp in bf[1]])
    except TypeError as exc:
        print(f"bfloat16 with grad raises TypeError: {exc}")
    else:
        fail("lstm_stack with bfloat16 inputs that require grad did not raise")

    # ------------------------------------------------ the main path: fig10
    phase("main path: fig10 on the card (RevPred.train, evaluate, "
          "build_spottune)")
    klc.LAUNCHES = klc.STACK_LAUNCHES = klc.TRAIN_LAUNCHES = klc.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    rows, preds, walls, market = fig10_run("cuda")
    torch.cuda.synchronize()
    fig10_wall = time.perf_counter() - t0
    launches = {"lstm_stack_fwd_train": klc.TRAIN_LAUNCHES,
                "lstm_stack_bwd": klc.BWD_LAUNCHES,
                "lstm_stack (inference)": klc.STACK_LAUNCHES,
                "lstm_cell": klc.LAUNCHES}
    steps = fig10_steps(market, FIG10_TRAIN_DAYS * 1440, FIG10_EPOCHS,
                        FIG10_STRIDE)
    print("rows beside BENCH_simcore.json's (the JAX package's results on "
          "the CPU of its container) and the band written before the run:")
    bad = []
    for name, v in rows.items():
        lo, hi = FIG10_BAND[name]
        inside = lo <= v <= hi
        bad += [] if inside else [name]
        print(f"  fig10_{name:32s} {v:10.4f}   golden {FIG10_GOLDEN[name]:8.4f}  "
              f"band [{lo}, {hi}]  {'inside' if inside else 'OUTSIDE'}")
    print(f"wall {fig10_wall:.2f} s (training: revpred {walls['revpred']:.2f} s, "
          f"tributary {walls['tributary']:.2f} s, logreg {walls['logreg']:.2f} s); "
          f"{steps} training steps per kind; launches {launches}")
    if bad:
        fail(f"fig10 rows outside their band: {bad}")
    if not (launches["lstm_stack_fwd_train"] == launches["lstm_stack_bwd"]
            == 2 * steps and launches["lstm_cell"] == 0
            and launches["lstm_stack (inference)"] > 0):
        fail(f"the fig10 run did not launch the training kernels once per "
             f"LSTM training step ({2 * steps} steps of revpred and tributary): "
             f"{launches}")

    # ------------------------------------------- card against the CPU
    phase("one market's revpred trained on the card and on the CPU")
    inst = market.pool[0]
    data = rp.build_dataset(market.traces[inst.name], inst.od_price, 0,
                            FIG10_TRAIN_DAYS * 1440, "algo2",
                            np.random.default_rng(0), FIG10_STRIDE)
    init = rp.init_revpred(torch.Generator().manual_seed(7), device="cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        losses = []
        t0 = time.perf_counter()
        params, _ = rp.train_model(rp.revpred_logits, init, data,
                                   epochs=FIG10_EPOCHS, seed=0, device=dev,
                                   on_step=losses.append)
        losses = [float(x) for x in losses]
        runs[dev] = (rp.params_to_numpy(params), losses,
                     time.perf_counter() - t0)
    (pc, lc, wc), (pp, lp, wp) = runs["cuda"], runs["cpu"]
    loss_rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lc, lp))
    param_err = max(float(np.abs(a - b).max())
                    for a, b in zip(rp.tree_leaves(pc), rp.tree_leaves(pp)))
    print(f"{inst.name}: {len(lc)} steps, card {wc:.2f} s, CPU {wp:.2f} s; "
          f"per-step loss max rel diff {loss_rel:.3g} (tol {TRAIN_LOSS_RTOL}), "
          f"final parameters max abs diff {param_err:.3g} (tol "
          f"{TRAIN_PARAM_ATOL}); losses {lc[0]:.6f} -> {lc[-1]:.6f}")
    if not (len(lc) == len(lp) > 0 and loss_rel <= TRAIN_LOSS_RTOL
            and param_err <= TRAIN_PARAM_ATOL):
        fail("the card and CPU trainings disagree beyond their tolerances")

    # ------------------------------------------------- where the time goes
    phase("revpred training (6 markets) under torch.profiler")
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.revpred import RevPred
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        RevPred.train(market, FIG10_TRAIN_DAYS * 1440, kind="revpred",
                      epochs=FIG10_EPOCHS, stride=FIG10_STRIDE, device="cuda")
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    iv = device_intervals(prof)
    busy = busy_us(iv) / 1e6
    by = {}
    for s0, s1, nm in iv:
        key = train_kernel_kind(nm)
        n, tsum = by.get(key, (0, 0.0))
        by[key] = (n + 1, tsum + (s1 - s0) / 1e6)
    print(f"wall {prof_wall:.3f} s (profiler on; {walls['revpred']:.3f} s "
          f"unprofiled), {len(iv)} kernels, card busy {busy * 1e3:.2f} ms = "
          f"{100 * busy / prof_wall:.2f}%, idle {100 * (1 - busy / prof_wall):.2f}%")
    for key, (n, tsum) in sorted(by.items(), key=lambda kv: -kv[1][1]):
        print(f"  {tsum * 1e3:9.3f} ms  {100 * tsum / max(busy, 1e-12):6.2f}% of "
              f"busy  {n:6d} launches  {key}")

    # -------------------------------------------------------------- timing
    phase("lstm_stack training kernels at RevPred's training batch (CUDA "
          "events, torch.profiler)")
    G, B, T, I, H, L = BWD_CASES[0]
    xs, layers, dh = grad_case(G, B, T, I, H, L, seed=1)
    xs = xs.detach()
    wflat = [lp[k] for lp in layers for k in ("w_ih", "w_hh", "b")]
    with torch.no_grad():
        _, gates, c, _ = klc.lstm_stack_fwd_train_cuda(xs, layers)

    def pair():
        return torch.autograd.grad(ops.lstm_stack(xs, layers), wflat, dh)

    def pair_plain():
        return torch.autograd.grad(ref.lstm_stack_ref(xs, layers), wflat, dh)

    def fwd_train():
        with torch.no_grad():
            return klc.lstm_stack_fwd_train_cuda(xs, layers)

    def fwd_train_plain():
        with torch.no_grad():
            return ref.lstm_stack_fwd_train_ref(xs, layers)

    def bwd():
        with torch.no_grad():
            return klc.lstm_stack_bwd_cuda(dh, gates, c, layers)

    def bwd_plain():
        with torch.no_grad():
            return ref.lstm_stack_bwd_ref(dh, gates, c, layers)

    # cuDNN's nn.LSTM forward + backward at the same shape (G = 1): weights
    # (4H, I_l), b_ih = b, b_hh = 0, gate order i, f, g, o; TF32 off
    lstm = torch.nn.LSTM(I, H, num_layers=L, batch_first=True).cuda()
    with torch.no_grad():
        for n, lp in enumerate(layers):
            getattr(lstm, f"weight_ih_l{n}").copy_(lp["w_ih"][0].t())
            getattr(lstm, f"weight_hh_l{n}").copy_(lp["w_hh"][0].t())
            getattr(lstm, f"bias_ih_l{n}").copy_(lp["b"][0])
            getattr(lstm, f"bias_hh_l{n}").zero_()
    lib_params = list(lstm.parameters())

    def cudnn_pair():
        return torch.autograd.grad(lstm(xs[0])[1][0][-1], lib_params, dh[0])

    def cudnn_fwd():
        with torch.no_grad():
            return lstm(xs[0])

    lib_g = cudnn_pair()
    ker_g = pair()
    lib_err = (lib_g[0] - ker_g[0][0].t()).abs().max().item() / \
        ker_g[0].abs().max().item()
    t = {}
    t["fwd_train_ms"] = cuda_ms(fwd_train, iters=200)
    t["bwd_ms"] = cuda_ms(bwd, iters=200)
    t["pair_ms"] = cuda_ms(pair, iters=100)
    t["fwd_train_plain_ms"] = cuda_ms(fwd_train_plain, iters=3, warmup=1)
    t["pair_plain_ms"] = cuda_ms(pair_plain, iters=3, warmup=1)
    t["bwd_plain_ms"] = cuda_ms(bwd_plain, iters=3, warmup=1)
    t["fwd_library_ms"] = cuda_ms(cudnn_fwd, iters=100)
    t["pair_library_ms"] = cuda_ms(cudnn_pair, iters=100)
    t["fwd_train_ms_b"] = cuda_ms(fwd_train, iters=200)
    t["bwd_ms_b"] = cuda_ms(bwd, iters=200)
    t["pair_ms_b"] = cuda_ms(pair, iters=100)
    t["fwd_train_device_us"] = device_us_per_call(fwd_train, iters=50)
    t["bwd_device_us"] = device_us_per_call(bwd, iters=50)
    t["fwd_train_launch_us"], t["fwd_train_launches_seen"] = launch_card_us(
        fwd_train, "lstm_stack_fwd_train")
    t["bwd_launch_us"], t["bwd_launches_seen"] = launch_card_us(bwd, "lstm_stack_bwd")
    t["pair_device_us"] = device_us_per_call(pair, iters=50)
    t["pair_plain_device_us"] = device_us_per_call(pair_plain, iters=2, warmup=1)
    t["fwd_library_device_us"] = device_us_per_call(cudnn_fwd, iters=50)
    t["pair_library_device_us"] = device_us_per_call(cudnn_pair, iters=50)
    # forward + backward through autograd, its card time by part
    from torch.profiler import ProfilerActivity, profile
    for _ in range(10):
        pair()
    torch.cuda.synchronize()
    n_pair = 50
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_pair):
            pair()
        torch.cuda.synchronize()
    parts = {}
    for s0, s1, nm in device_intervals(prof):
        key = train_kernel_kind(nm)
        parts[key] = parts.get(key, 0.0) + (s1 - s0) / n_pair
    t["pair_parts_device_us"] = parts
    fwd_bound, fwd_by, bwd_bound, bwd_by, pair_bound, pair_by = \
        lstm_train_bound_ms(G, B, T, I, H, L)
    sms = klc.n_sms(xs.device)
    plans = {"lstm_stack_fwd_train": klc.lstm_stack_train_plan(B, I, H, T, L, sms, G),
             "lstm_stack_bwd": klc.lstm_stack_bwd_plan(B, H, T, L, sms, G)}
    print(f"G={G} B={B} T={T} I={I} H={H} {L} layers f32 on {sms} SMs:")
    diags = {}
    for name, (wave, rows_, blocks, smem) in plans.items():
        diags[name] = T + L - 1 if wave == L else L * T
        print(f"  {name} plan: {wave} layers a wave, {rows_} rows a block, "
              f"{blocks} blocks = {-(-blocks // sms)} wave(s) over the SMs, "
              f"{smem} bytes of shared memory, {diags[name]} dependent "
              f"diagonals")
        if blocks > sms:
            fail(f"{name} at the training batch runs {blocks} blocks on {sms} "
                 "SMs: more than one wave")
    per_diag = {k: (t[f"{k}_launch_us"] / diags[n] if t[f"{k}_launch_us"] else None)
                for k, n in (("fwd_train", "lstm_stack_fwd_train"),
                             ("bwd", "lstm_stack_bwd"))}
    fmt = lambda v: "not measured" if v is None else f"{v:.4f}"
    print(f"  forward with save {t['fwd_train_ms']:.5f} / {t['fwd_train_ms_b']:.5f} "
          f"ms, {fmt(t['fwd_train_launch_us'])} us of card time a launch "
          f"({t['fwd_train_launches_seen']} launches seen in 50 calls; "
          f"{t['fwd_train_device_us']} us a call), "
          f"{fmt(per_diag['fwd_train'])} us a diagonal; its plain version "
          f"(ref.lstm_stack_fwd_train_ref) {t['fwd_train_plain_ms']:.4f} ms; "
          f"bound {fwd_bound:.4g} ms ({fwd_by}); cuDNN nn.LSTM forward "
          f"{t['fwd_library_ms']:.5f} ms, {t['fwd_library_device_us']} us")
    print(f"  backward {t['bwd_ms']:.5f} / {t['bwd_ms_b']:.5f} ms, "
          f"{fmt(t['bwd_launch_us'])} us of card time a launch "
          f"({t['bwd_launches_seen']} launches seen in 50 calls; "
          f"{t['bwd_device_us']} us a call), {fmt(per_diag['bwd'])} us a "
          f"diagonal; its plain version (ref.lstm_stack_bwd_ref) "
          f"{t['bwd_plain_ms']:.4f} ms; bound {bwd_bound:.4g} ms ({bwd_by})")
    print(f"  forward + backward through the kernels (LstmStack, weight "
          f"gradients by torch.bmm) {t['pair_ms']:.5f} / {t['pair_ms_b']:.5f} "
          f"ms, {t['pair_device_us']} us of card time; autograd of the plain "
          f"version {t['pair_plain_ms']:.4f} ms, {t['pair_plain_device_us']} us; "
          f"cuDNN nn.LSTM forward + backward (TF32 off) {t['pair_library_ms']:.5f} "
          f"ms, {t['pair_library_device_us']} us (its dW_ih of layer 0 agrees "
          f"with the kernels' to {lib_err:.3g} of the largest); bound "
          f"{pair_bound:.4g} ms ({pair_by})")
    print("  its card time by part (us a call): " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(parts.items(), key=lambda kv: -kv[1])))
    print(f"  launches per training step: 1 lstm_stack_fwd_train + 1 "
          f"lstm_stack_bwd (revpred, tributary); per fig10 run: "
          f"{launches['lstm_stack_fwd_train']} + {launches['lstm_stack_bwd']}")
    source = "src/repro_torch/kernels/csrc/lstm_cell.cu"
    replaces = ("src/repro/kernels/lstm_cell.py:50 (lstm_cell_pallas, "
                "differentiated through its lax.scan by jax.value_and_grad "
                "at src/repro/core/revpred.py:289-297; no Pallas backward)")
    shape = {"G": G, "B": B, "T": T, "I": I, "H": H, "layers": L,
             "dtype": "float32", "n_sms": sms}
    fwd_row = {
        "name": "lstm_stack_fwd_train", "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches["lstm_stack_fwd_train"],
        "max_abs_err": saved_err, "err_is": "of the saved gates, c and h",
        "ms": t["fwd_train_ms"], "ms_b": t["fwd_train_ms_b"],
        "plain_ms": t["fwd_train_plain_ms"],
        "bound_ms": fwd_bound, "bound_by": fwd_by,
        "library_ms": None,
        "library": "none computes the forward with its saved state; cuDNN's "
                   "forward alone is fwd_library_ms",
        "fwd_library_ms": t["fwd_library_ms"],
        "fwd_library_device_us": t["fwd_library_device_us"],
        "device_us": t["fwd_train_launch_us"],
        "us_per_diagonal": per_diag["fwd_train"],
        "plan": dict(zip(("wave", "rows", "blocks", "smem_bytes"),
                         plans["lstm_stack_fwd_train"])),
        "shape": shape,
    }
    bwd_row = {
        "name": "lstm_stack_bwd", "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches["lstm_stack_bwd"],
        "fwd_train_launches": launches["lstm_stack_fwd_train"],
        "max_abs_err": bwd_err, "err_is": "of each gradient leaf's largest",
        "saved_state_err": saved_err,
        "ms": t["bwd_ms"], "plain_ms": t["bwd_plain_ms"],
        "bound_ms": bwd_bound, "bound_by": bwd_by,
        "library_ms": None,
        "library": "none computes the backward alone; cuDNN's forward + "
                   "backward is pair_library_ms, to be read against pair_ms",
        "pair_library": "torch.nn.LSTM (cuDNN, TF32 off) forward + backward",
        "pair_bound_ms": pair_bound, "pair_bound_by": pair_by,
        "us_per_diagonal": per_diag["bwd"],
        "plan": dict(zip(("wave", "rows", "blocks", "smem_bytes"),
                         plans["lstm_stack_bwd"])),
        "shape": shape,
        **t, "fig10": {"rows": rows, "wall_s": fig10_wall,
                       "train_wall_s": walls, "steps_per_kind": steps,
                       "launches": launches, "card_busy_s": busy,
                       "profiled_wall_s": prof_wall,
                       "card_vs_cpu": {"loss_rel": loss_rel,
                                       "param_abs": param_err,
                                       "card_s": wc, "cpu_s": wp}},
    }
    return fwd_row, bwd_row


# ------------------------------------------------------------------------
# phi3-mini-3.8b: flash attention at head dim 96
# ------------------------------------------------------------------------

PHI3_ARCH, PHI3_BATCH, PHI3_PROMPT, PHI3_NEW = "phi3-mini-3.8b", 2, 256, 8


def phi3_phase(torch) -> dict:
    """phi3-mini-3.8b at full width (random bf16 weights from a seed, 32
    layers of 32 heads x 96): 2 prompts x 256 tokens prefilled through the
    kernels and through the plain versions in bf16, then in float32 with 8
    greedy tokens; flash_attention's D = 96 routes timed at its shape.
    Returns the D = 96 numbers for flash_attention's JSON row."""
    import dataclasses

    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention_cuda as kfa
    from repro_torch.launch.serve import Server
    from repro_torch.models.context import ModelCtx
    from repro_torch.models.model import Model, tree_leaves, tree_map

    phase(f"main path: {PHI3_ARCH} prefill at full width (flash attention "
          f"at head dim 96)")
    cfg = get_config(PHI3_ARCH)
    D = cfg.d_model // cfg.n_heads
    t0 = time.perf_counter()
    params = Model(cfg).init(torch.Generator(device="cuda").manual_seed(0),
                             device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"{cfg.name}: {n_params:,} parameters ({cfg.dtype}, "
          f"{sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9:.2f}"
          f" GB), {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads x {D}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; random weights "
          f"from seed 0, init {time.perf_counter() - t0:.2f} s; depth not cut")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                             size=(PHI3_BATCH, PHI3_PROMPT))
    dev_tok = torch.as_tensor(toks, device="cuda").long()
    max_len = PHI3_PROMPT + PHI3_NEW
    server = Server(cfg, params, max_len=max_len, device="cuda")
    plain = Server(cfg, params, ctx=ModelCtx(kernels="ref"), max_len=max_len,
                   device="cuda")
    server.prefill(dev_tok)                               # warm-up
    torch.cuda.synchronize()
    kfa.LAUNCHES = kfa.WGMMA_LAUNCHES = 0
    lg_k = server.prefill(dev_tok)[0].float()[:, -1]
    torch.cuda.synchronize()
    fa, fa_wg = kfa.LAUNCHES, kfa.WGMMA_LAUNCHES
    lg_r = plain.prefill(dev_tok)[0].float()[:, -1]

    def prefill_ms(srv, n=5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            srv.prefill(dev_tok)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / n * 1e3

    pre_ms, pre_plain_ms, pre_ms_b = (prefill_ms(server), prefill_ms(plain),
                                      prefill_ms(server))
    lg_err = (lg_k - lg_r).abs().max().item()
    lg_tol = SERVE_REL_TOL * lg_r.abs().max().item()
    finite = bool(torch.isfinite(lg_k).all())
    print(f"bf16 prefill {PHI3_BATCH} x {PHI3_PROMPT}: flash_attention launches "
          f"{fa}, all on the wgmma route at D = {D}: {fa_wg == fa} (want "
          f"{cfg.n_layers}); {pre_ms:.2f} / {pre_ms_b:.2f} ms through the kernels, "
          f"{pre_plain_ms:.2f} ms through the plain versions; last-position "
          f"logits max abs diff {lg_err:.4g} (tol {lg_tol:.4g} = {SERVE_REL_TOL} "
          f"x max |logit|), finite {finite}")
    if not (D == 96 and fa == fa_wg == cfg.n_layers and finite
            and lg_err <= lg_tol):
        fail(f"{PHI3_ARCH} bf16 prefill: {fa} flash launches ({fa_wg} wgmma, "
             f"want {cfg.n_layers}), logits {lg_err:.4g} apart (tol {lg_tol:.4g})")
    del server, plain

    phase(f"{PHI3_ARCH} in float32: prefill and {PHI3_NEW} greedy tokens, "
          "kernels against plain")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    del params
    s32 = Server(cfg32, p32, max_len=max_len, device="cuda")
    s32_r = Server(cfg32, p32, ctx=ModelCtx(kernels="ref"), max_len=max_len,
                   device="cuda")
    kfa.LAUNCHES = kfa.TF32_LAUNCHES = 0
    out32 = s32.generate({"tokens": toks}, PHI3_NEW)
    torch.cuda.synchronize()
    fa32, fa32_tf = kfa.LAUNCHES, kfa.TF32_LAUNCHES
    out32_r = s32_r.generate({"tokens": toks}, PHI3_NEW)
    lg32_k = s32.prefill(dev_tok)[0].float()[:, -1]
    lg32_r = s32_r.prefill(dev_tok)[0].float()[:, -1]
    torch.cuda.synchronize()
    same32 = int((out32 == out32_r).sum())
    lg32_err = (lg32_k - lg32_r).abs().max().item()
    pre32_ms, pre32_plain_ms = prefill_ms(s32, 3), prefill_ms(s32_r, 3)
    print(f"float32: flash launches {fa32}, on the 3xTF32 route {fa32_tf} "
          f"(prefill, want {cfg.n_layers}); "
          f"{same32} of {out32.numel()} tokens equal; prefill logits kernels "
          f"against plain max abs diff {lg32_err:.4g} (tol {PHI3_F32_LOGIT_TOL}); "
          f"prefill {pre32_ms:.2f} ms "
          f"through the kernels, {pre32_plain_ms:.2f} ms plain")
    if (not fa32 == fa32_tf == cfg.n_layers or same32 != out32.numel()
            or not lg32_err <= PHI3_F32_LOGIT_TOL):
        fail(f"{PHI3_ARCH} float32 through the kernels and the plain versions: "
             f"{same32} of {out32.numel()} tokens equal, {fa32} flash launches "
             f"({fa32_tf} 3xTF32), "
             f"prefill logits {lg32_err:.4g} apart (tol {PHI3_F32_LOGIT_TOL})")
    del s32, s32_r, p32
    torch.cuda.empty_cache()

    phase(f"flash_attention at {PHI3_ARCH}'s shape, head dim 96 (CUDA events)")
    gen = torch.Generator().manual_seed(12)
    B, S, H = PHI3_BATCH, PHI3_PROMPT, cfg.n_heads
    out = {"d96_shape": {"B": B, "S": S, "H": H, "D": D, "causal": True},
           "d96_f32_shape": {"B": B, "S": S, "H": H, "D": D, "causal": True},
           "d96_prefill_launches": fa, "d96_prefill_ms": pre_ms,
           "d96_prefill_plain_ms": pre_plain_ms, "d96_bf16_logit_err": lg_err,
           "d96_f32_tokens_equal": same32}
    for dtype, name, tol in ((torch.bfloat16, "bf16", FLASH_TOL["bfloat16"]),
                             (torch.float32, "f32", FLASH_TOL["float32"])):
        q, k, v = ((torch.randn(B, S, H, D, generator=gen)).to("cuda", dtype)
                   for _ in range(3))
        r = flash_timing(torch, q, k, v, f"{name}, {PHI3_ARCH}'s prefill")
        if not r["err"] <= tol:
            fail(f"flash_attention {name} at {PHI3_ARCH}'s shape: max abs err "
                 f"{r['err']:.3g} > {tol}")
        out.update({f"d96_{name}_{key}": val for key, val in r.items()})
    out.update({"d96_f32_prefill_launches": fa32_tf, "d96_f32_prefill_ms": pre32_ms,
                "d96_f32_prefill_plain_ms": pre32_plain_ms})
    return out


# ------------------------------------------------------------------------
# the model's training path: Model.loss and make_train_step through the
# flash and SSD kernels, Trainer card against CPU, checkpoint/restart
# ------------------------------------------------------------------------

TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ = "zamba2-1.2b", 2, 512
# float32 at full width, kernels against the plain versions (set before the
# first chip run): the loss relative, each gradient leaf of its largest
# magnitude
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-3
# the kernel's log-sum-exp against the plain one, absolute (|lse| ~ 7 here)
LSE_TOL = 1e-4
# a Function's gradients against autograd of the plain forward, of each
# leaf's largest magnitude: float32 / bf16 (flash's bf16 tolerance)
FN_GRAD_TOL = {"float32": 1e-4, "bfloat16": 4e-2}
TRAIN_STEPS, TRAIN_LR = 5, 1e-3
# reduced configs in float32, 4 Trainer steps, card against CPU (relative)
TRAINER_RTOL = 1e-4
RESTART_RTOL = 1e-5          # tests/test_checkpoint.py:150
FIG12_RATES = (("t2.micro", 62.83e6), ("m4.4xlarge", 134.22e6))  # bytes/s


def leaf_names(tree, prefix=""):
    """Names of a parameter tree's leaves in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}/{k}")]
    return [prefix]


def flash_bwd_bound_ms(B, S, H, D, elem_bytes):
    """Least time for the flash backward (causal, Sq = Sk = S): q, k, v, o
    and do read once, lse read once, dq, dk and dv written once; against
    five products over the (query, key) pairs the mask keeps (S = QK^T
    recomputed, dV = P^T dO, dP = dO V^T, dQ = dS K, dK = dS^T Q) at the
    forward row's rate (bf16 on the tensor cores, float32 at the 3xTF32
    rate)."""
    n_bytes = elem_bytes * B * H * D * 8 * S + 4 * B * H * S
    pairs = S * (S + 1) // 2
    flops = 10.0 * B * H * pairs * D
    peak = H100_BF16_FLOPS if elem_bytes == 2 else H100_TF32_FLOPS / 3
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ssd_bwd_bound_ms(B, Q, H, P, N, groups):
    """Least time for the SSD chunk's backward (float32): the chunk's
    inputs (B and C once per group) and the outputs' gradients read once,
    the inputs' gradients written once; against the forward's products
    recomputed and two gradient products for each, at the 3xTF32 rate."""
    ins = B * Q * H * (P + 1) + H + 2 * B * Q * groups * N + B * H * P * N
    outs = B * Q * H * P + B * H * P * N
    n_bytes = 4 * (2 * ins + outs)
    tri = Q * (Q + 1) // 2
    flops = 3 * 2.0 * B * (groups * tri * N + H * tri * P + 2 * H * Q * P * N)
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / (H100_TF32_FLOPS / 3) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def model_train_phases(torch) -> dict:
    """The model's training path on the card: the kernels' log-sum-exp and
    their Functions' gradients against the plain versions, float32
    zamba2-1.2b at full width (one Model.loss and its gradients through the
    kernels and through the plain versions), the config's own bf16 with a
    float32 master through make_train_step (timed, profiled), Trainer on
    the card against the CPU on two reduced configs, checkpoint/restart on
    the card, and the full-width state's checkpoint size against fig12's
    rates.  Returns the training fields of the flash and ssd JSON rows."""
    import dataclasses
    import tempfile

    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile, record_function, schedule
    from repro_torch.checkpoint import (CheckpointManager, LocalObjectStore,
                                        ThrottledStore)
    from repro_torch.checkpoint.checkpointer import tree_bytes
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.kernels import flash_attention_cuda as kfa
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_chunk_cuda as kss
    from repro_torch.launch.train import Trainer, batch_to, make_train_step
    from repro_torch.models.context import null_ctx
    from repro_torch.models.model import Model, tree_leaves, tree_map
    from repro_torch.optim import adamw
    from repro_torch.optim.optimizers import tree_unflatten

    t_all = time.perf_counter()
    out = {"flash": {}, "flash_f32": {}, "ssd": {}}
    gen = torch.Generator().manual_seed(20)
    cfg = get_config(TRAIN_ARCH)
    B, S, H, D = TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.head_dim
    Q, SH, SP, SN = cfg.ssm_chunk, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to("cuda", dtype)

    def leafwise(got, want):
        return max(((g.float() - w.float()).abs().max()
                    / w.float().abs().max().clamp_min(1e-30)).item()
                   for g, w in zip(got, want))

    # ---------------------------------------- the kernels' training pieces
    phase("flash_attention's log-sum-exp and the two Functions' gradients "
          "against the plain versions")
    lse_err, fn_err = 0.0, {}
    lse_cases = [(B, S, S, H, D, True), (1, 200, 237, 4, 96, False),
                 (2, 1, 38, 4, 16, True), (1, 333, 333, 2, 128, True),
                 (2, 70, 70, 3, 32, False)]
    for dt, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        for b_, sq, sk, h_, d_, causal in lse_cases:
            q = randn(b_, sq, h_, d_, dtype=dt)
            k, v = (randn(b_, sk, h_, d_, dtype=dt) for _ in range(2))
            o, lse = kfa.flash_attention_lse_cuda(q, k, v, causal)
            o2, lse2 = ref.flash_attention_fwd_lse(q, k, v, causal)
            torch.cuda.synchronize()
            e = (lse - lse2).abs().max().item()
            eo = (o.float() - o2.float()).abs().max().item()
            if not (lse.shape == (b_, h_, sq) and e <= LSE_TOL
                    and eo <= FLASH_TOL[name]):
                fail(f"flash_attention_lse_cuda {name} B={b_} Sq={sq} Sk={sk} "
                     f"H={h_} D={d_} causal={causal}: lse max abs err {e:.3g} "
                     f"(tol {LSE_TOL}), o {eo:.3g} (tol {FLASH_TOL[name]})")
            lse_err = max(lse_err, e)
        # the Function at the training shape against autograd of the plain
        # forward (materialised scores)
        q, k, v = (randn(B, S, H, D, dtype=dt).requires_grad_(True) for _ in range(3))
        do = randn(B, S, H, D, dtype=dt)
        got = torch.autograd.grad(ops.flash_attention(q, k, v, True, chunk=S),
                                  (q, k, v), do)
        want = torch.autograd.grad(ops.flash_attention(q, k, v, True, force="ref"),
                                   (q, k, v), do)
        fn_err[f"flash_{name}"] = leafwise(got, want)
    x, dt_, A = randn(B, Q, SH, SP), (torch.rand(B, Q, SH, generator=gen) * 0.099
                                      + 0.001).cuda(), -(torch.rand(SH, generator=gen)
                                                         * 1.5 + 0.5).cuda()
    Bg, Cg, st = randn(B, Q, 1, SN), randn(B, Q, 1, SN), randn(B, SH, SP, SN)
    leaves = [t.requires_grad_(True) for t in (x, dt_, A, Bg, Cg, st)]
    args = leaves[:3] + [t.expand(B, Q, SH, SN) for t in leaves[3:5]] + leaves[5:]
    dy, dst = randn(B, Q, SH, SP), randn(B, SH, SP, SN)
    y, ns = ops.ssd_chunk(*args)
    got = torch.autograd.grad((y, ns), leaves, (dy, dst))
    y2, ns2 = ops.ssd_chunk(*args, force="ref")
    want = torch.autograd.grad((y2, ns2), leaves, (dy, dst))
    fn_err["ssd_chunk"] = leafwise(got, want)
    print(f"lse: {2 * len(lse_cases)} cases (both routes; {TRAIN_ARCH}'s "
          f"training shape, D in (16, 32, 96, 128), Sq != Sk) max abs err "
          f"{lse_err:.3g} (tol {LSE_TOL}); gradients against autograd of the "
          f"plain forward at the training shapes, of each leaf's largest: "
          + ", ".join(f"{k} {v:.3g}" for k, v in fn_err.items())
          + f" (tol f32 {FN_GRAD_TOL['float32']}, bf16 {FN_GRAD_TOL['bfloat16']})")
    for key, err in fn_err.items():
        if not err <= FN_GRAD_TOL["bfloat16" if key.endswith("bfloat16") else "float32"]:
            fail(f"{key}: the Function's gradients are {err:.3g} of the largest "
                 "from autograd of the plain forward")

    # --------------------------- float32 zamba2 at full width: loss + grads
    phase(f"main path: {TRAIN_ARCH} (float32) Model.loss and its gradients at "
          f"full width, through the kernels and through the plain versions")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = Model(cfg32)
    t0 = time.perf_counter()
    params = model32.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    names = leaf_names(params)
    n_params = sum(t.numel() for t in tree_leaves(params))
    batch = batch_to(SyntheticLMDataset(cfg32, B, S, seed=0).get_batch(0), "cuda")
    print(f"{cfg32.name} float32: {n_params:,} parameters in {len(names)} leaves, "
          f"{cfg.n_layers} layers, depth not cut; random weights from seed 0 "
          f"(init {time.perf_counter() - t0:.2f} s); batch {B} x {S} tokens from "
          f"SyntheticLMDataset(seed=0); remat none")

    def loss_and_grads(ctx):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = model32.loss(p, batch, ctx)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        counts = (kfa.TF32_LAUNCHES, kss.LAUNCHES)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        torch.cuda.synchronize()
        return (float(loss.detach()), [g.detach() for g in grads], counts,
                (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3)

    kfa.LAUNCHES = kfa.TF32_LAUNCHES = kfa.WGMMA_LAUNCHES = kss.LAUNCHES = 0
    loss_k, g_k, fwd_counts, fwd_ms, bwd_ms = loss_and_grads(
        null_ctx(attn_chunk=min(512, S), remat="none"))
    bwd_counts = (kfa.TF32_LAUNCHES, kss.LAUNCHES)
    loss_r, g_r, _, fwd_ms_r, bwd_ms_r = loss_and_grads(
        null_ctx(attn_chunk=min(512, S), remat="none", kernels="ref"))
    want_fa = Model(cfg).n_shared_invocations
    want_ss = cfg.n_layers * -(-S // Q)
    loss_rel = abs(loss_k - loss_r) / abs(loss_r)
    errs = [((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
            for a, b in zip(g_k, g_r)]
    worst = max(range(len(errs)), key=errs.__getitem__)
    finite = all(bool(torch.isfinite(g).all()) for g in g_k)
    print(f"loss through the kernels {loss_k:.7f}, through the plain versions "
          f"{loss_r:.7f}: relative diff {loss_rel:.3g} (tol {TRAIN_LOSS_RTOL})")
    print("gradient leaves, max abs diff of each leaf's largest magnitude: "
          + ", ".join(f"{n} {e:.3g}" for n, e in zip(names, errs)))
    print(f"worst leaf {names[worst]} {errs[worst]:.3g} (tol {TRAIN_GRAD_TOL}); "
          f"every gradient finite: {finite}")
    print(f"launches: forward flash {fwd_counts[0]} (3xTF32 route, want {want_fa}), "
          f"ssd_chunk {fwd_counts[1]} (want {cfg.n_layers} x {-(-S // Q)} = "
          f"{want_ss}); after the backward {bwd_counts} (the backwards are plain); "
          f"wall: forward {fwd_ms:.1f} ms, backward {bwd_ms:.1f} ms through the "
          f"kernels, {fwd_ms_r:.1f} / {bwd_ms_r:.1f} ms plain")
    if fwd_counts != (want_fa, want_ss) or bwd_counts != fwd_counts:
        fail(f"the float32 training forward launched (flash 3xTF32, ssd_chunk) "
             f"{fwd_counts} (want {(want_fa, want_ss)}), {bwd_counts} after the "
             f"backward")
    if not (loss_rel <= TRAIN_LOSS_RTOL and errs[worst] <= TRAIN_GRAD_TOL and finite):
        fail(f"float32 {TRAIN_ARCH} training through the kernels: loss {loss_rel:.3g} "
             f"relative, worst leaf {names[worst]} {errs[worst]:.3g}")
    out["flash_f32"]["train"] = {
        "arch": cfg32.name, "batch": B, "seq": S, "launches_per_forward": fwd_counts[0],
        "loss_kernels": loss_k, "loss_plain": loss_r, "loss_rel": loss_rel,
        "worst_leaf": names[worst], "worst_leaf_err": errs[worst],
        "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "fwd_plain_ms": fwd_ms_r,
        "bwd_plain_ms": bwd_ms_r}
    out["ssd"]["train_f32_launches_per_forward"] = fwd_counts[1]
    del params, g_k, g_r
    torch.cuda.empty_cache()

    # --------------------------- the config's bf16, float32 master: steps
    phase(f"main path: {TRAIN_ARCH} ({cfg.dtype}, float32 master) "
          f"{TRAIN_STEPS} train steps through the kernels (make_train_step, adamw)")
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    opt = adamw(TRAIN_LR, keep_master=(cfg.opt_precision == "fp32"))
    state = {"params": params, "opt": opt.init(params)}
    del params
    ctx = null_ctx(attn_chunk=min(512, S), remat="none")
    step_fn = make_train_step(model, opt, ctx)
    batch = batch_to(SyntheticLMDataset(cfg, B, S, seed=0).get_batch(0), "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kfa.LAUNCHES = kfa.WGMMA_LAUNCHES = kss.LAUNCHES = 0
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fa_step, ss_step = kfa.WGMMA_LAUNCHES / TRAIN_STEPS, kss.LAUNCHES / TRAIN_STEPS
    ms_step = sum(step_ms[-3:]) / 3
    state_bytes = tree_bytes(state)
    print(f"losses {[round(x, 5) for x in losses]} on the repeated batch (lr "
          f"{TRAIN_LR}); step ms {[round(x, 1) for x in step_ms]}, "
          f"{ms_step:.2f} ms a step over the last 3 ({B * S / ms_step * 1e3:.0f} "
          f"tokens/s); peak memory {peak_gb:.2f} GB (torch.cuda.max_memory_allocated)"
          f"; train state {state_bytes / 1e9:.3f} GB")
    print(f"launches a step: flash_attention {fa_step:g} (bf16 wgmma route, want "
          f"{want_fa}), ssd_chunk {ss_step:g} (want {want_ss})")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"bf16 training: losses {losses}: not finite, or step "
             f"{TRAIN_STEPS}'s not below step 1's")
    if (fa_step, ss_step) != (want_fa, want_ss) or kfa.LAUNCHES != kfa.WGMMA_LAUNCHES:
        fail(f"bf16 training launched flash {kfa.LAUNCHES} ({kfa.WGMMA_LAUNCHES} "
             f"wgmma) and ssd_chunk {kss.LAUNCHES} times in {TRAIN_STEPS} steps")

    phase(f"{TRAIN_ARCH} bf16 train step under torch.profiler")
    seen = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: seen.extend(device_intervals(p))) as prof:
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            float(m["loss"])
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
            prof.step()
    busy = busy_us(seen) / 1e6
    idle = 1 - busy / prof_wall

    # one step in its three parts, each ended by a synchronise, to split
    # the card's busy time between forward, backward and update
    def parts(state):
        p = tree_map(lambda t: t.detach().requires_grad_(True), state["params"])
        with record_function("train.forward"):
            loss, _ = model.loss(p, batch, ctx)
            torch.cuda.synchronize()
        with record_function("train.backward"):
            grads = torch.autograd.grad(loss, tree_leaves(p))
            torch.cuda.synchronize()
        with record_function("train.update"):
            new = opt.update(tree_unflatten(p, list(grads)), state["opt"],
                             state["params"])
            torch.cuda.synchronize()
        return {"params": new[0], "opt": new[1]}

    spans, kern = {}, []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state = parts(state)
    for e in prof.events():
        if e.name.startswith("train.") and e.device_type == torch.autograd.DeviceType.CPU:
            spans[e.name] = (e.time_range.start, e.time_range.end)
    kern = device_intervals(prof)
    part_busy = {n: busy_us([iv for iv in kern if lo <= iv[0] <= hi]) / 1e3
                 for n, (lo, hi) in spans.items()}
    total = sum(part_busy.values())
    bwd_share = (part_busy["train.backward"] / total
                 if total and "train.backward" in part_busy else None)
    print(f"one step (profiler on): wall {prof_wall * 1e3:.2f} ms, {len(seen)} "
          f"kernels, card busy {busy * 1e3:.2f} ms, idle {100 * idle:.2f}%")
    print("the step in parts, card busy ms: "
          + ", ".join(f"{n[6:]} {v:.2f}" for n, v in part_busy.items())
          + (f"; the backward's share of busy {100 * bwd_share:.1f}%"
             if bwd_share is not None else "; no share: the trace has no part "
             "or no kernel"))
    out["flash"]["train"] = {
        "arch": cfg.name, "dtype": cfg.dtype, "master": "float32", "batch": B,
        "seq": S, "steps": TRAIN_STEPS, "losses": losses, "step_ms": step_ms,
        "ms_per_step": ms_step, "peak_memory_gb": peak_gb,
        "state_bytes": state_bytes, "launches_per_step": fa_step,
        "kernels_per_step_seen": len(seen), "busy_ms": busy * 1e3,
        "wall_ms": prof_wall * 1e3, "idle_share": idle,
        "busy_ms_by_part": part_busy, "backward_share_of_busy": bwd_share}
    out["ssd"]["train_launches_per_step"] = ss_step

    phase(f"the full-width train state against fig12's store rates "
          f"(ThrottledStore; not written)")
    deadline = {}
    with tempfile.TemporaryDirectory() as tmp:
        for where, rate in FIG12_RATES:
            store = ThrottledStore(LocalObjectStore(tmp), bandwidth_bps=rate)
            mgr = CheckpointManager(store, "fullwidth")
            deadline[where] = (store.transfer_time(state_bytes),
                               mgr.fits_deadline(state, 120.0))
    print(f"tree_bytes {state_bytes:,} ({state_bytes / 1e9:.2f} GB: bf16 params, "
          f"float32 master, m and v); "
          + "; ".join(f"at {r / 1e6:.2f} MB/s ({w}) {deadline[w][0]:.1f} s, "
                      f"fits the 120 s notice: {deadline[w][1]}"
                      for w, r in FIG12_RATES))
    out["flash"]["train"]["fits_deadline"] = deadline
    del state, m
    torch.cuda.empty_cache()

    # ------------------------------- the backwards' card time (rows 4b, 5b)
    phase("the plain backwards at the training shapes (CUDA events, card time)")
    bwd = {}
    for dt, name in ((torch.bfloat16, "flash"), (torch.float32, "flash_f32")):
        q, k, v, do = (randn(B, S, H, D, dtype=dt) for _ in range(4))
        o, lse = kfa.flash_attention_lse_cuda(q, k, v, True)

        def fb():
            return ref.flash_attention_bwd(q, k, v, o, lse, do, True, None, S)

        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        dot = do.transpose(1, 2)

        def sdpa_bwd():
            return torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)

        got = fb()
        lib = sdpa_bwd()
        lib_err = max((a.float() - b.transpose(1, 2).float()).abs().max().item()
                      for a, b in zip(got, lib))
        bound, by = flash_bwd_bound_ms(B, S, H, D, q.element_size())
        r = {"ms": cuda_ms(fb, iters=50, warmup=5),
             "library_ms": cuda_ms(sdpa_bwd, iters=50, warmup=5),
             "device_us": device_us_per_call(fb, iters=10, warmup=2,
                                             what=f"of the flash backward, {name}"),
             "library_device_us": device_us_per_call(
                 sdpa_bwd, iters=10, warmup=2,
                 what=f"of scaled_dot_product_attention's backward, {name}"),
             "bound_ms": bound, "bound_by": by, "library_err": lib_err,
             "launches_per_step": want_fa,
             "shape": {"B": B, "S": S, "H": H, "D": D, "dtype": str(dt)[6:],
                       "causal": True, "chunk": S},
             "library": "torch.autograd.grad of scaled_dot_product_attention"}
        print(f"flash backward {str(dt)[6:]} (B,S,H,D) = {(B, S, H, D)}: "
              f"{r['ms']:.4f} ms (CUDA events), {r['device_us']} us of card time; "
              f"SDPA's backward {r['library_ms']:.4f} ms, {r['library_device_us']} "
              f"us (max abs diff from the plain backward {lib_err:.3g}); bound "
              f"{bound:.4g} ms ({by}); {want_fa} a step")
        bwd[name] = r
        del q, k, v, do, o, lse, qt, kt, vt, ot, dot
    ssd_args = [t.detach() for t in args]
    dy, dst = dy.detach(), dst.detach()

    def sb():
        return ref.ssd_chunk_bwd(*ssd_args, dy, dst)

    bound, by = ssd_bwd_bound_ms(B, Q, SH, SP, SN, cfg.ssm_groups)
    r = {"ms": cuda_ms(sb, iters=30, warmup=3),
         "device_us": device_us_per_call(sb, iters=10, warmup=2,
                                         what="of the SSD chunk's backward"),
         "bound_ms": bound, "bound_by": by, "library_ms": None,
         "launches_per_step": want_ss,
         "shape": {"B": B, "Q": Q, "H": SH, "P": SP, "N": SN, "dtype": "float32",
                   "bc_head_stride": int(ssd_args[3].stride(2))}}
    print(f"ssd_chunk backward (B,Q,H,P,N) = {(B, Q, SH, SP, SN)}, B/C head stride "
          f"0: {r['ms']:.4f} ms (CUDA events), {r['device_us']} us of card time; "
          f"bound {bound:.4g} ms ({by}); {want_ss} a step; no PyTorch call "
          f"computes it")
    bwd["ssd"] = r
    for key in ("flash", "flash_f32", "ssd"):
        out[key]["backward"] = bwd[key]

    # ------------------------------- Trainer: card against CPU, restart
    phase("Trainer on the card against the CPU (reduced configs, float32), "
          "checkpoint/restart on the card")
    trainer = {}
    for arch in ("zamba2-1.2b", "qwen1.5-0.5b"):
        rcfg = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
        runs = {}
        for dev in ("cuda", "cpu"):
            tr = Trainer(rcfg, batch=2, seq=64, seed=0, val_every=1, device=dev)
            before = (kfa.LAUNCHES, kss.LAUNCHES)
            tr.run_steps(4)
            runs[dev] = (tr.metrics_vals, (kfa.LAUNCHES - before[0],
                                           kss.LAUNCHES - before[1]))
        (lk, nk), (lc, _) = runs["cuda"], runs["cpu"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lc))
        print(f"{rcfg.name}: card losses {[round(x, 6) for x in lk]}, CPU "
              f"{[round(x, 6) for x in lc]}: max relative diff {rel:.3g} (tol "
              f"{TRAINER_RTOL}); card launches (flash, ssd_chunk) {nk}")
        if not rel <= TRAINER_RTOL or nk[0] == 0:
            fail(f"Trainer {rcfg.name}: card and CPU losses {rel:.3g} apart, or the "
                 "card run launched no flash kernel")
        trainer[rcfg.name] = {"card": lk, "cpu": lc, "rel": rel, "launches": nk}
    rcfg = dataclasses.replace(get_config("zamba2-1.2b", reduced=True), dtype="float32")
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(LocalObjectStore(tmp), "trial", save_interval_steps=2)
        direct = Trainer(rcfg, batch=2, seq=64, seed=0, val_every=1, ckpt=mgr)
        direct.run_steps(4)
        mgr.wait()
        again = Trainer(rcfg, batch=2, seq=64, seed=0, val_every=1,
                        ckpt=CheckpointManager(LocalObjectStore(tmp), "trial", 2))
        got = again.restore(step=2)
        on_card = all(t.is_cuda for t in tree_leaves(again.state["params"]))
        again.run_steps(2)
    rel = abs(again.metrics_vals[-1] - direct.metrics_vals[-1]) / abs(direct.metrics_vals[-1])
    print(f"restart: restored step {got} onto the card ({on_card}), 2 more steps: "
          f"step-4 loss {again.metrics_vals[-1]:.7f} against the direct run's "
          f"{direct.metrics_vals[-1]:.7f}, relative diff {rel:.3g} (tol {RESTART_RTOL})")
    if not (got == 2 and on_card and rel <= RESTART_RTOL
            and again.metrics_vals[:2] == direct.metrics_vals[:2]):
        fail(f"checkpoint/restart on the card: step {got}, step-4 loss {rel:.3g} "
             "relative from the direct run")
    trainer["restart_rel"] = rel
    out["flash"]["train"]["trainer"] = trainer
    wall = time.perf_counter() - t_all
    print(f"the model's training phases: {wall:.1f} s of wall")
    out["flash"]["train"]["phases_wall_s"] = wall
    return out


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs a CUDA card")

    from repro_torch.core import revpred as rp
    from repro_torch.kernels import build, lstm_cell as klc, ref

    # ------------------------------------------------------------ device
    phase("device")
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"device: {name}, compute capability {cap}, "
          f"count {torch.cuda.device_count()}")
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if cap != (9, 0):
        fail(f"compute capability {cap}: the kernels are built for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmul and cuDNN: plain versions run in full float32")

    # ------------------------------------------------------------- build
    phase("build")
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
    for stem, log in build.BUILD_LOG.items():
        print(f"-- nvcc {stem}.cu ({build.BUILD_SECONDS[stem]:.2f} s):")
        print(log.strip())

    # ------------------------------------- kernel against plain, on card
    phase("lstm_cell kernel against its plain version")
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    shapes = [(G, 1, I, 32) for G in (1, 6) for I in (6, 7, 32)]
    shapes += [(G, B, 32 if H == 32 else 64, H)
               for B in (4, 256) for H in (32, 128) for G in (1, 3)]
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for G, B, I, H in shapes:
            args = cell_inputs(G, B, I, H, dtype, "cuda")
            h1, c1 = klc.lstm_cell_cuda(*args)
            h2, c2 = ref.lstm_cell_ref(*args)
            torch.cuda.synchronize()
            e = max((h1.float() - h2.float()).abs().max().item(),
                    (c1.float() - c2.float()).abs().max().item())
            if not e <= tol:
                fail(f"lstm_cell {dtype} G={G} B={B} I={I} H={H}: "
                     f"max abs err {e:.3g} > {tol}")
            err[dtype] = max(err[dtype], e)
    print(f"{len(shapes)} shapes x 2 dtypes agree: max abs err "
          f"f32 {err[torch.float32]:.3g} (tol {F32_TOL}), "
          f"bf16 {err[torch.bfloat16]:.3g} (tol {BF16_TOL})")

    phase("lstm_stack kernel against its plain version")
    stack_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for I, T, H, G, B in STACK_SHAPES:
            xs, layers = stack_inputs(G, B, T, I, H, dtype, "cuda")
            h1 = klc.lstm_stack_cuda(xs, layers)
            h2 = ref.lstm_stack_ref(xs, layers)
            torch.cuda.synchronize()
            e = (h1.float() - h2.float()).abs().max().item()
            if not (h1.shape == (G, B, H) and e <= tol):
                fail(f"lstm_stack {dtype} I={I} T={T} H={H} G={G} B={B}: "
                     f"max abs err {e:.3g} > {tol}")
            stack_err[dtype] = max(stack_err[dtype], e)
    print(f"{len(STACK_SHAPES)} shapes (I, T) in ((6, 59), (7, 60)), H in "
          f"(16, 32), G in (1, 6, 40), B in (1, 4), {STACK_LAYERS} layers, x 2 "
          f"dtypes agree with ref.lstm_stack_ref: max abs err f32 "
          f"{stack_err[torch.float32]:.3g} (tol {F32_TOL}), bf16 "
          f"{stack_err[torch.bfloat16]:.3g} (tol {BF16_TOL})")

    gen = torch.Generator().manual_seed(0)
    G = 6
    stacked = rp.tree_map(lambda *xs: torch.stack(xs),
                          *[rp.init_revpred(gen, 32, device="cuda")
                            for _ in range(G)])
    hist = torch.rand(G, 1, rp.HISTORY, rp.N_FEAT, generator=gen).cuda()
    present = torch.rand(G, 1, rp.N_FEAT + 1, generator=gen).cuda()
    before = klc.STACK_LAUNCHES, klc.LAUNCHES
    with torch.inference_mode():
        lg_k = rp.revpred_logits(stacked, hist, present)
    fwd_launches = (klc.STACK_LAUNCHES - before[0], klc.LAUNCHES - before[1])
    with torch.inference_mode():
        lg_r = rp.revpred_logits(stacked, hist, present, force="ref")
    fwd_err = (lg_k - lg_r).abs().max().item()
    if not fwd_err <= FORWARD_TOL or fwd_launches != (1, 0):
        fail(f"revpred_logits through the kernel: max abs err {fwd_err:.3g}, "
             f"(stack, cell) launches {fwd_launches} (want (1, 0))")
    print(f"revpred_logits G={G}: one lstm_stack launch, no lstm_cell launch; "
          f"kernel against plain max abs err {fwd_err:.3g} (tol {FORWARD_TOL})")

    # --------------------------------------------------------- main path
    phase("main path: SpotTune tuning loop on the card")
    print("RevPred weights are untrained (fresh init, one generator seed per "
          "market, pos_frac=0.2); the fig10 phase trains them")
    klc.LAUNCHES = klc.STACK_LAUNCHES = 0
    with ForwardCounter() as fwd:
        engine, revpred, res, wall = run_scenario("cuda")
    launches, cell_launches, n_fwd = klc.STACK_LAUNCHES, klc.LAUNCHES, fwd.n
    print(f"cost ${res.cost:.4f}  refund ${res.refunded:.4f}  "
          f"JCT {res.jct / 3600:.4f} h  events {len(engine.events)}")
    print(f"predicted top-3 {res.predicted_rank[:3]}  true best "
          f"{res.true_rank[0]}  wall {wall:.2f} s")
    print(f"RevPred queries {len(revpred._p_cache)}, forwards {n_fwd}, "
          f"lstm_stack launches {launches}, lstm_cell launches {cell_launches}")
    if launches <= 0 or launches != n_fwd or cell_launches != 0:
        fail("the main path did not launch the lstm_stack kernel once per "
             "RevPred forward and the lstm_cell kernel no time")
    ps = list(revpred._p_cache.values())
    if not (all(0.0 <= p <= 1.0 for p in ps) and math.isfinite(res.cost)
            and len(res.predicted_rank) == 16):
        fail("main path outputs are not finite probabilities / a full rank")

    phase("the same scenario on the CPU (plain versions)")
    cpu_engine, cpu_revpred, cpu_res, cpu_wall = run_scenario("cpu")
    common = set(revpred._p_cache) & set(cpu_revpred._p_cache)
    p_err = max(abs(revpred._p_cache[k] - cpu_revpred._p_cache[k])
                for k in common)
    print(f"cpu wall {cpu_wall:.2f} s; {len(common)} common RevPred queries, "
          f"max abs diff {p_err:.3g} (tol {P_CACHE_TOL})")
    if not common or not p_err <= P_CACHE_TOL:
        fail(f"card and CPU revocation probabilities differ by {p_err:.3g}")
    same = (res.cost == cpu_res.cost and res.refunded == cpu_res.refunded
            and res.predicted_rank == cpu_res.predicted_rank)
    print(f"cost, refund and ranking agree: {same} (card ${res.cost:.6f} / "
          f"${res.refunded:.6f}, cpu ${cpu_res.cost:.6f} / "
          f"${cpu_res.refunded:.6f})")
    if not same:
        fail("the tuning loop's cost, refund or ranking differs between the "
             "card and the CPU")

    # ------------------------------------------------- where the time goes
    phase("main path on the card under torch.profiler")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, _, prof_wall = run_scenario("cuda")
    iv = device_intervals(prof)
    busy = busy_us(iv) / 1e6
    by_name = {}
    for s0, s1, nm in iv:
        by_name[nm] = by_name.get(nm, 0.0) + (s1 - s0) / 1e6
    stack_s = sum(v for k, v in by_name.items() if "lstm_stack_kernel" in k)
    n_stack = sum(1 for _, _, nm in iv if "lstm_stack_kernel" in nm)
    print(f"profiled wall {prof_wall:.3f} s (profiler on), {len(iv)} kernels, "
          f"card busy {busy:.4f} s = {100 * busy / prof_wall:.2f}% of wall, "
          f"idle {100 * (1 - busy / prof_wall):.2f}%")
    print(f"lstm_stack kernel busy {stack_s:.4f} s over {n_stack} launches "
          f"({stack_s / max(n_stack, 1) * 1e6:.2f} us each); other kernels "
          f"{busy - stack_s:.4f} s; busy against the unprofiled wall "
          f"{wall:.3f} s: {100 * busy / wall:.2f}%")
    for nm, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"  {v * 1e3:9.3f} ms  {nm[:100]}")

    phase("one full-pool RevPred forward (host wall, synchronised)")
    G = len(engine.market.pool)
    stack = revpred._ensure_stack()
    idx = torch.arange(G, device="cuda")
    params = rp.tree_map(lambda x: x.index_select(0, idx), stack["params"])
    h_np = torch.rand(G, 1, rp.HISTORY, rp.N_FEAT, generator=gen).numpy()
    p_np = torch.rand(G, 1, rp.N_FEAT + 1, generator=gen).numpy()

    def fwd(force):
        with torch.inference_mode():
            lg = rp.revpred_logits(params, torch.as_tensor(h_np).cuda(),
                                   torch.as_tensor(p_np).cuda(), force=force)
            return torch.sigmoid(lg).cpu()

    def wall_ms(fn, n=30):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    fwd_kernel_ms = wall_ms(lambda: fwd(None))
    fwd_plain_ms = wall_ms(lambda: fwd("ref"))
    fwd_kernel_ms_b = wall_ms(lambda: fwd(None))
    print(f"G={G}: through the kernel {fwd_kernel_ms:.3f} / "
          f"{fwd_kernel_ms_b:.3f} ms, through the plain version "
          f"{fwd_plain_ms:.3f} ms; the main path ran {n_fwd} forwards "
          f"= {n_fwd * fwd_kernel_ms / 1e3:.3f} s of its {wall:.3f} s wall")

    # ------------------------------------------------------------ timing
    phase("timing (CUDA events)")
    G, B, I, H = 6, 1, 32, 32          # layers 2-3 of a full-pool forward
    args = cell_inputs(G, B, I, H, torch.float32, "cuda")
    ms = cuda_ms(lambda: klc.lstm_cell_cuda(*args))
    plain_ms = cuda_ms(lambda: ref.lstm_cell_ref(*args))
    ms_b = cuda_ms(lambda: klc.lstm_cell_cuda(*args))
    plain_ms_b = cuda_ms(lambda: ref.lstm_cell_ref(*args))
    # torch.lstm_cell computes one group (G=1): weights (4H, I), two biases
    a1 = cell_inputs(1, B, I, H, torch.float32, "cuda")
    ms_g1 = cuda_ms(lambda: klc.lstm_cell_cuda(*a1))
    w_ih_t = a1[3][0].t().contiguous()
    w_hh_t = a1[4][0].t().contiguous()
    zero_b = torch.zeros_like(a1[5][0])
    lib = torch.lstm_cell(a1[0][0], (a1[1][0], a1[2][0]), w_ih_t, w_hh_t,
                          a1[5][0], zero_b)
    ker = klc.lstm_cell_cuda(*a1)
    lib_err = max((lib[0] - ker[0][0]).abs().max().item(),
                  (lib[1] - ker[1][0]).abs().max().item())
    library_ms = cuda_ms(lambda: torch.lstm_cell(
        a1[0][0], (a1[1][0], a1[2][0]), w_ih_t, w_hh_t, a1[5][0], zero_b))
    dev_us = device_us_per_call(lambda: klc.lstm_cell_cuda(*args))
    plain_dev_us = device_us_per_call(lambda: ref.lstm_cell_ref(*args))
    bound_ms, bound_by = cell_bound_ms(G, B, I, H)
    print(f"G={G} B={B} I={I} H={H} f32: kernel {ms:.5f} / {ms_b:.5f} ms, "
          f"plain {plain_ms:.5f} / {plain_ms_b:.5f} ms, bound {bound_ms:.3g} "
          f"ms ({bound_by})")
    print(f"card time per call (profiler): kernel {dev_us} us, plain "
          f"{plain_dev_us} us")
    print(f"G=1: kernel {ms_g1:.5f} ms, torch.lstm_cell {library_ms:.5f} ms "
          f"(agrees with the kernel to {lib_err:.3g})")

    lstm_row = {
        "name": "lstm_cell", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lstm_cell.cu",
        "replaces": "src/repro/kernels/lstm_cell.py:50 (lstm_cell_pallas)",
        "launches": cell_launches,
        "paths": "none since the stack kernel: held against its plain "
                 "version only (training runs the stack's own training "
                 "kernels, rows lstm_stack_fwd_train and lstm_stack_bwd)",
        "max_abs_err": max(err.values()),
        "max_err_f32": err[torch.float32], "max_err_bf16": err[torch.bfloat16],
        "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
        "shape": {"G": G, "B": B, "I": I, "H": H, "dtype": "float32"},
        "library_shape": {"G": 1, "B": B, "I": I, "H": H},
        "ms_g1": ms_g1,
        "device_us": dev_us, "plain_device_us": plain_dev_us,
    }

    # ---------------------------------------------------- the stack's timing
    phase("lstm_stack timing: a full-pool forward's stack (CUDA events)")
    G, B, I, T, H = len(engine.market.pool), 1, rp.N_FEAT, rp.HISTORY, 32
    xs, layers = stack_inputs(G, B, T, I, H, torch.float32, "cuda", seed=1)
    st_ms = cuda_ms(lambda: klc.lstm_stack_cuda(xs, layers), iters=1000)
    st_plain = cuda_ms(lambda: ref.lstm_stack_ref(xs, layers), iters=20, warmup=3)
    st_ms_b = cuda_ms(lambda: klc.lstm_stack_cuda(xs, layers), iters=1000)
    st_plain_b = cuda_ms(lambda: ref.lstm_stack_ref(xs, layers), iters=20,
                         warmup=3)
    st_dev = device_us_per_call(lambda: klc.lstm_stack_cuda(xs, layers))
    st_plain_dev = device_us_per_call(lambda: ref.lstm_stack_ref(xs, layers),
                                      iters=10, warmup=2)
    st_bound, st_by = stack_bound_ms(G, B, T, I, H)
    wave = klc.lstm_stack_plan(B, I, H, T, STACK_LAYERS)[0]
    # a wave of all layers is a wavefront: T + L - 1 dependent steps
    steps = T + STACK_LAYERS - 1 if wave == STACK_LAYERS else STACK_LAYERS * T
    # cuDNN's nn.LSTM computes one group (G = 1): weights (4H, I_l), b_ih = b
    # and b_hh = 0, gate order i, f, g, o as here; TF32 is off (set above)
    x1, l1 = stack_inputs(1, B, T, I, H, torch.float32, "cuda", seed=1)
    st_g1 = cuda_ms(lambda: klc.lstm_stack_cuda(x1, l1), iters=1000)
    lstm = torch.nn.LSTM(I, H, num_layers=STACK_LAYERS, batch_first=True).cuda()
    with torch.no_grad():
        for n, lp in enumerate(l1):
            getattr(lstm, f"weight_ih_l{n}").copy_(lp["w_ih"][0].t())
            getattr(lstm, f"weight_hh_l{n}").copy_(lp["w_hh"][0].t())
            getattr(lstm, f"bias_ih_l{n}").copy_(lp["b"][0])
            getattr(lstm, f"bias_hh_l{n}").zero_()
    with torch.inference_mode():
        lib_h = lstm(x1[0])[1][0][-1]
        st_lib_err = (lib_h - klc.lstm_stack_cuda(x1, l1)[0]).abs().max().item()
        st_lib = cuda_ms(lambda: lstm(x1[0]), iters=500)
    st_lib_dev = device_us_per_call(lambda: lstm(x1[0]))
    print(f"G={G} B={B} I={I} T={T} H={H} {STACK_LAYERS} layers f32: kernel "
          f"{st_ms:.5f} / {st_ms_b:.5f} ms, plain (the per-step cell loop) "
          f"{st_plain:.4f} / {st_plain_b:.4f} ms; bound {st_bound:.3g} ms "
          f"({st_by}); {wave} layers a wave, {steps} dependent steps, "
          f"{st_ms / steps * 1e3:.4f} us of kernel each")
    print(f"card time per call (profiler): kernel {st_dev} us, plain "
          f"{st_plain_dev} us")
    print(f"G=1: kernel {st_g1:.5f} ms; cuDNN nn.LSTM ({STACK_LAYERS} layers, "
          f"TF32 off) {st_lib:.5f} ms, {st_lib_dev} us of card time (agrees "
          f"with the kernel to {st_lib_err:.3g})")
    stack_row = {
        "name": "lstm_stack", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lstm_cell.cu",
        "replaces": "src/repro/kernels/lstm_cell.py:50 (lstm_cell_pallas, "
                    "scanned over RevPred's 3 x 59 steps by "
                    "src/repro/core/revpred.py:187 _run_lstm_stack)",
        "launches": launches, "forwards": n_fwd,
        "max_abs_err": max(stack_err.values()),
        "max_err_f32": stack_err[torch.float32],
        "max_err_bf16": stack_err[torch.bfloat16],
        "ms": st_ms, "plain_ms": st_plain, "bound_ms": st_bound,
        "bound_by": st_by, "dependent_steps": steps, "wave": wave,
        "library_ms": st_lib,
        "library": "torch.nn.LSTM (cuDNN, TF32 off), G = 1",
        "library_device_us": st_lib_dev, "ms_g1": st_g1,
        "shape": {"G": G, "B": B, "I": I, "T": T, "H": H,
                  "layers": STACK_LAYERS, "dtype": "float32"},
        "device_us": st_dev, "plain_device_us": st_plain_dev,
        "forward_wall_ms": fwd_kernel_ms, "forward_plain_wall_ms": fwd_plain_ms,
        "tuning_wall_s": wall, "tuning_busy_s": busy,
    }

    soa_row = soa_phases(torch)
    sweep = soa_row["revpred_sweep"]
    stack_row["revpred_sweep_launches"] = sweep["lstm_stack_launches"]
    stack_row["revpred_sweep_forwards"] = sweep["forwards"]
    # the service after the sweep, before the training and phi3 phases
    svc = service_phases(torch)
    learned = svc["learned"]
    soa_row["service"] = svc["service"]
    soa_row["service_launches"] = {
        "fused": svc["service"]["soa_step_fused_launches"],
        "fold_only": svc["service"]["soa_step_fold_launches"],
        "learned_revpred_study": learned["soa_step"]}
    stack_row["service_launches"] = learned["lstm_stack"]
    stack_row["service_forwards"] = learned["forwards"]
    flash_row, flash_f32_row, ssd_row = serve_phases(torch)
    # the training slice and phi3 run last, so the earlier paths run as
    # they did before them
    fwd_train_row, bwd_row = train_phases(torch)
    fwd_train_row["service_launches"] = learned["lstm_stack_fwd_train"]
    bwd_row["service_launches"] = learned["lstm_stack_bwd"]
    stack_row["fig10_launches"] = bwd_row["fig10"]["launches"][
        "lstm_stack (inference)"]
    for key, val in phi3_phase(torch).items():
        (flash_f32_row if "_f32_" in key else flash_row)[key] = val
    # the model's training path last: it needs the card's memory to itself
    train = model_train_phases(torch)
    flash_row.update(train["flash"])
    flash_f32_row.update(train["flash_f32"])
    ssd_row.update(train["ssd"])
    print(smi)
    print(json.dumps({"kernels": [lstm_row, stack_row, fwd_train_row, bwd_row,
                                  soa_row, flash_row, flash_f32_row, ssd_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
