"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
nvcc, holds each kernel against its plain PyTorch version on the card, and
drives the port's two paths through them:

* the SpotTune tuning loop (12-day market, 16 trials, theta=0.7, mcnt=3) with
  a RevPred whose LSTM cell is the ``lstm_cell`` kernel, repeated on the CPU
  through the plain versions and compared;
* the fig9_sweep1000 grid (1000 replicas) through ``SweepRunner`` on the
  card, whose SoA rounds run the ``soa_step`` kernel (the EWMA fold and the
  per-replica boundary min), repeated on the CPU and compared replica by
  replica, and a 20-replica sweep with RevPreds that reaches both kernels.

It profiles the card during the sweep and times both kernels beside their
plain versions, their bounds and a PyTorch call where one exists.  Every
phase is fatal on failure.  The last line of standard output is

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
    """(start_us, end_us, name) of every kernel the profiler saw on the card."""
    import torch
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
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


def device_us_per_call(fn, iters: int = 200, warmup: int = 20):
    """Mean microseconds of card time per call (kernels only, launch gaps
    excluded), from a torch.profiler trace; None if the trace has no device
    events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    iv = device_intervals(prof)
    if not iv:
        return None
    return sum(e - s for s, e, _ in iv) / iters


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
    boundary row over the float64 peak."""
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
    klc.LAUNCHES = 0
    ksc.LAUNCHES = ksc.FOLD_LAUNCHES = 0
    rp_tuners, rp_card, rp_wall = revpred_sweep("cuda")
    rp_cell, rp_soa = klc.LAUNCHES, ksc.LAUNCHES
    print(f"{len(rp_tuners)} replicas in {rp_wall:.3f} s; lstm_cell launches "
          f"{rp_cell}, soa_step launches {rp_soa} "
          f"(fold-only {ksc.FOLD_LAUNCHES}); RevPred queries "
          f"{sum(len(rp._p_cache) for rp in rp_card.values())}")
    if rp_cell <= 0 or rp_soa <= 0:
        fail("the RevPred sweep did not launch both lstm_cell and soa_step")
    cpu_tuners, rp_cpu, rp_cpu_wall = revpred_sweep("cpu")
    p_err, n_common = 0.0, 0
    for seed, rp in rp_card.items():
        other = rp_cpu[seed]._p_cache
        for k, p in rp._p_cache.items():
            if k in other:
                n_common += 1
                p_err = max(p_err, abs(p - other[k]))
    same_cost = all(a.result.cost == b.result.cost
                    and a.result.predicted_rank == b.result.predicted_rank
                    for a, b in zip(rp_tuners, cpu_tuners))
    print(f"cpu wall {rp_cpu_wall:.3f} s; {n_common} common RevPred queries, "
          f"max abs diff {p_err:.3g} (tol {P_CACHE_TOL}); costs and rankings "
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
        elif "lstm_cell_kernel" in nm:
            kind = "lstm_cell kernel"
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
    bound_ms, bound_by = soa_bound_ms(lens, F, L, N, R)
    print(f"(F, L, N, R) = {(F, L, N, R)}, float64 fold + int64 min: kernel "
          f"{ms:.5f} / {ms_b:.5f} ms, with the copies to and from the card "
          f"{ms_copies:.5f} / {ms_copies_b:.5f} ms, plain {plain_ms:.5f} / "
          f"{plain_ms_b:.5f} ms, fold-only entry {fold_ms:.5f} ms; bound "
          f"{bound_ms:.3g} ms ({bound_by})")
    print(f"card time per call (profiler): kernel {dev_us} us, plain "
          f"{plain_dev_us} us")
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
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
        "library": "torch.full + scatter_reduce_ amin, the min half alone",
        "shape": {"F": F, "L": L, "N": N, "R": R},
        "device_us": dev_us, "plain_device_us": plain_dev_us,
        "sweep_device_us_per_call": sweep_us,
        "sweep": {"replicas": len(grid), "wall_s": card_wall,
                  "replicas_per_s": len(grid) / card_wall,
                  "cpu_wall_s": cpu_wall, "rounds": rounds,
                  "h2d_bytes": h2d, "d2h_bytes": d2h,
                  "card_busy_s": busy, "profiled_wall_s": prof_wall},
    }


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

    gen = torch.Generator().manual_seed(0)
    G = 6
    stacked = rp.tree_map(lambda *xs: torch.stack(xs),
                          *[rp.init_revpred(gen, 32, device="cuda")
                            for _ in range(G)])
    hist = torch.rand(G, 1, rp.HISTORY, rp.N_FEAT, generator=gen).cuda()
    present = torch.rand(G, 1, rp.N_FEAT + 1, generator=gen).cuda()
    with torch.inference_mode():
        lg_k = rp.revpred_logits(stacked, hist, present)
        lg_r = rp.revpred_logits(stacked, hist, present, force="ref")
    fwd_err = (lg_k - lg_r).abs().max().item()
    if not fwd_err <= FORWARD_TOL:
        fail(f"revpred_logits through the kernel: max abs err {fwd_err:.3g}")
    print(f"revpred_logits G={G}: kernel against plain max abs err "
          f"{fwd_err:.3g} (tol {FORWARD_TOL})")

    # --------------------------------------------------------- main path
    phase("main path: SpotTune tuning loop on the card")
    print("RevPred weights are untrained (fresh init, one generator seed per "
          "market, pos_frac=0.2): RevPred training is a later slice")
    klc.LAUNCHES = 0
    engine, revpred, res, wall = run_scenario("cuda")
    launches = klc.LAUNCHES
    print(f"cost ${res.cost:.4f}  refund ${res.refunded:.4f}  "
          f"JCT {res.jct / 3600:.4f} h  events {len(engine.events)}")
    print(f"predicted top-3 {res.predicted_rank[:3]}  true best "
          f"{res.true_rank[0]}  wall {wall:.2f} s")
    print(f"RevPred queries {len(revpred._p_cache)}, lstm_cell launches "
          f"{launches}")
    if launches <= 0:
        fail("the main path launched the lstm_cell kernel no time")
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
    print(f"cost agrees: {res.cost == cpu_res.cost} "
          f"(card ${res.cost:.6f}, cpu ${cpu_res.cost:.6f}); "
          f"ranking agrees: {res.predicted_rank == cpu_res.predicted_rank}")

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
    cell_s = sum(v for k, v in by_name.items() if "lstm_cell_kernel" in k)
    print(f"profiled wall {prof_wall:.3f} s (profiler on), {len(iv)} kernels, "
          f"card busy {busy:.4f} s = {100 * busy / prof_wall:.2f}% of wall, "
          f"idle {100 * (1 - busy / prof_wall):.2f}%")
    print(f"lstm_cell kernel busy {cell_s:.4f} s; other kernels "
          f"{busy - cell_s:.4f} s; busy against the unprofiled wall "
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
    n_fwd = launches / (3 * rp.HISTORY)
    print(f"G={G}: through the kernel {fwd_kernel_ms:.3f} / "
          f"{fwd_kernel_ms_b:.3f} ms, through the plain version "
          f"{fwd_plain_ms:.3f} ms; the main path ran {n_fwd:.0f} forwards "
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
        "launches": launches,
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

    soa_row = soa_phases(torch)
    print(smi)
    print(json.dumps({"kernels": [lstm_row, soa_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
