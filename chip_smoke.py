"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py
    python3 chip_smoke.py --only elastic    # the build, then the distribution layer
    python3 chip_smoke.py --only tp         # the build, then the sharded forward
    python3 chip_smoke.py --only a12        # the build, the mesh decode, the dry run,
                                            # the chunked MLA attention
    python3 chip_smoke.py --only a15        # the build, MLA's kernels at deepseek-v2's
                                            # shape, the families' training

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
* the multi-tenant tuning service: three tenants' fig9-shaped studies (144
  replicas, 12 market seeds a tenant, each with its own 12-day market) under demand contention and
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
* the model's training path: flash attention's log-sum-exp (both
  routes) against the plain one and the kernels' autograd Functions
  (``FlashAttention``, ``SsdChunk``: kernel forwards and backwards)
  against autograd of the plain forwards; the backward kernels
  (``flash_attention_bwd``, ``ssd_chunk_bwd``) against the plain backwards
  at every flash head dim, ragged, offset and GQA shape, both types, and
  the SSD chunk's training shapes, each call repeated bitwise; float32
  zamba2-1.2b at full width
  (B = 2, S = 512), one ``Model.loss`` and its gradients through the
  kernels (7 flash and 76 ssd_chunk launches, and as many backward kernel
  calls) and through the plain
  versions, every leaf compared; the config's bf16 with a float32 master,
  5 steps of ``make_train_step`` with ``adamw`` (ms a step, peak memory,
  launches a step, the backward kernels' 7 and 76 a step and no call of a
  plain backward, the card's idle share and the backward's share of its
  busy time under the profiler); the backward kernels timed at the training
  shapes beside the plain backwards, SDPA's backward and their bounds, the
  flash backward in bf16 and float32 also at pixtral-12b's and
  whisper-base's encoder shapes beside SDPA's; ``Trainer`` on the card
  against the CPU on the reduced zamba2 and qwen1.5-0.5b, a checkpoint
  restart on the card, and the full-width state's checkpoint size against
  fig12's store rates;
* the training backend's slice, last: flash attention and the SSD chunk at
  the trials' and whisper's shapes (D = 16, ragged Sk = 30 and 1500 not
  causal, Sq != Sk, P = N = 16 with Q = 32) against their plain versions
  and timed; whisper-base at full width (random weights from a seed)
  served through ``Server(device="cuda")`` with its frames, 2 x 256
  prompt tokens and 32 greedy tokens (18 flash launches a prefill: 6
  encoder, 6 decoder self, 6 cross), through the kernels and the plain
  versions in bf16 and float32, one float32 loss and its gradients, five
  profiled bf16 train steps; a ``backend="training"`` ScenarioSpec
  (qwen1.5-0.5b) through ``SweepRunner(device="cuda")`` beside a sim
  replica (the SpotTune loop with real snapshots, restores and refunds),
  and each seed arch's trial: its 48-step stream, a snapshot and restore,
  replay bitwise equal to the cursor's state, its stream against the
  CPU's, and a profiled trial step;
* the last model families, after that: flash attention at head dim 128
  behind grok-1's and pixtral-12b's GQA (G = 6 and 4) on both routes
  against the plain version and timed, with the D = 128 kernels' register
  spills from the build; grok-1 (2 of 64 layers), pixtral-12b (all 40, its
  1024 stub patches ahead of 256 prompt tokens) and deepseek-v2 (3 of 60
  layers, MLA) served at published width through ``Server(device="cuda")``,
  2 prompts and 32 greedy tokens: bf16 through the kernels and the plain
  versions (logits compared), a profiled prefill and decode, each MoE
  layer's capacity drops and the card time of its router, dispatch,
  expert products and combine; float32 (tokens compared, every flash
  launch on the 3xTF32 route; deepseek-v2's prefill one MLA attention
  kernel a layer); deepseek-v2's MLA forms (the materialized one on the
  flash kernels, one launch) and incremental decode against the full
  forward at full width; MLA's attention kernels (forward and backward,
  bf16 and float32) held against their plain versions at deepseek-v2's
  shape and timed beside their bounds, the plain versions and SDPA; one
  MLA layer at full width forward and backward in bf16 and float32, its
  materialized form on the flash kernels against the same form plain and
  against the absorbed form (``mla_materialized_phase``); the flash
  kernels at the materialized pair (q and k 192 wide, v 128) checked and
  timed at deepseek-v2's training shape and at S = 4096 beside their
  bounds, the plain versions and SDPA (``flash_dv_timing_phase``); the
  reduced three on the card against the CPU;
* the families' training at published width (``family_train_phases``):
  pixtral-12b (4 of 40 layers) float32 loss and gradients through the
  kernels against the plain path, then profiled bf16 Trainer steps;
  deepseek-v2 (2 of 60 layers, moments_fp32) profiled bf16 Trainer steps,
  its peak beside the reckoned state (AdamW updates its large leaves in
  slices, in place: an out-of-memory fails the run), two MLA attention
  forward and two backward kernel calls a step and no flash launch, then
  one more step on the same state in MLA's materialized form (two flash
  forward launches and two backward calls, no MLA kernel; its loss, peak
  and wall); the reduced three one step each, card against CPU;
* the distribution layer, last (``elastic_phases``): a NCCL process group
  of one and ``slice_mesh()`` of the card; qwen1.5-0.5b at published width
  trained 4 bf16 steps (B = 2 x 256) through flash attention, saved to an
  object store and restored through ``ElasticTrial.restore_onto`` (every
  leaf equal to the saved one, the restore wall and state bytes beside the
  120 s revocation notice), served 32 tokens from the migrated weights in
  bf16 and float32 (equal to the un-migrated ``Server``'s); deepseek-v2 (3
  of 60 layers) decoded under ``Policy(cfg, mesh, "decode")`` on its
  "distributed" MLA plan against the decode with no mesh (logits on the
  same tokens in bf16 and float32, float32 tokens equal, decode ms a token
  step of both, all-reduces a step); ``int8_allreduce`` over
  "data" bit-equal to ``axis=None`` on the attention gradients;
* the tensor-, sequence- and expert-parallel forward, last
  (``tp_phases``): a NCCL group of one under a (1, 1) ("data", "model")
  mesh, the full TP rule set of ``Policy.ctx``, parameters, optimizer
  state and batches as DTensors; zamba2-1.2b at published width (B = 2 x
  512): float32 loss and gradients on the placed state against the no-mesh
  path (7 flash and 76 ssd_chunk launches a forward on both, through
  ``local_map`` on the mesh), then bf16 ``Trainer`` steps on the mesh and
  with no mesh (ms, kernels a step, idle share, peak memory); deepseek-v2
  (3 of 60 layers) float32 prefill through MLA and the MoE "ep" shard_map
  body against the no-mesh prefill (logits, each MoE layer's slots);
* the ssm, hybrid and audio decode on a mesh, last (``mesh_decode_phases``):
  zamba2-1.2b, whisper-base and mamba2-130m at published width served by
  ``Server.generate`` under the decode policy's "local" and "distributed"
  plans on the (1, 1) mesh against the no-mesh ``generate``, bf16 and
  float32, and under a prefill policy's ctx; then the dry run
  (``dryrun_phase``): the port's ``launch.dryrun`` traces tp_phases' bf16
  zamba2 step on a fake (1, 1) world in a child process, its flash and
  ssd_chunk operators held to the launches the card counted and its
  predicted peak memory to the step's measured peak.

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

import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
T_START = time.perf_counter()

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
    # the seconds since the script started, to attribute its wall by phase
    print(f"\n== {name} [{time.perf_counter() - T_START:.1f} s]", flush=True)


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
SERVICE_MARKET_SEEDS = 12        # a tenant's market seeds (fig9's grid has 25)
# fig9 runs 10 engine seeds: the contended service costs markets x impulses
# x window (every market replays every tenant's demand impulses): about a
# minute a run at one seed and 25 market seeds a tenant (300 replicas) on
# the H100 machine's host, so the run is cut to 12 market seeds (144
# replicas, about a quarter of that) to keep the script inside half its
# time limit (PERF.md §4)
SERVICE_ENGINE_SEEDS = 1
SERVICE_IMPACT = 0.04
SERVICE_POLICY = ("maxmin", {"max_active": 2})
SLAQ_RTOL = 1e-4   # the port's EarlyCurve against the JAX package's
#                    (tests/test_torch_earlycurve.py RTOL)


def service_studies():
    """Each tenant's fig9-shaped study: 4 workloads x SERVICE_MARKET_SEEDS
    market seeds of its own (alice from 100, bob and carol after) x the
    engine seeds,
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
    """Least time for one attention call (the package's
    ``flash_attention_cuda.flash_bound_ms``: q, k, v read once and o
    written once over the HBM rate, against the two products'
    multiply-adds over the (query, key) pairs the mask keeps at the peak of
    the kernel's arithmetic: bf16 on the tensor cores, float32 at the
    3xTF32 rate, or with ``ffma`` at the float32 rate outside the tensor
    cores, the bound of the float32 FFMA kernel the 3xTF32 one replaced)."""
    from repro_torch.kernels.flash_attention_cuda import flash_bound_ms as bound
    return bound(B, Sq, Sk, H, D, causal, elem_bytes, ffma=ffma)


def ssd_bound_ms(B, Q, H, P, N, groups=None):
    """Least time for one SSD chunk (float32; the package's
    ``ssd_chunk_cuda.ssd_bound_ms``): x, dt, A and the state read once, y
    and the new state written once, B and C read once per head
    (``groups=None``, what the port's first FFMA kernel was given, at the
    float32 peak outside the tensor cores) or once per group (at the
    3xTF32 rate on the tensor cores)."""
    from repro_torch.kernels.ssd_chunk_cuda import ssd_bound_ms as bound
    return bound(B, Q, H, P, N, groups)


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
    cases += [(2, s, sk, 4, d, torch.float32, c) for d in (16, 32, 64, 96, 128)
              for s in (1, 200, 333) for sk in (s, s + 37)
              for c in (True, False)]
    # a rank's block of queries against the whole sequence's keys (the
    # data-parallel-only layout's sequence split): the causal mask offset by
    # the block's first position, Sq < Sk, in both types
    # (B, Sq, Sk, H, D, dtype, q_offset)
    off_cases = [(2, sq, sk, 4, d, dt, off) for dt in (torch.bfloat16, torch.float32)
                 for d in (64, 128) for sq, sk, off in
                 ((200, 800, 137), (200, 800, 600), (64, 2048, 1984), (333, 512, 179),
                  (128, 1024, 0))]
    flash_err = {"float32": 0.0, "bfloat16": 0.0}

    def check_flash(q, k, v, causal, what, scale=None, q_offset=0):
        o = kfa.flash_attention_cuda(q, k, v, causal, scale, q_offset)
        want = ref.flash_attention_ref(q, k, v, causal, scale, q_offset)
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
    for b_, s_, sk_, h_, d_, dt, off in off_cases:
        q = randn(b_, s_, h_, d_, dtype=dt)
        k, v = (randn(b_, sk_, h_, d_, dtype=dt) for _ in range(2))
        check_flash(q, k, v, True, f"B={b_} Sq={s_} Sk={sk_} H={h_} D={d_} "
                    f"q_offset={off}", q_offset=off)
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
    n_bf16 = sum(1 for c in cases + off_cases if c[5] == torch.bfloat16) + 3
    n_f32 = len(cases) + len(off_cases) + 6 - n_bf16
    if (n_wg, n_tf) != (n_bf16, n_f32):
        fail(f"the bf16 cases launched the bf16 kernel {n_wg} times (want "
             f"{n_bf16}), the float32 cases the 3xTF32 kernel {n_tf} times "
             f"(want {n_f32})")
    print(f"{len(cases) + len(off_cases) + 6} cases (zamba2's prefill B={B} "
          f"S={S} H={H} D={D} and {PHI3_ARCH}'s B={PHI3_BATCH} S={PHI3_PROMPT} "
          f"H={p3.n_heads} D={p3.d_model // p3.n_heads} in both types, causal "
          f"and not; at D in (16, 32, 64, 96, 128) bf16 with S in (1, 200, 333, 512) "
          f"and f32 with S in (1, 200, 333), Sk = S and S + 37; "
          f"{len(off_cases)} causal with a query offset, Sq < Sk; strided views "
          f"in both types): max abs err f32 {flash_err['float32']:.3g} (tol "
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


def flash_bwd_bound_ms(B, Sq, Sk, H, D, causal, elem_bytes, q_offset=0):
    """Least time for the flash backward (the package's
    ``flash_attention_cuda.flash_bwd_bound_ms`` of ``flash_bwd_cost``, which
    the dry run's cost counter also reads): q, k, v, do and lse read once,
    dq, dk and dv written once, against five products over the (query,
    key) pairs the mask keeps (S = QK^T recomputed, dV = P^T dO, dP =
    dO V^T, dQ = dS K, dK = dS^T Q), bf16 on the tensor cores, float32 at
    the 3xTF32 rate."""
    from repro_torch.kernels.flash_attention_cuda import flash_bwd_bound_ms as bound
    return bound(B, Sq, Sk, H, D, causal, elem_bytes, q_offset)


def ssd_bwd_bound_ms(B, Q, H, P, N, groups):
    """Least time for the SSD chunk's backward (float32; the package's
    ``ssd_chunk_cuda.ssd_bwd_bound_ms`` of ``ssd_chunk_bwd_cost``): the
    chunk's inputs (B and C once per group) and the outputs' gradients read
    once, the inputs' gradients written once; against the forward's
    products recomputed and two gradient products for each, at the 3xTF32
    rate."""
    from repro_torch.kernels.ssd_chunk_cuda import ssd_bwd_bound_ms as bound
    return bound(B, Q, H, P, N, groups)


# the backward kernels against their plain versions: each gradient within
# these of its largest magnitude (tests/test_torch_kernels_cuda.py), two
# calls bitwise equal
BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
SSD_BWD_TOL = 1e-4
SSD_BWD_LARGE_DECAY_TOL = 1e-2
# (B, Sq, Sk, H, D, causal, q_offset, K/V heads expanded to H or None)
FLASH_BWD_CASES = [(2, 512, 512, 32, 64, True, 0, None),    # zamba2's training shape
                   (2, 256, 1500, 8, 64, False, 0, None),   # whisper's cross-attention
                   (1, 200, 237, 4, 96, False, 0, None), (2, 70, 70, 3, 32, True, 0, None),
                   (2, 1, 38, 4, 16, True, 0, None), (1, 333, 333, 2, 128, True, 0, None),
                   (1, 64, 256, 2, 64, True, 192, None), (2, 100, 300, 4, 128, True, 37, None),
                   (2, 1280, 1280, 32, 128, True, 0, 8)]    # pixtral-12b: 32 over 8
# (B, Q, H, P, N, B/C head stride 0, dt scale, a chunk slice of S = 2Q)
SSD_BWD_CASES = [(2, 256, 64, 64, 64, True, 1.0, False),    # zamba2's training chunk
                 (2, 256, 64, 64, 64, False, 1.0, False), (2, 256, 8, 64, 64, True, 1.0, True),
                 (4, 32, 8, 16, 16, False, 1.0, False),     # the mamba2 trial's
                 (1, 200, 4, 64, 128, True, 1.0, False), (2, 32, 3, 8, 4, False, 1.0, False),
                 (2, 64, 3, 16, 8, False, 1000.0, False)]   # dt |A| ~ 100


def backward_kernel_checks(torch, randn, leafwise) -> dict:
    """The backward kernels against their plain versions at FLASH_BWD_CASES
    and SSD_BWD_CASES (every head dim of the flash forward, causal and not,
    Sq != Sk with ragged tiles, a query offset, expanded GQA, both types;
    the SSD chunk's widths of zamba2 and the mamba2 trial, head stride 0
    and not, a chunk slice, N = 128, dt |A| ~ 100), each call repeated and
    compared bitwise.  Returns the largest errors."""
    from repro_torch.kernels import flash_attention_cuda as kfa
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_chunk_cuda as kss

    out = {"flash": {"max_abs_err": 0.0, "max_rel_err": 0.0},
           "flash_f32": {"max_abs_err": 0.0, "max_rel_err": 0.0},
           "ssd": {"max_abs_err": 0.0, "max_rel_err": 0.0, "large_decay_rel_err": 0.0}}
    n0 = kfa.BWD_LAUNCHES, kss.BWD_LAUNCHES
    for dt, name, key in ((torch.float32, "float32", "flash_f32"),
                          (torch.bfloat16, "bfloat16", "flash")):
        for B, Sq, Sk, H, D, causal, q_off, kvh in FLASH_BWD_CASES:
            q, do = randn(B, Sq, H, D, dtype=dt), randn(B, Sq, H, D, dtype=dt)
            k, v = (randn(B, Sk, kvh or H, D, dtype=dt) for _ in range(2))
            if kvh:
                k, v = (t[:, :, :, None].expand(B, Sk, kvh, H // kvh, D).reshape(B, Sk, H, D)
                        for t in (k, v))
            _, lse = kfa.flash_attention_lse_cuda(q, k, v, causal, None, q_off)
            got = kfa.flash_attention_bwd_cuda(q, k, v, lse, do, causal, None, q_off)
            again = kfa.flash_attention_bwd_cuda(q, k, v, lse, do, causal, None, q_off)
            want = ref.flash_attention_bwd(q, k, v, lse, do, causal, None, None, q_off)
            torch.cuda.synchronize()
            rel = leafwise(got, want)
            ab = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            what = (f"flash_attention_bwd {name} (B,Sq,Sk,H,D) = {(B, Sq, Sk, H, D)} causal "
                    f"{causal} q_offset {q_off}" + (f", K/V {kvh} heads expanded" if kvh else ""))
            print(f"  {what}: of each gradient's largest {rel:.3g} (max abs {ab:.3g}); "
                  f"repeat bitwise {same}")
            if not (rel <= BWD_TOL[name] and same):
                fail(f"{what}: {rel:.3g} of the largest (tol {BWD_TOL[name]}), "
                     f"bitwise repeat {same}")
            out[key]["max_rel_err"] = max(out[key]["max_rel_err"], rel)
            out[key]["max_abs_err"] = max(out[key]["max_abs_err"], ab)
            del q, k, v, do, lse, got, again, want
    for B, Q, H, P, N, s0, dts, sliced in SSD_BWD_CASES:
        rows = 2 * Q if sliced else Q
        x, dy = randn(B, rows, H, P), randn(B, rows, H, P)
        dt_ = (torch.rand(B, rows, H) * 0.099 + 0.001).cuda() * dts
        A = -(torch.rand(H) * 1.5 + 0.5).cuda()
        Bm, Cm = randn(B, rows, H, N), randn(B, rows, H, N)
        st, dst = randn(B, H, P, N), randn(B, H, P, N)
        if s0:
            Bm, Cm = (t[:, :, :1].expand(B, rows, H, N) for t in (Bm, Cm))
        if sliced:
            x, dt_, Bm, Cm, dy = (t[:, Q:] for t in (x, dt_, Bm, Cm, dy))
        args = (x, dt_, A, Bm, Cm, st, dy, dst)
        got = kss.ssd_chunk_bwd_cuda(*args)
        again = kss.ssd_chunk_bwd_cuda(*args)
        want = ref.ssd_chunk_bwd(*args)
        torch.cuda.synchronize()
        rel = leafwise(got, want)
        ab = max((g - w).abs().max().item() for g, w in zip(got, want))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        tol = SSD_BWD_TOL if dts == 1.0 else SSD_BWD_LARGE_DECAY_TOL
        what = (f"ssd_chunk_bwd (B,Q,H,P,N) = {(B, Q, H, P, N)}" + (", B/C head stride 0"
                if s0 else "") + (", a chunk slice of S = 2Q" if sliced else "")
                + (f", dt x {dts:g}" if dts != 1.0 else ""))
        print(f"  {what}: of each gradient's largest {rel:.3g} (max abs {ab:.3g}, tol "
              f"{tol}); finite {finite}; repeat bitwise {same}")
        if not (rel <= tol and same and finite):
            fail(f"{what}: {rel:.3g} of the largest (tol {tol}), finite {finite}, bitwise "
                 f"repeat {same}")
        if dts == 1.0:
            out["ssd"]["max_rel_err"] = max(out["ssd"]["max_rel_err"], rel)
            out["ssd"]["max_abs_err"] = max(out["ssd"]["max_abs_err"], ab)
        else:
            out["ssd"]["large_decay_rel_err"] = rel
    print(f"{2 * len(FLASH_BWD_CASES)} flash and {len(SSD_BWD_CASES)} SSD backward cases "
          f"agree with the plain backwards and repeat bitwise ({kfa.BWD_LAUNCHES - n0[0]} "
          f"and {kss.BWD_LAUNCHES - n0[1]} calls)")
    return out


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

    phase("the backward kernels (flash_attention_bwd, ssd_chunk_bwd) against their "
          "plain versions")
    bwd_err = backward_kernel_checks(torch, randn, leafwise)

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
        bwd0 = (kfa.BWD_LAUNCHES, kss.BWD_LAUNCHES)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        counts = counts + (kfa.BWD_LAUNCHES - bwd0[0], kss.BWD_LAUNCHES - bwd0[1])
        torch.cuda.synchronize()
        return (float(loss.detach()), [g.detach() for g in grads], counts,
                (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3)

    kfa.LAUNCHES = kfa.TF32_LAUNCHES = kfa.WGMMA_LAUNCHES = kss.LAUNCHES = 0
    loss_k, g_k, counts_k, fwd_ms, bwd_ms = loss_and_grads(
        null_ctx(attn_chunk=min(512, S), remat="none"))
    fwd_counts, bwd_kernels = counts_k[:2], counts_k[2:]
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
          f"{want_ss}); after the backward {bwd_counts}; backward kernels flash "
          f"{bwd_kernels[0]}, ssd_chunk {bwd_kernels[1]} (want {(want_fa, want_ss)}); "
          f"wall: forward {fwd_ms:.1f} ms, backward {bwd_ms:.1f} ms through the "
          f"kernels, {fwd_ms_r:.1f} / {bwd_ms_r:.1f} ms plain")
    if (fwd_counts != (want_fa, want_ss) or bwd_counts != fwd_counts
            or bwd_kernels != (want_fa, want_ss)):
        fail(f"the float32 training forward launched (flash 3xTF32, ssd_chunk) "
             f"{fwd_counts} (want {(want_fa, want_ss)}), {bwd_counts} after the "
             f"backward, whose kernels launched {bwd_kernels}")
    if not (loss_rel <= TRAIN_LOSS_RTOL and errs[worst] <= TRAIN_GRAD_TOL and finite):
        fail(f"float32 {TRAIN_ARCH} training through the kernels: loss {loss_rel:.3g} "
             f"relative, worst leaf {names[worst]} {errs[worst]:.3g}")
    out["flash_f32"]["train"] = {
        "arch": cfg32.name, "batch": B, "seq": S, "launches_per_forward": fwd_counts[0],
        "bwd_launches_per_backward": bwd_kernels[0],
        "loss_kernels": loss_k, "loss_plain": loss_r, "loss_rel": loss_rel,
        "worst_leaf": names[worst], "worst_leaf_err": errs[worst],
        "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "fwd_plain_ms": fwd_ms_r,
        "bwd_plain_ms": bwd_ms_r}
    out["ssd"]["train_f32_launches_per_forward"] = fwd_counts[1]
    out["ssd"]["train_f32_bwd_launches_per_backward"] = bwd_kernels[1]
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
    kfa.BWD_LAUNCHES = kss.BWD_LAUNCHES = 0
    losses, step_ms = [], []
    plain_calls = []            # calls of the plain backwards: none on the card
    real_bwd = ref.flash_attention_bwd, ref.ssd_chunk_bwd
    ref.flash_attention_bwd = lambda *a, **k: (plain_calls.append("flash")
                                               or real_bwd[0](*a, **k))
    ref.ssd_chunk_bwd = lambda *a, **k: plain_calls.append("ssd") or real_bwd[1](*a, **k)
    try:
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        ref.flash_attention_bwd, ref.ssd_chunk_bwd = real_bwd
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fa_step, ss_step = kfa.WGMMA_LAUNCHES / TRAIN_STEPS, kss.LAUNCHES / TRAIN_STEPS
    fa_bwd_step, ss_bwd_step = kfa.BWD_LAUNCHES / TRAIN_STEPS, kss.BWD_LAUNCHES / TRAIN_STEPS
    ms_step = sum(step_ms[-3:]) / 3
    state_bytes = tree_bytes(state)
    print(f"losses {[round(x, 5) for x in losses]} on the repeated batch (lr "
          f"{TRAIN_LR}); step ms {[round(x, 1) for x in step_ms]}, "
          f"{ms_step:.2f} ms a step over the last 3 ({B * S / ms_step * 1e3:.0f} "
          f"tokens/s); peak memory {peak_gb:.2f} GB (torch.cuda.max_memory_allocated)"
          f"; train state {state_bytes / 1e9:.3f} GB")
    print(f"launches a step: flash_attention {fa_step:g} (bf16 wgmma route, want "
          f"{want_fa}), ssd_chunk {ss_step:g} (want {want_ss}); backward kernels "
          f"flash_attention_bwd {fa_bwd_step:g}, ssd_chunk_bwd {ss_bwd_step:g}; calls of "
          f"the plain backwards {len(plain_calls)}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"bf16 training: losses {losses}: not finite, or step "
             f"{TRAIN_STEPS}'s not below step 1's")
    if (fa_step, ss_step) != (want_fa, want_ss) or kfa.LAUNCHES != kfa.WGMMA_LAUNCHES:
        fail(f"bf16 training launched flash {kfa.LAUNCHES} ({kfa.WGMMA_LAUNCHES} "
             f"wgmma) and ssd_chunk {kss.LAUNCHES} times in {TRAIN_STEPS} steps")
    if (fa_bwd_step, ss_bwd_step) != (want_fa, want_ss) or plain_calls:
        fail(f"bf16 training launched the backward kernels {kfa.BWD_LAUNCHES} and "
             f"{kss.BWD_LAUNCHES} times in {TRAIN_STEPS} steps (want {want_fa} and "
             f"{want_ss} a step) and called the plain backwards {len(plain_calls)} times")

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
        "bwd_launches_per_step": fa_bwd_step,
        "kernels_per_step_seen": len(seen), "busy_ms": busy * 1e3,
        "wall_ms": prof_wall * 1e3, "idle_share": idle,
        "busy_ms_by_part": part_busy, "backward_share_of_busy": bwd_share}
    out["ssd"]["train_launches_per_step"] = ss_step
    out["ssd"]["train_bwd_launches_per_step"] = ss_bwd_step

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
    phase("the backward kernels at the training shapes beside the plain backwards "
          "and SDPA's (CUDA events, card time)")
    bwd = {}
    for dt, name in ((torch.bfloat16, "flash"), (torch.float32, "flash_f32")):
        q, k, v, do = (randn(B, S, H, D, dtype=dt) for _ in range(4))
        o, lse = kfa.flash_attention_lse_cuda(q, k, v, True)

        def fk():
            return kfa.flash_attention_bwd_cuda(q, k, v, lse, do, True)

        def fb():
            return ref.flash_attention_bwd(q, k, v, lse, do, True, None, S)

        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        dot = do.transpose(1, 2)

        def sdpa_bwd():
            return torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)

        got = fb()
        lib = sdpa_bwd()
        lib_err = max((a.float() - b.transpose(1, 2).float()).abs().max().item()
                      for a, b in zip(got, lib))
        bound, by = flash_bwd_bound_ms(B, S, S, H, D, True, q.element_size())
        r = {"ms": cuda_ms(fk, iters=50, warmup=5),
             "plain_ms": cuda_ms(fb, iters=20, warmup=3),
             "library_ms": cuda_ms(sdpa_bwd, iters=50, warmup=5),
             "device_us": device_us_per_call(fk, iters=20, warmup=3,
                                             what=f"of the flash backward kernels, {name}"),
             "plain_device_us": device_us_per_call(fb, iters=10, warmup=2,
                                                   what=f"of the plain flash backward, {name}"),
             "library_device_us": device_us_per_call(
                 sdpa_bwd, iters=10, warmup=2,
                 what=f"of scaled_dot_product_attention's backward, {name}"),
             "bound_ms": bound, "bound_by": by, "library_err": lib_err,
             "launches_per_step": want_fa,
             "max_abs_err": bwd_err[name]["max_abs_err"],
             "max_rel_err": bwd_err[name]["max_rel_err"],
             "shape": {"B": B, "S": S, "H": H, "D": D, "dtype": str(dt)[6:],
                       "causal": True},
             "library": "torch.autograd.grad of scaled_dot_product_attention"}
        print(f"flash backward {str(dt)[6:]} (B,S,H,D) = {(B, S, H, D)}: kernels "
              f"{r['ms']:.4f} ms (CUDA events), {r['device_us']} us of card time; plain "
              f"{r['plain_ms']:.4f} ms, {r['plain_device_us']} us; SDPA's backward "
              f"{r['library_ms']:.4f} ms, {r['library_device_us']} us (max abs diff from "
              f"the plain backward {lib_err:.3g}); bound {bound:.4g} ms ({by}); "
              f"{want_fa} a step")
        bwd[name] = r
        del q, k, v, do, o, lse, qt, kt, vt, ot, dot
    ssd_args = [t.detach() for t in args]
    dy, dst = dy.detach(), dst.detach()

    def sk():
        return kss.ssd_chunk_bwd_cuda(*ssd_args, dy, dst)

    def sb():
        return ref.ssd_chunk_bwd(*ssd_args, dy, dst)

    bound, by = ssd_bwd_bound_ms(B, Q, SH, SP, SN, cfg.ssm_groups)
    r = {"ms": cuda_ms(sk, iters=50, warmup=5),
         "plain_ms": cuda_ms(sb, iters=20, warmup=3),
         "device_us": device_us_per_call(sk, iters=20, warmup=3,
                                         what="of the SSD chunk's backward kernel"),
         "plain_device_us": device_us_per_call(sb, iters=10, warmup=2,
                                               what="of the SSD chunk's plain backward"),
         "bound_ms": bound, "bound_by": by, "library_ms": None,
         "launches_per_step": want_ss,
         "max_abs_err": bwd_err["ssd"]["max_abs_err"],
         "max_rel_err": bwd_err["ssd"]["max_rel_err"],
         "large_decay_rel_err": bwd_err["ssd"]["large_decay_rel_err"],
         "shape": {"B": B, "Q": Q, "H": SH, "P": SP, "N": SN, "dtype": "float32",
                   "bc_head_stride": int(ssd_args[3].stride(2))}}
    print(f"ssd_chunk backward (B,Q,H,P,N) = {(B, Q, SH, SP, SN)}, B/C head stride "
          f"0: kernel {r['ms']:.4f} ms (CUDA events), {r['device_us']} us of card "
          f"time; plain {r['plain_ms']:.4f} ms, {r['plain_device_us']} us; bound "
          f"{bound:.4g} ms ({by}); {want_ss} a step; no PyTorch call computes it")
    bwd["ssd"] = r
    # the flash backward at pixtral-12b's and whisper-base's encoder shapes,
    # bf16 and float32, beside SDPA's backward in the same type (PERF.md row
    # 4b)
    shapes = {"flash": {}, "flash_f32": {}}
    for (name, (mb, ml, mh, md, mc)), (key, fdt) in itertools.product(
            (("pixtral-12b", (2, 1280, 32, 128, True)),
             ("whisper-base encoder", (2, 1500, 8, 64, False))),
            (("flash", torch.bfloat16), ("flash_f32", torch.float32))):
        q, k, v, do = (randn(mb, ml, mh, md, dtype=fdt) for _ in range(4))
        _, lse = kfa.flash_attention_lse_cuda(q, k, v, mc)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=mc)
        dot = do.transpose(1, 2)

        def fk():
            return kfa.flash_attention_bwd_cuda(q, k, v, lse, do, mc)

        def sdpa_bwd():
            return torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)

        tname = str(fdt)[6:]
        bound, by = flash_bwd_bound_ms(mb, ml, ml, mh, md, mc, q.element_size())
        r = {"ms": cuda_ms(fk, iters=20, warmup=3),
             "device_us": device_us_per_call(
                 fk, iters=10, warmup=2, what=f"of the flash backward kernels, {name} {tname}"),
             "library_device_us": device_us_per_call(
                 sdpa_bwd, iters=10, warmup=2,
                 what=f"of scaled_dot_product_attention's backward, {name} {tname}"),
             "bound_ms": bound, "bound_by": by,
             "shape": {"B": mb, "S": ml, "H": mh, "D": md, "dtype": tname, "causal": mc}}
        print(f"flash backward {tname} {name} (B,S,H,D) = {(mb, ml, mh, md)} causal {mc}: "
              f"kernels {r['ms']:.4f} ms (CUDA events), {r['device_us']} us of card time; "
              f"SDPA's backward {r['library_device_us']} us; bound {bound:.4g} ms ({by})")
        shapes[key][name] = r
        del q, k, v, do, lse, qt, kt, vt, ot, dot
    bwd["flash"]["shapes"] = shapes["flash"]
    bwd["flash_f32"]["shapes"] = shapes["flash_f32"]
    for key in ("flash", "flash_f32", "ssd"):
        out[key]["backward"] = bwd[key]
    # the backward kernels' rows of the kernels line; launches: the bf16
    # train steps' (the counts set to 0 before them)
    fb, f32b = bwd["flash"], bwd["flash_f32"]
    out["rows"] = [{
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cuh",
        "replaces": "src/repro/models/attention.py:202 (_flash_bwd_rule, XLA code "
                    "under flash_attention_vjp, :187-240; no Pallas kernel)",
        "kernel": "flash_bwd_dq_kernel + flash_bwd_dkdv_kernel, one call: bf16 on bf16 "
                  "wgmma fed by TMA (p and dS as bf16 hi + lo, no transposed copy, S once "
                  "in the dk/dv pass), float32 on 3xTF32 tf32 wgmma fed by TMA (raw "
                  "float32 rows as hi, the producers writing lo and the transposed units "
                  "from shared memory; S^T once in the dk/dv pass, P^T handed between its "
                  "warpgroups; two consumer warpgroups over 128 q rows in the dq pass at "
                  "D <= 64)",
        "launches": fa_bwd_step * TRAIN_STEPS, "launches_per_step": fa_bwd_step,
        "steps": TRAIN_STEPS, "shapes": fb["shapes"], "max_abs_err": fb["max_abs_err"],
        "max_rel_err": fb["max_rel_err"], "tol_rel": BWD_TOL["bfloat16"],
        "ms": fb["ms"], "plain_ms": fb["plain_ms"], "bound_ms": fb["bound_ms"],
        "bound_by": fb["bound_by"], "library_ms": fb["library_ms"],
        "library": fb["library"], "device_us": fb["device_us"],
        "plain_device_us": fb["plain_device_us"],
        "library_device_us": fb["library_device_us"], "shape": fb["shape"],
        "f32": {"max_abs_err": f32b["max_abs_err"], "max_rel_err": f32b["max_rel_err"],
                "tol_rel": BWD_TOL["float32"], "ms": f32b["ms"],
                "plain_ms": f32b["plain_ms"], "bound_ms": f32b["bound_ms"],
                "bound_by": f32b["bound_by"], "library_ms": f32b["library_ms"],
                "device_us": f32b["device_us"], "plain_device_us": f32b["plain_device_us"],
                "library_device_us": f32b["library_device_us"],
                "shapes": f32b["shapes"], "launches_per_f32_backward": bwd_kernels[0]},
    }, {
        "name": "ssd_chunk_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_chunk_bwd.cuh",
        "replaces": "src/repro/models/ssd.py:136-139 (autodiff of "
                    "jax.checkpoint(_chunk_scan_step), XLA code; no Pallas kernel)",
        "kernel": "ssd_bwd_tile_kernel (a block per 64-row tile, head and batch; 3xTF32 "
                  "wgmma, operands split by truncation, full tiles loaded with no "
                  "predicates) + ssd_bwd_finish_kernel (the cross-tile sums in a fixed "
                  "order), one call",
        "launches": ss_bwd_step * TRAIN_STEPS, "launches_per_step": ss_bwd_step,
        "steps": TRAIN_STEPS, "launches_per_f32_backward": bwd_kernels[1],
        **{k: v for k, v in bwd["ssd"].items() if k != "launches_per_step"},
        "tol_rel": SSD_BWD_TOL, "tol_rel_large_decay": SSD_BWD_LARGE_DECAY_TOL,
    }]

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


# ---------------------------------------------------------------------------
# real-training trials and the whisper-base audio family (the training
# backend's slice)
# ---------------------------------------------------------------------------

# (B, Sq, Sk, H, D, causal): the reduced trials at D = 16 (qwen and
# whisper's decoder self-attention, causal; whisper's encoder over Se = 30
# frames and its cross-attention, Sq = 32 against Sk = 30, not causal) and
# whisper-base at full width (the encoder over 1500 frames: a ragged last
# key tile; the cross-attention of 256 prompt tokens against them; the
# decoder's causal self-attention)
SLICE_FLASH_SHAPES = [
    (4, 32, 32, 4, 16, True), (2, 32, 32, 4, 16, True),
    (4, 30, 30, 4, 16, False), (4, 32, 30, 4, 16, False),
    (2, 30, 30, 4, 16, False), (2, 32, 30, 4, 16, False),
    (2, 1500, 1500, 8, 64, False), (2, 256, 1500, 8, 64, False),
    (2, 256, 256, 8, 64, True),
]
# mamba2-130m reduced: (B, Q, H, P, N) at both trial batches
SLICE_SSD_SHAPES = [(4, 32, 8, 16, 16), (2, 32, 8, 16, 16)]
WHISPER_ARCH, WHISPER_BATCH, WHISPER_PROMPT, WHISPER_NEW = "whisper-base", 2, 256, 32
WHISPER_STEPS = 5
# C4: a trial's bf16 losses (float32 master), card against CPU, relative;
# the bound tests/test_torch_training_backend.py holds the port to against
# the JAX package (the two round bf16 at different places)
TRIAL_RTOL = 1e-2
TRIAL_REPLAY_STEP = 22       # not a cached boundary: replayed from step 16


def slice_flash_timing(torch, B, Sq, Sk, H, D, causal, dtype, what, gen):
    """The flash kernel beside its plain version and
    ``scaled_dot_product_attention`` on the same inputs (CUDA events, ms a
    call from Python; the card time of a kernel and SDPA call from the
    profiler) and its bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention_cuda as kfa
    from repro_torch.kernels import ref

    q = torch.randn(B, Sq, H, D, generator=gen).to("cuda", dtype)
    k, v = (torch.randn(B, Sk, H, D, generator=gen).to("cuda", dtype)
            for _ in range(2))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def kern():
        return kfa.flash_attention_cuda(q, k, v, causal)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

    r = {"ms": cuda_ms(kern, iters=200),
         "plain_ms": cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal),
                             iters=20, warmup=3),
         "library_ms": cuda_ms(sdpa, iters=200),
         "device_us": device_us_per_call(kern, iters=50, what=f"of the kernel, {what}"),
         "library_device_us": device_us_per_call(
             sdpa, iters=50, what=f"of scaled_dot_product_attention, {what}")}
    r["bound_ms"], r["bound_by"] = flash_bound_ms(B, Sq, Sk, H, D, causal,
                                                  q.element_size())
    r["shape"] = {"B": B, "Sq": Sq, "Sk": Sk, "H": H, "D": D, "causal": causal,
                  "dtype": str(dtype)[6:]}
    print(f"flash_attention {what} {str(dtype)[6:]} (B,Sq,Sk,H,D) = "
          f"{(B, Sq, Sk, H, D)} causal={causal}: kernel {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms, scaled_dot_product_attention "
          f"{r['library_ms']:.4f} ms (CUDA events); card time a call: kernel "
          f"{r['device_us']} us, SDPA {r['library_device_us']} us; bound "
          f"{r['bound_ms']:.4g} ms ({r['bound_by']})")
    return r


def trial_phases(torch) -> dict:
    """The training backend's slice on the card: flash attention and the
    SSD chunk at the trials' and whisper's shapes against their plain
    versions; whisper-base at full width (random weights from a seed):
    served through the kernels and through the plain versions in bf16 and
    float32, one float32 loss and its gradients, five bf16 train steps;
    then real-training trials: a training ScenarioSpec through
    SweepRunner(device="cuda") beside a sim replica (the SpotTune loop with
    revocation snapshots and restores), and for each seed arch its 48-step
    stream, a snapshot and restore, bitwise replay and the card's stream
    against the CPU's.  Returns the slice's fields of the flash and ssd JSON
    rows."""
    import dataclasses
    import shutil

    import numpy as np
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.backends.training import (TRAINING_ARCHS, TRAINING_BINDINGS,
                                               TRAINING_WORKLOADS,
                                               TrainingTrialBackend, _to_host)
    from repro_torch.configs.base import get_config
    from repro_torch.core.trial import TrialSpec
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.kernels import flash_attention_cuda as kfa
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_chunk_cuda as kss
    from repro_torch.launch.serve import Server
    from repro_torch.launch.train import Trainer, batch_to, make_train_step
    from repro_torch.models.context import ModelCtx, null_ctx
    from repro_torch.models.inputs import sample_train_batch
    from repro_torch.models.model import Model, tree_leaves, tree_map
    from repro_torch.optim import adamw
    from repro_torch.sweep.runner import SweepRunner
    from repro_torch.sweep.spec import ScenarioSpec

    t_all = time.perf_counter()
    out = {"flash": {}, "flash_f32": {}, "ssd": {}}
    gen = torch.Generator().manual_seed(21)
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16"}

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to("cuda", dtype)

    # ------------------------------- the kernels at the slice's shapes
    phase("flash_attention and ssd_chunk at the training backend's shapes "
          "against their plain versions")
    flash_err = {"float32": 0.0, "bfloat16": 0.0}
    for b_, sq, sk, h_, d_, causal in SLICE_FLASH_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            q = randn(b_, sq, h_, d_, dtype=dt)
            k, v = (randn(b_, sk, h_, d_, dtype=dt) for _ in range(2))
            o = kfa.flash_attention_cuda(q, k, v, causal)
            want = ref.flash_attention_ref(q, k, v, causal)
            torch.cuda.synchronize()
            e = (o.float() - want.float()).abs().max().item()
            print(f"  {names[dt]} (B,Sq,Sk,H,D) = {(b_, sq, sk, h_, d_)} "
                  f"causal={causal}: max abs err {e:.3g}")
            if not (o.shape == q.shape and e <= FLASH_TOL[names[dt]]):
                fail(f"flash_attention {names[dt]} B={b_} Sq={sq} Sk={sk} H={h_} "
                     f"D={d_} causal={causal}: max abs err {e:.3g} > "
                     f"{FLASH_TOL[names[dt]]}")
            flash_err[names[dt]] = max(flash_err[names[dt]], e)
    ssd_err = 0.0
    for b_, q_, h_, p_, n_ in SLICE_SSD_SHAPES:
        x = randn(b_, q_, h_, p_)
        dt = (torch.rand(b_, q_, h_, generator=gen) * 0.099 + 0.001).cuda()
        A = -(torch.rand(h_, generator=gen) * 1.5 + 0.5).cuda()
        Bm, Cm = (randn(b_, q_, 1, n_).expand(b_, q_, h_, n_) for _ in range(2))
        st = randn(b_, h_, p_, n_)
        y, s = kss.ssd_chunk_cuda(x, dt, A, Bm, Cm, st)
        y2, s2 = ref.ssd_chunk_ref(x, dt, A, Bm, Cm, st)
        torch.cuda.synchronize()
        e = max((y - y2).abs().max().item(), (s - s2).abs().max().item())
        ok = all(torch.allclose(a, b, rtol=SSD_TOL, atol=SSD_TOL)
                 for a, b in ((y, y2), (s, s2)))
        print(f"  ssd_chunk (B,Q,H,P,N) = {(b_, q_, h_, p_, n_)}, B/C head "
              f"stride 0: max abs err {e:.3g}")
        if not ok:
            fail(f"ssd_chunk {(b_, q_, h_, p_, n_)}: max abs err {e:.3g} "
                 f"(rtol = atol = {SSD_TOL})")
        ssd_err = max(ssd_err, e)
    print(f"{2 * len(SLICE_FLASH_SHAPES)} flash cases (D = 16 at the trials' "
          f"shapes, Sq != Sk, ragged Sk = 30 and 1500 not causal, whisper-base's "
          f"D = 64): max abs err f32 {flash_err['float32']:.3g} (tol "
          f"{FLASH_TOL['float32']}), bf16 {flash_err['bfloat16']:.3g} (tol "
          f"{FLASH_TOL['bfloat16']}); {len(SLICE_SSD_SHAPES)} ssd_chunk cases "
          f"(P = N = 16, Q = 32): max abs err {ssd_err:.3g} (tol {SSD_TOL})")
    out["flash"]["slice_max_abs_err"] = flash_err["bfloat16"]
    out["flash_f32"]["slice_max_abs_err"] = flash_err["float32"]
    out["ssd"]["slice_max_abs_err"] = ssd_err

    phase("the kernels' time at the slice's shapes (CUDA events)")
    out["flash"]["slice_timing"] = {
        "whisper_encoder": slice_flash_timing(
            torch, 2, 1500, 1500, 8, 64, False, torch.bfloat16,
            "whisper-base encoder", gen),
        "whisper_cross": slice_flash_timing(
            torch, 2, 256, 1500, 8, 64, False, torch.bfloat16,
            "whisper-base cross-attention", gen),
        "qwen_trial": slice_flash_timing(
            torch, 4, 32, 32, 4, 16, True, torch.bfloat16, "reduced qwen trial", gen)}
    out["flash_f32"]["slice_timing"] = {
        "whisper_encoder": slice_flash_timing(
            torch, 2, 1500, 1500, 8, 64, False, torch.float32,
            "whisper-base encoder", gen)}
    b_, q_, h_, p_, n_ = SLICE_SSD_SHAPES[0]
    x = randn(b_, q_, h_, p_)
    dt = (torch.rand(b_, q_, h_, generator=gen) * 0.099 + 0.001).cuda()
    A = -(torch.rand(h_, generator=gen) * 1.5 + 0.5).cuda()
    Bm, Cm = (randn(b_, q_, 1, n_).expand(b_, q_, h_, n_) for _ in range(2))
    st = randn(b_, h_, p_, n_)
    r = {"ms": cuda_ms(lambda: kss.ssd_chunk_cuda(x, dt, A, Bm, Cm, st), iters=200),
         "plain_ms": cuda_ms(lambda: ref.ssd_chunk_ref(x, dt, A, Bm, Cm, st),
                             iters=50, warmup=5), "library_ms": None,
         "device_us": device_us_per_call(
             lambda: kss.ssd_chunk_cuda(x, dt, A, Bm, Cm, st), iters=50,
             what="of ssd_chunk, mamba2 trial")}
    r["bound_ms"], r["bound_by"] = ssd_bound_ms(b_, q_, h_, p_, n_, groups=1)
    r["shape"] = {"B": b_, "Q": q_, "H": h_, "P": p_, "N": n_, "bc_head_stride": 0}
    print(f"ssd_chunk mamba2 trial (B,Q,H,P,N) = {(b_, q_, h_, p_, n_)}: kernel "
          f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms (CUDA events), card time "
          f"a call {r['device_us']} us; bound "
          f"{r['bound_ms']:.4g} ms ({r['bound_by']}); no PyTorch call computes it")
    out["ssd"]["slice_timing"] = {"mamba2_trial": r}

    # ------------------------------- whisper-base at full width: serving
    phase(f"main path: {WHISPER_ARCH} served at full width on the card "
          f"(bf16, then float32)")
    cfg = get_config(WHISPER_ARCH)
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    want_fa = cfg.enc_layers + 2 * cfg.n_layers
    print(f"{cfg.name}: {n_params:,} parameters ({cfg.dtype}), {cfg.enc_layers} "
          f"encoder + {cfg.n_layers} decoder layers (d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads x {cfg.head_dim}, {cfg.enc_seq_len} frames), "
          f"published width and depth; random weights from seed 0, init "
          f"{time.perf_counter() - t0:.2f} s")
    sample = sample_train_batch(np.random.default_rng(0), cfg, WHISPER_BATCH,
                                WHISPER_PROMPT)
    toks, frames = sample["tokens"], sample["frames"].cuda()
    max_len = WHISPER_PROMPT + WHISPER_NEW
    server = Server(cfg, params, max_len=max_len, device="cuda")
    plain = Server(cfg, params, ctx=ModelCtx(kernels="ref"), max_len=max_len,
                   device="cuda")
    server.generate({"tokens": toks[:, :16], "frames": frames}, 2)    # warm-up
    torch.cuda.synchronize()
    kfa.LAUNCHES = kfa.WGMMA_LAUNCHES = kfa.TF32_LAUNCHES = kss.LAUNCHES = 0
    t0 = time.perf_counter()
    wout = server.generate({"tokens": toks, "frames": frames}, WHISPER_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    serve_launches = (kfa.LAUNCHES, kfa.WGMMA_LAUNCHES)
    print(f"generate: {WHISPER_BATCH} x {WHISPER_PROMPT} prompt tokens and "
          f"{cfg.enc_seq_len} frames -> {tuple(wout.shape)} tokens in "
          f"{gen_s * 1e3:.1f} ms; flash launches per prefill {serve_launches[0]}, "
          f"on the bf16 wgmma route {serve_launches[1]} (want {want_fa}: "
          f"{cfg.enc_layers} encoder, {cfg.n_layers} decoder self, "
          f"{cfg.n_layers} cross)")
    if serve_launches != (want_fa, want_fa):
        fail(f"whisper's prefill launched flash {serve_launches} (want {want_fa} "
             "on the bf16 route)")
    if not (int(wout.min()) >= 0 and int(wout.max()) < cfg.vocab_size):
        fail("whisper generated tokens out of range")
    dev_tok = torch.as_tensor(toks, device="cuda").long()
    with torch.inference_mode():
        def prefill_ms(srv, n=3):
            srv.prefill(dev_tok, frames)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(n):
                srv.prefill(dev_tok, frames)
            torch.cuda.synchronize()
            return (time.perf_counter() - t) / n * 1e3
        pre_ms, pre_plain_ms = prefill_ms(server), prefill_ms(plain)
        lg_k = server.prefill(dev_tok, frames)[0].float()[:, -1]
        lg_r = plain.prefill(dev_tok, frames)[0].float()[:, -1]
    lg_err = (lg_k - lg_r).abs().max().item()
    lg_tol = SERVE_REL_TOL * lg_r.abs().max().item()
    print(f"bf16 prefill {pre_ms:.2f} ms through the kernels, {pre_plain_ms:.2f} "
          f"ms plain; logits max abs diff {lg_err:.4g} (tol {lg_tol:.4g} = "
          f"{SERVE_REL_TOL} x max |logit|); decode "
          f"{(gen_s * 1e3 - pre_ms) / (WHISPER_NEW - 1):.3f} ms a token step")
    if not lg_err <= lg_tol:
        fail("whisper bf16 prefill logits, kernels against plain, beyond the "
             "stated tolerance")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    s32 = Server(cfg32, p32, max_len=max_len, device="cuda")
    s32_r = Server(cfg32, p32, ctx=ModelCtx(kernels="ref"), max_len=max_len,
                   device="cuda")
    f32_frames = frames.float()
    kfa.LAUNCHES = kfa.TF32_LAUNCHES = 0
    o32 = s32.generate({"tokens": toks, "frames": f32_frames}, WHISPER_NEW)
    torch.cuda.synchronize()
    tf32_serve = (kfa.LAUNCHES, kfa.TF32_LAUNCHES)
    o32_r = s32_r.generate({"tokens": toks, "frames": f32_frames}, WHISPER_NEW)
    same32 = int((o32 == o32_r).sum())
    print(f"float32 (weights cast from the bf16 ones): {same32} of {o32.numel()} "
          f"greedy tokens equal, kernels against plain; flash launches per "
          f"prefill {tf32_serve[0]}, on the 3xTF32 route {tf32_serve[1]}")
    if tf32_serve != (want_fa, want_fa) or same32 != o32.numel():
        fail(f"whisper float32 serving: launches {tf32_serve} (want {want_fa}), "
             f"{same32} of {o32.numel()} tokens equal")
    del s32, s32_r, server, plain
    out["flash"]["whisper_serve"] = {
        "arch": cfg.name, "batch": WHISPER_BATCH, "prompt": WHISPER_PROMPT,
        "frames": cfg.enc_seq_len, "new_tokens": WHISPER_NEW,
        "launches_per_prefill": serve_launches[1], "prefill_ms": pre_ms,
        "prefill_plain_ms": pre_plain_ms, "generate_s": gen_s,
        "logit_err": lg_err, "logit_tol": lg_tol}
    out["flash_f32"]["whisper_serve"] = {
        "launches_per_prefill": tf32_serve[1], "tokens_equal": same32,
        "tokens": o32.numel()}

    # --------------------- whisper-base: float32 loss and gradients
    phase(f"main path: {WHISPER_ARCH} (float32) Model.loss and its gradients "
          f"at full width, through the kernels and through the plain versions")
    B, S = WHISPER_BATCH, WHISPER_PROMPT
    model32 = Model(cfg32)
    batch32 = batch_to(SyntheticLMDataset(cfg32, B, S, seed=0).get_batch(0), "cuda")

    def loss_and_grads(ctx):
        p = tree_map(lambda t: t.detach().requires_grad_(True), p32)
        loss, _ = model32.loss(p, batch32, ctx)
        n = kfa.TF32_LAUNCHES
        grads = torch.autograd.grad(loss, tree_leaves(p))
        torch.cuda.synchronize()
        return float(loss.detach()), [g.detach() for g in grads], n

    kfa.LAUNCHES = kfa.TF32_LAUNCHES = 0
    loss_k, g_k, fwd_fa = loss_and_grads(null_ctx(attn_chunk=min(512, S), remat="none"))
    loss_r, g_r, _ = loss_and_grads(null_ctx(attn_chunk=min(512, S), remat="none",
                                             kernels="ref"))
    leaf = leaf_names(p32)
    errs = [((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
            for a, b in zip(g_k, g_r)]
    worst = max(range(len(errs)), key=errs.__getitem__)
    loss_rel = abs(loss_k - loss_r) / abs(loss_r)
    print(f"batch {B} x {S} tokens and {cfg.enc_seq_len} frames: loss through the "
          f"kernels {loss_k:.7f}, plain {loss_r:.7f}, relative diff {loss_rel:.3g} "
          f"(tol {TRAIN_LOSS_RTOL}); worst of {len(errs)} gradient leaves "
          f"{leaf[worst]} {errs[worst]:.3g} of its largest (tol {TRAIN_GRAD_TOL}); "
          f"flash launches in the forward {fwd_fa} (3xTF32, want {want_fa})")
    if not (loss_rel <= TRAIN_LOSS_RTOL and errs[worst] <= TRAIN_GRAD_TOL
            and fwd_fa == want_fa):
        fail(f"whisper float32 training through the kernels: loss {loss_rel:.3g} "
             f"relative, worst leaf {errs[worst]:.3g}, {fwd_fa} flash launches")
    out["flash_f32"]["whisper_train"] = {
        "loss_rel": loss_rel, "worst_leaf": leaf[worst],
        "worst_leaf_err": errs[worst], "launches_per_forward": fwd_fa}
    del p32, g_k, g_r, batch32
    torch.cuda.empty_cache()

    # --------------------- whisper-base: the config's bf16, 5 train steps
    phase(f"main path: {WHISPER_ARCH} ({cfg.dtype}, float32 master) "
          f"{WHISPER_STEPS} train steps through the kernels")
    opt = adamw(TRAIN_LR, keep_master=(cfg.opt_precision == "fp32"))
    state = {"params": params, "opt": opt.init(params)}
    del params
    step_fn = make_train_step(model, opt, null_ctx(attn_chunk=min(512, S),
                                                   remat="none"))
    batch = batch_to(SyntheticLMDataset(cfg, B, S, seed=0).get_batch(0), "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kfa.LAUNCHES = kfa.WGMMA_LAUNCHES = 0
    losses, step_ms = [], []
    for _ in range(WHISPER_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fa_step = kfa.WGMMA_LAUNCHES / WHISPER_STEPS
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
    ms_step = sum(step_ms[-3:]) / 3
    print(f"losses {[round(x, 5) for x in losses]} on the repeated batch (lr "
          f"{TRAIN_LR}); step ms {[round(x, 1) for x in step_ms]}, {ms_step:.2f} ms "
          f"a step over the last 3; peak memory {peak_gb:.2f} GB; flash launches "
          f"a step {fa_step:g} (bf16 wgmma, want {want_fa}); under the profiler: "
          f"{len(seen)} kernels a step, wall {prof_wall * 1e3:.2f} ms, card busy "
          f"{busy * 1e3:.2f} ms, idle {100 * idle:.2f}%")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"whisper bf16 training: losses {losses}")
    if fa_step != want_fa:
        fail(f"whisper bf16 training launched flash {fa_step:g} times a step")
    out["flash"]["whisper_train"] = {
        "arch": cfg.name, "dtype": cfg.dtype, "master": "float32", "batch": B,
        "seq": S, "losses": losses, "step_ms": step_ms, "ms_per_step": ms_step,
        "peak_memory_gb": peak_gb, "launches_per_step": fa_step,
        "kernels_per_step_seen": len(seen), "busy_ms": busy * 1e3,
        "wall_ms": prof_wall * 1e3, "idle_share": idle}
    del state, m, batch, step_fn
    torch.cuda.empty_cache()

    # ------------------------------------ real-training trials: the loop
    phase("main path: a backend='training' ScenarioSpec (qwen1.5-0.5b) through "
          "SweepRunner(device='cuda') beside a sim replica: the SpotTune loop "
          "on real trials")
    t_trials = time.perf_counter()
    sim = ScenarioSpec(workload="LoR", market_seed=0, days=2.0)
    train = ScenarioSpec(workload="qwen1.5-0.5b", market_seed=0,
                         backend="training", days=2.0)
    tuners = SweepRunner(device="cuda").prepare([sim, train])
    be = tuners[1].engine.backend
    if not (isinstance(be, TrainingTrialBackend) and be.device.type == "cuda"):
        fail(f"the training replica's backend is {type(be).__name__} on "
             f"{getattr(be, 'device', None)}")
    res_sim = tuners[0].run()
    torch.cuda.synchronize()
    kfa.LAUNCHES = kss.LAUNCHES = 0
    t0 = time.perf_counter()
    res = tuners[1].run()
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    loop_launches = (kfa.LAUNCHES, kss.LAUNCHES)
    runs = list(be._runs.values())
    steps = sum(r.trainer.step + (r.replayer.step if r.replayer else 0) for r in runs)
    host = [r.trainer.mean_step_time() for r in runs]
    print(f"sim replica: {res_sim.steps_total:.0f} steps; training replica: "
          f"{res.steps_total:.0f} steps, {res.redeployments} redeployments, "
          f"{be.snapshots} snapshots, {be.restores} restores, {be.snapshot_skips} "
          f"skipped, billed ${res.cost:.2f}, refunded ${res.refunded:.2f}; "
          f"ranking {len(res.predicted_rank)} trials, top {res.predicted_rank[0]}")
    print(f"{len(runs)} runs, {steps} train steps on the card (cursors and "
          f"replayers) in {loop_s:.2f} s of wall ({steps / loop_s:.1f} steps/s); "
          f"host_step_time mean {1e3 * sum(host) / len(host):.2f} ms; flash "
          f"launches {loop_launches[0]} ({loop_launches[0] / max(steps, 1):.2f} a "
          f"step: the reduced qwen has 2 layers)")
    if not (res.steps_total > 0 and res.redeployments > 0 and be.snapshots > 0
            and be.restores > 0 and res.refunded > 0
            and len(res.predicted_rank) == 8
            and res.predicted_rank[0].startswith("train-qwen1.5-0.5b/")):
        fail("the SpotTune loop on real trials did not run whole: steps, "
             "redeployments, snapshots, restores, refunds or the ranking missing")
    if loop_launches[0] == 0:
        fail("the training loop launched no flash kernel")
    shutil.rmtree(be.store.inner.root, ignore_errors=True)
    trials = {"loop": {
        "arch": "qwen1.5-0.5b", "steps_total": res.steps_total,
        "redeployments": res.redeployments, "snapshots": be.snapshots,
        "restores": be.restores, "refunded": res.refunded, "cost": res.cost,
        "wall_s": loop_s, "train_steps": steps, "flash_launches": loop_launches[0],
        "host_step_ms": 1e3 * sum(host) / len(host)}}

    # ----------------------- real-training trials: each arch on its own
    phase("the three seed archs' trials on the card: 48-step streams, a "
          "snapshot and restore, bitwise replay, card against CPU")
    for arch in TRAINING_ARCHS:
        w = TRAINING_WORKLOADS[arch]
        t = TrialSpec(w, w.hp_grid()[0], 0)
        card = TrainingTrialBackend(device="cuda")
        run = card._run(t)
        kfa.LAUNCHES = kss.LAUNCHES = 0
        t0 = time.perf_counter()
        card._ensure(run, TRIAL_REPLAY_STEP)
        mid = _to_host(run.trainer.state)
        stream = card.metric_range(t, 1, w.max_trial_steps // w.val_every)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = run.trainer.step
        per_step = (kfa.LAUNCHES / n, kss.LAUNCHES / n)
        replayed = card._host_state(run, TRIAL_REPLAY_STEP)
        bitwise = all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
                      for a, b in zip(tree_leaves(replayed), tree_leaves(mid)))
        differ = [nm for nm, a, b in zip(leaf_names(replayed), tree_leaves(replayed),
                                         tree_leaves(mid))
                  if isinstance(a, torch.Tensor) and not torch.equal(a, b)]
        snap = card.snapshot(t, 24, deadline_s=120.0)
        card.restore(t, 24)
        restored = card.last_restore[2]
        restore_ok = snap == 24.0 and all(
            torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
            for a, b in zip(tree_leaves(restored),
                            tree_leaves(card._host_state(run, 24))))
        cpu = TrainingTrialBackend(device="cpu")
        cstream = cpu.metric_range(t, 1, w.max_trial_steps // w.val_every)
        rel = max(abs(a - b) / abs(b) for a, b in zip(stream, cstream))
        print(f"{arch}: {n} steps in {wall:.2f} s ({n / wall:.1f} steps/s, "
              f"host_step_time {1e3 * card.host_step_time(t):.2f} ms); launches a "
              f"step flash {per_step[0]:g}, ssd_chunk {per_step[1]:g}; losses "
              f"{stream[0]:.4f} -> {stream[-1]:.4f}; replay to step "
              f"{TRIAL_REPLAY_STEP} bitwise equal on every leaf: {bitwise}"
              + (f" (differ: {differ[:6]})" if differ else "")
              + f"; snapshot 24 and restore bit-identical: {restore_ok}; card "
              f"against CPU stream max relative diff {rel:.3g} (tol {TRIAL_RTOL})")
        tc = run.trainer.cfg
        want = ((0, tc.n_layers * -(-run.trainer.data.seq // tc.ssm_chunk))
                if tc.family == "ssm" else
                (tc.enc_layers + 2 * tc.n_layers if tc.family == "audio"
                 else tc.n_layers, 0))
        if per_step != want:
            fail(f"{arch} trial launched (flash, ssd_chunk) {per_step} a step, "
                 f"want {want}")
        if not (bitwise and restore_ok and rel <= TRIAL_RTOL
                and all(math.isfinite(x) for x in stream)):
            fail(f"{arch} trial: bitwise replay {bitwise}, restore {restore_ok}, "
                 f"card against CPU {rel:.3g}")
        trials[arch] = {"steps": n, "wall_s": wall, "host_step_ms":
                        1e3 * card.host_step_time(t), "flash_per_step": per_step[0],
                        "ssd_per_step": per_step[1], "bitwise_replay": bitwise,
                        "restore_bit_identical": restore_ok, "card_vs_cpu_rel": rel,
                        "first_loss": stream[0], "last_loss": stream[-1]}
        shutil.rmtree(card.store.inner.root, ignore_errors=True)
        shutil.rmtree(cpu.store.inner.root, ignore_errors=True)

    phase("a trial's steps under torch.profiler (reduced qwen, bf16)")
    w = TRAINING_WORKLOADS["qwen1.5-0.5b"]
    tr = Trainer(**TRAINING_BINDINGS[w.name].trainer_kwargs({"lr": 3e-3},
                                                           w.val_every),
                 device="cuda")
    tr.run_steps(3)
    seen = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: seen.extend(device_intervals(p))) as prof:
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.run_steps(4)
            torch.cuda.synchronize()
            trial_wall = time.perf_counter() - t0
            prof.step()
    busy = busy_us(seen) / 1e6
    trial_idle = 1 - busy / trial_wall
    print(f"4 trial steps: wall {trial_wall * 1e3:.2f} ms, {len(seen) / 4:.0f} "
          f"kernels a step, card busy {busy * 1e3:.2f} ms, idle "
          f"{100 * trial_idle:.2f}%")
    trials["profile"] = {"kernels_per_step": len(seen) / 4,
                         "wall_ms_per_step": trial_wall * 1e3 / 4,
                         "busy_ms_per_step": busy * 1e3 / 4, "idle_share": trial_idle}
    trials["phases_wall_s"] = time.perf_counter() - t_trials
    out["flash"]["trials"] = trials
    out["ssd"]["trials_launches_per_step"] = trials["mamba2-130m"]["ssd_per_step"]
    wall = time.perf_counter() - t_all
    print(f"the training backend's phases: {wall:.1f} s of wall (trials "
          f"{trials['phases_wall_s']:.1f} s)")
    out["flash"]["slice_wall_s"] = wall
    return out


# ------------------------------------------------------------------------
# the last model families: grok-1 and pixtral-12b through flash attention
# at D = 128 (GQA, G = 6 and 4), deepseek-v2 through MLA's plain attention
# ------------------------------------------------------------------------

FAMILY_BATCH, FAMILY_PROMPT, FAMILY_NEW = 2, 256, 32
# the depth cuts at published width: grok-1 64 -> 2 layers (11.45 B
# parameters), deepseek-v2 60 -> 3 (the dense layer and 2 MoE layers, every
# expert whole: 9.33 B); pixtral-12b keeps its 40 (12.25 B), in float32 too
FAMILY_LAYERS = {"grok-1-314b": 2, "deepseek-v2-236b": 3, "pixtral-12b": 40}
# flash attention at D = 128 inside the models: (B, S, H, KV), causal
FAMILY_FLASH = {"grok-1-314b": (2, 256, 48, 8), "pixtral-12b": (2, 1280, 32, 8)}
# MLA (float32, full width): the materialized form against the absorbed
# one (tests/test_models_equiv.py:123); prefill of S - 1 tokens and one
# decode step against the full forward (tests/test_models_equiv.py:159-165)
MLA_EQUIV_TOL, PREFILL_TOL, DECODE_TOL = 2e-4, 2e-4, 3e-4
# the reduced models, card against CPU, float32 logits
CARD_CPU_LOGIT_TOL = 1e-4
FAMILY_DECODE_STEPS = 8      # decode steps under the profiler


def mla_bound_ms(B, S, H, Dk, Dv, elem_bytes):
    """Least time for MLA's attention (causal, one shared key and value
    head): q, the shared k and v read once and o written once over the HBM
    rate, against the two products' multiply-adds over the (query, key)
    pairs the mask keeps, at the bf16 tensor-core peak (bf16 inputs) or the
    3xTF32 rate (float32)."""
    n_bytes = elem_bytes * B * (S * H * Dk + S * Dk + S * Dv + S * H * Dv)
    flops = 2.0 * B * H * (S * (S + 1) // 2) * (Dk + Dv)
    return _mla_bound(n_bytes, flops, elem_bytes)


def mla_bwd_bound_ms(B, S, H, Dk, Dv, elem_bytes):
    """Least time for MLA's attention backward (causal): q, k, v and do read
    once with lse (float32), dq, dk and dv written once, against the five
    products over the kept (query, key) pairs: S = Q.K^T, dQ = dS.K and dK
    = dS^T.Q over Dk, dP = dO.V^T and dV = P^T.dO over Dv."""
    n_bytes = (elem_bytes * B * (2 * S * H * Dk + 2 * S * Dk + 2 * S * Dv + S * H * Dv)
               + 4 * B * H * S)
    flops = 2.0 * B * H * (S * (S + 1) // 2) * (3 * Dk + 2 * Dv)
    return _mla_bound(n_bytes, flops, elem_bytes)


def _mla_bound(n_bytes, flops, elem_bytes):
    peak = H100_BF16_FLOPS if elem_bytes == 2 else H100_TF32_FLOPS / 3
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def profiled(torch, fn):
    """(wall s, the card's kernel intervals) of one call of ``fn`` traced by
    torch.profiler, after a traced call whose events are discarded (the
    profiler misses launches in its first moments)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    seen, wall = [], 0.0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: seen.extend(device_intervals(p))) as prof:
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            prof.step()
    return wall, seen


def params_to_float32(tree) -> None:
    """Every leaf of a parameter tree cast to float32 in place, one leaf at
    a time: each bf16 leaf is freed as its float32 copy is made, so the
    card never holds both whole trees."""
    for key, val in tree.items():
        if isinstance(val, dict):
            params_to_float32(val)
        else:
            tree[key] = val.float()


def moe_layer_replay(torch, model, params, batch, ctx):
    """The prefill replayed layer by layer: each MoE layer's share of
    (token, expert) assignments that capacity dropped, and the first MoE
    layer's FFN input and parameters (for the timing of its parts)."""
    from repro_torch.models import blocks, layers, moe
    from repro_torch.models.model import _row

    cfg = model.cfg
    shares, first = [], None
    with torch.inference_mode():
        x, positions = model._embed_inputs(params, batch, ctx)
        for name, _, depth in model._block_stacks():
            for i in range(depth):
                lp = _row(params[name], i)
                if "moe" in lp:
                    h = layers.rms_norm(x, lp["ln1"], cfg.norm_eps)
                    a, _ = blocks.attn_prefill(h, lp["attn"], cfg, ctx, positions)
                    h2 = layers.rms_norm(x + a, lp["ln2"], cfg.norm_eps)
                    T = h2.shape[0] * h2.shape[1]
                    _, idx, _ = moe._route(h2.reshape(T, -1), lp["moe"]["router"], cfg)
                    _, keep = moe._dispatch_indices(idx, 0, cfg.n_experts,
                                                    moe.capacity(T, cfg))
                    shares.append(1.0 - keep.float().mean().item())
                    if first is None:
                        first = (h2, lp["moe"])
                x, _ = blocks.block_prefill(x, lp, cfg, ctx, positions)
    return shares, first


def moe_split_us(torch, cfg, h, p):
    """Card us of one MoE layer's parts on its prefill input h (B, S, D):
    the router (logits, softmax, top-k, aux), the dispatch (slots and the
    index_add_ into the capacity buffers), the expert products, the combine,
    and the shared experts where the config has them."""
    from repro_torch.models import layers, moe

    T = h.shape[0] * h.shape[1]
    x = h.reshape(T, -1)
    cap = moe.capacity(T, cfg)
    E = cfg.n_experts
    with torch.inference_mode():
        w, idx, _ = moe._route(x, p["router"], cfg)
        slot, keep = moe._dispatch_indices(idx, 0, E, cap)
        buf = moe._dispatch(x, slot, keep, E, cap)
        out = moe._expert_ffn(buf, p["w_gate"], p["w_up"], p["w_down"])
    parts = {
        "router": lambda: moe._route(x, p["router"], cfg),
        "dispatch": lambda: moe._dispatch(x, *moe._dispatch_indices(idx, 0, E, cap),
                                          E, cap),
        "expert_products": lambda: moe._expert_ffn(buf, p["w_gate"], p["w_up"],
                                                   p["w_down"]),
        "combine": lambda: moe._combine(out, slot, keep, w, x.dtype)}
    if cfg.n_shared_experts:
        parts["shared_experts"] = lambda: layers.mlp(h, p["shared"], gated=True)
    res = {"capacity": cap, "tokens": T}
    with torch.inference_mode():
        for name, fn in parts.items():
            res[name] = device_us_per_call(fn, iters=10, warmup=3,
                                           what=f"of the MoE layer's {name}")
    return res


def serve_family(torch, arch, gen_seed=0):
    """One family at published width (cut in depth as FAMILY_LAYERS says),
    random weights from a seed, served B x 256 prompt tokens (pixtral: its
    1024 stub patches ahead of them) and 32 greedy tokens through
    ``Server(device="cuda")``: in bf16 through the kernels and through the
    plain versions (prefill logits compared), profiled, the MoE layers'
    drops and parts timed; then in float32 (cast from the bf16 weights,
    which are freed first), tokens compared.  Returns the phase's numbers."""
    import dataclasses

    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention_cuda as kfa
    from repro_torch.kernels import mla_attention_cuda as kmla
    from repro_torch.launch.serve import Server
    from repro_torch.models.context import ModelCtx
    from repro_torch.models.inputs import sample_train_batch
    from repro_torch.models.model import Model, tree_leaves

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=FAMILY_LAYERS[arch])
    n_flash = 0 if cfg.use_mla else cfg.n_layers
    # MLA's attention: one forward kernel a layer in the prefill; its
    # one-token decode stays plain, as the reference's is
    n_mla = cfg.n_layers if cfg.use_mla else 0
    phase(f"main path: {arch} served at published width, {cfg.n_layers} of "
          f"{full.n_layers} layers (bf16, then float32)")
    t0 = time.perf_counter()
    params = Model(cfg).init(torch.Generator(device="cuda").manual_seed(gen_seed),
                             device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"{cfg.name}: {n_params:,} parameters ({cfg.dtype}, "
          f"{sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9:.2f}"
          f" GB; the whole model {full.param_count():,}, "
          f"{full.active_param_count():,} active), d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads"
          + (f" (MLA: q_lora {cfg.q_lora_rank}, kv_lora {cfg.kv_lora_rank}, qk "
             f"{cfg.qk_nope_head_dim} + {cfg.qk_rope_head_dim}, v {cfg.v_head_dim})"
             if cfg.use_mla else f" over {cfg.n_kv_heads} K/V heads of {cfg.head_dim}")
          + (f", {cfg.n_experts} experts at d_ff {cfg.moe_d_ff}, top-"
             f"{cfg.experts_per_tok}, {cfg.n_shared_experts} shared, "
             f"{cfg.first_k_dense} dense first" if cfg.n_experts else "")
          + f", d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; random weights from "
          f"seed {gen_seed}, init {time.perf_counter() - t0:.2f} s")
    seq = FAMILY_PROMPT + (cfg.n_patches if cfg.family == "vlm" else 0)
    sample = sample_train_batch(np.random.default_rng(4), cfg, FAMILY_BATCH, seq)
    pre = {k: (v.cuda() if isinstance(v, torch.Tensor) else v)
           for k, v in sample.items() if k != "labels"}
    max_len = seq + FAMILY_NEW
    dev_tok = torch.as_tensor(pre["tokens"], device="cuda").long()
    patches = pre.get("patch_embeds")
    server = Server(cfg, params, max_len=max_len, device="cuda")
    plain = Server(cfg, params, ctx=ModelCtx(kernels="ref"), max_len=max_len,
                   device="cuda")
    server.generate({k: (v[:, :16] if k == "tokens" else v) for k, v in pre.items()},
                    2)                                           # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kfa.LAUNCHES = kfa.WGMMA_LAUNCHES = kfa.TF32_LAUNCHES = kmla.LAUNCHES = 0
    t0 = time.perf_counter()
    out = server.generate(pre, FAMILY_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = (kfa.LAUNCHES, kfa.WGMMA_LAUNCHES)
    mla_launches = kmla.LAUNCHES
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"generate: {FAMILY_BATCH} x {seq} positions -> {tuple(out.shape)} tokens "
          f"in {gen_s * 1e3:.1f} ms; flash launches {launches[0]}, on the bf16 "
          f"wgmma route {launches[1]} (want {n_flash}); MLA attention launches "
          f"{mla_launches} (want {n_mla}); peak memory {peak_gb:.2f} GB")
    if launches != (n_flash, n_flash) or mla_launches != n_mla:
        fail(f"{arch} bf16 serving launched flash {launches} (want {n_flash}), MLA "
             f"attention {mla_launches} (want {n_mla})")
    if not (int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size):
        fail(f"{arch} generated tokens out of range")

    def prefill_ms(srv, n=3):
        srv.prefill(dev_tok, patch_embeds=patches)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            srv.prefill(dev_tok, patch_embeds=patches)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / n * 1e3

    pre_ms, pre_plain_ms = prefill_ms(server), prefill_ms(plain)
    with torch.inference_mode():
        lg_k = server.prefill(dev_tok, patch_embeds=patches)[0].float()[:, -1]
        lg_r = plain.prefill(dev_tok, patch_embeds=patches)[0].float()[:, -1]
    lg_err = (lg_k - lg_r).abs().max().item()
    lg_tol = SERVE_REL_TOL * lg_r.abs().max().item()
    decode_ms = (gen_s * 1e3 - pre_ms) / (FAMILY_NEW - 1)
    finite = bool(torch.isfinite(lg_k).all())
    print(f"bf16 prefill {pre_ms:.2f} ms through the kernels, {pre_plain_ms:.2f} ms "
          f"plain; last-position logits max abs diff {lg_err:.4g} (tol "
          f"{lg_tol:.4g} = {SERVE_REL_TOL} x max |logit|), finite {finite}; decode "
          f"{decode_ms:.3f} ms a token step")
    if not (finite and lg_err <= lg_tol):
        fail(f"{arch} bf16 prefill logits, kernels against plain, {lg_err:.4g} "
             f"apart (tol {lg_tol:.4g})")

    # the card's idle share over a profiled prefill and decode steps
    def prefill():
        return server.prefill(dev_tok, patch_embeds=patches)

    with torch.inference_mode():
        pre_wall, pre_iv = profiled(torch, prefill)
        lg, cache = prefill()
        tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
        steps = iter(range(2 * FAMILY_DECODE_STEPS))

        def decode():
            nonlocal tok, cache
            for _ in range(FAMILY_DECODE_STEPS):
                tok, cache = server.step(cache, tok, seq + next(steps))
        dec_wall, dec_iv = profiled(torch, decode)
        del cache, lg
    idle_pre = 1 - busy_us(pre_iv) / 1e6 / pre_wall
    idle_dec = 1 - busy_us(dec_iv) / 1e6 / dec_wall
    per_step = len(dec_iv) / FAMILY_DECODE_STEPS
    print(f"profiled prefill: wall {pre_wall * 1e3:.2f} ms, {len(pre_iv)} kernels, "
          f"card busy {busy_us(pre_iv) / 1e3:.2f} ms, idle {100 * idle_pre:.2f}%; "
          f"{FAMILY_DECODE_STEPS} decode steps: wall {dec_wall * 1e3:.2f} ms, "
          f"{per_step:.0f} kernels a step, card busy {busy_us(dec_iv) / 1e3:.2f} ms, "
          f"idle {100 * idle_dec:.2f}%")
    res = {"arch": arch, "layers": cfg.n_layers, "published_layers": full.n_layers,
           "parameters": n_params, "batch": FAMILY_BATCH, "positions": seq,
           "new_tokens": FAMILY_NEW, "flash_launches_per_prefill": launches[0],
           "mla_launches_per_prefill": mla_launches,
           "prefill_ms": pre_ms, "prefill_plain_ms": pre_plain_ms,
           "decode_ms_per_step": decode_ms, "generate_s": gen_s,
           "peak_memory_gb": peak_gb, "bf16_logit_err": lg_err,
           "bf16_logit_tol": lg_tol, "kernels_per_decode_step": per_step,
           "prefill_idle_share": idle_pre, "decode_idle_share": idle_dec}

    if cfg.n_experts:
        batch = {"tokens": dev_tok}
        if patches is not None:
            batch["patch_embeds"] = patches
        shares, (h2, lp) = moe_layer_replay(torch, server.model, params, batch,
                                            server.ctx)
        print(f"assignments capacity dropped, per MoE layer (capacity factor "
              f"{cfg.capacity_factor}, T = {FAMILY_BATCH * seq}): "
              + ", ".join(f"{100 * x:.2f}%" for x in shares))
        split = moe_split_us(torch, cfg, h2, lp)
        parts = [k for k in split if k not in ("capacity", "tokens")]
        total = sum(split[k] or 0.0 for k in parts)
        # a part whose trace the profiler saw no launch of is None (§7 of
        # PERF.md: the profiler now and then misses launches)
        print(f"one MoE layer's card time at the prefill (capacity "
              f"{split['capacity']} of {split['tokens']} tokens): "
              + ", ".join(f"{k} not seen by the profiler" if split[k] is None else
                          f"{k} {split[k]:.1f} us ({100 * split[k] / total:.1f}%)"
                          for k in parts))
        res["moe_dropped_share"] = shares
        res["moe_layer_us"] = split
        del h2, lp
    del server, plain, out

    # ------------------------------------------------------------ float32
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params_to_float32(params)
    torch.cuda.empty_cache()
    p32 = params
    s32 = Server(cfg32, p32, max_len=max_len, device="cuda")
    s32_r = Server(cfg32, p32, ctx=ModelCtx(kernels="ref"), max_len=max_len,
                   device="cuda")
    pre32 = {k: (v.float() if isinstance(v, torch.Tensor) else v)
             for k, v in pre.items()}
    kfa.LAUNCHES = kfa.TF32_LAUNCHES = kmla.LAUNCHES = 0
    o32 = s32.generate(pre32, FAMILY_NEW)
    torch.cuda.synchronize()
    tf32 = (kfa.LAUNCHES, kfa.TF32_LAUNCHES)
    mla32 = kmla.LAUNCHES
    o32_r = s32_r.generate(pre32, FAMILY_NEW)
    p32_patches = pre32.get("patch_embeds")
    with torch.inference_mode():
        l32_k = s32.prefill(dev_tok, patch_embeds=p32_patches)[0][:, -1]
        l32_r = s32_r.prefill(dev_tok, patch_embeds=p32_patches)[0][:, -1]
    torch.cuda.synchronize()
    same = int((o32 == o32_r).sum())
    l32_err = (l32_k - l32_r).abs().max().item()
    print(f"float32 (weights cast from the bf16 ones): {same} of {o32.numel()} "
          f"greedy tokens equal, kernels against plain; flash launches "
          f"{tf32[0]}, on the 3xTF32 route {tf32[1]} (want {n_flash}), MLA attention "
          f"{mla32} (want {n_mla}); prefill logits max abs diff {l32_err:.4g}")
    if tf32 != (n_flash, n_flash) or mla32 != n_mla or same != o32.numel():
        fail(f"{arch} float32 serving: flash launches {tf32} (want {n_flash}), MLA "
             f"{mla32} (want {n_mla}), {same} of {o32.numel()} tokens equal")
    res.update({"f32_flash_launches_per_prefill": tf32[1], "f32_tokens_equal": same,
                "f32_tokens": o32.numel(), "f32_logit_err": l32_err})
    del s32, s32_r, o32, o32_r
    return res, cfg32, p32


MLA_TOL = {"float32": 1e-4, "bfloat16": 1e-2}   # of each output's largest (BWD_TOL)


def mla_kernel_phase(torch, B, S, gen) -> dict:
    """MLA's absorbed attention at deepseek-v2's shape (B x S positions, 128
    heads on one shared key head 576 wide and value head 512 wide, causal,
    its scale) in bf16 and float32: the kernels (the forward with its lse,
    the backward) against their plain versions (``ref``'s flash forward and
    backward at one K/V head), each call repeated bitwise; then each timed
    by CUDA events and by card time beside its bound, the plain version,
    the model's plain route (``latent_attention`` with ``kernels="ref"``)
    and SDPA with ``enable_gqa`` (its forward, and its backward alone).
    Returns the kernels line's two rows (forward, backward)."""
    import torch.nn.functional as F
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import mla_attention_cuda as kmla
    from repro_torch.models import mla
    from repro_torch.models.context import null_ctx

    phase("MLA's attention kernels at deepseek-v2's shape against their plain "
          "versions, then timed beside the plain versions and SDPA (CUDA events, "
          "card time)")
    cfg = get_config("deepseek-v2-236b")
    H, R, qr = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    Dk, Dv, scale = R + qr, R, mla._scale(cfg)
    shape = {"B": B, "S": S, "H": H, "Dk": Dk, "Dv": Dv, "causal": True}
    rows = {
        d: {"name": f"mla_attention{'' if d == 'fwd' else '_bwd'}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mla_attention.cu",
            "replaces": "src/repro/models/mla.py:130 (attention.attention on MLA's "
                        "absorbed form, XLA code: no Pallas kernel)",
            "shape": shape}
        for d in ("fwd", "bwd")}

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max().clamp_min(1e-30)).item()

    for dt in (torch.bfloat16, torch.float32):
        name = "bfloat16" if dt == torch.bfloat16 else "float32"
        q = torch.randn(B, S, H, Dk, generator=gen).to("cuda", dt)
        kk = torch.randn(B, S, Dk, generator=gen).to("cuda", dt)
        vv = kk[..., :R].contiguous()     # the model's v: c_kv, k's first R columns
        do = torch.randn(B, S, H, Dv, generator=gen).to("cuda", dt)
        n0 = kmla.LAUNCHES, kmla.BWD_LAUNCHES
        o, lse = kmla.mla_attention_lse_cuda(q, kk, vv, True, scale)
        grads = kmla.mla_attention_bwd_cuda(q, kk, vv, lse, do, True, scale)
        o2, lse2 = kmla.mla_attention_lse_cuda(q, kk, vv, True, scale)
        grads2 = kmla.mla_attention_bwd_cuda(q, kk, vv, lse, do, True, scale)
        launches = (kmla.LAUNCHES - n0[0], kmla.BWD_LAUNCHES - n0[1])
        o_r, lse_r = kmla.mla_fwd_lse_ref(q, kk, vv, True, scale)
        g_r = kmla.mla_bwd_ref(q, kk, vv, lse, do, True, scale)
        torch.cuda.synchronize()
        errs = {"o": rel(o, o_r), "lse": rel(lse, lse_r),
                **{n: rel(a, b) for n, a, b in zip(("dq", "dk", "dv"), grads, g_r)}}
        abs_fwd = (o.float() - o_r.float()).abs().max().item()
        abs_bwd = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(grads, g_r))
        same = (torch.equal(o, o2) and torch.equal(lse, lse2)
                and all(torch.equal(a, b) for a, b in zip(grads, grads2)))
        finite = all(bool(torch.isfinite(t).all()) for t in (o, lse, *grads))
        print(f"{name}: (B, S, H, Dk, Dv) = {(B, S, H, Dk, Dv)} causal, of each "
              f"output's largest: o {errs['o']:.3g}, lse {errs['lse']:.3g}, dq "
              f"{errs['dq']:.3g}, dk {errs['dk']:.3g}, dv {errs['dv']:.3g} (tol "
              f"{MLA_TOL[name]}); max abs err forward {abs_fwd:.3g}, backward "
              f"{abs_bwd:.3g}; repeated bitwise {same}; finite {finite}; launches "
              f"(forward, backward) {launches}")
        if not (max(errs.values()) <= MLA_TOL[name] and same and finite
                and launches == (2, 2)):
            fail(f"MLA's attention kernels at deepseek-v2's shape, {name}: {errs}, "
                 f"repeated bitwise {same}, finite {finite}, launches {launches}")
        del o2, lse2, grads2, o_r, lse_r, g_r

        qt, kt, vt = (t.detach().requires_grad_(True)
                      for t in (q.transpose(1, 2), kk[:, None], vv[:, None]))
        dot = do.transpose(1, 2)
        ctx_ref = null_ctx(kernels="ref")
        calls = {
            "fwd": {"kernel": lambda: kmla.mla_attention_cuda(q, kk, vv, True, scale),
                    "plain": lambda: kmla.mla_fwd_lse_ref(q, kk, vv, True, scale),
                    "route_plain": lambda: mla.latent_attention(q, kk, vv, True, scale,
                                                                ctx_ref)},
            "bwd": {"kernel": lambda: kmla.mla_attention_bwd_cuda(q, kk, vv, lse, do, True,
                                                                  scale),
                    "plain": lambda: kmla.mla_bwd_ref(q, kk, vv, lse, do, True, scale)}}
        try:
            o_s = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=scale,
                                                 enable_gqa=True)
            lib_err = rel(o_s.transpose(1, 2), o)
            calls["fwd"]["library"] = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, scale=scale, enable_gqa=True)
            calls["bwd"]["library"] = lambda: torch.autograd.grad(
                o_s, (qt, kt, vt), dot, retain_graph=True)
            refused = None
        except (RuntimeError, ValueError, NotImplementedError) as err:
            # SDPA refused the shapes: recorded, no library time
            refused, lib_err = str(err).splitlines()[0][:200], None
        eb = torch.finfo(dt).bits // 8
        bounds = {"fwd": mla_bound_ms(B, S, H, Dk, Dv, eb),
                  "bwd": mla_bwd_bound_ms(B, S, H, Dk, Dv, eb)}
        for d, fns in calls.items():
            r = {"max_abs_err": abs_fwd if d == "fwd" else abs_bwd,
                 "errors": errs, "bound_ms": bounds[d][0], "bound_by": bounds[d][1]}
            for what, fn in fns.items():
                fast = what in ("kernel", "library")
                r[f"{what}_ms"] = cuda_ms(fn, iters=50 if fast else 10,
                                          warmup=5 if fast else 2)
                r[f"{what}_device_us"] = device_us_per_call(
                    fn, iters=20 if fast else 5, warmup=3 if fast else 1,
                    what=f"of MLA's {d} {what}, {name}")
            r["library_err"], r["library_refused"] = lib_err, refused
            print(f"  {d} {name}: kernel {r['kernel_ms']:.4f} ms (CUDA events), card "
                  f"{r['kernel_device_us']} us; bound {r['bound_ms']:.4g} ms "
                  f"({r['bound_by']}), {r['kernel_ms'] / r['bound_ms']:.1f}x; plain "
                  f"{r['plain_ms']:.4f} ms, card {r['plain_device_us']} us"
                  + (f"; the model's plain route {r['route_plain_ms']:.4f} ms, card "
                     f"{r['route_plain_device_us']} us" if d == "fwd" else "")
                  + (f"; SDPA (enable_gqa) {r['library_ms']:.4f} ms, card "
                     f"{r['library_device_us']} us ({lib_err:.3g} from the kernel's o)"
                     if refused is None else f"; SDPA refused: {refused}"))
            rows[d][name] = r
        del qt, kt, vt, calls
        torch.cuda.empty_cache()
    for d, row in rows.items():
        # the line's numbers: the bf16 route's (the training and serving type)
        bf = row["bfloat16"]
        row.update({"max_abs_err": max(row[n]["max_abs_err"] for n in ("bfloat16",
                                                                        "float32")),
                    "ms": bf["kernel_ms"], "plain_ms": bf["plain_ms"],
                    "bound_ms": bf["bound_ms"], "bound_by": bf["bound_by"],
                    "library_ms": bf.get("library_ms"), "device_us": bf["kernel_device_us"],
                    "library": "torch.nn.functional.scaled_dot_product_attention "
                               "(enable_gqa)" + (", its backward" if d == "bwd" else "")})
    return rows


# MLA's materialized form (q and k 192 wide a head, v 128) on the flash
# kernels: one layer at full width, of each output's largest.  The kernels
# against the same form's plain version: FN_GRAD_TOL (the flash Function's
# gradients against the plain version's); the two forms against each other:
# float32 1e-3 (tests/test_torch_mla.py's GRAD_TOL against the JAX
# package), bf16 5e-2 (SERVE_REL_TOL: the two forms round at other places)
MAT_FORMS_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
# (B, S) of the flash kernels' timing at the materialized pair: A15's
# training shape, and one sequence at DeepSeek-V2's 4K pretraining length
MAT_TIMING_SHAPES = ((2, 256), (1, 4096))


def mla_materialized_phase(torch, B, S, gen) -> dict:
    """One MLA layer of deepseek-v2 at full width (128 heads, q and k 192
    wide a head, v 128; B x S positions, causal) forward and backward in
    bf16 and float32: the materialized form on the flash kernels, the same
    form with ``kernels="ref"`` on the card, and the absorbed form on the
    MLA kernels, each for the output, x's gradient and every attention
    leaf's (the cotangent a fixed random tensor).  Held: the kernels
    against the plain version within FN_GRAD_TOL, the forms within
    MAT_FORMS_TOL, one flash forward launch and one backward call in the
    kernels' run (no MLA kernel), none in the plain run, one MLA forward
    and backward call in the absorbed run.  Returns each type's errors and
    launches."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention_cuda as kfa
    from repro_torch.kernels import mla_attention_cuda as kmla
    from repro_torch.models import mla
    from repro_torch.models.context import ModelCtx, null_ctx
    from repro_torch.optim.optimizers import tree_leaves, tree_map

    phase(f"deepseek-v2's MLA layer at full width (B = {B}, S = {S}): the materialized "
          "form on the flash kernels against its plain version and the absorbed form, "
          "forward and backward, bf16 and float32")
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        name = "bfloat16" if dt == torch.bfloat16 else "float32"
        cfg = dataclasses.replace(get_config("deepseek-v2-236b"), dtype=name)
        params = mla.init_mla(torch.Generator(device="cuda").manual_seed(3), cfg, "cuda")
        names = ["out", "x"] + leaf_names(params)
        x = torch.randn(B, S, cfg.d_model, generator=gen).to("cuda", dt)
        cot = torch.randn(B, S, cfg.d_model, generator=gen).to("cuda", dt)
        pos = torch.arange(S, device="cuda")

        def run(ctx):
            p = tree_map(lambda t: t.detach().requires_grad_(True), params)
            xt = x.detach().requires_grad_(True)
            n0 = (kfa.LAUNCHES, kfa.BWD_LAUNCHES, kmla.LAUNCHES, kmla.BWD_LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o = mla.mla_train(xt, p, cfg, pos, ctx)
            grads = torch.autograd.grad(o, [xt] + tree_leaves(p), cot)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            n = tuple(a - b for a, b in zip(
                (kfa.LAUNCHES, kfa.BWD_LAUNCHES, kmla.LAUNCHES, kmla.BWD_LAUNCHES), n0))
            return [o.detach()] + [g.detach() for g in grads], n, ms

        mat = {"rules": {"mla_materialized": True}, "remat": "none", "attn_chunk": S}
        kern, n_k, ms_k = run(ModelCtx(**mat))
        plain, n_p, ms_p = run(ModelCtx(**mat, kernels="ref"))
        absorbed, n_a, ms_a = run(null_ctx(remat="none", attn_chunk=S))

        def rel(a, b):
            return ((a.float() - b.float()).abs().max()
                    / b.float().abs().max().clamp_min(1e-30)).item()

        e_kp = [rel(a, b) for a, b in zip(kern, plain)]
        e_fm = [rel(a, b) for a, b in zip(kern, absorbed)]
        finite = all(bool(torch.isfinite(t).all()) for t in kern)
        wk, wf = max(range(len(names)), key=e_kp.__getitem__), max(
            range(len(names)), key=e_fm.__getitem__)
        print(f"{name}: of each output's largest, kernels against plain: worst {names[wk]} "
              f"{e_kp[wk]:.3g} (out {e_kp[0]:.3g}, x {e_kp[1]:.3g}; tol "
              f"{FN_GRAD_TOL[name]}); materialized against absorbed: worst {names[wf]} "
              f"{e_fm[wf]:.3g} (out {e_fm[0]:.3g}; tol {MAT_FORMS_TOL[name]}); finite "
              f"{finite}; launches (flash forward, flash backward, MLA forward, MLA "
              f"backward): kernels {n_k}, plain {n_p}, absorbed {n_a}; wall forward + "
              f"backward {ms_k:.2f} / {ms_p:.2f} / {ms_a:.2f} ms")
        if not (e_kp[wk] <= FN_GRAD_TOL[name] and e_fm[wf] <= MAT_FORMS_TOL[name] and finite
                and n_k == (1, 1, 0, 0) and n_p == (0, 0, 0, 0) and n_a == (0, 0, 1, 1)):
            fail(f"MLA's materialized form at full width, {name}: kernels against plain "
                 f"{names[wk]} {e_kp[wk]:.3g}, against absorbed {names[wf]} {e_fm[wf]:.3g}, "
                 f"finite {finite}, launches {n_k} / {n_p} / {n_a}")
        out[name] = {"kernels_vs_plain": dict(zip(names, e_kp)),
                     "materialized_vs_absorbed": dict(zip(names, e_fm)),
                     "launches": {"kernels": n_k, "plain": n_p, "absorbed": n_a},
                     "wall_ms": {"kernels": ms_k, "plain": ms_p, "absorbed": ms_a}}
        del kern, plain, absorbed, params, x, cot
        torch.cuda.empty_cache()
    return out


def sdpa_backend(torch, qt, kt, vt, scale) -> str:
    """The backend ``scaled_dot_product_attention`` picks for these causal
    inputs: PyTorch's own choice (``torch._fused_sdp_choice``), or, where
    that is not there, what the names of its card kernels show (the
    profiler misses launches late in the run, so the names may be none)."""
    try:
        from torch.nn.attention import SDPBackend
        return SDPBackend(torch._fused_sdp_choice(qt, kt, vt, is_causal=True,
                                                  scale=scale)).name
    except (AttributeError, TypeError, ValueError, ImportError):
        pass
    import torch.nn.functional as F
    names = card_launches(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=scale), 2, 1)
    low = " ".join(names).lower()
    for key, backend in (("cudnn", "CUDNN_ATTENTION"), ("flash", "FLASH_ATTENTION"),
                         ("fmha", "EFFICIENT_ATTENTION"), ("cutlass", "EFFICIENT_ATTENTION")):
        if key in low:
            return backend
    return "unknown (no kernel seen)" if not names else "MATH"


def flash_dv_timing_phase(torch, gen) -> dict:
    """The flash kernels at MLA's materialized pair (q and k 192 wide, v
    128; 128 heads, causal, scale 192^-0.5) at MAT_TIMING_SHAPES in bf16
    and float32: the forward and the backward (its launches: dq, dV, dK),
    each checked against its plain version (of each output's largest,
    BWD_TOL) and repeated bitwise, then timed by CUDA events and card time
    beside its bound (``flash_bound_ms`` / ``flash_bwd_bound_ms`` with Dv),
    the plain version (key chunks of min(512, S)) and SDPA on the same
    tensors (its backward by ``torch.autograd.grad``; the backend it picks
    named, ``sdpa_backend``).  Returns the kernels line's two rows."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention_cuda as kfa
    from repro_torch.kernels import ref

    phase("the flash kernels at MLA's materialized pair (192, 128): checked, then timed "
          "beside the bound, the plain version and SDPA (CUDA events, card time)")
    H, Dk, Dv = 128, 192, 128
    scale = Dk ** -0.5
    src = "src/repro_torch/kernels/csrc/"
    rows = {"fwd": {"name": "flash_attention (Dk 192, Dv 128)", "route": "cuda",
                    "source": src + "flash_attention.cu",
                    "replaces": "src/repro/kernels/flash_attention.py:77 "
                                "(flash_attention_pallas); at this pair the reference "
                                "runs src/repro/models/mla.py:101 (attention.attention on "
                                "MLA's materialized form, XLA code)"},
            "bwd": {"name": "flash_attention_bwd (Dk 192, Dv 128)", "route": "cuda",
                    "source": src + "flash_attention_bwd.cuh",
                    "replaces": "src/repro/models/attention.py:202 (_flash_bwd_rule, XLA "
                                "code: no Pallas kernel) at src/repro/models/mla.py:101"}}
    for B, S in MAT_TIMING_SHAPES:
        chunk = min(512, S)
        for dt in (torch.bfloat16, torch.float32):
            name = "bfloat16" if dt == torch.bfloat16 else "float32"
            q, k = (torch.randn(B, S, H, Dk, generator=gen).to("cuda", dt) for _ in range(2))
            v, do = (torch.randn(B, S, H, Dv, generator=gen).to("cuda", dt) for _ in range(2))
            o, lse = kfa.flash_attention_lse_cuda(q, k, v, True, scale)
            grads = kfa.flash_attention_bwd_cuda(q, k, v, lse, do, True, scale)
            o2, lse2 = kfa.flash_attention_lse_cuda(q, k, v, True, scale)
            grads2 = kfa.flash_attention_bwd_cuda(q, k, v, lse, do, True, scale)
            o_r, lse_r = ref.flash_attention_fwd_lse(q, k, v, True, scale, chunk)
            g_r = ref.flash_attention_bwd(q, k, v, lse, do, True, scale, chunk)
            torch.cuda.synchronize()
            errs = [((a.float() - b.float()).abs().max()
                     / b.float().abs().max().clamp_min(1e-30)).item()
                    for a, b in zip((o, lse, *grads), (o_r, lse_r, *g_r))]
            abs_f = (o.float() - o_r.float()).abs().max().item()
            abs_b = max((a.float() - b.float()).abs().max().item()
                        for a, b in zip(grads, g_r))
            same = (torch.equal(o, o2) and torch.equal(lse, lse2)
                    and all(torch.equal(a, b) for a, b in zip(grads, grads2)))
            print(f"{name} (B, S) = {(B, S)}: of each output's largest o {errs[0]:.3g}, lse "
                  f"{errs[1]:.3g}, dq {errs[2]:.3g}, dk {errs[3]:.3g}, dv {errs[4]:.3g} "
                  f"(tol {BWD_TOL[name]}); repeated bitwise {same}")
            if not (max(errs) <= BWD_TOL[name] and same):
                fail(f"the flash kernels at (192, 128), {name} {(B, S)}: {errs}, "
                     f"repeated bitwise {same}")
            del o2, lse2, grads2, o_r, lse_r, g_r
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
            ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=scale)
            dot = do.transpose(1, 2)
            backend = sdpa_backend(torch, qt, kt, vt, scale)
            eb = q.element_size()
            big = S > 512
            calls = {
                "fwd": (lambda: kfa.flash_attention_cuda(q, k, v, True, scale),
                        lambda: ref.flash_attention_fwd_lse(q, k, v, True, scale, chunk),
                        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                               scale=scale),
                        kfa.flash_bound_ms(B, S, S, H, Dk, True, eb, Dv=Dv)),
                "bwd": (lambda: kfa.flash_attention_bwd_cuda(q, k, v, lse, do, True, scale),
                        lambda: ref.flash_attention_bwd(q, k, v, lse, do, True, scale, chunk),
                        lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True),
                        kfa.flash_bwd_bound_ms(B, S, S, H, Dk, True, eb, Dv=Dv))}
            for d, (kern, plain, lib, (bound, by)) in calls.items():
                r = {"max_abs_err": abs_f if d == "fwd" else abs_b, "errors": errs,
                     "bound_ms": bound, "bound_by": by, "library_backend": backend}
                for what, fn in (("kernel", kern), ("plain", plain), ("library", lib)):
                    fast = what != "plain"
                    r[f"{what}_ms"] = cuda_ms(fn, iters=(5 if big else 30) if fast else 3,
                                              warmup=2 if fast else 1)
                    r[f"{what}_device_us"] = device_us_per_call(
                        fn, iters=(3 if big else 10) if fast else 2, warmup=1,
                        what=f"{d} {what}, {name} {(B, S)}")
                print(f"  {d} {name} {(B, S)}: kernel {r['kernel_ms']:.4f} ms (CUDA "
                      f"events), card {r['kernel_device_us']} us; bound "
                      f"{r['bound_ms']:.4g} ms ({by}), {r['kernel_ms'] / bound:.1f}x; plain "
                      f"{r['plain_ms']:.4f} ms, card {r['plain_device_us']} us; SDPA "
                      f"({backend}) {r['library_ms']:.4f} ms, card "
                      f"{r['library_device_us']} us")
                rows[d].setdefault(name, {})[f"B{B}_S{S}"] = r
            del q, k, v, do, o, lse, grads, qt, kt, vt, ot, dot, calls
            torch.cuda.empty_cache()
    for d, row in rows.items():
        # the line's numbers: bf16 at A15's training shape (the step's)
        bf = row["bfloat16"]["B2_S256"]
        row.update({"max_abs_err": max(row[n][sh]["max_abs_err"] for n in
                                       ("bfloat16", "float32") for sh in row[n]),
                    "ms": bf["kernel_ms"], "plain_ms": bf["plain_ms"],
                    "bound_ms": bf["bound_ms"], "bound_by": bf["bound_by"],
                    "library_ms": bf["library_ms"], "device_us": bf["kernel_device_us"],
                    "library": "torch.nn.functional.scaled_dot_product_attention ("
                               + bf["library_backend"] + ")"
                               + (", its backward" if d == "bwd" else "")})
    return rows


def family_phases(torch) -> dict:
    """The slice of the last model families on the card: flash attention at
    D = 128 with grok-1's and pixtral-12b's GQA (G = 6 and 4) on both
    routes against the plain version, timed beside SDPA and the bound, the
    kernels' D = 128 register spills from the build; grok-1 (2 layers),
    pixtral-12b (40 layers) and deepseek-v2 (3 layers) served at published
    width (``serve_family``); deepseek's MLA checks in float32 at full width
    and MLA's attention kernels held and timed (``mla_kernel_phase``); the
    reduced three on the card against the CPU.  Returns the slice's fields
    of the two flash rows and the MLA kernels' two rows."""
    import dataclasses

    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention_cuda as kfa
    from repro_torch.kernels import mla_attention_cuda as kmla
    from repro_torch.launch.serve import Server
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import mla
    from repro_torch.models.context import ModelCtx, null_ctx
    from repro_torch.models.inputs import sample_train_batch
    from repro_torch.models.model import Model, _row, tree_map

    t_all = time.perf_counter()
    out = {"flash": {}, "flash_f32": {}}
    gen = torch.Generator().manual_seed(22)
    names = {torch.float32: "float32", torch.bfloat16: "bfloat16"}

    # ------------------------------- flash attention at D = 128, GQA
    phase("flash_attention at D = 128 with grok-1's and pixtral-12b's GQA "
          "against the plain version (both routes)")
    torch.cuda.empty_cache()
    print(f"card memory held by tensors of earlier phases: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    spills = {}
    for line_no, line in enumerate(build.BUILD_LOG.get("flash_attention", "")
                                   .splitlines()):
        if "Function properties for" in line and "ILi128E" in line:
            route = "bf16" if "wgmma_kernel" in line else "f32"
            spills[route] = (build.BUILD_LOG["flash_attention"].splitlines()
                             [line_no + 1].strip())
    print(f"ptxas at D = 128: bf16 wgmma kernel: {spills.get('bf16')}; 3xTF32 "
          f"kernel: {spills.get('f32')}")
    for arch, (b_, s_, h_, kv) in FAMILY_FLASH.items():
        cfg = get_config(arch)
        g = h_ // kv
        for dt in (torch.bfloat16, torch.float32):
            q = torch.randn(b_, s_, kv, g, 128, generator=gen).to("cuda", dt)
            k, v = (torch.randn(b_, s_, kv, 128, generator=gen).to("cuda", dt)
                    for _ in range(2))
            before = (kfa.LAUNCHES, kfa.WGMMA_LAUNCHES, kfa.TF32_LAUNCHES)
            with torch.inference_mode():
                o = attn_lib.attention(q, k, v, causal=True)
                o_ref = attn_lib.attention(q, k, v, causal=True, kernels="ref")
            torch.cuda.synchronize()
            n = (kfa.LAUNCHES - before[0], kfa.WGMMA_LAUNCHES - before[1],
                 kfa.TF32_LAUNCHES - before[2])
            e = (o.float() - o_ref.float()).abs().max().item()
            tol = FLASH_TOL[names[dt]]
            want = (1, 1, 0) if dt == torch.bfloat16 else (1, 0, 1)
            print(f"  {arch} {names[dt]} (B,S,H,KV,G,D) = {(b_, s_, h_, kv, g, 128)} "
                  f"causal, through models.attention.attention: max abs err "
                  f"{e:.3g} (tol {tol}); launches (all, wgmma, 3xTF32) {n}")
            if not (cfg.head_dim == 128 and o.shape == q.shape and e <= tol
                    and n == want):
                fail(f"flash_attention at {arch}'s D = 128 GQA shape, {names[dt]}: "
                     f"max abs err {e:.3g}, launches {n} (want {want})")
            row = out["flash" if dt == torch.bfloat16 else "flash_f32"]
            row.setdefault("d128_max_abs_err", 0.0)
            row["d128_max_abs_err"] = max(row["d128_max_abs_err"], e)
    out["flash"]["d128_spill"] = spills.get("bf16")
    out["flash_f32"]["d128_spill"] = spills.get("f32")

    phase("flash_attention at D = 128, grok-1's and pixtral-12b's prefill "
          "shapes (CUDA events, card time)")
    for arch, (b_, s_, h_, _) in FAMILY_FLASH.items():
        key = arch.split("-")[0]
        for dt, row in ((torch.bfloat16, out["flash"]), (torch.float32, out["flash_f32"])):
            r = slice_flash_timing(torch, b_, s_, s_, h_, 128, True, dt,
                                   f"{arch}'s prefill", gen)
            row.setdefault("d128_timing", {})[key] = r

    # -------------------------------------------- the three families served
    fam = {}
    for arch in ("grok-1-314b", "pixtral-12b"):
        res, _, p32 = serve_family(torch, arch)
        fam[arch] = res
        del p32
        torch.cuda.empty_cache()
    res, cfg32, p32 = serve_family(torch, "deepseek-v2-236b")
    fam["deepseek-v2-236b"] = res

    # ------------------------------ deepseek-v2: MLA checks at full width
    phase("deepseek-v2 (float32, full width): MLA's materialized form against "
          "the absorbed one; prefill of S - 1 and one decode step against the "
          "full forward")
    B, S = FAMILY_BATCH, FAMILY_PROMPT
    lp = _row(p32["moe_layers"]["attn"], 0)
    x = torch.randn(B, S, cfg32.d_model, generator=gen).cuda()
    pos = torch.arange(S, device="cuda")
    before = kfa.LAUNCHES
    with torch.inference_mode():
        o_abs = mla.mla_train(x, lp, cfg32, pos, null_ctx())
        o_mat = mla.mla_train(x, lp, cfg32, pos,
                              ModelCtx(rules={"mla_materialized": True}))
    torch.cuda.synchronize()
    mla_err = (o_abs - o_mat).abs().max().item()
    mat_launches = kfa.LAUNCHES - before
    print(f"B = {B}, S = {S}, {cfg32.n_heads} heads: materialized against absorbed "
          f"max abs diff {mla_err:.3g} (tol {MLA_EQUIV_TOL}; max |out| "
          f"{o_abs.abs().max().item():.3g}); flash launches {mat_launches} (the "
          f"materialized form's: want 1)")
    if not (mla_err <= MLA_EQUIV_TOL and mat_launches == 1):
        fail(f"deepseek-v2 MLA forms {mla_err:.3g} apart, or flash launches "
             f"{mat_launches} (want 1)")
    del o_abs, o_mat
    cfg_cf = dataclasses.replace(cfg32, capacity_factor=float(cfg32.n_experts))
    m = Model(cfg_cf)
    batch = {k: (v if isinstance(v, torch.Tensor) else torch.as_tensor(v)).cuda().long()
             for k, v in sample_train_batch(np.random.default_rng(0), cfg_cf, B,
                                            S).items()}
    ctx = null_ctx(remat="none")
    with torch.inference_mode():
        full_lg = m.forward(p32, {"tokens": batch["tokens"]}, ctx)[0]
        lg_pre, cache = m.prefill(p32, {"tokens": batch["tokens"][:, :-1]}, ctx,
                                  cache_len=S)
        lg_dec, _ = m.decode_step(p32, cache, batch["tokens"][:, -1:], S - 1, ctx)
    torch.cuda.synchronize()
    pre_err = (lg_pre[:, -1] - full_lg[:, -2]).abs().max().item()
    dec_err = (lg_dec[:, 0] - full_lg[:, -1]).abs().max().item()
    print(f"capacity_factor = n_experts = {cfg32.n_experts}: prefill of {S - 1} "
          f"against the full forward max abs diff {pre_err:.3g} (tol "
          f"{PREFILL_TOL}), one decode step {dec_err:.3g} (tol {DECODE_TOL}); max "
          f"|logit| {full_lg.abs().max().item():.3g}")
    if not (pre_err <= PREFILL_TOL and dec_err <= DECODE_TOL):
        fail(f"deepseek-v2 incremental decode against the full forward: "
             f"{pre_err:.3g} / {dec_err:.3g}")
    fam["deepseek-v2-236b"].update({"mla_forms_err": mla_err,
                                    "materialized_flash_launches": mat_launches,
                                    "prefill_vs_forward_err": pre_err,
                                    "decode_vs_forward_err": dec_err})
    del full_lg, lg_pre, cache, lg_dec, p32, m
    torch.cuda.empty_cache()

    out["mla"] = mla_kernel_phase(torch, B, S, gen)
    out["mla"]["fwd"]["launches"] = fam["deepseek-v2-236b"]["mla_launches_per_prefill"]
    # MLA's materialized form on the flash kernels at full width
    mat = mla_materialized_phase(torch, B, S, gen)
    out["flash_dv"] = flash_dv_timing_phase(torch, gen)
    out["flash_dv"]["fwd"]["layer_check"] = mat

    # ------------------------------ the reduced three, card against CPU
    phase("the reduced deepseek-v2, grok-1 and pixtral-12b (float32) on the "
          "card against the CPU")
    reduced = {}
    for arch in ("deepseek-v2-236b", "grok-1-314b", "pixtral-12b"):
        rc = dataclasses.replace(get_config(arch, reduced=True), dtype="float32")
        p_cpu = Model(rc).init(torch.Generator().manual_seed(3), device="cpu")
        p_card = tree_map(lambda t: t.cuda(), p_cpu)
        n = 13 + (rc.n_patches if rc.family == "vlm" else 0)
        smp = sample_train_batch(np.random.default_rng(5), rc, B, n)
        pre = {k: v for k, v in smp.items() if k != "labels"}
        kfa.LAUNCHES = kmla.LAUNCHES = 0
        tok_card = Server(rc, p_card, max_len=n + 16, device="cuda").generate(pre, 12)
        torch.cuda.synchronize()
        launches, mla_launches = kfa.LAUNCHES, kmla.LAUNCHES
        tok_cpu = Server(rc, p_cpu, max_len=n + 16, device="cpu").generate(pre, 12)
        pre_t = {"tokens": torch.as_tensor(pre["tokens"]).long(),
                 **({"patch_embeds": pre["patch_embeds"]} if rc.family == "vlm" else {})}
        with torch.inference_mode():
            lc = Model(rc).forward(p_card, {k: v.cuda() for k, v in pre_t.items()})[0]
            lh = Model(rc).forward(p_cpu, pre_t)[0]
        err = (lc.cpu() - lh).abs().max().item()
        same = bool(torch.equal(tok_card.cpu(), tok_cpu))
        want = 0 if rc.use_mla else rc.n_layers
        want_mla = rc.n_layers if rc.use_mla else 0
        print(f"  {arch} reduced: tokens equal {same}, forward logits max abs diff "
              f"{err:.3g} (tol {CARD_CPU_LOGIT_TOL}); flash launches {launches} "
              f"(want {want}), MLA attention launches {mla_launches} (want {want_mla})")
        if not (same and err <= CARD_CPU_LOGIT_TOL and launches == want
                and mla_launches == want_mla):
            fail(f"{arch} reduced on the card against the CPU: tokens equal {same}, "
                 f"logits {err:.3g}, flash launches {launches}, MLA {mla_launches}")
        reduced[arch] = {"tokens_equal": same, "logit_err": err}

    wall = time.perf_counter() - t_all
    print(f"the model families' phases: {wall:.1f} s of wall")
    out["flash"]["families"] = fam
    out["flash"]["families_reduced_card_vs_cpu"] = reduced
    out["flash"]["families_wall_s"] = wall
    out["flash_f32"]["families_tokens_equal"] = {
        a: (r["f32_tokens_equal"], r["f32_tokens"]) for a, r in fam.items()}
    return out


# ------------------------------------------------------------------------
# A15: training of the moe, mla and vlm families on the card at published
# width, cut in depth, at the configs' own optimizer precision
# ------------------------------------------------------------------------

# the depth cuts at published width: pixtral-12b 40 -> 4 layers (2.43 B
# parameters, float32 master: ~16 B a parameter); deepseek-v2 60 -> 2 (the
# dense first layer and one MoE layer of 160 experts, 5.36 B, moments_fp32:
# 12 B a parameter)
A15_LAYERS = {"pixtral-12b": 4, "deepseek-v2-236b": 2}
A15_BATCH, A15_TEXT = 2, 256     # B x 256 text tokens (pixtral: 1024 patches first)
A15_LR = 1e-3                    # TRAIN_LR
A15_REDUCED_TOL = 1e-2           # bf16 training, C4's bound
# the step's change of a parameter or master leaf (new - old), card against
# CPU, relative to the CPU's: at lr 1e-3 a leaf moves by ~1e-3 of its norm,
# which A15_REDUCED_TOL cannot see; a missing update is 1, a reversed one 2,
# and the bf16 gradients' rounding flips Adam's first update (+-lr) on some
# elements (the port against the JAX package on the CPU: at most 0.56)
A15_CHANGE_TOL = 0.75


class _FixedBatches:
    """A Trainer's data: the same batch at every step."""

    def __init__(self, batch):
        self.batch = batch

    def get_batch(self, step):
        return self.batch


def _norm_rel(a, b) -> float:
    """|a - b| / |b| over the whole leaf (float64)."""
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def _train_parts(torch, model, opt, state, batch, ctx):
    """One train step in its three parts, each ended by a synchronise, under
    the profiler: (new state, loss, card busy ms by part, kernels seen, host
    wall ms by part).  The state is donated, as the Trainer's step donates
    it."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.optim.optimizers import tree_leaves, tree_map, tree_unflatten

    spans = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        p = tree_map(lambda t: t.detach().requires_grad_(True), state["params"])
        with record_function("train.forward"):
            loss, metrics = model.loss(p, batch, ctx)
            torch.cuda.synchronize()
        with record_function("train.backward"):
            grads = torch.autograd.grad(loss, tree_leaves(p))
            torch.cuda.synchronize()
        loss = float(loss.detach())
        g = tree_unflatten(state["params"], list(grads))
        # the graph (its leaves share the parameters' storage) goes before
        # the donated update, as the Trainer's step lets it go
        del p, grads, metrics
        with record_function("train.update"):
            new = opt.update(g, state["opt"], state["params"], donate=True)
            torch.cuda.synchronize()
    for e in prof.events():
        if e.name.startswith("train.") and e.device_type == torch.autograd.DeviceType.CPU:
            spans[e.name[6:]] = (e.time_range.start, e.time_range.end)
    kern = device_intervals(prof)
    busy = {n: busy_us([iv for iv in kern if lo <= iv[0] <= hi]) / 1e3
            for n, (lo, hi) in spans.items()}
    wall = {n: (hi - lo) / 1e3 for n, (lo, hi) in spans.items()}
    return {"params": new[0], "opt": new[1]}, loss, busy, len(kern), wall


def a15_trainer(torch, arch, cfg, B, S, materialized=False):
    """Profiled bf16 ``Trainer`` steps of ``cfg`` on one fixed batch: a
    warm-up step, two steps under the profiler (the second measured), one
    step in its parts (forward, backward, update) -> the numbers.  With
    ``materialized`` (an MLA model) one more step in its parts on the same
    state with ``ctx.rules["mla_materialized"]`` set: its loss, flash calls,
    peak and wall.  A step that runs out of the card's memory fails the
    run."""
    from repro_torch.kernels import flash_attention_cuda as kfa
    from repro_torch.kernels import mla_attention_cuda as kmla
    from repro_torch.launch.train import Trainer, batch_to
    from repro_torch.optim import optimizers

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, batch=B, seq=S, lr=A15_LR, seed=0, val_every=1,
                 device="cuda", draw_on="cuda")
    tr.data = _FixedBatches(tr.data.get_batch(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves_of(tr.state["params"]))
    state_gb = sum(t.numel() * t.element_size() for t in tree_leaves_of(tr.state)) / 1e9
    res = {"arch": cfg.name, "layers": cfg.n_layers, "batch": B, "seq": S,
           "opt_precision": cfg.opt_precision, "params": n_params,
           "state_gb": state_gb, "init_s": init_s, "lr": A15_LR}
    print(f"{cfg.name}: {cfg.n_layers} layers at published width, {n_params:,} "
          f"parameters, {cfg.dtype}, opt_precision {cfg.opt_precision}: train "
          f"state {state_gb:.2f} GB ({state_gb * 1e9 / n_params:.1f} B a parameter), "
          f"drawn on the card in {init_s:.2f} s; B = {B} x {S} positions, one "
          f"fixed batch, lr {A15_LR}")
    before = (kfa.LAUNCHES, kfa.WGMMA_LAUNCHES, kmla.LAUNCHES, kmla.BWD_LAUNCHES)
    # the leaves AdamW updates in slices, and where they lie: a donated
    # step writes them in place
    big = {p: t.data_ptr() for p, t in leaf_paths_of(tr.state)
           if t.numel() > optimizers.SLICE_ELEMS}
    try:
        t0 = time.perf_counter()
        tr.run_steps(1)
        torch.cuda.synchronize()
        warm_ms = (time.perf_counter() - t0) * 1e3
        wall, seen = profiled(torch, lambda: tr.run_steps(1))
    except torch.cuda.OutOfMemoryError as err:
        msg = str(err).splitlines()[0][:400]
        fail(f"{cfg.name} at {cfg.n_layers} layers ran out of the card's memory in "
             f"step {tr.step + 1}: peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
             f"(torch.cuda.max_memory_allocated); {msg}")
    # (no name may keep the state's leaves: the donated update below writes
    # in place only leaves that nothing else holds)
    in_place = sum(t.data_ptr() == big[p] for p, t in leaf_paths_of(tr.state) if p in big)
    print(f"  {len(big)} leaves over AdamW's slice cut ({optimizers.SLICE_ELEMS:,} "
          f"elements), {in_place} of them updated in place over {tr.step} steps")
    busy = busy_us(seen) / 1e6
    state, loss_parts, part_busy, n_kern, _ = _train_parts(
        torch, tr.model, tr.optimizer, tr.state,
        batch_to(tr.data.get_batch(0), "cuda"), tr.ctx)
    tr.state = None
    steps = tr.step + 1
    flash = (kfa.LAUNCHES - before[0], kfa.WGMMA_LAUNCHES - before[1])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if materialized:
        res["materialized"] = _materialized_step(torch, tr, state, cfg)
    del state
    mla_n = (kmla.LAUNCHES - before[2], kmla.BWD_LAUNCHES - before[3])
    losses = list(tr.metrics_vals) + [loss_parts]
    res.update({
        "losses": losses, "warm_step_ms": warm_ms, "step_ms": wall * 1e3,
        "trainer_step_s": list(tr.step_seconds), "kernels_per_step": len(seen),
        "busy_ms": busy * 1e3, "idle_share": 1 - busy / wall,
        "busy_ms_by_part": part_busy, "kernels_in_parts_step": n_kern,
        "flash_launches_per_step": flash[0] / steps,
        "wgmma_launches_per_step": flash[1] / steps,
        "mla_launches_per_step": mla_n[0] / steps,
        "mla_bwd_launches_per_step": mla_n[1] / steps,
        "sliced_leaves": len(big), "sliced_leaves_in_place": in_place,
        "peak_gb": peak_gb})
    print(f"  losses over {steps} steps {[round(x, 5) for x in losses]}; a step "
          f"{wall * 1e3:.2f} ms under the profiler ({warm_ms:.2f} ms the first), "
          f"{len(seen)} kernels, card busy {busy * 1e3:.2f} ms, idle "
          f"{100 * res['idle_share']:.2f}%; busy by part (ms): "
          + ", ".join(f"{k} {v:.2f}" for k, v in part_busy.items())
          + f"; flash launches a step {res['flash_launches_per_step']:g} "
          f"(bf16 wgmma {res['wgmma_launches_per_step']:g}), MLA forward "
          f"{res['mla_launches_per_step']:g}, backward "
          f"{res['mla_bwd_launches_per_step']:g}; peak {res['peak_gb']:.2f} GB")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        fail(f"{cfg.name} bf16 training at published width: losses {losses} not "
             "finite or not falling on a fixed batch")
    return res


def _materialized_step(torch, tr, state, cfg) -> dict:
    """One bf16 step of ``tr``'s model in its parts (``_train_parts``) on
    ``state`` (donated) with MLA's materialized form: its loss, flash
    launches (forward, backward calls, MLA kernels), peak, card busy and
    host wall by part (each part ended by a synchronise)."""
    import dataclasses

    from repro_torch.kernels import flash_attention_cuda as kfa
    from repro_torch.kernels import mla_attention_cuda as kmla
    from repro_torch.launch.train import batch_to

    ctx = dataclasses.replace(tr.ctx, rules={**tr.ctx.rules, "mla_materialized": True})
    n0 = (kfa.LAUNCHES, kfa.WGMMA_LAUNCHES, kfa.BWD_LAUNCHES, kmla.LAUNCHES,
          kmla.BWD_LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        new, loss, busy, n_kern, parts = _train_parts(
            torch, tr.model, tr.optimizer, state, batch_to(tr.data.get_batch(0), "cuda"), ctx)
    except torch.cuda.OutOfMemoryError as err:
        fail(f"{cfg.name}: the materialized MLA step ran out of the card's memory: "
             f"{str(err).splitlines()[0][:300]}")
    wall = sum(parts.values())
    n = tuple(a - b for a, b in zip((kfa.LAUNCHES, kfa.WGMMA_LAUNCHES, kfa.BWD_LAUNCHES,
                                     kmla.LAUNCHES, kmla.BWD_LAUNCHES), n0))
    peak = torch.cuda.max_memory_allocated() / 1e9
    total = torch.cuda.get_device_properties(0).total_memory / 1e9
    del new
    out = {"loss": loss, "flash_launches": n[0], "wgmma_launches": n[1],
           "flash_bwd_launches": n[2], "mla_launches": n[3], "mla_bwd_launches": n[4],
           "peak_gb": peak, "card_gb": total, "wall_ms": wall, "wall_ms_by_part": parts,
           "busy_ms_by_part": busy, "kernels": n_kern}
    print(f"  the same state, one more bf16 step with MLA's materialized form (in its "
          f"parts, under the profiler): loss {loss:.5f}, flash forward launches {n[0]} "
          f"(bf16 wgmma {n[1]}), backward calls {n[2]}, MLA kernels {n[3]} / {n[4]}; "
          f"peak {peak:.2f} GB of the card's {total:.2f} GB; {wall:.2f} ms (host wall of "
          f"the parts); by part (ms, wall / card busy): " + ", ".join(
              f"{k} {parts[k]:.2f} / {v:.2f}" for k, v in busy.items()))
    want = (cfg.n_layers, cfg.n_layers, cfg.n_layers, 0, 0)
    if not (math.isfinite(loss) and n == want):
        fail(f"{cfg.name}: the materialized step's loss {loss} or its launches (flash "
             f"forward, bf16, backward, MLA forward, backward) {n} (want {want})")
    return out


def tree_leaves_of(tree):
    from repro_torch.optim.optimizers import tree_leaves
    return [t for t in tree_leaves(tree) if hasattr(t, "numel")]


def family_train_phases(torch) -> dict:
    """A15 on the card: pixtral-12b (4 layers, published width) float32
    Model.loss and its gradients through the kernels (the 3xTF32 flash
    route at D = 128, the plain backward) against the plain path, then
    profiled bf16 Trainer steps at its float32 master; deepseek-v2 (2
    layers: the dense layer and a MoE layer of 160 experts, MLA's attention
    on its kernels forward and backward) in bf16 at moments_fp32, its state
    reckoned beside the measured peak, its profiled Trainer steps (an
    out-of-memory fails the run); the reduced grok-1, deepseek-v2 and
    pixtral-12b one bf16 Trainer step each at their full configs'
    optimizer precision, card against CPU.  Returns the phase's fields of
    the flash rows and the deepseek step's MLA launches."""
    import dataclasses
    import gc

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.kernels import flash_attention_cuda as kfa
    from repro_torch.kernels import mla_attention_cuda as kmla
    from repro_torch.launch.train import Trainer, batch_to
    from repro_torch.models.context import null_ctx
    from repro_torch.models.model import Model
    from repro_torch.optim.optimizers import tree_leaves, tree_map

    t_all = time.perf_counter()
    out = {"flash": {}, "flash_f32": {}}
    torch.cuda.empty_cache()
    print(f"card memory held by tensors of earlier phases: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    B = A15_BATCH

    # ----------------------- pixtral-12b float32: loss + grads, kernels/plain
    arch = "pixtral-12b"
    cfg = dataclasses.replace(get_config(arch), n_layers=A15_LAYERS[arch])
    S = A15_TEXT + cfg.n_patches
    phase(f"A15: {arch} ({cfg.n_layers} layers, float32) Model.loss and its "
          f"gradients through the kernels against the plain path")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = Model(cfg32)
    params = model32.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    names = leaf_names(params)
    batch = batch_to(SyntheticLMDataset(cfg32, B, S, seed=0).get_batch(0), "cuda")
    ctx = null_ctx(attn_chunk=min(512, S), remat="none")

    def loss_and_grads(ctx):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = model32.loss(p, batch, ctx)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fwd = kfa.TF32_LAUNCHES
        grads = torch.autograd.grad(loss, tree_leaves(p))
        torch.cuda.synchronize()
        return (float(loss.detach()), [g.detach() for g in grads], fwd,
                (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3)

    kfa.LAUNCHES = kfa.TF32_LAUNCHES = kfa.WGMMA_LAUNCHES = kfa.BWD_LAUNCHES = 0
    loss_k, g_k, fwd_n, fwd_ms, bwd_ms = loss_and_grads(ctx)
    bwd_n, bwd_kernels = kfa.TF32_LAUNCHES, kfa.BWD_LAUNCHES
    loss_r, g_r, _, fwd_ms_r, bwd_ms_r = loss_and_grads(
        null_ctx(attn_chunk=min(512, S), remat="none", kernels="ref"))
    loss_rel = abs(loss_k - loss_r) / abs(loss_r)
    errs = [((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
            for a, b in zip(g_k, g_r)]
    worst = max(range(len(errs)), key=errs.__getitem__)
    finite = all(bool(torch.isfinite(g).all()) for g in g_k)
    print(f"B = {B} x {S} positions ({cfg.n_patches} patches, {A15_TEXT} tokens): "
          f"loss through the kernels {loss_k:.7f}, plain {loss_r:.7f}, relative "
          f"diff {loss_rel:.3g} (tol {TRAIN_LOSS_RTOL}); worst gradient leaf "
          f"{names[worst]} {errs[worst]:.3g} of its largest (tol {TRAIN_GRAD_TOL}); "
          f"finite {finite}; flash launches: forward {fwd_n} on the 3xTF32 route "
          f"(want {cfg.n_layers}), after the backward {bwd_n}, backward kernel calls "
          f"{bwd_kernels}; wall forward {fwd_ms:.1f} / backward {bwd_ms:.1f} ms through "
          f"the kernels, {fwd_ms_r:.1f} / {bwd_ms_r:.1f} ms plain")
    if not (loss_rel <= TRAIN_LOSS_RTOL and errs[worst] <= TRAIN_GRAD_TOL and finite
            and fwd_n == bwd_n == cfg.n_layers == kfa.LAUNCHES == bwd_kernels
            and kfa.BWD_LAUNCHES == bwd_kernels):
        fail(f"{arch} float32 training through the kernels: loss {loss_rel:.3g}, "
             f"worst leaf {names[worst]} {errs[worst]:.3g}, flash launches "
             f"{fwd_n} / {bwd_n}, backward kernel calls {bwd_kernels}")
    out["flash_f32"]["a15_train"] = {
        "arch": arch, "layers": cfg.n_layers, "batch": B, "seq": S,
        "launches_per_forward": fwd_n, "bwd_launches_per_backward": bwd_kernels,
        "loss_rel": loss_rel,
        "worst_leaf": names[worst], "worst_leaf_err": errs[worst],
        "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "fwd_plain_ms": fwd_ms_r,
        "bwd_plain_ms": bwd_ms_r}
    del params, g_k, g_r, batch
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------ bf16 Trainer steps at full width
    fam = {}
    phase(f"A15: {arch} ({cfg.n_layers} layers, {cfg.dtype}, float32 master) "
          f"profiled Trainer steps")
    fam[arch] = a15_trainer(torch, arch, cfg, B, S)
    gc.collect()
    torch.cuda.empty_cache()

    arch = "deepseek-v2-236b"
    dcfg = dataclasses.replace(get_config(arch), n_layers=A15_LAYERS[arch])
    phase(f"A15: {arch} ({dcfg.n_layers} layers, {dcfg.dtype}, "
          f"{dcfg.opt_precision}) profiled Trainer steps")
    n = sum(t.numel() for t in tree_leaves(Model(dcfg).init(None, device="meta")))
    reckoned = n * (2 + 4 + 4) / 1e9
    print(f"state reckoned: {n:,} parameters x (2 B bf16 + 4 + 4 B float32 "
          f"moments) = {reckoned:.2f} GB; with bf16 gradients "
          f"{n * 12 / 1e9:.2f} GB before any activation or update temporary")
    res = a15_trainer(torch, arch, dcfg, B, A15_TEXT, materialized=True)
    res["state_reckoned_gb"] = reckoned
    print(f"  peak {res['peak_gb']:.2f} GB against the reckoned state "
          f"{reckoned:.2f} GB ({n * 12 / 1e9:.2f} GB with the gradients)")
    # MLA's attention: one forward and one backward kernel call a layer and
    # step; no flash launch (deepseek-v2 has no standard attention)
    want = (dcfg.n_layers, dcfg.n_layers)
    got = (res["mla_launches_per_step"], res["mla_bwd_launches_per_step"])
    if got != want or res["flash_launches_per_step"] != 0:
        fail(f"{arch} training step: MLA launches (forward, backward) a step {got} "
             f"(want {want}), flash launches {res['flash_launches_per_step']} (want 0)")
    out["mla"] = {"a15_step": {k: res[k] for k in (
        "mla_launches_per_step", "mla_bwd_launches_per_step", "step_ms", "peak_gb")},
        "a15_materialized_step": res["materialized"]}
    gc.collect()
    torch.cuda.empty_cache()
    fam[arch] = res

    # --------------------------- the reduced three: card against the CPU
    phase("A15: the reduced grok-1, deepseek-v2 and pixtral-12b, one Trainer "
          "step each at the full config's optimizer precision, card against CPU")
    print("bf16 through the kernels: the loss, parameters and master copy held, "
          "the moments (the two devices' bf16 gradients) printed; the same bf16 "
          "step with the card's attention on the plain version (kernels='ref') "
          "printed, to attribute the moments' spread; the float32 step through "
          "the kernels: every leaf held. Held: the loss and each leaf "
          f"|card - CPU| / |CPU| within {A15_REDUCED_TOL}, and the step's change "
          "of each parameter and master leaf (new - old), |card - CPU| / |CPU| "
          f"within {A15_CHANGE_TOL}")
    reduced, bad = {}, []
    for arch in ("grok-1-314b", "deepseek-v2-236b", "pixtral-12b"):
        base = dataclasses.replace(get_config(arch, reduced=True),
                                   opt_precision=get_config(arch).opt_precision)
        seq = 24 + (base.n_patches if base.family == "vlm" else 0)
        reduced[arch] = {"opt_precision": base.opt_precision}
        for run, dtype, kernels in (("bf16", "bfloat16", None),
                                    ("bf16_plain_attention", "bfloat16", "ref"),
                                    ("f32", "float32", None)):
            rc = dataclasses.replace(base, dtype=dtype)
            states, losses = {}, {}
            before = kfa.LAUNCHES, kmla.LAUNCHES, kmla.BWD_LAUNCHES
            for dev in ("cuda", "cpu"):
                tr = Trainer(rc, batch=B, seq=seq, lr=A15_LR, seed=0, val_every=1,
                             device=dev, ctx=null_ctx(attn_chunk=min(512, seq),
                                                      remat="none", kernels=kernels))
                # both devices draw the same weights (on the CPU, from seed 0)
                start = {p: t.detach().cpu() for p, t in leaf_paths_of(tr.state["params"])}
                tr.run_steps(1)
                states[dev], losses[dev] = tr.state, tr.metrics_vals[0]
            launches = kfa.LAUNCHES - before[0]
            mla_n = (kmla.LAUNCHES - before[1], kmla.BWD_LAUNCHES - before[2])
            card = dict(leaf_paths_of(states["cuda"]))
            errs, change = {}, {}
            for path, want in leaf_paths_of(states["cpu"]):
                kind = ("['params']" if path.startswith("['params']")
                        else path[:path.index("]", 7) + 1])
                e = _norm_rel(card[path].cpu(), want)
                if e >= errs.get(kind, (0.0, ""))[0]:
                    errs[kind] = (e, path)
                if kind in ("['params']", "['opt']['master']"):
                    # the master copy started as the parameters cast up
                    w0 = start[path.removeprefix(kind)].double()
                    c = _norm_rel(card[path].cpu().double() - w0, want.double() - w0)
                    if c >= change.get(kind, (0.0, ""))[0]:
                        change[kind] = (c, path)
            loss_rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
            reduced[arch][run] = {"loss_rel": loss_rel, "flash_launches": launches,
                                  "mla_launches": mla_n,
                                  "worst_norm_rel": {k: v[0] for k, v in errs.items()},
                                  "worst_leaf": {k: v[1] for k, v in errs.items()},
                                  "worst_change_rel": {k: v[0] for k, v in change.items()},
                                  "worst_change_leaf": {k: v[1] for k, v in change.items()}}
            print(f"  {rc.name} ({rc.opt_precision}) {run}: loss card "
                  f"{losses['cuda']:.6f}, CPU {losses['cpu']:.6f} ({loss_rel:.3g}); "
                  f"card flash launches {launches}, MLA (forward, backward) {mla_n}; "
                  f"worst leaf of each part: "
                  + ", ".join(f"{k} {v[0]:.3g} ({v[1]})" for k, v in errs.items())
                  + "; worst change: "
                  + ", ".join(f"{k} {v[0]:.3g} ({v[1]})" for k, v in change.items()))
            want_fa = 0 if (rc.use_mla or kernels == "ref") else rc.n_layers
            if launches != want_fa:
                bad.append(f"{arch} {run} flash launches {launches} (want {want_fa})")
            want_mla = ((rc.n_layers,) * 2 if rc.use_mla and kernels is None else (0, 0))
            if mla_n != want_mla:
                bad.append(f"{arch} {run} MLA launches {mla_n} (want {want_mla})")
            if run == "bf16_plain_attention":
                continue
            if not loss_rel <= A15_REDUCED_TOL:
                bad.append(f"{arch} {run} loss {loss_rel:.3g}")
            held = [k for k in errs if run == "f32" or k in ("['params']",
                                                               "['opt']['master']")]
            bad += [f"{arch} {run} {errs[k][1]} {errs[k][0]:.3g}" for k in held
                    if not errs[k][0] <= A15_REDUCED_TOL]
            bad += [f"{arch} {run} the change of {v[1]} {v[0]:.3g}"
                    for v in change.values() if not v[0] <= A15_CHANGE_TOL]
    if bad:
        fail(f"the reduced families' step, card against CPU, beyond "
             f"{A15_REDUCED_TOL} (a leaf) or {A15_CHANGE_TOL} (its change): "
             + "; ".join(bad))
    wall = time.perf_counter() - t_all
    print(f"the A15 training phases: {wall:.1f} s of wall")
    out["flash"]["a15_train"] = {"families": fam, "reduced_card_vs_cpu": reduced,
                                 "wall_s": wall}
    return out


def leaf_paths_of(tree):
    """(key string, tensor) of a state's tensor leaves."""
    from repro_torch.checkpoint.checkpointer import leaf_paths
    return [(p, t) for p, t in leaf_paths(tree) if hasattr(t, "numel")]


ELASTIC_ARCH = "qwen1.5-0.5b"    # hf:Qwen/Qwen1.5-0.5B, published width and depth
ELASTIC_BATCH, ELASTIC_SEQ, ELASTIC_STEPS = 2, 256, 4
NOTICE_S = 120.0                 # the spot revocation notice (paper §IV-F)
# deepseek-v2's sharded decode against the decode with no mesh: float32
# logits on the same tokens (and the tokens equal); the MLA sub-block's
# output on the same input, relative to its largest magnitude (bf16: a few
# ulps of 2^-8; a flipped expert choice downstream is no attention error)
ELASTIC_F32_LOGIT_TOL = 1e-4
ELASTIC_ATTN_REL_TOL = {"bfloat16": 2.0 ** -6, "float32": 1e-5}


def elastic_phases(torch) -> dict:
    """The distribution layer on the card: a NCCL process group of one
    (``init_world_of_one``; no gloo fallback, a failure to start fails the
    run) and ``slice_mesh()`` of the one card.

    (a) Algorithm 1's migration at published width: qwen1.5-0.5b trained
    ``ELASTIC_STEPS`` bf16 steps (B = 2 x 256) through the flash kernel,
    saved to a ``LocalObjectStore``, restored through
    ``ElasticTrial.restore_onto(slice_mesh(), ...)``: every leaf equal to
    the saved one, the restore wall and the state bytes beside the 120 s
    notice; a ``Server`` of the migrated parameters generates 32 tokens in
    bf16 and float32, equal to one fed the saved parameters.
    (b) deepseek-v2 (3 of 60 layers, published width) under
    ``Policy(cfg, mesh, "decode")``, whose MLA plan is "distributed" even
    on one card, against the decode with no mesh: every step's logits on
    the same tokens (bf16 within ``SERVE_REL_TOL`` of the largest, float32
    within ``ELASTIC_F32_LOGIT_TOL``), the float32 tokens equal, decode ms
    a token step of both and the all-reduces a step.
    (c) ``int8_allreduce`` over "data" on the attention gradients of (a)'s
    model, bit-equal to ``axis=None``.  Returns the flash rows' fields."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch.distributed as dist
    from repro_torch.checkpoint import LocalObjectStore
    from repro_torch.checkpoint.checkpointer import tree_bytes
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention_cuda as kfa
    from repro_torch.launch.elastic import ElasticTrial, full_state, slice_mesh
    from repro_torch.launch.mesh import init_world_of_one
    from repro_torch.launch.serve import Server
    from repro_torch.launch.sharding import Policy
    from repro_torch.launch.train import Trainer, batch_to
    from repro_torch.models import blocks
    from repro_torch.models.model import Model, _row, tree_leaves, tree_map
    from repro_torch.optim.compression import init_error, int8_allreduce

    t_all = time.perf_counter()
    out = {"flash": {}, "flash_f32": {}}
    phase("the distribution layer: a NCCL group of one, slice_mesh() of the card")
    started = init_world_of_one("cuda")
    print(f"process group: backend {dist.get_backend()}, world {dist.get_world_size()}"
          f" (started here: {started})")
    if "nccl" not in str(dist.get_backend()):
        fail(f"the card's process group runs {dist.get_backend()}, not NCCL")
    mesh = slice_mesh()
    print(f"slice_mesh(): {mesh}")

    # ---------------------------------------- (a) the Algorithm-1 migration
    cfg = get_config(ELASTIC_ARCH)
    phase(f"main path: {ELASTIC_ARCH} trained {ELASTIC_STEPS} bf16 steps (B = "
          f"{ELASTIC_BATCH} x {ELASTIC_SEQ}), saved, restored onto slice_mesh(), "
          f"served from the migrated weights")
    kfa.LAUNCHES = kfa.WGMMA_LAUNCHES = kfa.TF32_LAUNCHES = 0
    t0 = time.perf_counter()
    tr = Trainer(cfg, batch=ELASTIC_BATCH, seq=ELASTIC_SEQ, device="cuda")
    tr.run_steps(ELASTIC_STEPS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = (kfa.LAUNCHES, kfa.WGMMA_LAUNCHES)
    n_bytes = tree_bytes(tr.state)
    print(f"{cfg.name}: d_model {cfg.d_model}, {cfg.n_layers} layers, vocab "
          f"{cfg.vocab_size}, D = {cfg.head_dim}; {ELASTIC_STEPS} steps in "
          f"{train_s:.2f} s (init included), step ms "
          f"{[round(x * 1e3, 2) for x in tr.step_seconds]}; flash launches "
          f"{train_launches[0]}, on the bf16 wgmma route {train_launches[1]} (want "
          f"{ELASTIC_STEPS * cfg.n_layers}); state {n_bytes:,} bytes")
    if train_launches != (ELASTIC_STEPS * cfg.n_layers,) * 2:
        fail(f"training launched flash {train_launches}")
    with tempfile.TemporaryDirectory() as tmp:
        trial = ElasticTrial(cfg, LocalObjectStore(tmp), "trial")
        t0 = time.perf_counter()
        trial.save(tr.step, tr.state)
        save_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, step = trial.restore_onto(mesh, tr.state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    saved, got = tree_leaves(tr.state), tree_leaves(state)
    equal = sum(bool(torch.equal(b.to_local(), a)) if isinstance(a, torch.Tensor)
                else a == b for a, b in zip(saved, got))
    placements = {str(tuple(b.placements)) for b in got if isinstance(b, torch.Tensor)}
    print(f"save {save_s:.2f} s, restore onto {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}"
          f" {restore_s:.2f} s for {n_bytes:,} bytes ({n_bytes / restore_s / 1e9:.2f} "
          f"GB/s), against the {NOTICE_S:.0f} s notice; step {step}; {equal} of "
          f"{len(saved)} leaves equal; placements {sorted(placements)}")
    if step != ELASTIC_STEPS or equal != len(saved) or restore_s > NOTICE_S:
        fail(f"the migration: step {step}, {equal} of {len(saved)} leaves equal, "
             f"restore {restore_s:.2f} s")

    rng = np.random.default_rng(23)
    prompts = {"tokens": rng.integers(0, cfg.vocab_size, (ELASTIC_BATCH, ELASTIC_SEQ))}
    max_len = ELASTIC_SEQ + FAMILY_NEW
    migrated = full_state(state["params"])
    serve = {}
    for dt in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=dt)
        moved, kept = migrated, tr.state["params"]
        if dt == "float32":
            moved, kept = (tree_map(lambda t: t.float(), p) for p in (moved, kept))
        kfa.LAUNCHES = kfa.WGMMA_LAUNCHES = kfa.TF32_LAUNCHES = 0
        t0 = time.perf_counter()
        tok_m = Server(c, moved, max_len=max_len, device="cuda").generate(
            prompts, FAMILY_NEW)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        route = kfa.WGMMA_LAUNCHES if dt == "bfloat16" else kfa.TF32_LAUNCHES
        launches = kfa.LAUNCHES
        tok_k = Server(c, kept, max_len=max_len, device="cuda").generate(
            prompts, FAMILY_NEW)
        same = int((tok_m == tok_k).sum())
        print(f"{dt}: the migrated Server's {tuple(tok_m.shape)} tokens in "
              f"{gen_s * 1e3:.1f} ms, {same} of {tok_m.numel()} equal to the "
              f"un-migrated Server's; flash launches {launches}, on the {dt} route "
              f"{route}")
        if same != tok_m.numel() or not (route > 0 and route == launches):
            fail(f"{dt} serving from the migrated weights: {same} of "
                 f"{tok_m.numel()} tokens equal, flash launches {launches} "
                 f"({route} on the route)")
        serve[dt] = {"tokens_equal": same, "tokens": tok_m.numel(),
                     "flash_launches": launches, "generate_ms": gen_s * 1e3}
        del moved, kept
    out["flash"]["elastic"] = {
        "arch": ELASTIC_ARCH, "train_launches": train_launches[0],
        "serve_launches": serve["bfloat16"]["flash_launches"],
        "state_bytes": n_bytes, "save_s": save_s, "restore_s": restore_s,
        "notice_s": NOTICE_S, "leaves_equal": equal, "leaves": len(saved),
        "tokens_equal": serve["bfloat16"]["tokens_equal"],
        "tokens": serve["bfloat16"]["tokens"]}
    out["flash_f32"]["elastic"] = {
        "serve_launches": serve["float32"]["flash_launches"],
        "tokens_equal": serve["float32"]["tokens_equal"],
        "tokens": serve["float32"]["tokens"]}

    # ---------------------------- (c) int8_allreduce over "data", one card
    phase("int8_allreduce over 'data' against axis=None (the attention "
          "gradients of one qwen1.5-0.5b step)")
    batch = batch_to(tr.data.get_batch(tr.step), "cuda")
    params = tree_map(lambda p: p.detach().requires_grad_(True), tr.state["params"])
    attn = params["layers"]["attn"]
    with torch.enable_grad():
        loss, _ = tr.model.loss(params, batch, tr.ctx)
        grads = torch.autograd.grad(loss, tree_leaves(attn))
    grads = dict(zip(sorted(attn), grads))
    err = init_error(grads)
    mean_d, err_d = int8_allreduce(grads, "data", err, mesh=mesh)
    mean_n, err_n = int8_allreduce(grads, None, err)
    torch.cuda.synchronize()
    bit = all(torch.equal(mean_d[k], mean_n[k]) and torch.equal(err_d[k], err_n[k])
              for k in grads)
    print(f"{len(grads)} leaves ({', '.join(f'{k} {tuple(v.shape)}' for k, v in grads.items())}),"
          f" {sum(v.numel() for v in grads.values()):,} values: means and residuals "
          f"bit-equal {bit}")
    if not bit:
        fail("int8_allreduce over 'data' differs from axis=None on one card")
    out["flash"]["elastic"]["int8_allreduce_bit_equal"] = bit
    del tr, state, migrated, params, grads, mean_d, mean_n, err, err_d, err_n, batch
    torch.cuda.empty_cache()

    # ------------------------------- (b) deepseek-v2's sequence-sharded decode
    arch = "deepseek-v2-236b"
    full = get_config(arch)
    mcfg = dataclasses.replace(full, n_layers=FAMILY_LAYERS[arch])
    phase(f"main path: {arch} ({mcfg.n_layers} of {full.n_layers} layers, published "
          f"width) decoded on slice_mesh() under Policy(cfg, mesh, 'decode'), bf16 "
          f"then float32")
    params = Model(mcfg).init(torch.Generator(device="cuda").manual_seed(0),
                              device="cuda")
    ctx = Policy(mcfg, mesh, "decode").ctx(decode=True, batch=FAMILY_BATCH)
    plan = ctx.decode_plan
    print(f"decode plan {plan}; decode_attn {ctx.decode_attn!r}")
    if plan.mode != "distributed" or not ctx.sharded_decode:
        fail(f"deepseek-v2's plan on one card: {plan}")
    prompts = {"tokens": rng.integers(0, mcfg.vocab_size, (FAMILY_BATCH, FAMILY_PROMPT))}
    dev_tok = torch.as_tensor(prompts["tokens"], device="cuda").long()
    max_len = FAMILY_PROMPT + FAMILY_NEW

    def decode(srv, fed):
        """The prefill, then a decode step on each of ``fed``'s tokens:
        (every step's last-position logits, ms a step, the all-reduces of
        one more step under the profiler and their host ms)."""
        from torch.profiler import ProfilerActivity, profile
        with torch.inference_mode():
            lg, cache = srv.prefill(dev_tok)
            logits = [lg[:, -1].float()]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(fed.shape[1] - 1):
                lg, cache = srv.model.decode_step(srv.params, cache, fed[:, i:i + 1],
                                                  FAMILY_PROMPT + i, srv.ctx)
                logits.append(lg[:, -1].float())
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / (fed.shape[1] - 1) * 1e3
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                srv.model.decode_step(srv.params, cache, fed[:, -1:],
                                      FAMILY_PROMPT + fed.shape[1] - 1, srv.ctx)
                torch.cuda.synchronize()
        ar = [e for e in prof.key_averages() if "allreduce" in e.key.lower()]
        return (torch.stack(logits, 1), ms, sum(e.count for e in ar),
                sum(e.cpu_time_total for e in ar) / 1e3)

    res = {"plan": dataclasses.asdict(plan)}
    for dt in ("bfloat16", "float32"):
        if dt == "float32":
            params_to_float32(params)
            torch.cuda.empty_cache()
        c = dataclasses.replace(mcfg, dtype=dt)
        local = Server(c, params, max_len=max_len, device="cuda")
        shard = Server(c, params, ctx=ctx, max_len=max_len, device="cuda")
        # the sharded MLA sub-block against the local one on the same input,
        # every layer's weights and its prefill cache
        with torch.inference_mode():
            _, cache = local.prefill(dev_tok)
            stacks = (("dense", "dense_layers", mcfg.first_k_dense),
                      ("moe", "moe_layers", mcfg.n_layers - mcfg.first_k_dense))
            caches = [_row(cache[ck], i) for ck, _, n in stacks for i in range(n)]
            layers_p = [_row(params[pk], i) for _, pk, n in stacks for i in range(n)]
            h = torch.randn(FAMILY_BATCH, 1, mcfg.d_model, device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(5))
            h = h.to(getattr(torch, dt))
            attn_err = 0.0
            for lp, lc in zip(layers_p, caches):
                a_l, _ = blocks.attn_decode(h, lp["attn"], c, local.ctx,
                                            tree_map(lambda t: t.clone(), lc), FAMILY_PROMPT)
                a_s, _ = blocks.attn_decode(h, lp["attn"], c, ctx,
                                            tree_map(lambda t: t.clone(), lc), FAMILY_PROMPT)
                attn_err = max(attn_err, ((a_s.float() - a_l.float()).abs().max()
                                          / a_l.float().abs().max()).item())
            del cache, caches
        tok_l = local.generate(prompts, FAMILY_NEW)
        tok_s = shard.generate(prompts, FAMILY_NEW)
        same = int((tok_l == tok_s).sum())
        fed = tok_l.long()
        lg_l, ms_l, ar_l, _ = decode(local, fed)
        lg_s, ms_s, ar_s, ar_ms = decode(shard, fed)
        _, ms_s2, _, _ = decode(shard, fed)
        _, ms_l2, _, _ = decode(local, fed)
        err = (lg_s - lg_l).abs().max().item()
        a_tol = ELASTIC_ATTN_REL_TOL[dt]
        print(f"{dt}: the MLA sub-block on the mesh against no mesh, {mcfg.n_layers} "
              f"layers: max diff {attn_err:.4g} of the largest |output| (tol {a_tol}); "
              f"tokens {same} of {tok_l.numel()} equal; on the same tokens every "
              f"step's logits max abs diff {err:.4g} (max |logit| "
              f"{lg_l.abs().max().item():.4g}); decode ms a token step: no mesh "
              f"{ms_l:.3f} / {ms_l2:.3f}, on the mesh {ms_s:.3f} / {ms_s2:.3f}; "
              f"all-reduces a step {ar_s} (no mesh {ar_l}; 3 a MLA layer), "
              f"{ar_ms:.3f} ms of host time")
        if attn_err > a_tol or (dt == "float32" and not (
                same == tok_l.numel() and err <= ELASTIC_F32_LOGIT_TOL)):
            fail(f"deepseek-v2 {dt} on the mesh: the MLA sub-block {attn_err:.4g} "
                 f"apart, {same} of {tok_l.numel()} tokens equal, logits {err:.4g} "
                 f"apart (float32 tol {ELASTIC_F32_LOGIT_TOL})")
        res[dt] = {"attn_rel_err": attn_err, "attn_rel_tol": a_tol,
                   "tokens_equal": same, "tokens": tok_l.numel(), "logit_err": err,
                   "decode_ms_local": [ms_l, ms_l2], "decode_ms_mesh": [ms_s, ms_s2],
                   "allreduces_per_step": ar_s, "allreduce_host_ms": ar_ms}
        del local, shard
    out["flash"]["elastic"]["deepseek_decode"] = res
    del params
    torch.cuda.empty_cache()
    if started:
        dist.destroy_process_group()
    wall = time.perf_counter() - t_all
    print(f"the distribution layer's phases: {wall:.1f} s of wall")
    out["flash"]["elastic"]["wall_s"] = wall
    return out


TP_STEPS = 3                     # bf16 Trainer steps timed on each path
TP_LOSS_RTOL, TP_GRAD_TOL = 1e-5, 1e-4
TP_LOGIT_TOL = 1e-4
TP_MLA_ARCH, TP_MLA_LAYERS, TP_MLA_BATCH, TP_MLA_PROMPT = "deepseek-v2-236b", 3, 2, 256


def tp_phases(torch) -> dict:
    """The tensor-, sequence- and expert-parallel forward on the card: a
    NCCL group of one under a (1, 1) ("data", "model") mesh, on which every
    rule of ``Policy.ctx`` divides, so the full TP/FSDP set applies
    ("kv" attention, ``ssm_x``, the sequence-sharded ``residual``,
    ``logits_sp``, MoE "ep" with e_start 0).  Parameters, optimizer state
    and batches are DTensors placed by the policy; the flash and SSD-chunk
    kernels run on each rank's local shard under ``local_map``.

    (a) zamba2-1.2b at published width and depth, B = 2 x 512, under
    ``Policy(cfg, mesh, "train", global_batch=2)`` (above 1e9 parameters:
    not DP-only): float32 loss and gradients on the placed state against
    the no-mesh path, both through the kernels with remat "full"; the
    kernels a forward (7 flash, 76 ssd_chunk) and a whole step; then
    ``TP_STEPS`` bf16 ``Trainer`` steps on the mesh and with no mesh (the
    same remat): ms a step, kernels a step, the card's idle share and peak
    memory.  (b) deepseek-v2 at published width, 3 of 60 layers, float32
    prefill of 2 x 256 under ``Policy(cfg, mesh, "prefill")``: MLA on
    DTensors, each MoE layer through the shard_map body ("ep"): the
    last-position logits and each MoE layer's (slot, keep) against the
    no-mesh prefill's.  Returns the flash and ssd rows' fields."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.kernels import flash_attention_cuda as kfa
    from repro_torch.kernels import ssd_chunk_cuda as kss
    from repro_torch.launch.mesh import init_world_of_one, make_small_mesh
    from repro_torch.launch.serve import Server
    from repro_torch.launch.sharding import Policy, place, place_batch
    from repro_torch.launch.train import Trainer, batch_to, loss_and_grads
    from repro_torch.models import moe
    from repro_torch.models.context import null_ctx
    from repro_torch.models.model import Model, tree_leaves

    t_all = time.perf_counter()
    out = {"flash": {}, "flash_f32": {}, "ssd": {}}
    phase("the sharded forward: a NCCL group of one, a (1, 1) (data, model) mesh")
    started = init_world_of_one("cuda")
    if "nccl" not in str(dist.get_backend()):
        fail(f"the card's process group runs {dist.get_backend()}, not NCCL")
    mesh = make_small_mesh((1, 1), device_type="cuda")
    print(f"mesh: {mesh} (started the group here: {started})")

    def counts():      # forward flash and ssd_chunk, then their backward kernels
        return kfa.LAUNCHES, kss.LAUNCHES, kfa.BWD_LAUNCHES, kss.BWD_LAUNCHES

    def since(c0):
        return tuple(a - b for a, b in zip(counts(), c0))

    # ------------------------------------------- (a) zamba2, float32 check
    cfg = get_config(TRAIN_ARCH)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    B, S = TRAIN_BATCH, TRAIN_SEQ
    policy = Policy(cfg32, mesh, "train", global_batch=B)
    ctx = policy.ctx()
    phase(f"main path: {TRAIN_ARCH} (float32, B = {B} x {S}) loss and gradients "
          f"on the placed state under Policy(cfg, mesh, 'train').ctx(), against "
          f"the no-mesh path")
    rules = {k: (v if isinstance(v, str) else tuple(v)) for k, v in ctx.rules.items()}
    print(f"policy: dp_only {policy.dp_only}, rules {rules}, remat {ctx.remat}, "
          f"attn_chunk {ctx.attn_chunk}")
    if policy.dp_only or rules.get("attn_mode") != "kv" or "ssm_x" not in rules:
        fail("zamba2-1.2b's train policy on (1, 1) is not the TP rule set")
    model = Model(cfg32)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    batch = batch_to(SyntheticLMDataset(cfg32, B, S, seed=0).get_batch(0), "cuda")
    placed = place(params, policy.param_shardings(params))
    pbatch = place_batch(batch, policy)
    plain_ctx = null_ctx(remat=ctx.remat, attn_chunk=ctx.attn_chunk)
    want_fwd = (model.n_shared_invocations, cfg.n_layers * -(-S // cfg.ssm_chunk), 0, 0)
    fwd_counts = {}
    for name, p, b, c in (("mesh", placed, pbatch, ctx), ("no mesh", params, batch,
                                                          plain_ctx)):
        c0 = counts()
        with torch.no_grad():
            model.loss(p, b, c)
        torch.cuda.synchronize()
        fwd_counts[name] = since(c0)
    results = {}
    for name, p, b, c in (("mesh", placed, pbatch, ctx), ("no mesh", params, batch,
                                                          plain_ctx)):
        torch.cuda.synchronize()
        c0, t0 = counts(), time.perf_counter()
        loss, _, grads = loss_and_grads(model, p, b, c)
        torch.cuda.synchronize()
        results[name] = (loss, grads, since(c0), (time.perf_counter() - t0) * 1e3)
    loss_m, grads_m, step_counts_m, ms_m = results["mesh"]
    loss_p, grads_p, step_counts_p, ms_p = results["no mesh"]
    loss_m = float(loss_m.full_tensor())
    loss_p = float(loss_p)
    names = leaf_names(params)
    errs = [((g.full_tensor() - g0).abs().max() / g0.abs().max().clamp_min(1e-30)).item()
            for g, g0 in zip(tree_leaves(grads_m), tree_leaves(grads_p))]
    worst = max(range(len(errs)), key=errs.__getitem__)
    loss_rel = abs(loss_m - loss_p) / abs(loss_p)
    print(f"loss on the mesh {loss_m:.7f}, no mesh {loss_p:.7f}: relative "
          f"{loss_rel:.3g} (tol {TP_LOSS_RTOL}); worst gradient leaf "
          f"{names[worst]} {errs[worst]:.3g} of its largest (tol {TP_GRAD_TOL}), "
          f"{len(errs)} leaves")
    print(f"launches (flash, ssd_chunk, flash_attention_bwd, ssd_chunk_bwd): a forward "
          f"{fwd_counts['mesh']} on the mesh, "
          f"{fwd_counts['no mesh']} with no mesh (want {want_fwd}); a loss and its "
          f"gradients under remat 'full' (the forward recomputed in the backward) "
          f"{step_counts_m} on the mesh, {step_counts_p} with no mesh; wall "
          f"{ms_m:.1f} / {ms_p:.1f} ms")
    if fwd_counts["mesh"] != want_fwd or fwd_counts["no mesh"] != want_fwd \
            or step_counts_m != step_counts_p or step_counts_m[2:] != want_fwd[:2]:
        fail("the sharded path did not launch the kernels the no-mesh path does, or "
             "not one backward kernel call a forward one")
    if not (loss_rel <= TP_LOSS_RTOL and errs[worst] <= TP_GRAD_TOL):
        fail(f"float32 sharded training: loss {loss_rel:.3g} relative, worst leaf "
             f"{names[worst]} {errs[worst]:.3g}")
    out["flash_f32"]["tp"] = {
        "arch": cfg.name, "batch": B, "seq": S, "mesh": [1, 1],
        "launches_per_forward": fwd_counts["mesh"][0],
        "launches_per_loss_and_grads": step_counts_m[0],
        "loss_rel": loss_rel, "worst_leaf": names[worst], "worst_leaf_err": errs[worst],
        "loss_and_grads_ms": ms_m, "loss_and_grads_ms_no_mesh": ms_p}
    out["ssd"]["tp"] = {"launches_per_forward": fwd_counts["mesh"][1],
                        "launches_per_loss_and_grads": step_counts_m[1],
                        "bwd_launches_per_loss_and_grads": step_counts_m[3]}
    del params, placed, grads_m, grads_p, results
    torch.cuda.empty_cache()

    # ------------------------------------- (a) bf16 Trainer steps, timed
    phase(f"main path: {TRAIN_ARCH} ({cfg.dtype}, float32 master) {TP_STEPS} "
          f"Trainer steps on the mesh and with no mesh (remat 'full' both)")

    def trainer_numbers(tr):
        tr.run_steps(1)                                    # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        c0 = counts()
        tr.run_steps(TP_STEPS)
        n = since(c0)
        ms = [x * 1e3 for x in tr.step_seconds[-TP_STEPS:]]
        peak = torch.cuda.max_memory_allocated() / 1e9
        seen, walls = [], []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: seen.extend(device_intervals(p))) as prof:
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr.run_steps(1)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                prof.step()
        busy = busy_us(seen) / 1e6
        return {"ms": ms, "ms_step": sum(ms) / len(ms), "peak_gb": peak,
                "flash_per_step": n[0] / TP_STEPS, "ssd_per_step": n[1] / TP_STEPS,
                "flash_bwd_per_step": n[2] / TP_STEPS, "ssd_bwd_per_step": n[3] / TP_STEPS,
                "kernels_per_step": len(seen), "idle": 1 - busy / walls[-1],
                "profiled_wall_ms": walls[-1] * 1e3, "losses": list(tr.metrics_vals)}

    steps = {}
    for name in ("mesh", "no mesh"):
        tctx = (Policy(cfg, mesh, "train", global_batch=B).ctx() if name == "mesh"
                else null_ctx(remat="full", attn_chunk=ctx.attn_chunk))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()      # before the Trainer: not its step's
        tr = Trainer(cfg, batch=B, seq=S, lr=TRAIN_LR, val_every=1, ctx=tctx,
                     device="cuda")
        if name == "mesh" and not isinstance(tree_leaves(tr.state)[0], DTensor):
            fail("the Trainer on a mesh did not place its state")
        steps[name] = trainer_numbers(tr)
        steps[name]["base_gb"] = base / 1e9
        del tr
        torch.cuda.empty_cache()
    for name, r in steps.items():
        print(f"{name}: step ms {[round(x, 1) for x in r['ms']]}, {r['ms_step']:.2f} "
              f"ms a step; kernels a step {r['kernels_per_step']} (profiled), flash "
              f"{r['flash_per_step']:g}, ssd_chunk {r['ssd_per_step']:g} (backward "
              f"kernels {r['flash_bwd_per_step']:g}, {r['ssd_bwd_per_step']:g}); card idle "
              f"{100 * r['idle']:.2f}% of a profiled step ({r['profiled_wall_ms']:.1f} "
              f"ms); peak {r['peak_gb']:.2f} GB ({r['base_gb']:.2f} GB allocated "
              f"before the Trainer); losses "
              f"{[round(x, 5) for x in r['losses']]}")
    m, p = steps["mesh"], steps["no mesh"]
    print(f"DTensor dispatch on a group of one: {m['ms_step'] - p['ms_step']:+.2f} ms a "
          f"step ({m['ms_step'] / p['ms_step']:.2f}x), "
          f"{m['kernels_per_step'] - p['kernels_per_step']:+d} kernels a step")
    if not all(math.isfinite(x) for r in steps.values() for x in r["losses"]):
        fail("bf16 Trainer losses not finite")
    launched = ("flash_per_step", "ssd_per_step", "flash_bwd_per_step", "ssd_bwd_per_step")
    if [m[k] for k in launched] != [p[k] for k in launched] or min(m[k] for k in launched) <= 0:
        fail("the sharded bf16 step launched other kernels than the no-mesh step")
    out["flash"]["tp"] = {"arch": cfg.name, "batch": B, "seq": S, "steps": steps,
                          "launches_per_step": m["flash_per_step"]}
    out["ssd"]["tp"]["launches_per_bf16_step"] = m["ssd_per_step"]

    # ------------------------------- (b) deepseek-v2, MLA + the "ep" body
    full = get_config(TP_MLA_ARCH)
    mcfg = dataclasses.replace(full, n_layers=TP_MLA_LAYERS, dtype="float32")
    phase(f"main path: {TP_MLA_ARCH} ({TP_MLA_LAYERS} of {full.n_layers} layers, "
          f"float32) prefill of {TP_MLA_BATCH} x {TP_MLA_PROMPT} under "
          f"Policy(cfg, mesh, 'prefill').ctx(), against the no-mesh prefill")
    mpolicy = Policy(mcfg, mesh, "prefill")
    mctx = mpolicy.ctx()
    print(f"policy: dp_only {mpolicy.dp_only}, MoE strategy {moe._strategy(mcfg, mctx)}")
    if mpolicy.dp_only or moe._strategy(mcfg, mctx) != "ep":
        fail("deepseek-v2's prefill policy on (1, 1) is not the TP / 'ep' set")
    t0 = time.perf_counter()
    mparams = Model(mcfg).init(torch.Generator(device="cuda").manual_seed(0),
                               device="cuda")
    torch.cuda.synchronize()
    print(f"{sum(t.numel() for t in tree_leaves(mparams)):,} parameters (float32), "
          f"init {time.perf_counter() - t0:.2f} s")
    tokens = torch.as_tensor(np.random.default_rng(5).integers(
        0, mcfg.vocab_size, (TP_MLA_BATCH, TP_MLA_PROMPT)), device="cuda")
    seen = {}
    real = moe._dispatch_indices

    def recording(idx, e_start, e_count, capacity):
        slot, keep = real(idx, e_start, e_count, capacity)
        seen.setdefault(key, []).append((slot.clone(), keep.clone(), e_start, capacity))
        return slot, keep

    moe._dispatch_indices = recording
    pre = {}
    try:
        for key, c in (("mesh", mctx), ("no mesh", None)):
            srv = Server(mcfg, mparams, ctx=c, max_len=TP_MLA_PROMPT, device="cuda")
            srv.prefill(tokens)                               # warm-up
            seen.pop(key, None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = srv.prefill(tokens)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            pre[key] = (logits.full_tensor() if key == "mesh" else logits, ms)
            del srv
    finally:
        moe._dispatch_indices = real
    lerr = (pre["mesh"][0] - pre["no mesh"][0]).abs().max().item()
    n_moe = mcfg.n_layers - mcfg.first_k_dense
    same = (len(seen["mesh"]) == len(seen["no mesh"]) == n_moe and all(
        torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and a[2:] == b[2:]
        for a, b in zip(seen["mesh"], seen["no mesh"])))
    drops = [int((~k).sum()) for _, k, _, _ in seen["mesh"]]
    print(f"last-position logits: max abs diff {lerr:.3g} (tol {TP_LOGIT_TOL}); "
          f"{n_moe} MoE layers, (slot, keep) equal: {same} (e_start "
          f"{[a[2] for a in seen['mesh']]}, capacity {[a[3] for a in seen['mesh']]}, "
          f"dropped {drops}); prefill {pre['mesh'][1]:.1f} ms on the mesh, "
          f"{pre['no mesh'][1]:.1f} ms with no mesh")
    if not (lerr <= TP_LOGIT_TOL and same):
        fail("deepseek-v2's sharded prefill differs from the no-mesh prefill")
    out["flash"]["tp_mla"] = {"arch": full.name, "layers": TP_MLA_LAYERS,
                              "logit_err": lerr, "slot_keep_equal": same,
                              "prefill_ms": pre["mesh"][1],
                              "prefill_ms_no_mesh": pre["no mesh"][1]}
    del mparams
    torch.cuda.empty_cache()
    if started:
        dist.destroy_process_group()
    wall = time.perf_counter() - t_all
    print(f"the sharded forward's phases: {wall:.1f} s of wall")
    out["flash"]["tp"]["wall_s"] = wall
    return out


# new tokens a generate: cut from 32 / 64 / 64 to keep the two phases
# under 90 s (each generate is host-bound, ~40-75 ms a token step)
MESH_DECODE = (("zamba2-1.2b", 16), ("whisper-base", 32), ("mamba2-130m", 32))
MESH_DECODE_BATCH, MESH_DECODE_PROMPT = 2, 256
# float32: the last step's logits on the same tokens, of their largest
MESH_DECODE_F32_TOL = 1e-5
# bf16: one sub-block's output on the same input and cache (the mamba
# mixer's decode; whisper's decoder block), relative to its largest
# magnitude: a few ulps of 2^-8, as the MLA sub-block's in elastic_phases
MESH_DECODE_BF16_TOL = 2.0 ** -6
# the dry run's predicted peak against the measured one (PERF.md §6)
DRYRUN_PEAK_BAND = (0.8, 1.25)
# MLA's chunked attention against its naive version (float32): the forward
# of its largest magnitude, each gradient of its largest
MLA_CHUNK_S, MLA_CHUNK_B = 2048, 2
MLA_CHUNK_FWD_TOL, MLA_CHUNK_GRAD_TOL = 1e-5, 1e-4


def mla_chunked_phase(torch) -> dict:
    """deepseek-v2's absorbed attention (128 query heads on one shared key
    head 576 wide and value head 512 wide, causal, float32) at S = 2048, B
    = 2: the chunked route the model takes (``attention.plain_attention``
    over two 1024-key chunks, the JAX package's flash VJP) against
    ``naive_attention`` on the same inputs, forward and the q, k and v
    gradients, with each path's peak memory and CUDA-events ms of a
    forward and backward."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import mla

    phase("MLA's chunked attention against its naive version (deepseek-v2's "
          "absorbed shapes, float32)")
    t0 = time.perf_counter()
    cfg = get_config("deepseek-v2-236b")
    H, R, qr = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    B, S, chunk, scale = MLA_CHUNK_B, MLA_CHUNK_S, 1024, mla._scale(cfg)
    gen = torch.Generator(device="cuda").manual_seed(11)
    q0 = torch.randn(B, S, 1, H, R + qr, device="cuda", generator=gen)
    k0 = torch.randn(B, S, 1, R + qr, device="cuda", generator=gen)
    v0 = k0[..., :R].clone()
    do = torch.randn(B, S, 1, H, R, device="cuda", generator=gen)
    paths = {
        "chunked": lambda q, k, v: attn_lib.plain_attention(q, k, v, True, chunk,
                                                            scale=scale),
        "naive": lambda q, k, v: attn_lib.naive_attention(q, k, v, True, scale=scale)}
    res, got = {}, {}
    for name, fn in paths.items():
        q, k, v = (t.clone().requires_grad_(True) for t in (q0, k0, v0))

        def run():
            o = fn(q, k, v)
            return (o,) + torch.autograd.grad(o, (q, k, v), do)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got[name] = run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ms = cuda_ms(run, iters=5, warmup=1)
        res[name] = {"peak_gb": peak / 1e9, "ms": ms}
    errs = {}
    for i, what in enumerate(("o", "dq", "dk", "dv")):
        a, b = got["chunked"][i], got["naive"][i]
        errs[what] = ((a - b).abs().max() / b.abs().max()).item()
    ok = (errs["o"] <= MLA_CHUNK_FWD_TOL
          and max(errs["dq"], errs["dk"], errs["dv"]) <= MLA_CHUNK_GRAD_TOL)
    print(f"(B, S, H, Dk, Dv) = {(B, S, H, R + qr, R)}, causal, {S // chunk} key "
          f"chunks of {chunk}: chunked against naive, of the largest: forward "
          f"{errs['o']:.3g} (tol {MLA_CHUNK_FWD_TOL}), dq {errs['dq']:.3g}, dk "
          f"{errs['dk']:.3g}, dv {errs['dv']:.3g} (tol {MLA_CHUNK_GRAD_TOL}); "
          f"forward + backward: chunked {res['chunked']['ms']:.2f} ms, peak "
          f"{res['chunked']['peak_gb']:.3f} GB; naive {res['naive']['ms']:.2f} ms, "
          f"peak {res['naive']['peak_gb']:.3f} GB (max_memory_allocated above the "
          f"inputs)")
    if not ok:
        fail(f"MLA's chunked attention differs from the naive one: {errs}")
    del got
    torch.cuda.empty_cache()
    res.update({"errors": errs, "wall_s": time.perf_counter() - t0,
                "shape": {"B": B, "S": S, "H": H, "Dk": R + qr, "Dv": R,
                          "chunk": chunk}})
    print(f"the chunked MLA phase: {res['wall_s']:.1f} s")
    return res


def attribute_decode(torch, c, params, local, srv, dev_tok, fr, fed, S) -> dict:
    """Where the mesh decode (``srv``) parts from the no-mesh one
    (``local``): every cache leaf after the prefill, then each decode step
    fed the same token on both paths, the hidden state after each layer
    (the outputs of ``blocks.block_decode``, ``mamba_decode`` and
    ``dec_block_decode`` in the order the model calls them) until the
    first difference; there, the layer rerun on the same input and cache
    (a copy of the no-mesh path's from before the step) on both paths,
    part by part, names the op."""
    from repro_torch.checkpoint.checkpointer import leaf_paths
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import blocks, layers
    from repro_torch.models.model import _row, tree_map

    def clone(tree):
        return tree_map(lambda t: t.clone(), tree)

    with torch.inference_mode():
        _, c0 = local.prefill(dev_tok, fr)
        _, c1 = srv.prefill(dev_tok, fr)
    mesh_leaves = dict(leaf_paths(c1))
    leaf = {p: (t.float() - mesh_leaves[p].float()).abs().max().item()
            for p, t in leaf_paths(c0)}
    differ = {p: d for p, d in leaf.items() if d > 0}
    print(f"  attribution: after the prefill {len(differ)} of {len(leaf)} cache leaves "
          f"differ{'' if not differ else ': ' + str(differ)}")
    names = ("block_decode", "mamba_decode", "dec_block_decode")
    real = {n: getattr(blocks, n) for n in names}
    found = None
    try:
        for i in range(fed.shape[1] - 1):
            before = clone(c0)
            rec = {}
            for key, path_srv, cache in (("local", local, c0), ("mesh", srv, c1)):
                seen = rec[key] = []

                def wrap(n):
                    def f(x, *a, **k):
                        y = real[n](x, *a, **k)
                        seen.append((n, x.clone(), y[0].clone()))
                        return y
                    return f
                for n in names:
                    setattr(blocks, n, wrap(n))
                with torch.inference_mode():
                    path_srv.model.decode_step(path_srv.params, cache, fed[:, i:i + 1],
                                               S + i, path_srv.ctx)
                for n in names:
                    setattr(blocks, n, real[n])
            count = {}
            for (n, x0, y0), (_, x1, y1) in zip(rec["local"], rec["mesh"]):
                j = count[n] = count.get(n, -1) + 1
                d = (y0.float() - y1.float()).abs().max().item()
                if d > 0:
                    found = {"step": i, "layer": f"{n} #{j}", "hidden_diff": d,
                             "input_diff": (x0.float() - x1.float()).abs().max().item(),
                             "x": x0, "cache": before}
                    break
            if found:
                break
    finally:
        for n in names:
            setattr(blocks, n, real[n])
    if found is None:
        print(f"  attribution: no layer's output differs over "
              f"{fed.shape[1] - 1} decode steps")
        return {"cache_leaves_differ": len(differ), "first": None}
    n, j = found["layer"].split(" #")
    j = int(j)
    ops = {}
    x, pos = found["x"], S + found["step"]
    if n == "block_decode" and c.family == "hybrid":
        p, cache = params["shared_block"], _row(found["cache"]["attn"], j)
        with torch.inference_mode():
            h = layers.rms_norm(x, p["ln1"], c.norm_eps)
            a = [blocks.attn_decode(h, p["attn"], c, ctx, clone(cache), pos)[0]
                 for ctx in (local.ctx, srv.ctx)]
            ops["blocks.attn_decode"] = (a[0].float() - a[1].float()).abs().max().item()
            # its attention op on one q and cache: the softmax before the
            # product against the flash-decode combine
            B = x.shape[0]
            q, kn, vn = attn_lib.qkv_project(h, p["attn"], c, torch.full(
                (B, 1), pos, dtype=torch.int64, device=x.device))
            kc = attn_lib.cache_update(clone(cache), kn, vn, pos)
            plan = srv.ctx.decode_plan
            seq = tuple(plan.seq_axes)
            o0 = attn_lib.decode_attention(q, kc, pos)
            o1 = attn_lib.distributed_decode_attention(
                q, kc["k"], kc["v"], pos, srv.ctx.groups.group(seq) if seq else None, 0,
                scale=c.head_dim ** -0.5)
            ops["attention.decode_attention vs distributed_decode_attention"] = (
                (o0.float() - o1.float()).abs().max().item())
            x2 = x + a[0]
            h2 = layers.rms_norm(x2, p["ln2"], c.norm_eps)
            m = [blocks._mlp_decode(h2, p["mlp"], c.gated_mlp, ctx, c.d_ff)
                 for ctx in (local.ctx, srv.ctx)]
            ops["blocks._mlp_decode"] = (m[0].float() - m[1].float()).abs().max().item()
    first = {k: v for k, v in found.items() if k not in ("x", "cache")}
    print(f"  attribution: the first difference at decode step {first['step']}, "
          f"after {first['layer']}: the hidden state {first['hidden_diff']:.4g} apart "
          f"(its input {first['input_diff']:.4g}); that layer's parts on the same "
          f"input and cache: {ops or 'not broken down'}")
    return {"cache_leaves_differ": len(differ), "first": first, "ops": ops}




def mesh_decode_phases(torch) -> dict:
    """The ssm, hybrid and audio decode caches on a mesh: a NCCL group of
    one under a (1, 1) ("data", "model") mesh; zamba2-1.2b, whisper-base
    and mamba2-130m at published width and depth (random weights from a
    seed), 2 x 256 prompts (whisper with its frames), served by
    ``Server.generate`` under ``Policy(cfg, mesh, "decode").ctx(decode=True,
    batch=B)`` ("local") and ``ctx(decode=True, batch=None)``
    ("distributed": the sequence, and whisper's cross cache, over "data"),
    against the no-mesh ``generate``, bf16 then float32 (the weights cast
    in place).  float32: tokens N of N equal and the last step's logits on
    the same tokens within ``MESH_DECODE_F32_TOL`` of their largest; bf16:
    one sub-block's output on the same input and cache within
    ``MESH_DECODE_BF16_TOL`` of its largest, the tokens printed.  The
    prefill's flash and ssd_chunk launches equal on both paths, and
    ``generate`` under a prefill policy's ctx gives the no-mesh tokens
    (float32)."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention_cuda as kfa
    from repro_torch.kernels import ssd_chunk_cuda as kss
    from repro_torch.launch.mesh import init_world_of_one, make_small_mesh
    from repro_torch.launch.serve import Server
    from repro_torch.launch.sharding import Policy
    from repro_torch.models import blocks, ssd
    from repro_torch.models.model import Model, _row, tree_map

    t_all = time.perf_counter()
    phase("the ssm, hybrid and audio decode on a mesh: a NCCL group of one, a "
          "(1, 1) (data, model) mesh")
    started = init_world_of_one("cuda")
    mesh = make_small_mesh((1, 1), device_type="cuda")
    B, S = MESH_DECODE_BATCH, MESH_DECODE_PROMPT
    out = {}

    def counts():
        return kfa.LAUNCHES, kss.LAUNCHES

    for arch, new in MESH_DECODE:
        cfg = get_config(arch)
        phase(f"main path: {arch} (published width and depth) served on the mesh, "
              f"{B} x {S} prompts, {new} tokens, bf16 then float32")
        t0 = time.perf_counter()
        params = Model(cfg).init(torch.Generator(device="cuda").manual_seed(0),
                                 device="cuda")
        tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (B, S))
        dev_tok = torch.as_tensor(tokens, device="cuda").long()
        frames = (torch.randn(B, cfg.enc_seq_len, cfg.d_model, device="cuda",
                              generator=torch.Generator(device="cuda").manual_seed(7))
                  * 0.02 if cfg.family == "audio" else None)
        max_len = S + new
        res = {}
        for dt in ("bfloat16", "float32"):
            if dt == "float32":
                params_to_float32(params)
                torch.cuda.empty_cache()
            c = dataclasses.replace(cfg, dtype=dt)
            fr = None if frames is None else frames.to(getattr(torch, dt))
            batch = {"tokens": tokens, "frames": fr}
            local = Server(c, params, max_len=max_len, device="cuda")
            c0 = counts()
            with torch.inference_mode():
                _, cache = local.prefill(dev_tok, fr)
            n_local = tuple(b - a for a, b in zip(c0, counts()))
            t1 = time.perf_counter()
            tok0 = local.generate(batch, new)
            torch.cuda.synchronize()
            gen_ms = (time.perf_counter() - t1) * 1e3
            fed = tok0.long()
            lg0 = _replay_last(torch, local, dev_tok, fr, fed, S)
            # layer 0's mixer (ssm, hybrid) or decoder block (audio), and its cache
            if cfg.family == "audio":
                lp, lc = _row(params["dec_layers"], 0), _row(cache, 0)
            else:
                key = "layers" if cfg.family == "ssm" else "mamba_layers"
                lp = _row(params[key], 0)["mixer"]
                lc = _row(cache if cfg.family == "ssm" else cache["mamba"], 0)
            h = (torch.randn(B, 1, cfg.d_model, device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(5))
                 .to(getattr(torch, dt)))

            def sub_block(ctx):
                with torch.inference_mode():
                    lcc = tree_map(lambda t: t.clone(), lc)
                    if cfg.family == "audio":
                        return blocks.dec_block_decode(h, lp, c, ctx, lcc, S)[0].float()
                    return ssd.mamba_decode(h, lp, c, lcc, ctx)[0].float()

            a_local = sub_block(local.ctx)
            # zamba2: also its shared attention block (layer 0's cache), whose
            # decode on the mesh is the flash-decode combine
            attn_c = _row(cache["attn"], 0) if cfg.family == "hybrid" else None

            def attn_block(ctx):
                with torch.inference_mode():
                    lcc = tree_map(lambda t: t.clone(), attn_c)
                    return blocks.attn_decode(h, params["shared_block"]["attn"], c, ctx,
                                              lcc, S)[0].float()

            at_local = attn_block(local.ctx) if attn_c is not None else None
            row = {"prefill_launches_no_mesh": n_local, "generate_ms_no_mesh": gen_ms}
            for mode, batch_arg in (("local", B), ("distributed", None)):
                ctx = Policy(c, mesh, "decode").ctx(decode=True, batch=batch_arg)
                if ctx.decode_plan.mode != mode or not ctx.sharded_decode:
                    fail(f"{arch}: the decode plan {ctx.decode_plan} is not '{mode}'")
                srv = Server(c, params, ctx=ctx, max_len=max_len, device="cuda")
                c0 = counts()
                with torch.inference_mode():
                    srv.prefill(dev_tok, fr)
                n_mesh = tuple(b - a for a, b in zip(c0, counts()))
                t1 = time.perf_counter()
                tok = srv.generate(batch, new)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t1) * 1e3
                same = int((tok == tok0).sum())
                lg = _replay_last(torch, srv, dev_tok, fr, fed, S)
                lerr = ((lg - lg0).abs().max() / lg0.abs().max()).item()
                a_mesh = sub_block(ctx)     # (1, 1): the shard is the whole cache
                serr = ((a_mesh - a_local).abs().max() / a_local.abs().max()).item()
                aerr = (((attn_block(ctx) - at_local).abs().max()
                         / at_local.abs().max()).item() if attn_c is not None else 0.0)
                print(f"{dt} {mode} plan {ctx.decode_plan}: tokens {same} of "
                      f"{tok0.numel()} equal; last logits on the same tokens "
                      f"{lerr:.3g} of their largest; the {'decoder block' if cfg.family == 'audio' else 'mamba mixer'} "
                      f"on the same input {serr:.3g} of its largest, the shared "
                      f"attention block {aerr:.3g} (bf16 tol "
                      f"{MESH_DECODE_BF16_TOL:.4g}); prefill launches (flash, "
                      f"ssd_chunk) {n_mesh} against {n_local} with no mesh; generate "
                      f"{ms:.1f} ms against {gen_ms:.1f}")
                attr = None
                if dt == "bfloat16":
                    print(f"  bf16 tokens on the mesh {tok[0, :16].tolist()} ..., no "
                          f"mesh {tok0[0, :16].tolist()} ...")
                    attr = attribute_decode(torch, c, params, local, srv, dev_tok, fr,
                                            fed, S)
                if n_mesh != n_local:
                    fail(f"{arch} {dt} {mode}: the mesh prefill launched {n_mesh}, "
                         f"the no-mesh one {n_local}")
                if dt == "float32" and not (same == tok0.numel()
                                            and lerr <= MESH_DECODE_F32_TOL):
                    fail(f"{arch} float32 {mode}: {same} of {tok0.numel()} tokens "
                         f"equal, last logits {lerr:.3g} apart")
                if dt == "bfloat16" and not max(serr, aerr) <= MESH_DECODE_BF16_TOL:
                    fail(f"{arch} bf16 {mode}: a sub-block {max(serr, aerr):.3g} apart")
                row[mode] = {"plan": dataclasses.asdict(ctx.decode_plan),
                             "tokens_equal": same, "tokens": tok0.numel(),
                             "last_logit_rel_err": lerr, "sub_block_rel_err": serr,
                             "attn_block_rel_err": aerr,
                             "prefill_launches": n_mesh, "generate_ms": ms,
                             "attribution": attr}
                del srv
            pre = Server(c, params, ctx=Policy(c, mesh, "prefill").ctx(),
                         max_len=max_len, device="cuda")
            tok_p = pre.generate(batch, new)
            same_p = int((tok_p == tok0).sum())
            print(f"{dt}: generate under a prefill policy's ctx: tokens {same_p} of "
                  f"{tok0.numel()} equal to the no-mesh ones")
            if dt == "float32" and same_p != tok0.numel():
                fail(f"{arch}: generate under the prefill ctx differs from no mesh")
            row["prefill_ctx_tokens_equal"] = same_p
            res[dt] = row
            del pre, local, cache, lc, lp, attn_c
            torch.cuda.empty_cache()
        out[arch] = res
        del params
        torch.cuda.empty_cache()
        print(f"{arch}: {time.perf_counter() - t0:.1f} s")
    if started:
        dist.destroy_process_group()
    wall = time.perf_counter() - t_all
    print(f"the mesh decode phases: {wall:.1f} s of wall")
    out["wall_s"] = wall
    return out


def _replay_last(torch, srv, dev_tok, frames, fed, prompt):
    """The prefill and a decode step on each of ``fed``'s tokens but the
    last, on ``srv``'s path: the last step's last-position logits, float32."""
    with torch.inference_mode():
        lg, cache = srv.prefill(dev_tok, frames)
        for i in range(fed.shape[1] - 1):
            lg, cache = srv.model.decode_step(srv.params, cache, fed[:, i:i + 1],
                                              prompt + i, srv.ctx)
        return lg[:, -1].float()


def mesh_train_step(torch) -> dict:
    """The bf16 zamba2-1.2b ``Trainer`` step on the (1, 1) mesh as
    ``tp_phases`` runs it (for ``--only a12``): one warm-up step, then one
    step measured: its peak above the memory allocated before the Trainer
    was built, its ms and its kernel launches."""
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention_cuda as kfa
    from repro_torch.kernels import ssd_chunk_cuda as kss
    from repro_torch.launch.mesh import init_world_of_one, make_small_mesh
    from repro_torch.launch.sharding import Policy
    from repro_torch.launch.train import Trainer

    started = init_world_of_one("cuda")
    mesh = make_small_mesh((1, 1), device_type="cuda")
    cfg = get_config(TRAIN_ARCH)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    tr = Trainer(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR, val_every=1,
                 ctx=Policy(cfg, mesh, "train", global_batch=TRAIN_BATCH).ctx(),
                 device="cuda")
    tr.run_steps(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c0 = kfa.LAUNCHES, kss.LAUNCHES, kfa.BWD_LAUNCHES, kss.BWD_LAUNCHES
    tr.run_steps(1)
    torch.cuda.synchronize()
    r = {"peak_gb": torch.cuda.max_memory_allocated() / 1e9, "base_gb": base / 1e9,
         "ms_step": tr.step_seconds[-1] * 1e3,
         "flash_per_step": kfa.LAUNCHES - c0[0], "ssd_per_step": kss.LAUNCHES - c0[1],
         "flash_bwd_per_step": kfa.BWD_LAUNCHES - c0[2],
         "ssd_bwd_per_step": kss.BWD_LAUNCHES - c0[3]}
    del tr
    torch.cuda.empty_cache()
    if started:
        dist.destroy_process_group()
    return r


def dryrun_child() -> None:
    """The port's dry run of the train cell ``tp_phases`` runs for real
    (zamba2-1.2b, bf16 with a float32 master, B = 2 x 512, ``Policy(cfg,
    mesh, "train", global_batch=2)``) on a fake (1, 1) world of its own, in
    this process: prints the artifact and the kernel operators' calls as
    one JSON line."""
    import torch.distributed as dist
    from repro_torch.launch.dryrun import trace_cell, trace_device_type
    from repro_torch.launch.mesh import init_fake_world, make_small_mesh

    init_fake_world(1)
    try:
        mesh = make_small_mesh((1, 1), device_type=trace_device_type())
        t0 = time.perf_counter()
        art, counter = trace_cell(TRAIN_ARCH, "train_4k", mesh,
                                  global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)
        ops = {n: counter.launches(n)
               for n in ("flash_attention", "flash_attention_lse", "ssd_chunk",
                         "flash_attention_bwd", "ssd_chunk_bwd")}
        print(json.dumps({"artifact": art, "ops": ops, "device": mesh.device_type,
                          "wall_s": time.perf_counter() - t0}))
    finally:
        dist.destroy_process_group()


def start_dryrun_child():
    """Start ``dryrun_child`` in a process of its own (the fake world needs
    the default process group to itself); it traces on the host while the
    card runs the mesh decode."""
    import tempfile
    code = (f"import sys; sys.path[:0] = [{str(SRC)!r}, {str(ROOT)!r}]; "
            f"import chip_smoke; chip_smoke.dryrun_child()")
    # files, not pipes: nobody reads a pipe while the card's phases run
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=out, stderr=err,
                            text=True, cwd=str(ROOT))
    return proc, out, err, time.perf_counter()


def dryrun_phase(torch, measured: dict, child) -> dict:
    """The dry run against the card: the port's ``trace_cell`` of the
    zamba2-1.2b train step in the child ``start_dryrun_child`` started.
    Its flash and ssd_chunk operators and their backwards' must equal the
    launches the card counted for the step (``measured``:
    ``tp_phases``' mesh Trainer, or ``mesh_train_step``), and its
    predicted per-device peak must fall within ``DRYRUN_PEAK_BAND`` of the
    step's measured peak above the memory allocated before its Trainer.
    Printed, not gated: the cell's roofline row at the H100's rates beside
    the measured ms a step."""
    from repro_torch.launch.roofline import H100_RATES, analyze

    phase(f"the dry run: {TRAIN_ARCH}'s train step (B = {TRAIN_BATCH} x {TRAIN_SEQ}) "
          f"traced on a fake (1, 1) world, against the card")
    proc, out, err, t0 = child
    try:
        proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail("the dry run's child did not end within 600 s")
    wall = time.perf_counter() - t0
    out.seek(0)
    err.seek(0)
    stdout, stderr = out.read(), err.read()
    if proc.returncode != 0:
        print(stdout[-4000:])
        print(stderr[-4000:], file=sys.stderr)
        fail(f"the dry run's child exited {proc.returncode}")
    res = json.loads(stdout.strip().splitlines()[-1])
    art, ops = res["artifact"], res["ops"]
    flash = ops["flash_attention"] + ops["flash_attention_lse"]
    pred_gb = art["memory"]["peak_memory_in_bytes"] / 1e9
    step_gb = measured["peak_gb"] - measured["base_gb"]
    ratio = pred_gb / step_gb
    row = analyze(art, H100_RATES)
    print(f"traced on fake {res['device']} tensors in {res['wall_s']:.1f} s (the "
          f"child's wall {wall:.1f} s, beside the mesh decode): operators flash {flash} ({ops}), ssd_chunk "
          f"{ops['ssd_chunk']}, flash_attention_bwd {ops['flash_attention_bwd']}, "
          f"ssd_chunk_bwd {ops['ssd_chunk_bwd']}; the card counted "
          f"{measured['flash_per_step']:g}, {measured['ssd_per_step']:g}, "
          f"{measured['flash_bwd_per_step']:g} and {measured['ssd_bwd_per_step']:g} a step")
    print(f"peak: predicted {pred_gb:.3f} GB ({art['memory']}); measured "
          f"{measured['peak_gb']:.3f} GB, of which {measured['base_gb']:.3f} GB "
          f"allocated before the Trainer: the step's {step_gb:.3f} GB; ratio "
          f"{ratio:.3f} (band {DRYRUN_PEAK_BAND})")
    print(f"roofline at the H100's rates {H100_RATES}: compute "
          f"{row['t_compute_s'] * 1e3:.3f} ms, memory {row['t_memory_s'] * 1e3:.3f} ms, "
          f"collective {row['t_collective_s'] * 1e3:.3f} ms, dominant {row['dominant']}; "
          f"FLOPs {art['hlo_flops_per_device']:.4e}, bytes "
          f"{art['hlo_bytes_per_device']:.4e}; the measured step "
          f"{measured['ms_step']:.1f} ms")
    traced = (flash, ops["ssd_chunk"], ops["flash_attention_bwd"], ops["ssd_chunk_bwd"])
    card = (measured["flash_per_step"], measured["ssd_per_step"],
            measured["flash_bwd_per_step"], measured["ssd_bwd_per_step"])
    if traced != card:
        fail(f"the traced step's operators (flash, ssd_chunk and their backwards) "
             f"{traced} differ from the card's launches {card}")
    if not DRYRUN_PEAK_BAND[0] <= ratio <= DRYRUN_PEAK_BAND[1]:
        fail(f"the predicted peak is {ratio:.3f}x the measured one")
    return {"flash_ops": flash, "ssd_ops": ops["ssd_chunk"],
            "flash_bwd_ops": ops["flash_attention_bwd"], "ssd_bwd_ops": ops["ssd_chunk_bwd"],
            "predicted_peak_gb": pred_gb,
            "measured_step_peak_gb": step_gb, "peak_ratio": ratio,
            "roofline_ms": {k: row[k] * 1e3 for k in ("t_compute_s", "t_memory_s",
                                                       "t_collective_s")},
            "measured_ms_step": measured["ms_step"], "trace_s": res["wall_s"],
            "wall_s": wall}


def main() -> None:
    only = sys.argv[2] if len(sys.argv) == 3 and sys.argv[1] == "--only" else None
    if sys.argv[1:] and only not in ("elastic", "tp", "a12", "a15"):
        fail(f"arguments {sys.argv[1:]}: none, --only elastic, --only tp, "
             "--only a12 or --only a15")
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
    if only is not None:
        # the distribution layer's, the sharded forward's, the mesh
        # decode's and the dry run's, or the families' training phases
        # alone, after the build
        if only == "a15":
            gen = torch.Generator().manual_seed(22)
            alone = {"mla_kernels": mla_kernel_phase(torch, FAMILY_BATCH, FAMILY_PROMPT, gen),
                     "mla_materialized": mla_materialized_phase(torch, FAMILY_BATCH,
                                                                FAMILY_PROMPT, gen),
                     "flash_dv": flash_dv_timing_phase(torch, gen),
                     **family_train_phases(torch)}
        elif only == "a12":
            measured = mesh_train_step(torch)
            child = start_dryrun_child()
            alone = {"mesh_decode": mesh_decode_phases(torch),
                     "dryrun": dryrun_phase(torch, measured, child),
                     "mla_chunked": mla_chunked_phase(torch)}
        else:
            alone = elastic_phases(torch) if only == "elastic" else tp_phases(torch)
        print(smi)
        print(json.dumps(alone))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return

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
    # the model's training path next: it needs the card's memory to itself
    train = model_train_phases(torch)
    bwd_rows = train.pop("rows")
    flash_row.update(train["flash"])
    flash_f32_row.update(train["flash_f32"])
    ssd_row.update(train["ssd"])
    # the training backend's slice last: whisper-base and real-training trials
    trials = trial_phases(torch)
    flash_row.update(trials["flash"])
    flash_f32_row.update(trials["flash_f32"])
    ssd_row.update(trials["ssd"])
    # the last model families after them: each model has the card to itself
    families = family_phases(torch)
    flash_row.update(families["flash"])
    flash_f32_row.update(families["flash_f32"])
    mla_rows = families["mla"]
    # their training at published width next, with the card to itself
    a15 = family_train_phases(torch)
    flash_row.update(a15["flash"])
    flash_f32_row.update(a15["flash_f32"])
    step = a15["mla"]["a15_step"]
    dv_rows = families["flash_dv"]
    mat_step = a15["mla"]["a15_materialized_step"]
    dv_rows["fwd"]["launches"] = mat_step["flash_launches"]
    dv_rows["bwd"]["launches"] = mat_step["flash_bwd_launches"]
    for row in dv_rows.values():
        row["paths"] = ("deepseek-v2's A15 bf16 step with MLA's materialized form "
                        "(launches a step); one a layer in its full-width forward check")
    mla_rows["fwd"]["launches_per_a15_step"] = step["mla_launches_per_step"]
    mla_rows["bwd"]["launches"] = step["mla_bwd_launches_per_step"]
    mla_rows["bwd"]["paths"] = ("deepseek-v2's A15 bf16 Trainer step (launches a step); "
                                "the forward row's launches are its 3-layer prefill's")
    # the distribution layer: a NCCL group of one over the card
    elastic = elastic_phases(torch)
    flash_row.update(elastic["flash"])
    flash_f32_row.update(elastic["flash_f32"])
    # the sharded forward last, on its own group of one
    tp = tp_phases(torch)
    flash_row.update(tp["flash"])
    flash_f32_row.update(tp["flash_f32"])
    ssd_row.update(tp["ssd"])
    # the ssm, hybrid and audio decode on the mesh, then the dry run held
    # against the sharded step tp_phases measured
    child = start_dryrun_child()
    mesh_decode = mesh_decode_phases(torch)
    flash_row["mesh_decode_prefill_launches"] = {
        a: r["float32"]["local"]["prefill_launches"][0]
        for a, r in mesh_decode.items() if a != "wall_s"}
    ssd_row["mesh_decode_prefill_launches"] = {
        a: r["float32"]["local"]["prefill_launches"][1]
        for a, r in mesh_decode.items() if a != "wall_s"}
    dry = dryrun_phase(torch, tp["flash"]["tp"]["steps"]["mesh"], child)
    mla_chunked_phase(torch)
    flash_row["dryrun_ops"] = dry["flash_ops"]
    ssd_row["dryrun_ops"] = dry["ssd_ops"]
    bwd_rows[0]["dryrun_ops"] = dry["flash_bwd_ops"]
    bwd_rows[1]["dryrun_ops"] = dry["ssd_bwd_ops"]
    print(f"the whole script: {time.perf_counter() - T_START:.1f} s")
    print(smi)
    print(json.dumps({"kernels": [lstm_row, stack_row, fwd_train_row, bwd_row,
                                  soa_row, flash_row, flash_f32_row, ssd_row,
                                  *bwd_rows, mla_rows["fwd"], mla_rows["bwd"],
                                  dv_rows["fwd"], dv_rows["bwd"]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
