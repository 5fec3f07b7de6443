"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
nvcc, holds each kernel against its plain PyTorch version on the card, runs
the SpotTune tuning loop (12-day market, 16 trials, theta=0.7, mcnt=3) with a
RevPred whose LSTM cell is the CUDA kernel, repeats the run on the CPU
through the plain versions and compares the two, and times the kernel.
Every phase is fatal on failure.  The last line of standard output is

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


def device_us_per_call(fn, iters: int = 200):
    """Mean microseconds of card time per call (kernels only, launch gaps
    excluded), from a torch.profiler trace; None if the trace has no device
    events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(20):
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
    print(smi)
    row = {
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
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
