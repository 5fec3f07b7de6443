"""Card times of the backward kernels, for one or more checkouts in turn.

    python tools/bwd_kernel_timing.py                      # this checkout
    python tools/bwd_kernel_timing.py --root OLD --root . --root . --root OLD

Each ``--root`` (a checkout of the repository, such as a ``git archive`` of
an earlier commit unpacked into ``build/``) runs in a process of its own, in
the order given, so that two versions are compared on one card in turns.
Each process builds that checkout's kernels and times, at the training
path's shapes:

* the flash-attention backward (``flash_attention_bwd_cuda``) in bf16 at
  zamba2-1.2b's (B=2, S=512, H=32, D=64, causal), pixtral-12b's (B=2,
  S=1280, H=32, D=128, causal) and whisper-base's encoder (B=2, S=1500,
  H=8, D=64, not causal) shapes, and in float32 at those three and at
  phi3-mini's head dimension (B=2, S=256, H=32, D=96, causal);
* the SSD chunk's backward (``ssd_chunk_bwd_cuda``) at zamba2-1.2b's chunk
  (B=2, Q=256, H=64, P=N=64, B and C of head stride 0);
* MLA's absorbed attention, forward (``mla_attention_cuda``) and backward
  (``mla_attention_bwd_cuda``), at deepseek-v2's training shape (B=2,
  S=256, 128 query heads on one key head Dk=576 and one value head Dv=512,
  causal, scale 192^-0.5), bf16 and float32;
* with ``--only flash_fwd``: the flash-attention forward
  (``flash_attention_cuda``) at the flash backward's seven shapes, beside
  its bound (``flash_bound_ms``), its plain version and SDPA's forward;

each as card time a call (torch.profiler, the kernels' launches only) and
CUDA-events milliseconds a call, beside its bound (the checkout's
``flash_bwd_bound_ms`` / ``ssd_bwd_bound_ms`` / ``mla_bound_ms`` /
``mla_bwd_bound_ms``), the plain version's card time and, for attention,
``scaled_dot_product_attention`` (its backward by ``torch.autograd.grad``;
for MLA with ``enable_gqa``), which no path of the port calls.  The card
time of a call is built from the launches the profiler saw: per kernel name
the mean time of a launch seen, times the name's launches a call (those
seen over the calls issued, rounded, at least 1); MLA's rows also give it
per kernel name (``*_by_name``), and the CUDA-events time gives a row its
number where the profiler saw no launch.  With no ``--only`` it times
flash, ssd and mla; ``--only`` takes any of flash, ssd, mla and flash_fwd;
for MLA, ``--dtype float32`` (or ``bfloat16``) one type and
``--kernels-only`` the kernels alone (no plain version, no SDPA: the quick
way to time ablation copies, ``tools/mla_probe.py copy``).

It prints the card's name and power limit, one JSON line per checkout and a
table with one column per run.  It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# name: (B, S, H, D, causal, dtype)
FLASH = {"zamba2 bf16": (2, 512, 32, 64, True, "bfloat16"),
         "pixtral bf16": (2, 1280, 32, 128, True, "bfloat16"),
         "whisper-enc bf16": (2, 1500, 8, 64, False, "bfloat16"),
         "zamba2 f32": (2, 512, 32, 64, True, "float32"),
         "whisper-enc f32": (2, 1500, 8, 64, False, "float32"),
         "pixtral f32": (2, 1280, 32, 128, True, "float32"),
         "phi3 f32": (2, 256, 32, 96, True, "float32")}
SSD = (2, 256, 64, 64, 64)     # B, Q, H, P, N
# deepseek-v2's MLA attention at its training shape: B, S, H, Dk, Dv, scale
MLA = (2, 256, 128, 576, 512, 192 ** -0.5)
PARTS = ("flash", "ssd", "mla", "flash_fwd")
DEFAULT_PARTS = ("flash", "ssd", "mla")      # what a run with no --only times


def _card_by_name(torch, fn, iters=20, warmup=5):
    """Card time a call by kernel name (µs): the mean time of a launch the
    profiler saw, times the name's launches a call (seen over the calls
    issued, rounded, at least 1); {} if it saw none."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    seen = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, t = seen.get(e.name, (0, 0.0))
            seen[e.name] = (n + 1, t + e.time_range.end - e.time_range.start)
    return {name: t / n * max(1, round(n / iters)) for name, (n, t) in seen.items()}


def _card_us(torch, fn, iters=20, warmup=5):
    """Card time a call: the sum over the kernel names the profiler saw."""
    by = _card_by_name(torch, fn, iters, warmup)
    return sum(by.values()) if by else None


def _events_ms(torch, fn, iters=50, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _mla(torch, F, randn, out, dtypes=("bfloat16", "float32"), reference=True):
    """MLA's forward and backward rows at deepseek-v2's training shape."""
    from repro_torch.kernels import mla_attention_cuda as kmla
    B, S, H, Dk, Dv, scale = MLA
    for dt in dtypes:
        dtype = getattr(torch, dt)
        q, kk, vv, do = (randn(B, S, H, Dk, dtype=dtype), randn(B, S, Dk, dtype=dtype),
                         randn(B, S, Dv, dtype=dtype), randn(B, S, H, Dv, dtype=dtype))
        _, lse = kmla.mla_attention_lse_cuda(q, kk, vv, True, scale)
        qt, kt, vt = (t.detach().requires_grad_(True)
                      for t in (q.transpose(1, 2), kk[:, None], vv[:, None]))
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, scale=scale,
                                            enable_gqa=True)
        dot = do.transpose(1, 2)
        eb = q.element_size()
        calls = {
            "fwd": (lambda: kmla.mla_attention_cuda(q, kk, vv, True, scale),
                    lambda: kmla.mla_fwd_lse_ref(q, kk, vv, True, scale),
                    lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                           scale=scale, enable_gqa=True),
                    kmla.mla_bound_ms(B, S, S, H, Dk, Dv, True, eb)),
            "bwd": (lambda: kmla.mla_attention_bwd_cuda(q, kk, vv, lse, do, True, scale),
                    lambda: kmla.mla_bwd_ref(q, kk, vv, lse, do, True, scale),
                    lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True),
                    kmla.mla_bwd_bound_ms(B, S, S, H, Dk, Dv, True, eb))}
        for d, (kern, plain, sdpa, (bound, by)) in calls.items():
            names = _card_by_name(torch, kern)
            out[f"mla {d} {'bf16' if eb == 2 else 'f32'}"] = {
                "card_us": sum(names.values()) if names else None,
                "card_us_by_name": names, "ms": _events_ms(torch, kern),
                "plain_card_us": _card_us(torch, plain, iters=3, warmup=1) if reference else None,
                "sdpa_card_us": _card_us(torch, sdpa, iters=5, warmup=2) if reference else None,
                "bound_us": bound * 1e3, "bound_by": by}
        del q, kk, vv, do, lse, qt, kt, vt, ot, dot
        torch.cuda.empty_cache()


def measure(root: Path, parts=DEFAULT_PARTS, dtypes=("bfloat16", "float32"),
            reference=True) -> dict:
    """Every number of one checkout (run in its own process)."""
    sys.path.insert(0, str(root / "src"))
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention_cuda as kfa
    from repro_torch.kernels import ssd_chunk_cuda as kss
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    out = {"root": str(root), "device": torch.cuda.get_device_name(0)}
    gen = torch.Generator().manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to("cuda", dtype)

    if "mla" in parts:
        _mla(torch, F, randn, out, dtypes, reference)
    for name, (B, S, H, D, causal, dt) in FLASH.items():
        if "flash_fwd" not in parts:
            break
        dtype = getattr(torch, dt)
        q, k, v = (randn(B, S, H, D, dtype=dtype) for _ in range(3))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        bound, by = kfa.flash_bound_ms(B, S, S, H, D, causal, q.element_size())
        out[name + " fwd"] = {
            "card_us": _card_us(torch, lambda: kfa.flash_attention_cuda(q, k, v, causal)),
            "ms": _events_ms(torch, lambda: kfa.flash_attention_cuda(q, k, v, causal)),
            "plain_card_us": _card_us(
                torch, lambda: ref.flash_attention_fwd_lse(q, k, v, causal, None, S),
                iters=5, warmup=2) if reference else None,
            "sdpa_card_us": _card_us(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal), iters=10, warmup=3) if reference else None,
            "bound_us": bound * 1e3, "bound_by": by}
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    for name, (B, S, H, D, causal, dt) in FLASH.items():
        if "flash" not in parts:
            break
        dtype = getattr(torch, dt)
        q, k, v, do = (randn(B, S, H, D, dtype=dtype) for _ in range(4))
        _, lse = kfa.flash_attention_lse_cuda(q, k, v, causal)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        dot = do.transpose(1, 2)

        def kern():
            return kfa.flash_attention_bwd_cuda(q, k, v, lse, do, causal)

        def plain():
            return ref.flash_attention_bwd(q, k, v, lse, do, causal, None, S)

        def sdpa():
            return torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)

        bound, by = kfa.flash_bwd_bound_ms(B, S, S, H, D, causal, q.element_size())
        out[name] = {"card_us": _card_us(torch, kern), "ms": _events_ms(torch, kern),
                     "plain_card_us": _card_us(torch, plain, iters=5, warmup=2),
                     "sdpa_card_us": _card_us(torch, sdpa, iters=10, warmup=3),
                     "bound_us": bound * 1e3, "bound_by": by}
        del q, k, v, do, lse, qt, kt, vt, ot, dot
        torch.cuda.empty_cache()

    if "ssd" not in parts:
        return out
    B, Q, H, P, N = SSD
    x, dy = randn(B, Q, H, P), randn(B, Q, H, P)
    dt_ = (torch.rand(B, Q, H, generator=gen) * 0.099 + 0.001).cuda()
    A = -(torch.rand(H, generator=gen) * 1.5 + 0.5).cuda()
    Bm, Cm = (randn(B, Q, 1, N).expand(B, Q, H, N) for _ in range(2))
    st, dst = randn(B, H, P, N), randn(B, H, P, N)
    args = (x, dt_, A, Bm, Cm, st, dy, dst)
    bound, by = kss.ssd_bwd_bound_ms(B, Q, H, P, N, 1)
    out["ssd zamba2"] = {
        "card_us": _card_us(torch, lambda: kss.ssd_chunk_bwd_cuda(*args)),
        "ms": _events_ms(torch, lambda: kss.ssd_chunk_bwd_cuda(*args)),
        "plain_card_us": _card_us(torch, lambda: ref.ssd_chunk_bwd(*args), iters=5, warmup=2),
        "sdpa_card_us": None, "bound_us": bound * 1e3, "bound_by": by}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", action="append", help="checkout to time (repeatable)")
    ap.add_argument("--only", default=",".join(DEFAULT_PARTS),
                    help="comma-separated subset of " + ",".join(PARTS))
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    help="MLA: time this type alone")
    ap.add_argument("--kernels-only", action="store_true",
                    help="MLA: no plain version and no SDPA")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    parts = tuple(args.only.split(","))
    if set(parts) - set(PARTS):
        raise SystemExit(f"--only takes {','.join(PARTS)}, not {args.only}")
    dtypes = (args.dtype,) if args.dtype else ("bfloat16", "float32")
    if args.one:
        print(json.dumps(measure(Path(args.one).resolve(), parts, dtypes,
                                 not args.kernels_only)))
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    runs = []
    for root in args.root or [str(ROOT)]:
        flags = (["--dtype", args.dtype] if args.dtype else []) + (
            ["--kernels-only"] if args.kernels_only else [])
        proc = subprocess.run([sys.executable, __file__, "--one", root, "--only",
                               args.only, *flags], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            raise SystemExit(f"timing {root} failed")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    print("run: " + " | ".join(Path(r["root"]).name or r["root"] for r in runs))
    for name in [n for n in runs[0] if isinstance(runs[0][n], dict)]:
        for key in ("card_us", "ms", "plain_card_us", "sdpa_card_us", "bound_us"):
            vals = []
            for r in runs:
                v = r[name][key]
                vals.append("none" if v is None else f"{v:.4f}")
            print(f"{name + ' ' + key:36s} " + " | ".join(vals))
        for kname in sorted({k for r in runs for k in r[name].get("card_us_by_name", {})}):
            vals = [r[name]["card_us_by_name"].get(kname) for r in runs]
            print(f"  {kname[:60]:60s} " + " | ".join(
                "none" if v is None else f"{v:.4f}" for v in vals))
    print(smi)


if __name__ == "__main__":
    main()
