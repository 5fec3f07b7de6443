"""The SSD chunk's backward of one or more checkouts, checked and timed in turns.

    python tools/ssd_bwd_variants.py OLD . . OLD

Each argument is a checkout of the repository (such as a ``git archive`` of
a commit, or a copy with a design variant, unpacked under ``build/``); each
runs in a process of its own, in the order given, so that variants are
compared on one card in turns.  Each process builds that checkout's kernels
and prints one JSON line:

* ``ptxas``: the registers and spills ptxas reported for
  ``ssd_chunk_bwd.cu`` (N <= 64);
* for the SSD backward (``ssd_chunk_bwd_cuda``) at zamba2-1.2b's chunk (B=2,
  Q=256, H=64, P=N=64, B and C of head stride 0), at N = 128 (1, 200, 4,
  64, 128) and at a ragged chunk of unaligned rows (2, 100, 3, 16, 8): the
  largest error of its six gradients against the plain backward (of each
  gradient's largest magnitude), whether a second call repeats the first
  bitwise, and at zamba2's chunk three CUDA-events timings of 50 calls
  (microseconds a call);
* the float32 flash-attention backward and forward at zamba2-1.2b's shape
  (B=2, S=512, H=32, D=64, causal): the backward's error and both timings.

It needs a CUDA card.  ``tools/bwd_kernel_timing.py`` times both backwards
at every training shape beside their bounds, plain versions and SDPA.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path


def _events_us(torch, fn, reps=3, iters=50, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    out = []
    for _ in range(reps):
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / iters * 1e3)
    return out


def _rel(got, want) -> float:
    return max(((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want))


def measure(root: str) -> dict:
    sys.path.insert(0, str(Path(root).resolve() / "src"))
    import torch
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention_cuda as kfa
    from repro_torch.kernels import ssd_chunk_cuda as kss
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    build.build_all()
    log = build.BUILD_LOG.get("ssd_chunk_bwd", "")
    res = {"root": root, "ptxas": [ln.strip() for ln in log.splitlines()
                                   if "registers" in ln or "spill" in ln][-4:]}
    gen = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).cuda()

    for B, Q, H, P, N, stride0 in [(2, 256, 64, 64, 64, True), (1, 200, 4, 64, 128, True),
                                   (2, 100, 3, 16, 8, False)]:
        x, dy = randn(B, Q, H, P), randn(B, Q, H, P)
        dt = (torch.rand(B, Q, H, generator=gen) * 0.099 + 0.001).cuda()
        A = -(torch.rand(H, generator=gen) * 1.5 + 0.5).cuda()
        if stride0:
            Bm, Cm = (randn(B, Q, 1, N).expand(B, Q, H, N) for _ in range(2))
        else:
            Bm, Cm = randn(B, Q, H, N), randn(B, Q, H, N)
        args = (x, dt, A, Bm, Cm, randn(B, H, P, N), dy, randn(B, H, P, N))
        got = kss.ssd_chunk_bwd_cuda(*args)
        again = kss.ssd_chunk_bwd_cuda(*args)
        want = ref.ssd_chunk_bwd(*args)
        torch.cuda.synchronize()
        case = {"err": _rel(got, want),
                "bitwise": all(torch.equal(a, b) for a, b in zip(got, again))}
        if Q == 256:
            case["us"] = _events_us(torch, lambda: kss.ssd_chunk_bwd_cuda(*args))
        res[f"ssd {B},{Q},{H},{P},{N}"] = case

    q, k, v, do = (randn(2, 512, 32, 64) for _ in range(4))
    _, lse = kfa.flash_attention_lse_cuda(q, k, v, True)
    got = kfa.flash_attention_bwd_cuda(q, k, v, lse, do, True)
    want = ref.flash_attention_bwd(q, k, v, lse, do, True, None, 512)
    res["flash f32 bwd"] = {"err": _rel(got, want), "us": _events_us(
        torch, lambda: kfa.flash_attention_bwd_cuda(q, k, v, lse, do, True))}
    with torch.no_grad():
        res["flash f32 fwd"] = {"us": _events_us(
            torch, lambda: kfa.flash_attention_cuda(q, k, v, True))}
    return res


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(measure(sys.argv[2])))
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for root in sys.argv[1:] or ["."]:
        proc = subprocess.run([sys.executable, __file__, "--one", root], capture_output=True,
                              text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-5000:], file=sys.stderr)
            raise SystemExit(f"{root} failed")
        print(proc.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
