"""Card times and accuracy of the float32 flash-attention route.

    python tools/flash_f32_timing.py                      # this checkout
    python tools/flash_f32_timing.py --root OLD --root . --root . --root OLD
    python tools/flash_f32_timing.py --variants           # design choices
    python tools/flash_f32_timing.py --scores             # large scores
    python tools/flash_f32_timing.py --ssd-rounding       # ssd_chunk's rounding

Each ``--root`` (a checkout of the repository, such as a ``git archive`` of
an earlier commit unpacked into ``build/``) runs in a process of its own, in
the order given, so that two versions are compared on one card in turns.
It builds that checkout's kernels and times float32 ``flash_attention_cuda``
(causal) at zamba2-1.2b's prefill shape (B=4, S=512, H=32, D=64) and
phi3-mini-3.8b's (B=2, S=256, H=32, D=96): CUDA-events microseconds per
call, card microseconds per launch (torch.profiler, over the launches it
saw) and the max abs error against ``ref.flash_attention_ref``, beside
``scaled_dot_product_attention`` in float32 on the same inputs.

``--variants`` compiles text edits of this checkout's
``csrc/flash_attention.cu`` into ``build/flash_variants/`` and times them in
turns with the kernel as it is: ``cvt`` rounds to TF32 with the conversion
instruction (``cvt.rna.tf32.f32``) instead of integer operations; ``one
warpgroup`` gives every block one consumer warpgroup (64 q rows) at every
head dim, ``one warpgroup, producer warpgroups`` also a warpgroup of
producers a ring at D <= 64; ``two warpgroups at D = 96`` gives D = 96 two
consumer warpgroups and one V stage; ``consumer alone`` (the producers load
and store nothing) and ``producers alone`` (the consumer issues no product)
say which side sets the time, their outputs wrong.

``--ssd-rounding`` times ``ssd_chunk`` at zamba2-1.2b's chunk with its TF32
rounding as it is (the conversion instruction) and by integer operations,
in turns, and checks that both give the same bits.

``--scores`` prints, for q scaled by 1, 4, 8, 16 and 30 (D = 64, 96, 128,
S = 333, causal and not, two seeds), the float32 contract's allclose ratio
max |x - exact| / (3e-5 + 3e-5 |exact|) (above 1 misses it) of the kernel
and of the float32 plain version, exact being the plain formula in float64
on the card.

It prints the card's name and power limit.  It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"zamba2": (4, 512, 32, 64), "phi3": (2, 256, 32, 96)}
SCALES = (1.0, 4.0, 8.0, 16.0, 30.0)


def _events_us(torch, fn, iters=200, warmup=20):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters * 1e3


def _card_us(torch, fn, iters=50):
    """(card us per call from the launches seen, launches seen): a traced
    step whose events are discarded first, then ``iters`` calls; per kernel
    name the mean launch times its launches per call."""
    from torch.profiler import ProfilerActivity, profile, schedule
    seen = []

    def keep(p):
        seen.extend((e.name, e.time_range.end - e.time_range.start) for e in p.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)
                    and not e.name.startswith("ProfilerStep"))   # the step's span

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=keep) as prof:
        for _ in range(2):
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            prof.step()
    by = {}
    for nm, t in seen:
        n, s = by.get(nm, (0, 0.0))
        by[nm] = (n + 1, s + t)
    if not by:
        return None, 0
    return (sum(s / n * max(1, round(n / iters)) for n, s in by.values()),
            sum(n for n, _ in by.values()))


def _inputs(torch, B, S, H, D, seed, q_scale=1.0):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(B, S, H, D, generator=gen) * q_scale
    k, v = (torch.randn(B, S, H, D, generator=gen) for _ in range(2))
    return q.cuda(), k.cuda(), v.cuda()


def measure(root: Path) -> dict:
    """The times of one checkout (run in its own process)."""
    sys.path.insert(0, str(root / "src"))
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention_cuda as kfa
    build.build_all()
    out = {"root": str(root), "device": torch.cuda.get_device_name(0)}
    for name, (B, S, H, D) in SHAPES.items():
        q, k, v = _inputs(torch, B, S, H, D, seed=1)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def kern():
            return kfa.flash_attention_cuda(q, k, v, True)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

        card, seen = _card_us(torch, kern)
        lib_card, lib_seen = _card_us(torch, sdpa)
        out[name] = {"events_us": _events_us(torch, kern), "card_us": card,
                     "launches_seen": seen, "sdpa_events_us": _events_us(torch, sdpa),
                     "sdpa_card_us": lib_card, "sdpa_launches_seen": lib_seen,
                     "calls": 50,
                     "err": (kern() - ref.flash_attention_ref(q, k, v, True)).abs().max().item()}
    return out


# ------------------------------------------------------------------ variants

def _variants(csrc: Path) -> dict:
    """{name: flash_attention.cu} text edits of the source."""
    fa = (csrc / "flash_attention.cu").read_text()

    def edit(text, old, new):
        if old not in text:
            raise SystemExit(f"variant edit does not apply: {old[:60]!r}")
        return text.replace(old, new)

    cvt = fa.replace("Round::bits", "Round::cvt")
    wg = "  static constexpr int WG = D <= 64 ? 2 : 1;"
    prod = "  static constexpr int PROD = 64;"
    vst = "  static constexpr int VST = D <= 96 ? 2 : 1;"
    one = edit(fa, wg, "  static constexpr int WG = 1;")
    one_wide = edit(one, prod, "  static constexpr int PROD = D <= 64 ? 128 : 64;")
    two96 = edit(edit(fa, wg, "  static constexpr int WG = D <= 96 ? 2 : 1;"), vst,
                 "  static constexpr int VST = D <= 64 ? 2 : 1;")
    # where the time goes (wrong outputs): the producers skip their loads
    # and stores (the consumer alone), the consumer issues no product (the
    # producers alone)
    alone = fa
    for call in ("kt.load(kb", "kt.store(slot", "vt.load(vb", "vt.store(slot"):
        alone = edit(alone, call, "if (0) " + call)
    idle = edit(edit(fa, "    mma3_ss_n64(sc, q_hi, q_lo, k_hi, k_hi + C::QT, C::KS, BN);\n", ""),
                "    mma3_pv<C::DN>(oacc, ph, pl, v_hi, v_hi + C::VT);\n", "")
    return {"as is": fa, "cvt": cvt, "one warpgroup": one,
            "one warpgroup, producer warpgroups": one_wide,
            "two warpgroups at D = 96": two96,
            "consumer alone": alone, "producers alone": idle}


def variants() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention_cuda as kfa
    out_dir = ROOT / "build" / "flash_variants"
    procs = {}
    csrc = ROOT / "src/repro_torch/kernels/csrc"
    for name, fa in _variants(csrc).items():
        d = out_dir / "".join(c if c.isalnum() else "_" for c in name)
        d.mkdir(parents=True, exist_ok=True)
        (d / "flash_attention.cu").write_text(fa)
        (d / "hopper.cuh").write_text((csrc / "hopper.cuh").read_text())
        procs[name] = (subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "flash_attention.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), d)
    fns = {}
    for name, (proc, d) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} did not build:\n{log}")
        fn = ctypes.CDLL(str(d / "lib.so")).flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 17
                       + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    stream = torch.cuda.current_stream().cuda_stream
    for shape, (B, S, H, D) in SHAPES.items():
        q, k, v = _inputs(torch, B, S, H, D, seed=1)
        o = torch.empty_like(q)
        strides = [s for t in (q, k, v, o) for s in kfa.tma_strides(t)]
        want = ref.flash_attention_ref(q, k, v, True)
        res = {}
        order = list(fns.items())
        for name, fn in order + order[::-1]:
            def call(fn=fn):
                if fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, S, H, D,
                      *strides, D ** -0.5, 1, 0, q.device.index, stream) != 0:
                    raise SystemExit(f"variant {name} failed to launch")
            res.setdefault(name, []).append(round(_events_us(torch, call, iters=100), 2))
            call()
            res[name + " err"] = (o - want).abs().max().item()
        print(f"{shape} (B,S,H,D) = {(B, S, H, D)} f32 causal, CUDA-events us per "
              f"call in turns: {json.dumps(res)}", flush=True)


def ssd_rounding() -> None:
    """ssd_chunk at zamba2-1.2b's chunk with its TF32 rounding as it is (the
    conversion instruction) and by integer operations, in turns."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd_chunk_cuda as kss
    csrc = ROOT / "src/repro_torch/kernels/csrc"
    d = ROOT / "build" / "flash_variants" / "ssd_bits"
    d.mkdir(parents=True, exist_ok=True)
    (d / "ssd_chunk.cu").write_text((csrc / "ssd_chunk.cu").read_text())
    (d / "hopper.cuh").write_text((csrc / "hopper.cuh").read_text().replace(
        "Round RND = Round::cvt", "Round RND = Round::bits"))
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
                           str(d / "ssd_chunk.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"the ssd variant did not build:\n{proc.stdout}{proc.stderr}")
    kss._fn()
    fns = {"as is": kss._FN, "bits": ctypes.CDLL(str(d / "lib.so")).ssd_chunk_fwd}
    fns["bits"].argtypes, fns["bits"].restype = kss._FN.argtypes, kss._FN.restype
    gen = torch.Generator().manual_seed(3)
    B, Q, H, P, N = 4, 256, 64, 64, 64
    x = torch.randn(B, Q, H, P, generator=gen).cuda()
    dt = (torch.rand(B, Q, H, generator=gen) * 0.099 + 0.001).cuda()
    A = -(torch.rand(H, generator=gen) * 1.5 + 0.5).cuda()
    Bm, Cm = (torch.randn(B, Q, 1, N, generator=gen).cuda().expand(B, Q, H, N)
              for _ in range(2))
    st = torch.randn(B, H, P, N, generator=gen).cuda()
    res, outs = {}, {}
    for name in ("as is", "bits", "bits", "as is"):
        kss._FN = fns[name]
        res.setdefault(name, []).append(round(_events_us(
            torch, lambda: kss.ssd_chunk_cuda(x, dt, A, Bm, Cm, st)), 2))
        outs[name] = kss.ssd_chunk_cuda(x, dt, A, Bm, Cm, st)
    kss._FN = fns["as is"]
    same = all(torch.equal(a, b) for a, b in zip(outs["as is"], outs["bits"]))
    print(f"ssd_chunk (B,Q,H,P,N) = {(B, Q, H, P, N)}, B/C head stride 0, CUDA-events "
          f"us per call in turns: {json.dumps(res)}; outputs bit-equal: {same}", flush=True)


# -------------------------------------------------------------------- scores

def scores() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import flash_attention_cuda as kfa

    def exact(q, k, v, causal):
        q, k, v = q.double(), k.double(), v.double()
        Sq, Sk, D = q.shape[1], k.shape[1], q.shape[-1]
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * D ** -0.5
        if causal:
            keep = (torch.arange(Sq, device=q.device)[:, None]
                    >= torch.arange(Sk, device=q.device)[None, :])
            s = torch.where(keep, s, torch.full((), -1e30, dtype=s.dtype, device=s.device))
        return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)

    def ratio(x, t):
        return ((x.double() - t).abs() / (3e-5 + 3e-5 * t.abs())).max().item()

    for scale in SCALES:
        for D in (64, 96, 128):
            kr, pr, kp = [], [], []
            for seed in (0, 1):
                q, k, v = _inputs(torch, 2, 333, 4, D, seed=100 * seed + D, q_scale=scale)
                for causal in (True, False):
                    t = exact(q, k, v, causal)
                    o = kfa.flash_attention_cuda(q, k, v, causal)
                    p = ref.flash_attention_ref(q, k, v, causal)
                    kr.append(ratio(o, t))
                    pr.append(ratio(p, t))
                    kp.append(ratio(o, p.double()))
            print(f"q x {scale:g}, D = {D}: allclose ratio against float64, kernel "
                  f"max {max(kr):.3f}, float32 plain version max {max(pr):.3f}; "
                  f"kernel against the float32 plain version max {max(kp):.3f}",
                  flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", action="append", help="checkout to time (repeatable)")
    ap.add_argument("--variants", action="store_true", help="time the design variants")
    ap.add_argument("--scores", action="store_true", help="error as the scores grow")
    ap.add_argument("--ssd-rounding", action="store_true",
                    help="ssd_chunk with either TF32 rounding")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(measure(Path(args.one).resolve())))
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    if args.variants:
        variants()
    if args.scores:
        scores()
    if args.ssd_rounding:
        ssd_rounding()
    if args.root or not (args.variants or args.scores or args.ssd_rounding):
        for root in args.root or [str(ROOT)]:
            proc = subprocess.run([sys.executable, __file__, "--one", root],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stdout, proc.stderr, file=sys.stderr)
                raise SystemExit(f"timing {root} failed")
            print(proc.stdout.strip().splitlines()[-1], flush=True)
    print(smi)


if __name__ == "__main__":
    main()
