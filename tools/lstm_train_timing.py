"""Card times of the LSTM stack's kernels, for one or more checkouts in turn.

    python tools/lstm_train_timing.py                      # this checkout
    python tools/lstm_train_timing.py --root OLD --root . --root . --root OLD

Each ``--root`` (a checkout of the repository, such as a ``git archive`` of
an earlier commit unpacked into ``build/``) runs in a process of its own, in
the order given, so that two versions are compared on one card in turns.
Each process builds that checkout's kernels and times, on the card:

* the inference stack ``lstm_stack_cuda`` at a full-pool RevPred forward's
  shape (G = 6, B = 1, T = 59, I = 6, H = 32, 3 layers);
* the training forward ``lstm_stack_fwd_train_cuda`` and the backward
  ``lstm_stack_bwd_cuda`` at RevPred's and Tributary's training batches
  (G = 1, B = 256, T = 59 / 60, I = 6 / 7, H = 32, 3 layers), their card
  time per call (torch.profiler, kernels only) and per diagonal (card time
  over T + L - 1), and CUDA-events milliseconds per call;
* forward + backward through autograd (``ops.lstm_stack`` and
  ``torch.autograd.grad`` of every weight), its card time broken down into
  the two kernels, the weight gradients' GEMMs (``torch.bmm``) and the rest.

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
TRAIN_SHAPES = {"revpred": (1, 256, 59, 6, 32, 3),
                "tributary": (1, 256, 60, 7, 32, 3)}
INFER_SHAPE = (6, 1, 59, 6, 32, 3)     # G, B, T, I, H, layers


def _inputs(torch, G, B, T, I, H, L, seed):
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda()

    xs = rnd(G, B, T, I)
    layers = [{"w_ih": rnd(G, I if n == 0 else H, 4 * H,
                           scale=(I if n == 0 else H) ** -0.5),
               "w_hh": rnd(G, H, 4 * H, scale=H ** -0.5),
               "b": rnd(G, 4 * H, scale=0.1)} for n in range(L)]
    return xs, layers, rnd(G, B, H)


def _profile(torch, fn, iters, warmup=10):
    """(kernel intervals, profiled seconds) of ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _card_us(torch, fn, iters=50):
    iv = _profile(torch, fn, iters)
    return sum(e - s for s, e, _ in iv) / iters if iv else None


def _events_ms(torch, fn, iters=200, warmup=20):
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


def _kind(name: str) -> str:
    low = name.lower()
    if "lstm_stack_bwd" in name:
        return "bwd"
    if "lstm_stack_fwd_train" in name or ("lstm_stack_kernel" in name and "true" in low):
        return "fwd_train"
    if "gemm" in low or "sm90" in low or "cutlass" in low:
        return "bmm"
    return "rest"


def measure(root: Path) -> dict:
    """Every number of one checkout (run in its own process)."""
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import lstm_cell as klc
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    out = {"root": str(root), "device": torch.cuda.get_device_name(0)}

    G, B, T, I, H, L = INFER_SHAPE
    xs, layers, _ = _inputs(torch, G, B, T, I, H, L, seed=1)
    with torch.no_grad():
        out["infer_card_us"] = _card_us(torch, lambda: klc.lstm_stack_cuda(xs, layers), 200)
        out["infer_ms"] = _events_ms(torch, lambda: klc.lstm_stack_cuda(xs, layers), 1000)

    for name, (G, B, T, I, H, L) in TRAIN_SHAPES.items():
        xs, layers, dh = _inputs(torch, G, B, T, I, H, L, seed=1)
        wflat = [t.requires_grad_(True) for lp in layers for t in lp.values()]
        with torch.no_grad():
            _, gates, c, _ = klc.lstm_stack_fwd_train_cuda(xs, layers)

            def fwd():
                return klc.lstm_stack_fwd_train_cuda(xs, layers)

            def bwd():
                return klc.lstm_stack_bwd_cuda(dh, gates, c, layers)

            r = {"fwd_card_us": _card_us(torch, fwd), "bwd_card_us": _card_us(torch, bwd),
                 "fwd_ms": _events_ms(torch, fwd), "bwd_ms": _events_ms(torch, bwd)}

        def pair():
            return torch.autograd.grad(ops.lstm_stack(xs, layers), wflat, dh)

        iters = 50
        iv = _profile(torch, pair, iters)
        parts = {}
        for s, e, nm in iv:
            k = _kind(nm)
            parts[k] = parts.get(k, 0.0) + (e - s) / iters
        r["pair_card_us"] = sum(parts.values())
        r["pair_parts_us"] = parts
        r["pair_ms"] = _events_ms(torch, pair, 100)
        diag = T + L - 1
        r["fwd_us_per_diagonal"] = r["fwd_card_us"] / diag if r["fwd_card_us"] else None
        r["bwd_us_per_diagonal"] = r["bwd_card_us"] / diag if r["bwd_card_us"] else None
        if hasattr(klc, "lstm_stack_train_plan"):
            sms = klc.n_sms(xs.device)
            r["fwd_plan"] = klc.lstm_stack_train_plan(B, I, H, T, L, sms, G)
            r["bwd_plan"] = klc.lstm_stack_bwd_plan(B, H, T, L, sms, G)
            r["n_sms"] = sms
        else:
            r["fwd_plan"] = klc.lstm_stack_plan(B, I, H, T, L)
            r["bwd_plan"] = klc.lstm_stack_bwd_plan(B, H, T, L)
        out[name] = r
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", action="append", help="checkout to time (repeatable)")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(measure(Path(args.one).resolve())))
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    runs = []
    for root in args.root or [str(ROOT)]:
        proc = subprocess.run([sys.executable, __file__, "--one", root],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            raise SystemExit(f"timing {root} failed")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    rows = [("inference stack, card us", lambda r: r["infer_card_us"]),
            ("inference stack, events ms", lambda r: r["infer_ms"])]
    for name in TRAIN_SHAPES:
        for key in ("fwd_card_us", "bwd_card_us", "fwd_us_per_diagonal",
                    "bwd_us_per_diagonal", "fwd_ms", "bwd_ms", "pair_card_us",
                    "pair_ms"):
            rows.append((f"{name} {key}", lambda r, n=name, k=key: r[n][k]))
        for part in ("fwd_train", "bwd", "bmm", "rest"):
            rows.append((f"{name} pair {part} us",
                         lambda r, n=name, p=part: r[n]["pair_parts_us"].get(p, 0.0)))
    print("run: " + " | ".join(Path(r["root"]).name or r["root"] for r in runs))
    for label, get in rows:
        vals = []
        for r in runs:
            v = get(r)
            vals.append("none" if v is None else f"{v:.4f}")
        print(f"{label:40s} " + " | ".join(vals))
    print(smi)


if __name__ == "__main__":
    main()
