"""A phase trace of the float32 flash-attention backward, and the float32
zamba2-1.2b loss's backward through the kernels against the plain one.

    python tools/flash_bwd_trace.py                       # this checkout
    python tools/flash_bwd_trace.py --root OLD --root .   # checkouts in turn
    python tools/flash_bwd_trace.py --count --root OLD --root .
    python tools/flash_bwd_trace.py --sass --root OLD --root .
    python tools/flash_bwd_trace.py --same --root OLD --root .
    python tools/flash_bwd_trace.py --loss                # and the loss's backward

For each ``--root`` (a checkout, such as a ``git archive`` of a commit
unpacked under ``build/``) it copies the checkout's ``src/`` to
``build/trace_<n>/`` and instruments the copy's ``csrc/`` only, never the
program itself.  Per warpgroup of each block, ``clock64()`` stamps sum the
time in every ``mbar_wait`` (waiting on a ring, a load or the other
warpgroup), in every ``wgmma.wait_group`` (waiting on products) and from
each ``wgmma.fence`` to its ``wgmma.commit_group`` (issuing products); the
dq kernel's D pass ends at the line that computes the row's D
(``row_sum4(pdp_a)``), and, where the source has their lines, laps time
the dk/dv pass's P^T and the split of an A operand.  Each warpgroup writes
its sums into a buffer when it ends (an object whose destructor runs at
the kernel's end).  The tool builds the copy, runs the backward once at
zamba2-1.2b's shape (B=2, S=512, H=32, D=64, causal) and at pixtral-12b's
(B=2, S=1280, H=32, D=128, causal), and prints, per kernel and warpgroup
(the last one of a block its producers), the mean over blocks of a block's
microseconds (``%globaltimer``) and of each sum (cycles converted at the
rate the blocks' own two clocks give), "other" being the rest, and each
kernel's span on the card.

``--count`` also counts the tf32 ``wgmma`` instructions each warpgroup
issues, summed over the blocks (the products a call computes, by
warpgroup); the counting stores between products, so its times are not
the kernel's.  ``--sass`` instead counts, in each checkout's own
(unpatched) build of ``flash_attention_bwd.cu``, the ``HGMMA`` instructions
(all, and those on TF32) and the atomic instructions (``ATOM``, ``RED``) of
each kernel in the SASS (``cuobjdump -sass``), beside ptxas's registers and
spills where it builds the library.

``--same`` instead runs each checkout's float32 backward at 13 shapes (every
head dim, causal and not, ragged, Sq != Sk, a query offset, pixtral's
expanded GQA) from seeded inputs and compares the outputs with the first
checkout's bit for bit.

``--loss`` also times the float32 zamba2-1.2b ``Model.loss`` (B = 2 x 512,
full width, random weights) and its gradients through the kernels and
through the plain versions, in turns (kernels, plain, kernels, plain, ...):
host walls of the forward and the backward with the card synchronised,
CUDA events of the backward, and its card time under torch.profiler.

It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"zamba2": (2, 512, 32, 64, True), "pixtral": (2, 1280, 32, 128, True)}

# instrumentation appended to hopper.cuh's helpers (the copy only)
_PROBE = r"""
__device__ long long g_probe[2][65536][3][12];
__device__ __forceinline__ long long* probe_acc() {
  __shared__ long long acc[4][12];
  return acc[threadIdx.x / 128];
}
__device__ __forceinline__ long long probe_gtime() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void probe_add(int i, long long d) {
  if (threadIdx.x % 128 == 0) probe_acc()[i] += d;
}
__device__ __forceinline__ void probe_mark() {
  if (threadIdx.x % 128 == 0) probe_acc()[4] = clock64() - probe_acc()[7];
}
struct ProbeScope {
  int kid;
  long long g0;
  __device__ explicit ProbeScope(int k) : kid(k), g0(0) {
    if (threadIdx.x % 128 == 0) {
      long long* a = probe_acc();
      for (int i = 0; i < 12; ++i) a[i] = 0;
      a[7] = clock64();
      g0 = probe_gtime();
    }
  }
  __device__ ~ProbeScope() {
    if (threadIdx.x % 128 == 0) {
      long long* a = probe_acc();
      long long* o = g_probe[kid][blockIdx.x * gridDim.y + blockIdx.y][threadIdx.x / 128];
      unsigned smid;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
      o[0] = clock64() - a[7];
      o[1] = a[0];
      o[2] = a[1];
      o[3] = a[2];
      o[4] = a[4];
      o[5] = probe_gtime() - g0;
      o[6] = smid;
      o[7] = g0;
      o[8] = a[8];
      o[9] = a[9];
      o[10] = a[10];
      o[11] = a[5];
    }
  }
};
// laps: the time since probe_lap_start() into slot i (8, 9, 10)
__device__ __forceinline__ void probe_lap_start() {
  if (threadIdx.x % 128 == 0) probe_acc()[11] = clock64();
}
__device__ __forceinline__ void probe_lap(int i) {
  if (threadIdx.x % 128 == 0) probe_acc()[i] += clock64() - probe_acc()[11];
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const long long t0 = clock64();
  mbar_wait_raw(bar, parity);
  probe_add(0, clock64() - t0);
}
__device__ __forceinline__ void wg_fence() {
  if (threadIdx.x % 128 == 0) probe_acc()[3] = clock64();
  wg_fence_raw();
}
__device__ __forceinline__ void wg_commit() {
  wg_commit_raw();
  if (threadIdx.x % 128 == 0) {
    const long long t = clock64();
    probe_acc()[2] += t - probe_acc()[3];
    probe_acc()[3] = t;
  }
}
__device__ __forceinline__ void wg_wait_all() {
  const long long t0 = clock64();
  wg_wait_all_raw();
  probe_add(1, clock64() - t0);
}
__device__ __forceinline__ void wg_wait_one() {
  const long long t0 = clock64();
  wg_wait_one_raw();
  probe_add(1, clock64() - t0);
}
"""

_READ = r"""
extern "C" int probe_read(void* dst, int64_t n) {
  return (int)cudaMemcpyFromSymbol(dst, g_probe, n);
}
extern "C" int probe_clear() {
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, g_probe);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemset(p, 0, sizeof(g_probe));
}
"""


LAPS = [("cols16(lrow, i0, LOG2E, lv);", "over_d(aK, U * j);", 8),
        ("// P^T, masked on the tiles", "const int pb = j % PB;", 9),
        ("if constexpr (NC == 1) {\n      uint32_t ah[32], al[32];", "wg_fence();", 10)]


def _patch(src: Path, count: bool = False) -> None:
    """Instrument the copy's csrc/ in place (with `count`, the tf32 wgmma
    counts too, whose stores between products change the timing)."""
    csrc = src / "repro_torch" / "kernels" / "csrc"
    hp = csrc / "hopper.cuh"
    text = hp.read_text()
    for name in ("mbar_wait", "wg_fence", "wg_commit", "wg_wait_all", "wg_wait_one"):
        text, n = re.subn(rf"void {name}\(", f"void {name}_raw(", text, count=1)
        assert n == 1, name
    # the wrappers go after the last raw helper
    anchor = text.index("// keep the compiler from moving reads")
    text = text[:anchor] + _PROBE + "\n" + text[anchor:]
    # each tf32 wgmma a warpgroup issues counts one in slot 5
    for name in ("wgmma_tf32_ss_n64", "wgmma_tf32_rs_n64") if count else ():
        at = text.index(f"void {name}(")
        body = text.index("{\n", at) + 2
        text = text[:body] + "  probe_add(5, 1);\n" + text[body:]
    hp.write_text(text)
    fb = csrc / "flash_attention_bwd.cuh"
    text = fb.read_text()
    start, end = text.index("namespace tf32 {"), text.index("}  // namespace tf32")
    body = text[start:end]
    for kid, kernel in enumerate(("flash_bwd_dq_kernel(", "flash_bwd_dkdv_kernel(")):
        at = body.index(kernel)
        tid = body.index("const int tid = threadIdx.x;", at) + len("const int tid = threadIdx.x;")
        body = body[:tid] + f"\n  ProbeScope probe_scope({kid});" + body[tid:]
    m = re.search(r"\n([^\n]*row_sum4\(pdp_a\)[^\n]*\n)", body)
    assert m, "the D pass's end"
    body = body[:m.end()] + "  probe_mark();\n" + body[m.end():]
    # laps of the dk/dv pass's elementwise work, where the source has these
    # lines (8: the lse loads, 9: P^T, 10: the split of an A operand)
    for first, last, slot in LAPS:
        a = body.find(first)
        z = body.find(last, a + len(first)) if a >= 0 else -1
        if a >= 0 and z >= 0:
            body = (body[:a] + "probe_lap_start();\n" + body[a:z] + f"probe_lap({slot});\n"
                    + body[z:])
    fb.write_text(text[:start] + body + text[end:])
    cu = csrc / "flash_attention_bwd.cu"
    cu.write_text(cu.read_text() + _READ)


def trace(root: Path, n: int, count: bool = False) -> dict:
    """Every number of one checkout (run in its own process)."""
    copy = ROOT / "build" / f"trace_{n}{'_count' if count else ''}"
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(root / "src", copy / "src",
                    ignore=shutil.ignore_patterns("__pycache__"))
    _patch(copy / "src", count)
    sys.path.insert(0, str(copy / "src"))
    import ctypes

    import numpy as np
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention_cuda as kfa
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    build.build_all()
    lib = build.load("flash_attention_bwd")
    lib.probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    buf = np.zeros((2, 65536, 3, 12), dtype=np.int64)
    out = {"root": str(root), "device": torch.cuda.get_device_name(0),
           "ptxas": [ln for ln in build.BUILD_LOG.get("flash_attention_bwd", "").splitlines()
                     if "Compiling entry" in ln or "registers" in ln or "spill" in ln]}
    gen = torch.Generator().manual_seed(0)
    for name, (B, S, H, D, causal) in SHAPES.items():
        q, k, v, do = (torch.randn(B, S, H, D, generator=gen).cuda() for _ in range(4))
        _, lse = kfa.flash_attention_lse_cuda(q, k, v, causal)
        for _ in range(3):
            kfa.flash_attention_bwd_cuda(q, k, v, lse, do, causal)
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(20):
            kfa.flash_attention_bwd_cuda(q, k, v, lse, do, causal)
        b.record()
        torch.cuda.synchronize()
        assert lib.probe_clear() == 0
        kfa.flash_attention_bwd_cuda(q, k, v, lse, do, causal)
        torch.cuda.synchronize()
        assert lib.probe_read(buf.ctypes.data, buf.nbytes) == 0
        res = {"events_us": a.elapsed_time(b) / 20 * 1e3}
        for kid, kname in ((0, "dq"), (1, "dkdv")):
            blk = buf[kid][buf[kid, :, 0, 5] > 0]          # the blocks that ran
            ns_tot = blk[:, :, 5].astype(np.float64)
            cyc = blk[:, :, 0].astype(np.float64)
            ghz = cyc[:, 0].sum() / ns_tot[:, 0].sum()
            span = ((blk[:, 0, 7] + blk[:, 0, 5]).max() - blk[:, 0, 7].min()) / 1e3
            k_out = {"span_us": span, "ghz": ghz, "sms": int(len(np.unique(blk[:, 0, 6]))),
                     "blocks": int(len(blk))}
            for w in range(3):            # warpgroups; the last is the producers'
                if not ns_tot[:, w].any():
                    continue
                f = lambda i: float(blk[:, w, i].mean() / ghz / 1e3)   # noqa: E731
                tot = float(ns_tot[:, w].mean() / 1e3)
                r = {"block_us": tot, "ring_us": f(1), "prod_wait_us": f(2),
                     "issue_us": f(3)}
                r["other_us"] = tot - r["ring_us"] - r["prod_wait_us"] - r["issue_us"]
                if blk[:, w, 4].any():
                    r["d_pass_us"] = f(4)
                for i, lap in ((8, "lse_loads_us"), (9, "p_us"), (10, "split_us")):
                    if blk[:, w, i].any():
                        r[lap] = f(i)
                if count:
                    r["tf32_wgmma"] = int(blk[:, w, 11].sum())   # over the blocks
                k_out[f"wg{w}"] = r
            res[kname] = k_out
        out[name] = res
        del q, k, v, do, lse
        torch.cuda.empty_cache()
    return out


def sass_counts(root: Path) -> dict:
    """{kernel: {"hgmma": n, "tf32": n, "atomic": n}} of the checkout's
    float32 backward library (run in its own process)."""
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import build
    lib = build.build_all()["flash_attention_bwd"]
    dump = subprocess.run([str(Path(build._nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts, cur = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            m = re.search(r"(flash_bwd_\w+_kernel)ILi(\d+)", name)
            cur = f"{m.group(1)}<{m.group(2)}>" if m else name
            counts[cur] = {"hgmma": 0, "tf32": 0, "atomic": 0}
        elif cur is not None:
            m = re.match(r"\s*/\*[0-9a-f]+\*/\s*([^;]*);", line)   # /*addr*/ INSTR ... ;
            if m is None:
                continue
            ins = m.group(1)
            if "HGMMA" in ins:
                counts[cur]["hgmma"] += 1
                counts[cur]["tf32"] += "TF32" in ins
            if re.search(r"\b(ATOM|ATOMS|ATOMG|RED)\b", ins):
                counts[cur]["atomic"] += 1
    # ptxas's registers and spills, where this process built the library
    cur = None
    for line in build.BUILD_LOG.get("flash_attention_bwd", "").splitlines():
        m = re.search(r"Compiling entry function '.*(flash_bwd_\w+_kernel)ILi(\d+)", line)
        if m:
            cur = f"{m.group(1)}<{m.group(2)}>"
        elif cur in counts and ("registers" in line or "spill" in line):
            counts[cur]["ptxas"] = (counts[cur].get("ptxas", "") + " " + line.strip()).strip()
    return counts


# (B, Sq, Sk, H, D, causal, q_offset, K/V heads expanded to H or None)
SAME_CASES = [(1, 64, 64, 1, 64, True, 0, None), (1, 130, 130, 2, 64, True, 0, None),
              (1, 130, 100, 2, 64, False, 0, None), (2, 70, 70, 3, 32, True, 0, None),
              (2, 1, 38, 4, 16, True, 0, None), (1, 200, 237, 4, 96, False, 0, None),
              (1, 333, 333, 2, 128, True, 0, None), (1, 64, 256, 2, 64, True, 192, None),
              (2, 100, 300, 4, 128, True, 37, None), (2, 256, 1500, 8, 64, False, 0, None),
              (2, 512, 512, 32, 64, True, 0, None), (2, 256, 256, 32, 96, True, 0, None),
              (2, 1280, 1280, 32, 128, True, 0, 8)]


def same_outputs(root: Path, n: int) -> dict:
    """The checkout's float32 backward at SAME_CASES (inputs from seeds),
    saved to build/same_<n>.pt (run in its own process)."""
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention_cuda as kfa
    build.build_all()
    outs = []
    for i, (B, Sq, Sk, H, D, causal, qo, kvh) in enumerate(SAME_CASES):
        g = torch.Generator().manual_seed(100 + i)
        q, do = (torch.randn(B, Sq, H, D, generator=g).cuda() for _ in range(2))
        k, v = (torch.randn(B, Sk, kvh or H, D, generator=g).cuda() for _ in range(2))
        if kvh:
            k, v = (t[:, :, :, None].expand(B, Sk, kvh, H // kvh, D).reshape(B, Sk, H, D)
                    for t in (k, v))
        _, lse = kfa.flash_attention_lse_cuda(q, k, v, causal, None, qo)
        outs.append([t.cpu() for t in kfa.flash_attention_bwd_cuda(q, k, v, lse, do, causal,
                                                                   None, qo)])
    torch.save(outs, ROOT / "build" / f"same_{n}.pt")
    return {"root": str(root), "cases": len(outs)}


def loss_timing(root: Path, turns: int = 3) -> dict:
    """The float32 zamba2-1.2b loss's backward, kernels against plain, in turns."""
    sys.path.insert(0, str(root / "src"))
    import dataclasses
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.kernels import build
    from repro_torch.launch.train import batch_to
    from repro_torch.models.context import null_ctx
    from repro_torch.models.model import Model, tree_leaves, tree_map
    build.build_all()
    cfg = dataclasses.replace(get_config("zamba2-1.2b"), dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    batch = batch_to(SyntheticLMDataset(cfg, 2, 512, seed=0).get_batch(0), "cuda")
    ctxs = {"kernels": null_ctx(attn_chunk=512, remat="none"),
            "plain": null_ctx(attn_chunk=512, remat="none", kernels="ref")}

    def run(ctx, prof=False):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = model.loss(p, batch, ctx)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        busy = None
        if prof:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pr:
                a.record()
                torch.autograd.grad(loss, tree_leaves(p))
                b.record()
                torch.cuda.synchronize()
            busy = sum(e.time_range.end - e.time_range.start for e in pr.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        else:
            a.record()
            torch.autograd.grad(loss, tree_leaves(p))
            b.record()
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        return {"fwd_ms": (t1 - t0) * 1e3, "bwd_ms": (t2 - t1) * 1e3,
                "bwd_events_ms": a.elapsed_time(b), "bwd_busy_ms": busy}

    rows = []
    for i in range(turns):
        for name in ("kernels", "plain"):
            rows.append({"turn": i, "path": name, **run(ctxs[name], prof=(i == turns - 1))})
            print(json.dumps(rows[-1]), flush=True)
    return {"loss_backward": rows}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", action="append", help="checkout to trace (repeatable)")
    ap.add_argument("--loss", action="store_true", help="also time the loss's backward")
    ap.add_argument("--sass", action="store_true", help="count HGMMA and atomics instead")
    ap.add_argument("--count", action="store_true",
                    help="count the tf32 wgmma each warpgroup issues (times distorted)")
    ap.add_argument("--same", action="store_true",
                    help="compare the roots' float32 backward outputs bit for bit instead")
    ap.add_argument("--same-one", help=argparse.SUPPRESS)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--n", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--loss-one", help=argparse.SUPPRESS)
    ap.add_argument("--sass-one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(trace(Path(args.one).resolve(), args.n, args.count)))
        return
    if args.same_one:
        print(json.dumps(same_outputs(Path(args.same_one).resolve(), args.n)))
        return
    if args.same:
        import torch
        roots = args.root or [str(ROOT)]
        for n, root in enumerate(roots):
            proc = subprocess.run([sys.executable, __file__, "--same-one", root, "--n", str(n)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stdout, proc.stderr, file=sys.stderr)
                raise SystemExit(f"the outputs of {root} failed")
        first = torch.load(ROOT / "build" / "same_0.pt")
        for n, root in enumerate(roots[1:], 1):
            other = torch.load(ROOT / "build" / f"same_{n}.pt")
            print(f"== {root} against {roots[0]}")
            for case, a, b in zip(SAME_CASES, first, other):
                same = [bool(torch.equal(x, y)) for x, y in zip(a, b)]
                diff = max((x - y).abs().max().item() for x, y in zip(a, b))
                print(f"  {case}: dq, dk, dv bitwise equal {same}, max abs diff {diff:.3g}")
        return
    if args.sass_one:
        print(json.dumps(sass_counts(Path(args.sass_one).resolve())))
        return
    if args.sass:
        for root in args.root or [str(ROOT)]:
            proc = subprocess.run([sys.executable, __file__, "--sass-one", root],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stdout, proc.stderr, file=sys.stderr)
                raise SystemExit(f"the SASS of {root} failed")
            print(f"== {root}")
            for kernel, c in sorted(json.loads(proc.stdout.strip().splitlines()[-1]).items()):
                print(f"  {kernel:32s} HGMMA {c['hgmma']:5d} (TF32 {c['tf32']:5d}), "
                      f"atomics {c['atomic']}; {c.get('ptxas', 'ptxas: built before')}")
        return
    if args.loss_one:
        print(json.dumps(loss_timing(Path(args.loss_one).resolve())))
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    for n, root in enumerate(args.root or [str(ROOT)]):
        proc = subprocess.run([sys.executable, __file__, "--one", root, "--n", str(n)]
                              + (["--count"] if args.count else []),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            raise SystemExit(f"tracing {root} failed")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"== {root}")
        for ln in res["ptxas"]:
            print("  ptxas:", ln.strip())
        for name in SHAPES:
            r = res[name]
            print(f"  {name} {SHAPES[name]}: {r['events_us']:.2f} us a call (CUDA events, "
                  f"probed)")
            for kname in ("dq", "dkdv"):
                k = r[kname]
                print(f"    {kname}: span {k['span_us']:.2f} us, {k['blocks']} blocks on "
                      f"{k['sms']} SMs at {k['ghz']:.3f} GHz (the last warpgroup the producers)")
                for role, v in k.items():
                    if isinstance(v, dict):
                        print(f"      {role:9s} " + ", ".join(
                            f"{key} {val:.2f}" for key, val in v.items()))
        print(json.dumps(res))
    if args.loss:
        proc = subprocess.run([sys.executable, __file__, "--loss-one",
                               (args.root or [str(ROOT)])[-1]], capture_output=True, text=True)
        print(proc.stdout)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            raise SystemExit("the loss timing failed")
    print(smi)


if __name__ == "__main__":
    main()
