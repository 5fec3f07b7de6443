"""Probes of MLA's kernels (``csrc/mla_attention_wgmma.cuh``, bf16, and
``csrc/mla_attention_tf32.cuh``, float32) that the program does not carry:
timing-only copies, phase traces, ptxas's registers and the SASS.

    python tools/mla_probe.py copy F1 T1 ...   # patched copies under build/
    python tools/bwd_kernel_timing.py --only mla --root . --root build/mla_F1 ...
    python tools/mla_probe.py trace            # card only: the bf16 rows launch's phases
    python tools/mla_probe.py trace f32        # card only: the float32 forward's phases
    python tools/mla_probe.py ptxas            # card only: registers and spills
    python tools/mla_probe.py sass             # card only: HGMMA (TF32) and atomics

``copy`` writes ``build/mla_<name>/src``, this checkout's ``src/`` with one
change to a kernel header; ``tools/bwd_kernel_timing.py --root`` times it
beside the unchanged checkout, in turns.  The bf16 copies:

* F1: the forward's warpgroup 1 issues no S products (the most that handing
  P from warpgroup 0 to 1 could gain; its output is wrong);
* F2: the forward stores no O;
* R1: the rows launch issues no dQ products;
* R2: the rows launch releases K right after S in both passes (dQ reads a
  K stage being replaced);
* R3: the rows launch runs its second pass alone (no D);
* R4: the rows launch writes no P or dS to the scratch;
* R5: the rows launch hands no dS back to warpgroup 0;
* chains: S and dP as three and two independent ``wgmma`` chains summed at
  the end (a design measured and not kept);
* warp_arrive: one arrival a warp on the empty barriers instead of one a
  thread (measured, not kept);
* box_barriers: the rows launch's K and V stages with a full barrier a box
  (measured, not kept).

The float32 copies (``mla_attention_tf32.cuh``):

* T1: the forward issues no products;
* T2: the forward's consumers split no K unit;
* T3: the rows launch issues no products;
* T4: the keys launch's producers transpose no unit;
* T5: the keys launch issues no products;
* T6: the forward's warpgroups each compute S whole, as the bf16 forward
  does (and still add the other's partial: the cost of not handing S over);
* k56, k72, k96: the keys launch's register split (producer / consumer)
  56 / 224, 72 / 208 and 96 / 184 where it takes 80 / 200 (measured, not
  kept: PERF.md).

Copies F1-R5 and T1-T5 compute wrong numbers on purpose: time them, never
check them.  ``trace`` builds ``build/mla_trace`` (the bf16 rows launch
with ``clock64`` stamps a phase, per consumer warpgroup and pass, summed
over a block's stages) and prints each phase's mean cycles a block at
deepseek-v2's training shape (B=2, S=256, H=128, Dk=576, Dv=512, causal,
bf16); ``trace f32`` builds ``build/mla_trace_f32`` (the float32 forward,
per consumer warpgroup: waiting for units, for its products, at the S
exchange, splitting K's units, the rest) and prints the same at
the same shape in float32.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HEADER = "src/repro_torch/kernels/csrc/mla_attention_wgmma.cuh"
HEADER_F32 = "src/repro_torch/kernels/csrc/mla_attention_tf32.cuh"
SOURCE = "src/repro_torch/kernels/csrc/mla_attention.cu"

_RELEASE_K_AFTER_DQ = """        wg_commit();
        wg_wait_all();
        fence_regs(dq);
        mbar_arrive(k_empty);"""

PATCHES = {
    "F1": [("""    const uint32_t k_addr = smem_u32(sK + s * kst);
    wg_fence();""", """    const uint32_t k_addr = smem_u32(sK + s * kst);
    if (wg != 0) { wg_commit(); return; }
    wg_fence();""")],
    "F2": [("    for (int c = 0; c < nvb; ++c) tma_store_4d(&to,",
            "    for (int c = 0; c < 0; ++c) tma_store_4d(&to,")],
    "R1": [("wgmma_rs_n256(dq, ds", "if (0) wgmma_rs_n256(dq, ds"),
           ("wgmma_rs_n64(dq8,", "if (0) wgmma_rs_n64(dq8,")],
    "R2": [("      if (!pass2) mbar_arrive(k_empty);\n", "      mbar_arrive(k_empty);\n"),
           (_RELEASE_K_AFTER_DQ, _RELEASE_K_AFTER_DQ.replace("\n        mbar_arrive(k_empty);", "")),
           ("""        mbar_wait(k_full, u & 1);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_rs_n256(dq, ds + 4 * kk, desc_mn(k_addr + 4 * KB_BOX""",
            """        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_rs_n256(dq, ds + 4 * kk, desc_mn(k_addr + 4 * KB_BOX"""),
           ("""        fence_regs(dq8);
        mbar_arrive(k_empty);""", """        fence_regs(dq8);""")],
    "R3": [("const int b = tile.b, n_kt = tile.n_kt, U = 2 * n_kt;",
            "const int b = tile.b, n_kt = tile.n_kt, U = n_kt;"),
           ("      const bool pass2 = u >= n_kt;\n      const int t = pass2 ? u - n_kt : u, k0 = t * BN;",
            "      const bool pass2 = true;\n      const int t = u, k0 = t * BN;")],
    "R4": [("        store_pairs(Pb, k0, pp);\n", ""), ("        store_pairs(dSb, k0, ds);\n", "")],
    "R5": [("""        bar_sync(3, 256);
        uint32_t ds[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) ds[i] = xdS[i * 128 + wtid];
        if (t < n_kt - 1) bar_arrive(4, 256);""", """        uint32_t ds[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) ds[i] = pp[i];"""),
           ("""        if (t > 0) bar_sync(4, 256);
#pragma unroll
        for (int i = 0; i < 8; ++i) xdS[i * 128 + wtid] = ds[i];
        bar_arrive(3, 256);""", "")],
    "chains": [
        ("""// the row tile of block i: the last tiles (most keys under the causal""",
         """template <int NB, int NC>
__device__ __forceinline__ void qk_chains(float (&acc)[NC][16], uint32_t a, uint32_t b) {
#pragma unroll
  for (int g = 0; g < NB / NC; ++g)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = g * NC + j;
        wgmma_ss_n32(acc[j], desc_kmajor(a + c * BOX_BYTES + kk * 32),
                     desc_kmajor(b + c * KB_BOX + kk * 32), (g | kk) != 0);
      }
}

template <int NC>
__device__ __forceinline__ void add_chains(float (&acc)[NC][16]) {
#pragma unroll
  for (int j = 0; j < NC; ++j) fence_regs(acc[j]);
#pragma unroll
  for (int j = 1; j < NC; ++j)
#pragma unroll
    for (int r = 0; r < 16; ++r) acc[0][r] += acc[j][r];
}

// the row tile of block i: the last tiles (most keys under the causal"""),
        ("""  float sc[16];
  uint32_t pa[8];""", """  float s3[3][16];
  float (&sc)[16] = s3[0];
  uint32_t pa[8];"""),
        ("""    const uint32_t k_addr = smem_u32(sK + s * kst);
    wg_fence();
#pragma unroll
    for (int c = 0; c < MAX_KB; ++c) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n32(sc, desc_kmajor(q_addr + c * BOX_BYTES + kk * 32),
                     desc_kmajor(k_addr + c * KB_BOX + kk * 32), (c | kk) != 0);
    }
    wg_commit();""", """    wg_fence();
    qk_chains<MAX_KB, 3>(s3, q_addr, smem_u32(sK + s * kst));
    wg_commit();"""),
        ("""  issue_qk(0);
  wg_wait_all();
  fence_regs(sc);""", """  issue_qk(0);
  wg_wait_all();
  add_chains(s3);"""),
        ("""    wg_wait_one();   // S of stage t is in; P.V of stage t - 1 may still run
    fence_regs(sc);""", """    wg_wait_one();   // S of stage t is in; P.V of stage t - 1 may still run
    add_chains(s3);"""),
        ("""    float p[16];
    for (int u = 0; u < U; ++u) {""", """    float s3[3][16];
    float (&p)[16] = s3[0];
    for (int u = 0; u < U; ++u) {"""),
        ("""      wg_fence();
#pragma unroll
      for (int c = 0; c < MAX_KB; ++c) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n32(p, desc_kmajor(q_addr + c * BOX_BYTES + kk * 32),
                       desc_kmajor(k_addr + c * KB_BOX + kk * 32), (c | kk) != 0);
      }
      wg_commit();
      wg_wait_all();
      fence_regs(p);""", """      wg_fence();
      qk_chains<MAX_KB, 3>(s3, q_addr, k_addr);
      wg_commit();
      wg_wait_all();
      add_chains(s3);"""),
        ("""    float dp[16];
    float pdp[2]""", """    float d2[2][16];
    float (&dp)[16] = d2[0];
    float pdp[2]"""),
        ("""      wg_fence();
#pragma unroll
      for (int c = 0; c < MAX_VB; ++c) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n32(dp, desc_kmajor(do_addr + c * BOX_BYTES + kk * 32),
                       desc_kmajor(v_addr + c * KB_BOX + kk * 32), (c | kk) != 0);
      }
      wg_commit();
      wg_wait_all();
      fence_regs(dp);""", """      wg_fence();
      qk_chains<MAX_VB, 2>(d2, do_addr, v_addr);
      wg_commit();
      wg_wait_all();
      add_chains(d2);"""),
        ("          float d2[2];", "          float e2[2];"),
        ("            d2[e] = edge", "            e2[e] = edge"),
        ("          ds[i] = pack_bf16(d2[0], d2[1]);", "          ds[i] = pack_bf16(e2[0], e2[1]);")],
    "warp_arrive": [
        ("""// the MN-major descriptor of a tile whose 64-column boxes are `box` bytes""",
         """__device__ __forceinline__ void warp_arrive(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// the MN-major descriptor of a tile whose 64-column boxes are `box` bytes"""),
        ("      mbar_init(&empty[s], CONSUMERS);\n", "      mbar_init(&empty[s], CONSUMERS / 32);\n"),
        ("mbar_arrive(&empty[", "warp_arrive(&empty["),
        ("    mbar_init(k_empty, 256);\n    mbar_init(v_empty, 128);\n",
         "    mbar_init(k_empty, 8);\n    mbar_init(v_empty, 4);\n"),
        ("mbar_arrive(k_empty);", "warp_arrive(k_empty);"),
        ("mbar_arrive(v_empty);", "warp_arrive(v_empty);"),
        ("      mbar_init(&empty[s], 256);\n", "      mbar_init(&empty[s], 8);\n")],
    "box_barriers": [
        ("  __shared__ __align__(8) uint64_t bars[5];", "  __shared__ __align__(8) uint64_t bars[3 + MAX_KB + MAX_VB];"),
        ("""  uint64_t* qd_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 2;
  uint64_t* k_empty = bars + 3;
  uint64_t* v_empty = bars + 4;""", """  uint64_t* qd_full = bars;
  uint64_t* k_empty = bars + 1;
  uint64_t* v_empty = bars + 2;
  uint64_t* k_full = bars + 3;
  uint64_t* v_full = bars + 3 + MAX_KB;"""),
        ("""    mbar_init(k_full, 1);
    mbar_init(v_full, 1);
""", """    for (int c = 0; c < MAX_KB + MAX_VB; ++c) mbar_init(&k_full[c], 1);
"""),
        ("""        mbar_expect_tx(v_full, nvb * KB_BOX);
        for (int c = 0; c < nvb; ++c)
          tma_load_4d(sV + c * KB_BOX, &tv, v_full, c * 64, 0, t * BN, b);""",
         """        for (int c = 0; c < nvb; ++c) {
          mbar_expect_tx(&v_full[c], KB_BOX);
          tma_load_4d(sV + c * KB_BOX, &tv, &v_full[c], c * 64, 0, t * BN, b);
        }"""),
        ("""        mbar_expect_tx(k_full, nkb * KB_BOX);
        for (int c = 0; c < nkb; ++c)
          tma_load_4d(sK + c * KB_BOX, &tk, k_full, c * 64, 0, t * BN, b);""",
         """        for (int c = 0; c < nkb; ++c) {
          mbar_expect_tx(&k_full[c], KB_BOX);
          tma_load_4d(sK + c * KB_BOX, &tk, &k_full[c], c * 64, 0, t * BN, b);
        }"""),
        ("""      mbar_wait(k_full, u & 1);
      wg_fence();
#pragma unroll
      for (int c = 0; c < MAX_KB; ++c) {
#pragma unroll""", """      wg_fence();
#pragma unroll
      for (int c = 0; c < MAX_KB; ++c) {
        if (c < nkb) mbar_wait(&k_full[c], u & 1);
#pragma unroll"""),
        ("""      mbar_wait(v_full, u & 1);
      wg_fence();
#pragma unroll
      for (int c = 0; c < MAX_VB; ++c) {
#pragma unroll""", """      wg_fence();
#pragma unroll
      for (int c = 0; c < MAX_VB; ++c) {
        if (c < nvb) mbar_wait(&v_full[c], u & 1);
#pragma unroll"""),
        ("""        mbar_wait(k_full, u & 1);
        wg_fence();""", """#pragma unroll
        for (int c = 4; c < MAX_KB; ++c)
          if (c < nkb) mbar_wait(&k_full[c], u & 1);
        wg_fence();""")],
}


_REGS = "constexpr int KEYS_PRODUCER_REGS = 80, KEYS_CONSUMER_REGS = 200;"
F32_PATCHES = {
    "T1": [("        mma_rs_raw(sc,", "        if (0) mma_rs_raw(sc,"),
           ("            mma_rs(oa[i], ah", "            if (0) mma_rs(oa[i], ah")],
    "T2": [("        split_row_unit(ring + sk * UNIT, nboxes(Dk, c), wg, wtid);\n", "")],
    "T3": [("            mma_rs_raw(acc,", "            if (0) mma_rs_raw(acc,"),
           ("            mma_rs(dqa, ah, al", "            if (0) mma_rs(dqa, ah, al")],
    "T4": [("    transpose_unit(ring + s * UNIT, u.nb, ptid);\n", "")],
    "T5": [("          mma_rs(acc[j], ah, al", "          if (0) mma_rs(acc[j], ah, al")],
    "T6": [("      if ((c & 1) == wg) {\n", "      if (true) {\n")],
    "k56": [(_REGS, "constexpr int KEYS_PRODUCER_REGS = 56, KEYS_CONSUMER_REGS = 224;")],
    "k72": [(_REGS, "constexpr int KEYS_PRODUCER_REGS = 72, KEYS_CONSUMER_REGS = 208;")],
    "k96": [(_REGS, "constexpr int KEYS_PRODUCER_REGS = 96, KEYS_CONSUMER_REGS = 184;")],
}


def _patched(text: str, edits) -> str:
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"the source has changed: no {old[:70]!r}")
        text = text.replace(old, new)
    return text


def _copy(dst: Path) -> Path:
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "src", dst / "src", ignore=shutil.ignore_patterns("__pycache__"))
    return dst


def copy(names) -> None:
    for name in names:
        dst = _copy(ROOT / "build" / f"mla_{name}")
        p = dst / (HEADER_F32 if name in F32_PATCHES else HEADER)
        p.write_text(_patched(p.read_text(), {**PATCHES, **F32_PATCHES}[name]))
        print(dst)


# the trace's stamps: (text after which the stamp goes, phase), warpgroup 0
# then warpgroup 1; a phase is the time since the stamp before
PHASES = {0: ["wait K", "S", "exp, P to xP", "store P", "wait dS", "dQ"],
          1: ["wait V", "dP", "wait P", "D / dS", "store dS", "wait K + dQ"]}
STAMPS = {0: [("mbar_wait(k_full, u & 1);", 0), ("fence_regs(p);", 1),
              ("bar_arrive(1, 256);", 2), ("store_pairs(Pb, k0, pp);", 3),
              ("bar_sync(3, 256);", 4), ("fence_regs(dq);", 5)],
          1: [("mbar_wait(v_full, u & 1);", 0), ("fence_regs(dp);", 1),
              ("bar_sync(1, 256);", 2), ("D[i] = pdp[i] / ps[i];\n          }\n        }", 3),
              ("bar_arrive(3, 256);", 3), ("store_pairs(dSb, k0, ds);", 4),
              ("fence_regs(dq8);", 5)]}


def make_trace() -> Path:
    dst = _copy(ROOT / "build" / "mla_trace")
    p = dst / HEADER
    s = p.read_text()
    a = s.index("mla_bwd_rows_wgmma_kernel(")
    b = s.index("mla_bwd_keys_wgmma_kernel(")
    body = s[a:b]
    split = body.index("// ---------------------------------- warpgroup 1")
    parts = [body[:split], body[split:]]
    for wg in (0, 1):
        for text, ph in STAMPS[wg]:
            i = parts[wg].index(text) + len(text)
            parts[wg] = parts[wg][:i] + f" STAMP({ph});" + parts[wg][i:]
    body = "".join(parts)
    loop = "    for (int u = 0; u < U; ++u) {\n      const bool pass2 = u >= n_kt;"
    assert body.count(loop) == 2
    body = body.replace(loop, "    long long last = clock64();\n" + loop)
    body = body.replace("  mbar_wait(qd_full, 0);\n",
                        "  long long tr[12] = {0};\n  mbar_wait(qd_full, 0);\n", 1)
    body = body.replace(
        "  // dQ through the Q tile's shared memory",
        "  if (wtid == 0)\n    for (int i = 0; i < 12; ++i) g_trace[(blockIdx.x * 2 + wg) * 12 + i] = tr[i];\n"
        "  // dQ through the Q tile's shared memory", 1)
    s = s[:a] + body + s[b:]
    s = s.replace("constexpr float NEG_INF = -1e30f;\n", "constexpr float NEG_INF = -1e30f;\n"
                  "__device__ long long g_trace[1 << 16];\n"
                  "#define STAMP(ph) { const long long now_ = clock64(); if (pass2) "
                  "tr[6 + ph] += now_ - last; else tr[ph] += now_ - last; last = now_; }\n", 1)
    p.write_text(s)
    c = dst / SOURCE
    c.write_text(c.read_text() + "\nextern \"C\" int mla_trace(void* dst, int n) {\n"
                 "  return (int)cudaMemcpyFromSymbol(dst, mlawg::g_trace, (size_t)n * 8);\n}\n")
    return dst


def trace() -> None:
    dst = make_trace()
    sys.path.insert(0, str(dst / "src"))
    import ctypes

    import numpy as np
    import torch

    from repro_torch.kernels import mla_attention_cuda as kmla
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    lib = kmla._lib()
    lib.mla_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
    B, S, H, Dk, Dv, scale = 2, 256, 128, 576, 512, 192 ** -0.5
    gen = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(*shape, generator=gen).to("cuda", torch.bfloat16) for shape in
                   ((B, S, H, Dk), (B, S, Dk), (B, S, Dv), (B, S, H, Dv)))
    _, lse = kmla.mla_attention_lse_cuda(q, k, v, True, scale)
    for _ in range(3):
        kmla.mla_attention_bwd_cuda(q, k, v, lse, do, True, scale)
    torch.cuda.synchronize()
    blocks = B * (S * H // 64)
    buf = np.zeros(blocks * 2 * 12, dtype=np.int64)
    if lib.mla_trace(buf.ctypes.data, buf.size) != 0:
        raise SystemExit("reading the trace failed")
    t = buf.reshape(blocks, 2, 2, 6).astype(float).mean(0)
    print(_smi("name,power.limit,clocks.sm"))
    print(f"rows launch, mean cycles a block over {blocks} blocks (clock64 between "
          "stamps; a stamp may run ahead of a wait, so a wait's time can show "
          "in the next phase)")
    for wg in (0, 1):
        for ps in (0, 1):
            print(f"warpgroup {wg}, pass {ps + 1}: {t[wg, ps].sum():.0f}; " + ", ".join(
                f"{name} {c:.0f}" for name, c in zip(PHASES[wg], t[wg, ps])))


# the float32 forward's trace: 0 waiting for units, 1 for its products, 2 at
# the S exchange, 3 the rest (issuing products, the softmax), 4 splitting
# K's units; (text after which the stamp goes, phase)
F32_PHASES = ["unit waits", "product waits", "exchange", "rest", "K splits"]
F32_STAMPS = [("      const int sq = in.take(), sk = in.take();\n", 0),
              ("        split_row_unit(ring + sk * UNIT, nboxes(Dk, c), wg, wtid);\n", 4),
              ("        mma_rs_raw(sc, in.addr(sq), in.addr(sk), ksteps(Dk, c), wtid);\n", 1),
              ("    if (t > 0) bar_sync(3 + wg, 256);\n", 2),
              ("    bar_sync(2, 256);\n", 2),
              ("          const int s = in.take();\n", 0)]
F32_WAITS = "            wg_wait_all();\n            fence_regs(oa[i]);\n"


def make_trace_f32() -> Path:
    dst = _copy(ROOT / "build" / "mla_trace_f32")
    p = dst / HEADER_F32
    s = p.read_text()
    a = s.index("mla_fwd_tf32_kernel(const")
    b = s.index("// ------------------------------------------------------------ backward")
    f = s[a:b]
    for text, ph in F32_STAMPS:
        assert f.count(text) == 1, text
        f = f.replace(text, f"TS(3); {text}TS({ph});\n")
    assert f.count(F32_WAITS) == 1
    f = f.replace(F32_WAITS, f"TS(3);\n{F32_WAITS}TS(1);\n")
    f = f.replace("  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;\n",
                  "  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;\n"
                  "  long long tr_[5] = {0, 0, 0, 0, 0}, last_ = clock64();\n", 1)
    f = f.replace("  // ----------------------------------------------------------- epilogue\n",
                  "  TS(3);\n  if (wtid == 0)\n    for (int i = 0; i < 5; ++i) "
                  "g_trace[(blockIdx.x * 2 + wg) * 5 + i] = tr_[i];\n"
                  "  // ----------------------------------------------------------- epilogue\n", 1)
    s = s[:a] + f + s[b:]
    s = s.replace("using mlawg::ThreadRows;\n", "using mlawg::ThreadRows;\n"
                  "__device__ long long g_trace[1 << 16];\n"
                  "#define TS(i) { const long long now_ = clock64(); tr_[i] += now_ - last_; "
                  "last_ = now_; }\n", 1)
    p.write_text(s)
    c = dst / SOURCE
    c.write_text(c.read_text() + "\nextern \"C\" int mla_trace(void* dst, int n) {\n"
                 "  return (int)cudaMemcpyFromSymbol(dst, mlatf::g_trace, (size_t)n * 8);\n}\n")
    return dst


def trace_f32() -> None:
    dst = make_trace_f32()
    sys.path.insert(0, str(dst / "src"))
    import ctypes

    import numpy as np
    import torch

    from repro_torch.kernels import mla_attention_cuda as kmla
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    lib = kmla._lib()
    lib.mla_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
    B, S, H, Dk, Dv, scale = 2, 256, 128, 576, 512, 192 ** -0.5
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(*shape, generator=gen).cuda() for shape in
               ((B, S, H, Dk), (B, S, Dk), (B, S, Dv)))
    for _ in range(3):
        kmla.mla_attention_cuda(q, k, v, True, scale)
    torch.cuda.synchronize()
    blocks = B * (S * H // 64)
    buf = np.zeros(blocks * 2 * 5, dtype=np.int64)
    if lib.mla_trace(buf.ctypes.data, buf.size) != 0:
        raise SystemExit("reading the trace failed")
    t = buf.reshape(blocks, 2, 5).astype(float).mean(0)
    print(_smi("name,power.limit,clocks.sm"))
    print(f"float32 forward, mean cycles a block over {blocks} blocks (clock64 between "
          "stamps)")
    for wg in (0, 1):
        print(f"warpgroup {wg}: {t[wg].sum():.0f}; " + ", ".join(
            f"{name} {c:.0f}" for name, c in zip(F32_PHASES, t[wg])))


def _smi(fields: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def _library() -> Path:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    return build.build_all()["mla_attention"]


def ptxas() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    build.BUILD_DIR = ROOT / "build" / "kernels_ptxas"   # a fresh build prints its log
    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)
    build.build_all()
    for line in build.BUILD_LOG["mla_attention"].splitlines():
        if "Compiling entry" in line:
            print(re.sub(r".*function '(\S+)'.*", r"\1", line))
        elif "registers" in line or "spill" in line:
            print("   ", line.strip())


def sass() -> None:
    lib = _library()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = [0, 0, 0]
        elif fn and "HGMMA" in line:
            counts[fn][0] += 1
            counts[fn][1] += ".TF32" in line
        elif fn and re.search(r"\b(ATOM|RED)\.", line):
            counts[fn][2] += 1
    for fn, (h, t, a) in counts.items():
        print(f"HGMMA {h:4d} (TF32 {t:4d})  atomics {a}  {fn}")


def main() -> None:
    if len(sys.argv) < 2 or sys.argv[1] not in ("copy", "trace", "ptxas", "sass"):
        raise SystemExit(__doc__)
    cmd, args = sys.argv[1], sys.argv[2:]
    if cmd == "copy":
        names = {**PATCHES, **F32_PATCHES}
        unknown = [a for a in args if a not in names]
        if not args or unknown:
            raise SystemExit(f"copy takes some of {', '.join(names)}")
        copy(args)
    elif cmd == "trace" and args == ["f32"]:
        trace_f32()
    else:
        {"trace": trace, "ptxas": ptxas, "sass": sass}[cmd]()


if __name__ == "__main__":
    main()
