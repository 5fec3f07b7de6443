// Blocked online-softmax attention (forward) for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention_pallas (the
// Pallas body `_kernel`):
//
//   q (B,Sq,H,D), k and v (B,Sk,H,D), one head count H (GQA callers expand
//   K/V first)  ->  o (B,Sq,H,D) in q's type,
//   o = softmax(scale * q.k^T [masked]) . v
//
// with the causal mask qpos >= kpos (no offset) when `causal`; masked
// scores are -1e30 and the row sum is floored at 1e-30 before the
// division, as in the TPU kernel.  D is 16, 32, 64, 96 or 128 (a template
// parameter: zamba2 and the dense configs have 64 or 128, phi3-mini 96,
// the reduced test configs 16); the columns a kernel pads D with are zero
// (the products over them add nothing) and never stored.  q, k and v are
// read through their batch, sequence and head strides (the last dimension
// must be contiguous).  Rows past Sq and keys past Sk are masked (the TPU
// kernel asserts S % block == 0).  With a non-null `lse` (float32,
// (B, H, Sq) contiguous) the kernels also store each row's log-sum-exp in
// natural units of s = scale * q.k, what the JAX package's flash forward
// (models/attention.py:_chunked_fwd) returns for its backward: they keep
// the row max m2 in log2 units of the scaled score and the row sum l of
// the exp2 terms, so they store (m2 + log2(max(l, 1e-30))) * ln 2.  The
// serving path passes null and stores nothing extra.  Two kernels on the
// tensor cores, chosen by the input type in flash_attention_fwd:
//
// bfloat16: flash_attention_wgmma_kernel, on the tensor cores.
//   What bounds it: at zamba2-1.2b's prefill (B=4, S=512, H=32, D=64,
//   causal) one call moves 33.6 MB (~10 us at 3.35 TB/s) and needs 4.3
//   GFLOP of products (~4.4 us at 989 TFLOP/s of bf16), so the bound is bytes and
//   the products must run on the tensor cores to come near it.
//   Design: one block per (64-row q tile, head, batch) of one consumer
//   warpgroup (warps 0-3, 64 q rows) and one producer warp (warp 4).  The
//   grid's slow dimension walks the q tiles from the last to the first, so
//   the causal blocks with the most K tiles start first.  The producer
//   loads the Q tile once by TMA and streams 64-row K and V tiles by TMA
//   into a three-stage ring (two at D = 96 and 128) guarded by mbarriers (a full
//   barrier each for K and V, one empty barrier the consumers release); the
//   maps are encoded on the host and kept by address, shape and strides, so
//   a repeated call encodes nothing.  A causal block loads
//   no tile above its diagonal (the Pallas kernel's `pl.when` skip).  All
//   tiles are bf16 in 128-byte-swizzled shared memory, 64 columns a box (D =
//   128 is two boxes; D < 64 loads one box and D = 96 two, whose columns
//   past D the TMA fills with zeros).  The tensor maps are 4-D over (D, H, S, B) with the
//   tensors' own strides, so strided views need no copy, and rows past S
//   come back as zeros.  S = Q.K^T is wgmma m64n64k16 from shared memory
//   (D/16 k steps), f32 accumulators in registers, multiplied by
//   scale * log2(e) after the product (the TPU kernel scales q in float32
//   first; rounding q * scale back to bf16 would change q itself).  The row
//   max is reduced across the four threads of a row in the accumulator
//   layout; the running max and the per-thread partial row sums stay in
//   registers.  P is rounded to bf16 in registers and is the A operand of
//   the second wgmma (O += P.V, register A, V from shared memory as an
//   MN-major B through the transpose bit), O rescaled by 2^(m_old - m_new)
//   first.  The two products are pipelined inside the warpgroup: S of tile
//   t is issued with P.V of tile t-1, and the softmax of tile t runs on the
//   CUDA cores while the tensor cores finish P.V; O is rescaled once that
//   product is in.  The epilogue divides by max(l, 1e-30), stages bf16 O through the
//   Q tile's shared memory in the same swizzled layout and stores it by TMA,
//   which clips rows past Sq and columns past D.
//
// float32: flash_attention_tf32_kernel, at float32 accuracy (3xTF32).
//   Its contract is 3e-5 against the plain version.  One TF32 product
//   keeps 10 mantissa bits of each operand and misses it, so each float32
//   operand x is split into hi = tf32(x) and lo = tf32(x - hi), both
//   rounded to nearest, and every product is lo.hi + hi.lo + hi.hi
//   accumulated in float32 by wgmma (tf32, k = 8; hopper.cuh).
//   tests/test_torch_flash_tf32.py repeats the kernel's arithmetic on the
//   CPU: 3xTF32 holds 3e-5, 1xTF32 does not.
//   What bounds it: at phi3-mini's prefill (B=2, S=256, H=32, D=96,
//   causal) one call moves 25.2 MB (7.5 us at 3.35 TB/s) and needs 0.81
//   GFLOP of products, 4.9 us at the 3xTF32 rate (495 / 3 TFLOP/s): bytes.
//   At zamba2-1.2b's (B=4, S=512, H=32, D=64) 67.1 MB (20.0 us) and 4.30
//   GFLOP (26.1 us): operations.  The FFMA kernel it replaces could not
//   come under 12.1 and 64.2 us (67 TFLOP/s).
//   Design: one block per (q tile, head, batch), the q tiles walked from
//   the last to the first as in the bf16 kernel, of one or two consumer
//   warpgroups (64 q rows each, sharing the K and V tiles: two at
//   D <= 64, one above, where two measured slower) and two producer warp
//   pairs.  The producers read with 16-byte loads (the wrapper copies a
//   view that cannot be read so), split every element into hi and lo on
//   the way and store both into 128-byte-swizzled K-major shared memory,
//   the layout tf32 wgmma reads: both pairs the Q tiles once; then the
//   first pair the K tiles, [key][d], which is K-major for the B operand of
//   Q.K^T as it lies, and the second the V tiles transposed to [d][key],
//   since tf32 wgmma takes B only K-major.  K and V^T have a ring each,
//   guarded by mbarriers: a full barrier a stage, an empty barrier a stage
//   and consumer warpgroup (one whose causal rows end a tile early never
//   takes that tile and gives nothing back), so a K slot is refilled as
//   soon as S of its tile is in.  A producer issues all of a tile's loads
//   before it waits for a free slot.  Every element passes through
//   registers for its split anyway, so neither TMA nor cp.async would save
//   that trip: they would land raw floats that a second pass over shared
//   memory splits and, for V, transposes.  The split rounds with integer
//   operations (hopper.cuh's Round::bits), faster here than the conversion
//   instruction.
//   S = Q.K^T is wgmma m64n64k8 from shared memory (D/8 k steps of three
//   products), scaled by scale * log2(e) after the product and masked; the
//   online softmax runs with exp2 in the accumulator layout, the row max
//   and sum taken across the four threads of a row, as in the bf16 kernel.
//   P stays in registers: the S accumulator holds columns 2t, 2t+1 of each
//   8 and the tf32 A fragment wants t and t+4, so the key index is permuted
//   inside each 8-wide k step (A slot t takes key 2t, slot t+4 key 2t+1),
//   V^T's keys are staged in the same order, and P is split in registers
//   into the A operand of O += P.V (wgmma m64nNk8, N = max(D, 64), A in
//   registers).  S of tile t is issued with P.V of tile t-1, and the
//   softmax of tile t runs while P.V finishes.  The epilogue divides by
//   max(l, 1e-30) and stores O from the accumulators, two floats a store.
//   Shared memory (Cfg<D>::SMEM; hi and lo double every tile; Q and K keep
//   D rounded up to 32 columns, V^T max(D, 64) rows; + 1 KiB of alignment;
//   one block a SM):
//     D        Q tiles      K stage x depth   V^T stage x depth   total
//     16, 32   2 x 16 KiB   16 KiB x 2        32 KiB x 2          129 KiB
//     64       2 x 32       32 x 2            32 x 2              193
//     96       1 x 48       48 x 1            48 x 2              193
//     128      1 x 64       64 x 1            64 x 1              193
//   With one K stage the producers store K of tile t+1 while the consumer
//   is still in the softmax and P.V of tile t; D = 128 also waits for V.
//   Card times, the variants measured and what bounds them: PERF.md
//   (tools/flash_f32_timing.py).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <mutex>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

struct Strides {
  int64_t b, s, h;
};

// the epilogue's log-sum-exp of this thread's two rows i0 and i0 + 8 (the
// row max in log2 units, the row sum of exp2 terms), stored by the first
// of the row's four threads; lse is (B, H, Sq) and may be null
__device__ __forceinline__ void store_lse(float* lse, int b, int h, int H, int Sq, int i0,
                                          int lane, float m0, float l0, float m1, float l1) {
  if (lse == nullptr || lane % 4 != 0) return;
  float* row = lse + ((int64_t)b * H + h) * Sq;
  if (i0 < Sq) row[i0] = (m0 + log2f(fmaxf(l0, 1e-30f))) * LN2;
  if (i0 + 8 < Sq) row[i0 + 8] = (m1 + log2f(fmaxf(l1, 1e-30f))) * LN2;
}

// ------------------------------------------------------------------------
// float32: 3xTF32 wgmma kernel
// ------------------------------------------------------------------------

namespace tf32 {

constexpr int WG_Q = 64;                // q rows of a consumer warpgroup
constexpr int BN = 64;                  // keys per K / V tile
constexpr int MAX_WG = 2;
constexpr int MAX_STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int DK = (D + 31) / 32 * 32;   // Q and K columns in shared memory
  static constexpr int DN = D < 64 ? 64 : D;      // V^T rows = O columns (n of P.V)
  static constexpr int KS = D / 8;                // k steps of Q.K^T
  static constexpr int OREG = DN / 2;             // O accumulator floats a thread
  static constexpr int QT = WG_Q * DK * 4;        // bytes of a Q or K tile, hi or lo
  static constexpr int VT = DN * BN * 4;          // bytes of a V^T tile, hi or lo
  // consumer warpgroups, each 64 q rows of the block, sharing the K and
  // V^T tiles (at D = 96 two fit only with one V stage, and measured
  // slower than one)
  static constexpr int WG = D <= 64 ? 2 : 1;
  static constexpr int BM = WG * WG_Q;            // q rows per block
  static constexpr int CONSUMERS = 128 * WG;
  // producer threads of each ring
  static constexpr int PROD = 64;
  static constexpr int THREADS = CONSUMERS + 2 * PROD;
  static constexpr int KST = D <= 64 ? 2 : 1;     // depth of the K ring
  static constexpr int VST = D <= 96 ? 2 : 1;     // depth of the V ring
  // + 1 KiB to align the tiles to the swizzle's 1024-byte period
  static constexpr size_t SMEM =
      1024 + (size_t)2 * QT * (WG + KST) + (size_t)2 * VT * VST;
};

// d += P . V^T over the tile's 8 k steps, P split in registers (pl, ph)
// and V^T split in shared memory (v_hi, v_lo): lo.hi, hi.lo, hi.hi
template <int DN, int N>
__device__ __forceinline__ void mma3_pv(float (&d)[N], const uint32_t* ph, const uint32_t* pl,
                                        uint32_t v_hi, uint32_t v_lo) {
#pragma unroll
  for (int kk = 0; kk < BN / 8; ++kk) {
    const uint64_t dh = desc_k(v_hi, kk, DN), dl = desc_k(v_lo, kk, DN);
    if constexpr (DN == 128) {
      wgmma_tf32_rs_n128(d, pl + 4 * kk, dh);
      wgmma_tf32_rs_n128(d, ph + 4 * kk, dl);
      wgmma_tf32_rs_n128(d, ph + 4 * kk, dh);
    } else if constexpr (DN == 96) {
      wgmma_tf32_rs_n96(d, pl + 4 * kk, dh);
      wgmma_tf32_rs_n96(d, ph + 4 * kk, dl);
      wgmma_tf32_rs_n96(d, ph + 4 * kk, dh);
    } else {
      wgmma_tf32_rs_n64(d, pl + 4 * kk, dh);
      wgmma_tf32_rs_n64(d, ph + 4 * kk, dl);
      wgmma_tf32_rs_n64(d, ph + 4 * kk, dh);
    }
  }
}

// K tiles a causal block of q rows [q0, q0 + rows) needs: up to its last
// row's diagonal
__device__ __forceinline__ int tiles_for(int q0, int rows, int Sq, int Sk, int causal) {
  const int n = (Sk + BN - 1) / BN;
  return causal ? min(n, (min(q0 + rows, Sq) - 1) / BN + 1) : n;
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
flash_attention_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ o,
                            float* __restrict__ lse, int Sq, int Sk, int H, int n_qt,
                            Strides sq, Strides sk, Strides sv, Strides so, float scale_log2,
                            int causal) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  // q_full; k_full[s], v_full[s]; k_empty[s][w], v_empty[s][w]: an empty
  // barrier a consumer warpgroup, so that one whose causal rows end a tile
  // early gives back nothing it never took
  __shared__ __align__(8) uint64_t bars[1 + 2 * MAX_STAGES + 2 * MAX_STAGES * MAX_WG];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = base;                           // warpgroup w: hi, then lo
  uint8_t* sK = sQ + 2 * C::QT * C::WG;         // stage s: hi, then lo
  uint8_t* sV = sK + 2 * C::QT * C::KST;        // stage s: hi, then lo
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + MAX_STAGES;
  uint64_t* k_empty = bars + 1 + 2 * MAX_STAGES;                       // [s * MAX_WG + w]
  uint64_t* v_empty = bars + 1 + 2 * MAX_STAGES + MAX_STAGES * MAX_WG;  // [s * MAX_WG + w]

  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * C::BM;    // most K tiles first
  const int n_kt = tiles_for(q0, C::BM, Sq, Sk, causal);
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_full, 2 * C::PROD);
    for (int s = 0; s < MAX_STAGES; ++s) {
      mbar_init(&k_full[s], C::PROD);
      mbar_init(&v_full[s], C::PROD);
      for (int w = 0; w < MAX_WG; ++w) {
        mbar_init(&k_empty[s * MAX_WG + w], 128);
        mbar_init(&v_empty[s * MAX_WG + w], 128);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= C::CONSUMERS) {
    // ------------------------------------------------------ producers
    // all of them split the Q tiles, then one half streams the K tiles and
    // the other the V^T tiles, each through its own ring; a slot is
    // refilled once every warpgroup that reads its tile has given it back
    const int ptid = tid - C::CONSUMERS;
    for (int w = 0; w < C::WG; ++w) {
      const int qw = q0 + w * WG_Q;
      if (qw >= Sq) break;
      Rows<C::DK, 2 * C::PROD, Round::bits> qt;
      qt.load(q + b * sq.b + h * sq.h + (int64_t)qw * sq.s, sq.s, min(WG_Q, Sq - qw), D, true,
              ptid);
      qt.store(sQ + w * 2 * C::QT, sQ + w * 2 * C::QT + C::QT, ptid);
    }
    fence_async_shared();
    mbar_arrive(q_full);
    int n_kw[C::WG];   // K tiles each warpgroup reads
#pragma unroll
    for (int w = 0; w < C::WG; ++w)
      n_kw[w] = q0 + w * WG_Q < Sq ? tiles_for(q0 + w * WG_Q, WG_Q, Sq, Sk, causal) : 0;
    auto wait_empty = [&](uint64_t* empty, int t, int st) {
#pragma unroll
      for (int w = 0; w < C::WG; ++w)
        if (t - st >= 0 && t - st < n_kw[w])
          mbar_wait(&empty[(t % st) * MAX_WG + w], ((t / st) & 1) ^ 1);
    };
    if (ptid < C::PROD) {
      const float* kb = k + b * sk.b + h * sk.h;
      Rows<C::DK, C::PROD, Round::bits> kt;
      for (int t = 0; t < n_kt; ++t) {
        const int s = t % C::KST;
        kt.load(kb + (int64_t)t * BN * sk.s, sk.s, min(BN, Sk - t * BN), D, true, ptid);
        wait_empty(k_empty, t, C::KST);
        uint8_t* slot = sK + s * 2 * C::QT;
        kt.store(slot, slot + C::QT, ptid);
        fence_async_shared();
        mbar_arrive(&k_full[s]);
      }
    } else {
      const int vtid = ptid - C::PROD;
      const float* vb = v + b * sv.b + h * sv.h;
      auto unit = [](int, bool, float& s1, float& s2) { s1 = s2 = 1.f; };
      Cols<C::DN, C::PROD, Round::bits> vt;
      for (int t = 0; t < n_kt; ++t) {
        const int s = t % C::VST;
        vt.load(vb + (int64_t)t * BN * sv.s, sv.s, min(BN, Sk - t * BN), D, true, unit, vtid);
        wait_empty(v_empty, t, C::VST);
        uint8_t* slot = sV + s * 2 * C::VT;
        vt.store(slot, slot + C::VT, vtid);
        fence_async_shared();
        mbar_arrive(&v_full[s]);
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  // Each warpgroup owns 64 q rows.  As in the bf16 kernel: S of tile t is
  // issued with P.V of tile t-1, and the softmax of tile t runs while the
  // tensor cores finish P.V; the other warpgroup's products fill the gaps.
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int qw = q0 + wg * WG_Q;
  if (qw >= Sq) return;                    // the last block's rows may end early
  const int n_t = tiles_for(qw, WG_Q, Sq, Sk, causal);
  const int row0 = warp * 16 + lane / 4;   // this thread's rows: row0, row0 + 8
  const int cq = (lane % 4) * 2;           // its first column in each 8-column group
  float oacc[C::OREG];
  zero(oacc);
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float sc[32];
  uint32_t ph[32], pl[32];
  const uint32_t q_hi = smem_u32(sQ + wg * 2 * C::QT), q_lo = q_hi + C::QT;

  // S = Q.K^T of tile t into sc, issued and committed (not waited for)
  auto issue_qk = [&](int t) {
    const int s = t % C::KST;
    zero(sc);
    mbar_wait(&k_full[s], (t / C::KST) & 1);
    const uint32_t k_hi = smem_u32(sK + s * 2 * C::QT);
    wg_fence();
    mma3_ss_n64(sc, q_hi, q_lo, k_hi, k_hi + C::QT, C::KS, BN);
    wg_commit();
  };
  // O += P.V of tile t (P in ph, pl), issued and committed
  auto issue_pv = [&](int t) {
    const int s = t % C::VST;
    mbar_wait(&v_full[s], (t / C::VST) & 1);
    const uint32_t v_hi = smem_u32(sV + s * 2 * C::VT);
    wg_fence();
    mma3_pv<C::DN>(oacc, ph, pl, v_hi, v_hi + C::VT);
    wg_commit();
  };
  // the online softmax of tile t's scores: sc becomes P, the running max
  // and partial sums advance, and the factors O must be rescaled by come
  // back in a0, a1
  float a0 = 1.f, a1 = 1.f;
  auto softmax = [&](int t) {
    const int k0 = t * BN;
    const bool edge = k0 + BN > Sk || qw + WG_Q > Sq || (causal && k0 + BN - 1 > qw);
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      float x = sc[r] * scale_log2;
      if (edge) {
        const int j = k0 + (r / 4) * 8 + cq + (r % 2);
        const int i = qw + row0 + ((r % 4) >= 2 ? 8 : 0);
        if (j >= Sk || i >= Sq || (causal && j > i)) x = NEG_INF;
      }
      sc[r] = x;
      if ((r % 4) < 2) mx0 = fmaxf(mx0, x);
      else mx1 = fmaxf(mx1, x);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    a0 = exp2f(m0 - mn0);
    a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      if ((r % 4) < 2) {
        sc[r] = exp2f(sc[r] - mn0);
        rs0 += sc[r];
      } else {
        sc[r] = exp2f(sc[r] - mn1);
        rs1 += sc[r];
      }
    }
    l0 = l0 * a0 + rs0;   // this thread's columns; the row's four join at the end
    l1 = l1 * a1 + rs1;
  };
  // P split into tf32 A fragments, with the keys permuted inside each
  // 8-wide k step (V^T is staged in the same order): a thread holds S's
  // columns 2t, 2t+1 of each 8, and A slot t takes column 2t, slot t + 4
  // column 2t + 1.  Fragment order: (row, slot t), (row + 8, t),
  // (row, t + 4), (row + 8, t + 4).
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      split<Round::bits>(sc[4 * kk + 0], ph[4 * kk + 0], pl[4 * kk + 0]);
      split<Round::bits>(sc[4 * kk + 2], ph[4 * kk + 1], pl[4 * kk + 1]);
      split<Round::bits>(sc[4 * kk + 1], ph[4 * kk + 2], pl[4 * kk + 2]);
      split<Round::bits>(sc[4 * kk + 3], ph[4 * kk + 3], pl[4 * kk + 3]);
    }
  };
  uint64_t* my_k_empty = k_empty + wg;
  uint64_t* my_v_empty = v_empty + wg;

  mbar_wait(q_full, 0);
  issue_qk(0);
  wg_wait_all();
  fence_regs(sc);
  mbar_arrive(&my_k_empty[0]);
  softmax(0);
  pack_p();
  for (int t = 1; t < n_t; ++t) {
    issue_qk(t);
    issue_pv(t - 1);
    wg_wait_one();   // S of tile t is in; P_{t-1}.V_{t-1} may still run
    fence_regs(sc);
    mbar_arrive(&my_k_empty[(t % C::KST) * MAX_WG]);
    softmax(t);
    wg_wait_all();
    fence_regs(oacc);
    mbar_arrive(&my_v_empty[((t - 1) % C::VST) * MAX_WG]);
#pragma unroll
    for (int r = 0; r < C::OREG; ++r) oacc[r] *= (r % 4) < 2 ? a0 : a1;
    pack_p();
  }
  issue_pv(n_t - 1);
  wg_wait_all();
  fence_regs(oacc);
  mbar_arrive(&my_v_empty[((n_t - 1) % C::VST) * MAX_WG]);

  // ----------------------------------------------------------- epilogue
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  store_lse(lse, b, h, H, Sq, qw + row0, lane, m0, l0, m1, l1);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  float* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < C::OREG; r += 2) {
    const int i = qw + row0 + ((r % 4) >= 2 ? 8 : 0);
    const int col = (r / 4) * 8 + cq;
    const float inv = (r % 4) >= 2 ? inv1 : inv0;
    if (i < Sq && col < D)
      *reinterpret_cast<float2*>(ob + (int64_t)i * so.s + col) =
          make_float2(oacc[r] * inv, oacc[r + 1] * inv);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int64_t B,
           int64_t Sq, int64_t Sk, int64_t H, Strides sq, Strides sk, Strides sv, Strides so,
           float scale, int causal, int device, cudaStream_t stream) {
  // 16-byte loads: 16-byte-aligned bases and strides of whole float4s
  const void* ptrs[] = {q, k, v, o};
  const Strides strides[] = {sq, sk, sv, so};
  for (int i = 0; i < 4; ++i)
    if ((uintptr_t)ptrs[i] % 16 || strides[i].b % 4 || strides[i].s % 4 || strides[i].h % 4)
      return -3;
  auto kern = flash_attention_tf32_kernel<D>;
  const size_t smem = Cfg<D>::SMEM;
  static bool smem_set[64] = {};   // per device; setting it twice is harmless
  if (device < 0 || device >= 64 || !smem_set[device]) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (device >= 0 && device < 64) smem_set[device] = true;
  }
  const int64_t n_qt = (Sq + Cfg<D>::BM - 1) / Cfg<D>::BM;
  if (B * H > 0x7fffffff || n_qt > 65535) return -1;
  const dim3 grid((unsigned)(B * H), (unsigned)n_qt);
  kern<<<grid, Cfg<D>::THREADS, smem, stream>>>((const float*)q, (const float*)k,
                                                (const float*)v, (float*)o, lse, (int)Sq,
                                                (int)Sk, (int)H, (int)n_qt, sq, sk, sv, so,
                                                scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int64_t B,
             int64_t Sq, int64_t Sk, int64_t H, int64_t D, Strides sq, Strides sk, Strides sv,
             Strides so, float scale, int causal, int dev, cudaStream_t st) {
  switch (D) {
    case 16:
      return launch<16>(q, k, v, o, lse, B, Sq, Sk, H, sq, sk, sv, so, scale, causal, dev, st);
    case 32:
      return launch<32>(q, k, v, o, lse, B, Sq, Sk, H, sq, sk, sv, so, scale, causal, dev, st);
    case 64:
      return launch<64>(q, k, v, o, lse, B, Sq, Sk, H, sq, sk, sv, so, scale, causal, dev, st);
    case 96:
      return launch<96>(q, k, v, o, lse, B, Sq, Sk, H, sq, sk, sv, so, scale, causal, dev, st);
    case 128:
      return launch<128>(q, k, v, o, lse, B, Sq, Sk, H, sq, sk, sv, so, scale, causal, dev, st);
    default: return -1;
  }
}

}  // namespace tf32

// ------------------------------------------------------------------------
// bfloat16: TMA-fed wgmma kernel
// ------------------------------------------------------------------------

namespace tc {

constexpr int BM = 64;                 // q rows per block (one warpgroup)
constexpr int BN = 64;                 // k/v rows per tile
constexpr int MAX_STAGES = 3;          // depth of the K/V ring: 3, 2 at D = 96 and 128
constexpr int CONSUMERS = 128;         // warps 0-3
constexpr int THREADS = CONSUMERS + 32;   // + the producer warp
constexpr int BOX_BYTES = 64 * 128;    // one box: 64 rows x 64 bf16 columns
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int DP = (D + 63) / 64 * 64;   // columns in shared memory
  static constexpr int CH = DP / 64;           // boxes per tile
  static constexpr int KS = D / 16;            // k steps of Q.K^T
  static constexpr int OREG = DP / 2;          // O accumulator floats a thread
  static constexpr int TILE = CH * BOX_BYTES;  // bytes of one Q, K or V tile
  static constexpr int STAGES = D <= 64 ? 3 : 2;
  // + 1 KiB to align the tiles to the 128-byte swizzle's 1024-byte period
  static constexpr size_t SMEM = 1024 + (size_t)TILE * (1 + 2 * STAGES);
};

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// the consumer warpgroup's own barrier (id 1; 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// K-major operand (Q, K): rows of 128 bytes, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return desc_sw128(addr, 16, 1024);
}

// MN-major operand (V as B of P.V): a 16-key step is two 8-key groups 1024
// bytes apart; the 64-column boxes of D = 96 and 128 are BOX_BYTES apart
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr) {
  return desc_sw128(addr, BOX_BYTES, 1024);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (m64 x n64, f32) += A (smem, K-major) . B (smem, K-major), bf16
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (m64 x n64, f32) += A (registers, bf16x2) . B (smem, MN-major), bf16
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n128, f32) += A (registers, bf16x2) . B (smem, MN-major), bf16
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap to, float* __restrict__ lse,
                             int Sq, int Sk, int H, int n_qt, float scale_log2, int causal) {
  using C = Cfg<D>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * MAX_STAGES];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = base;
  uint8_t* sK = sQ + C::TILE;
  uint8_t* sV = sK + STAGES * C::TILE;
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + STAGES;
  uint64_t* empty = bars + 1 + 2 * STAGES;

  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * BM;    // most K tiles first
  int n_kt = (Sk + BN - 1) / BN;
  if (causal) n_kt = min(n_kt, (min(q0 + BM, Sq) - 1) / BN + 1);
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ------------------------------------------------ producer warp
    if (tid == CONSUMERS) {
      mbar_expect_tx(q_full, C::TILE);
      for (int c = 0; c < C::CH; ++c) tma_load_4d(sQ + c * BOX_BYTES, &tq, q_full, c * 64, h, q0, b);
      for (int t = 0; t < n_kt; ++t) {
        const int s = t % STAGES;
        mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(&k_full[s], C::TILE);
        for (int c = 0; c < C::CH; ++c)
          tma_load_4d(sK + s * C::TILE + c * BOX_BYTES, &tk, &k_full[s], c * 64, h, t * BN, b);
        mbar_expect_tx(&v_full[s], C::TILE);
        for (int c = 0; c < C::CH; ++c)
          tma_load_4d(sV + s * C::TILE + c * BOX_BYTES, &tv, &v_full[s], c * 64, h, t * BN, b);
      }
    }
    return;
  }

  // -------------------------------------------------- consumer warpgroup
  // Software pipeline inside the warpgroup: while the softmax of tile t
  // runs on the CUDA cores, the tensor cores finish P_{t-1}.V_{t-1}; O is
  // rescaled for tile t once that product is done.
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = warp * 16 + lane / 4;   // this thread's rows: row0, row0 + 8
  const int cq = (lane % 4) * 2;           // its first column in each 8-column group
  float o[C::OREG];
#pragma unroll
  for (int r = 0; r < C::OREG; ++r) o[r] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float sc[32];
  uint32_t pa[16];
  const uint32_t q_addr = smem_u32(sQ);

  // S = Q.K^T of tile t into sc, issued and committed (not waited for)
  auto issue_qk = [&](int t) {
    const int s = t % STAGES;
#pragma unroll
    for (int r = 0; r < 32; ++r) sc[r] = 0.f;
    mbar_wait(&k_full[s], (t / STAGES) & 1);
    const uint32_t k_addr = smem_u32(sK + s * C::TILE);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk) {
      const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
      wgmma_ss_n64(sc, desc_kmajor(q_addr + off), desc_kmajor(k_addr + off), kk > 0);
    }
    wg_commit();
  };
  // O += P.V of tile t (P in pa), issued and committed
  auto issue_pv = [&](int t) {
    const int s = t % STAGES;
    mbar_wait(&v_full[s], (t / STAGES) & 1);
    const uint32_t v_addr = smem_u32(sV + s * C::TILE);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      if constexpr (C::DP == 128)
        wgmma_rs_n128(o, pa + 4 * kk, desc_mnmajor(v_addr + kk * 16 * 128));
      else
        wgmma_rs_n64(o, pa + 4 * kk, desc_mnmajor(v_addr + kk * 16 * 128));
    }
    wg_commit();
  };
  // the online softmax of tile t's scores: sc becomes P (f32), the running
  // max and partial sums advance, and the factors O must be rescaled by
  // come back in a0, a1
  float a0 = 1.f, a1 = 1.f;
  auto softmax = [&](int t) {
    const int k0 = t * BN;
    // scores in log2 units, masked; row max over the row's four threads
    const bool edge = k0 + BN > Sk || q0 + BM > Sq || (causal && k0 + BN - 1 > q0);
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      float v = sc[r] * scale_log2;
      if (edge) {
        const int j = k0 + (r / 4) * 8 + cq + (r % 2);
        const int i = q0 + row0 + ((r % 4) >= 2 ? 8 : 0);
        if (j >= Sk || i >= Sq || (causal && j > i)) v = NEG_INF;
      }
      sc[r] = v;
      if ((r % 4) < 2) mx0 = fmaxf(mx0, v);
      else mx1 = fmaxf(mx1, v);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    a0 = exp2f(m0 - mn0);
    a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      if ((r % 4) < 2) {
        sc[r] = exp2f(sc[r] - mn0);
        rs0 += sc[r];
      } else {
        sc[r] = exp2f(sc[r] - mn1);
        rs1 += sc[r];
      }
    }
    l0 = l0 * a0 + rs0;   // this thread's columns; the row's four join at the end
    l1 = l1 * a1 + rs1;
  };
  // P in bf16: the accumulator layout of S is the A-fragment layout of P.V
  auto pack_p = [&]() {
#pragma unroll
    for (int i = 0; i < 16; ++i) pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
  };

  mbar_wait(q_full, 0);
  issue_qk(0);
  wg_wait_all();
  fence_regs(sc);
  softmax(0);
  pack_p();
  for (int t = 1; t < n_kt; ++t) {
    issue_qk(t);
    issue_pv(t - 1);
    wg_wait_one();   // S of tile t is in; P_{t-1}.V_{t-1} may still run
    fence_regs(sc);
    softmax(t);
    wg_wait_all();
    fence_regs(o);
    mbar_arrive(&empty[(t - 1) % STAGES]);
#pragma unroll
    for (int r = 0; r < C::OREG; ++r) o[r] *= (r % 4) < 2 ? a0 : a1;
    pack_p();
  }
  issue_pv(n_kt - 1);
  wg_wait_all();
  fence_regs(o);
  mbar_arrive(&empty[(n_kt - 1) % STAGES]);

  // ----------------------------------------------------------- epilogue
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  store_lse(lse, b, h, H, Sq, q0 + row0, lane, m0, l0, m1, l1);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  consumers_sync();   // every warp's products that read the Q tile are done
#pragma unroll
  for (int r = 0; r < C::OREG; r += 2) {
    const int row = row0 + ((r % 4) >= 2 ? 8 : 0);
    const float inv = (r % 4) >= 2 ? inv1 : inv0;
    const int col = (r / 4) * 8 + cq;
    const int cc = col % 64;
    const uint32_t off = (col / 64) * BOX_BYTES + row * 128 + (((cc / 8) ^ (row % 8)) * 16) +
                         (cc % 8) * 2;
    *reinterpret_cast<uint32_t*>(sQ + off) = pack_bf16(o[r] * inv, o[r + 1] * inv);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  consumers_sync();
  if (tid == 0) {
    for (int c = 0; c < C::CH; ++c) tma_store_4d(&to, sQ + c * BOX_BYTES, c * 64, h, q0, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time (cudaGetDriverEntryPoint), so the
// library needs no -lcuda
EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &res);
#endif
    if (err != cudaSuccess || res != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a 4-D map over (D, H, S, B) of a bf16 tensor with element strides `st`,
// boxes of 64 columns x 1 head x 64 rows x 1 batch, 128-byte swizzle
int make_map(CUtensorMap* map, const void* ptr, int64_t B, int64_t S, int64_t H, int64_t D,
             Strides st) {
  EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return -3;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)BM, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

// Encoded maps, kept by everything they encode: a map is a function of the
// base address, the shape and the strides, so a hit is the same map.  The
// prefill calls the kernel with the same few tensors over and over, and an
// encode costs host time on every launch otherwise.
struct MapKey {
  const void* ptr;
  int64_t B, S, H, D, sb, ss, sh;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && B == o.B && S == o.S && H == o.H && D == o.D && sb == o.sb &&
           ss == o.ss && sh == o.sh;
  }
};
constexpr int MAP_SLOTS = 64;
struct MapSlot {
  MapKey key;
  CUtensorMap map;
  bool used;
};
MapSlot g_map_slots[MAP_SLOTS];
std::mutex g_map_mutex;

int cached_map(CUtensorMap* map, const void* ptr, int64_t B, int64_t S, int64_t H, int64_t D,
               Strides st) {
  const MapKey key{ptr, B, S, H, D, st.b, st.s, st.h};
  uint64_t h = (uint64_t)(uintptr_t)ptr;
  for (int64_t f : {B, S, H, D, st.b, st.s, st.h}) h = (h ^ (uint64_t)f) * 0x9E3779B97F4A7C15ull;
  MapSlot& slot = g_map_slots[(h >> 32) % MAP_SLOTS];
  std::lock_guard<std::mutex> lock(g_map_mutex);
  if (slot.used && slot.key == key) {
    *map = slot.map;
    return 0;
  }
  const int rc = make_map(map, ptr, B, S, H, D, st);
  if (rc == 0) slot = MapSlot{key, *map, true};
  return rc;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int64_t B,
           int64_t Sq, int64_t Sk, int64_t H, Strides sq, Strides sk, Strides sv, Strides so,
           float scale, int causal, int device, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  int rc;
  if ((rc = cached_map(&tq, q, B, Sq, H, D, sq)) != 0) return rc;
  if ((rc = cached_map(&tk, k, B, Sk, H, D, sk)) != 0) return rc;
  if ((rc = cached_map(&tv, v, B, Sk, H, D, sv)) != 0) return rc;
  if ((rc = cached_map(&to, o, B, Sq, H, D, so)) != 0) return rc;
  auto kern = flash_attention_wgmma_kernel<D>;
  const size_t smem = Cfg<D>::SMEM;
  static bool smem_set[64] = {};   // per device; setting it twice is harmless
  if (device < 0 || device >= 64 || !smem_set[device]) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (device >= 0 && device < 64) smem_set[device] = true;
  }
  const int64_t n_qt = (Sq + BM - 1) / BM;
  if (B * H > 0x7fffffff || n_qt > 65535) return -1;
  const dim3 grid((unsigned)(B * H), (unsigned)n_qt);
  kern<<<grid, THREADS, smem, stream>>>(tq, tk, tv, to, lse, (int)Sq, (int)Sk, (int)H,
                                        (int)n_qt, scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* o, float* lse, int64_t B,
             int64_t Sq, int64_t Sk, int64_t H, int64_t D, Strides sq, Strides sk, Strides sv,
             Strides so, float scale, int causal, int dev, cudaStream_t st) {
  switch (D) {
    case 16:
      return launch<16>(q, k, v, o, lse, B, Sq, Sk, H, sq, sk, sv, so, scale, causal, dev, st);
    case 32:
      return launch<32>(q, k, v, o, lse, B, Sq, Sk, H, sq, sk, sv, so, scale, causal, dev, st);
    case 64:
      return launch<64>(q, k, v, o, lse, B, Sq, Sk, H, sq, sk, sv, so, scale, causal, dev, st);
    case 96:
      return launch<96>(q, k, v, o, lse, B, Sq, Sk, H, sq, sk, sv, so, scale, causal, dev, st);
    case 128:
      return launch<128>(q, k, v, o, lse, B, Sq, Sk, H, sq, sk, sv, so, scale, causal, dev, st);
    default: return -1;
  }
}

}  // namespace tc

}  // namespace

// Returns the CUDA error of the launch (0 on success); -1 for a shape the
// kernel does not take (D not 16, 32, 64, 96 or 128, an empty or oversized
// grid), -2 for a dtype code other than 0 (float32) or 1 (bfloat16), -3
// when a tensor cannot be read as it is (a base not 16-byte aligned, a
// stride not a multiple of 16 bytes: no bfloat16 tensor map, no float32
// 16-byte loads; the wrapper copies such tensors first).  Strides are in
// elements: (batch, sequence, head) for each of q, k, v and o.  `lse` is
// null or a contiguous float32 (B, H, Sq) tensor that receives each row's
// log-sum-exp.  float32 runs the 3xTF32 kernel, bfloat16 the bf16 one.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int64_t B, int64_t Sq, int64_t Sk, int64_t H,
                                   int64_t D, int64_t qb, int64_t qs, int64_t qh, int64_t kb,
                                   int64_t ks, int64_t kh, int64_t vb, int64_t vs,
                                   int64_t vh, int64_t ob, int64_t os, int64_t oh,
                                   float scale, int causal, int dtype, int device,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || B > 65535 || H > 65535 ||
      Sq > ((int64_t)1 << 30) || Sk > ((int64_t)1 << 30))
    return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Strides sq{qb, qs, qh}, sk{kb, ks, kh}, sv{vb, vs, vh}, so{ob, os, oh};
  cudaStream_t st = (cudaStream_t)stream;
  float* l = (float*)lse;
  if (dtype == 0)
    return tf32::dispatch(q, k, v, o, l, B, Sq, Sk, H, D, sq, sk, sv, so, scale, causal, device,
                          st);
  if (dtype == 1)
    return tc::dispatch(q, k, v, o, l, B, Sq, Sk, H, D, sq, sk, sv, so, scale, causal, device, st);
  return -2;
}
