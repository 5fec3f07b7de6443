// One Mamba2 SSD chunk (state-space duality) for Hopper (sm_90a), its
// products on the tensor cores at float32 accuracy (3xTF32).
//
// Replaces src/repro/kernels/ssd_scan.py:ssd_chunk_pallas (the Pallas body
// `_kernel`), the TPU version of src/repro/models/ssd.py:_chunk_scan_step.
// Per (batch b, head h), with a = dt * A and cum its inclusive prefix sum
// over the chunk's Q rows and xbar_j = dt_j x_j:
//
//   y[i]   = sum_{j <= i} exp(cum_i - cum_j) (C_i . B_j) xbar_j
//            + exp(cum_i) (C_i . state)
//   state' = exp(cum_{Q-1}) state + sum_j exp(cum_{Q-1} - cum_j) xbar_j (x) B_j
//
//   x (B,Q,H,P), dt (B,Q,H), A (H,), B and C (B,Q,H,N), state (B,H,P,N), all
//   float32  ->  y (B,Q,H,P), state' (B,H,P,N), float32, contiguous.
//
// x, dt, B and C are read through their (batch, row, head) strides, so a
// chunk's slice of a whole-sequence tensor needs no copy, and B and C may
// have head stride 0: the model hands one group's (B,S,N) tensor to all the
// heads as an expanded view.  Their last dimension must be contiguous.
// P <= 64 and N <= 128 (every config of the repo: P = 64, N = 64 or 128);
// any Q whose prefix sum fits in shared memory (a ragged last tile is
// masked).
//
// Precision (3xTF32).  A TF32 product keeps 10 mantissa bits of each
// operand, which does not hold the 1e-4 the plain version is held to.  Each
// float32 operand x is split into hi = tf32(x) (cvt.rna) and lo = tf32(x -
// hi), and every product is hi.hi + hi.lo + lo.hi accumulated in float32 by
// wgmma (tf32, k = 8): the dropped lo.lo term and lo's own rounding are
// ~2^-21 of each product.  tests/test_torch_ssd_chunk.py shows on the CPU
// that this split holds 1e-4 and that 1xTF32 does not.
//
// What bounds it: at zamba2-1.2b's chunk (B=4, Q=256, H=64, P=N=64, B and C
// read once per group) ~42.6 MB move (12.7 us at 3.35 TB/s) and ~2.15
// GFLOP of products are needed with C.B^T counted once per (batch, group),
// 13 us at the 3xTF32 rate (495 / 3 TFLOP/s): operations.  This kernel
// computes C.B^T once per (batch, head), 3.2 GFLOP (19.5 us at that rate).
//
// Design: one block per (h, b) of three warpgroups.  Warpgroups 1-2 (the
// producers) read tiles from global memory (16-byte loads, all of a tile's
// issued before they wait for a free slot), split them into tf32 hi and
// lo, and store both in 128-byte-swizzled K-major shared memory, the
// layout wgmma reads.  They run ahead through a ring of STAGES tile slots
// and CBUFS C_i buffers (two of each at N <= 64, one at N = 128) guarded
// by mbarriers, so the loads overlap the products.  Warpgroup 0 (the
// consumer) runs the products on 64-row tiles:
//   * per 64-row i-tile: C_i is staged once; the state term C_i . state^T
//     (state is K-major as it lies, (p, n)) is scaled by exp(cum_i) per
//     row; then for each j-tile up to the diagonal G = C_i . B_j^T (B_j
//     K-major as it lies) lands in registers, the decay exp(cum_i - cum_j)
//     and the causal mask are applied there, each element's (i, j) taken
//     from the accumulator layout, the mask BEFORE the exp (above the
//     diagonal cum_i - cum_j > 0 overflows), and S = G (.) decay is split
//     in registers and is the register A operand of y += S . xbar_j.
//   * tf32 wgmma reads shared-memory operands only K-major, so xbar_j is
//     staged transposed, (p, j), by the producer's stores.  The
//     accumulator layout of S is not the tf32 A-fragment layout: a thread
//     holds S's columns 2t, 2t+1 of each 8 and the A fragment wants t,
//     t+4.  Instead of moving S, the k index is permuted inside each
//     8-wide k step: A slot t takes column 2t and slot t+4 column 2t+1,
//     and xbar_j's rows are staged in the same permuted order.
//   * the new state is a last pass over the j-tiles: state' (p, n) =
//     (xbar w)^T (p, j) . B^T (n, j), both staged transposed with the same
//     permutation of j, w_j = exp(cum_{Q-1} - cum_j).
// Diagonal tiles run whole k steps: an m64 wgmma spans all 64 rows of the
// i-tile, and row 63 needs every column, so no k step of the diagonal
// tile can be skipped.  The tiles come in through 16-byte loads into
// registers, not TMA or cp.async: every element has to pass through
// registers for its hi/lo split anyway, and the transposed tiles are 4-byte
// elements TMA cannot transpose.  Shared memory (ssd_chunk_smem_bytes in
// ssd_chunk_cuda.py): 198,704 bytes at Q = 256 and N = 64, 165,936 at
// N = 128, so one block a SM and zamba2's 256 blocks in two waves.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W: 85-125
// us of card time at zamba2's chunk (the FFMA kernel before it: ~207),
// ~127 us inside a prefill (~251), 6.5-10x the 13 us bound.  What holds it
// there: each block walks its 18 tiles one after another, and a tile is a
// chain of ~3 us (the consumer's two wgmma chains, waited for, and the
// decay, mask and split between them, ~2.3 us alone; the producers'
// loads, splits and stores overlap it only in part), with one consumer
// warpgroup per SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int T = 64;              // rows of an i-tile and a j-tile; P is padded to 64
constexpr int CONSUMERS = 128;     // warpgroup 0: the products
constexpr int PRODUCERS = 256;     // warpgroups 1-2: global -> tf32 hi/lo -> shared
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_STAGES = 2;

struct Str3 {
  int64_t b, q, h;
};

template <int NT>
struct Cfg {
  static constexpr int STAGES = NT <= 64 ? 2 : 1;
  static constexpr int CBUFS = NT <= 64 ? 2 : 1;   // C_i tiles in flight
  static constexpr int TILE = T * NT * 4;   // bytes of a 64 x NT (or NT x 64) tile
  static constexpr int XT = T * T * 4;      // bytes of a 64 x 64 tile
  // C_i hi and lo, then per stage: the B slot (B_j, state or B_j^T) hi and
  // lo and the X slot (xbar_j^T) hi and lo
  static constexpr int STAGE = 2 * TILE + 2 * XT;
  static constexpr size_t TILES = (size_t)CBUFS * 2 * TILE + (size_t)STAGES * STAGE;
};

size_t smem_bytes(int Q, int NT) {
  const size_t tile = (size_t)T * NT * 4, xt = (size_t)T * T * 4;
  const size_t stages = NT <= 64 ? 2 : 1, cbufs = stages;
  // + 1 KiB to align the tiles to the swizzle's 1024-byte period; cum (Q
  // floats, rounded up to 4) and the scan's warp sums
  return 1024 + cbufs * 2 * tile + stages * (2 * tile + 2 * xt) +
         4 * ((((size_t)Q + 3) & ~(size_t)3) + WARPS);
}

// ------------------------------------------------------------------ kernel

template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, const float* __restrict__ state,
                 float* __restrict__ y, float* __restrict__ state_out, int Q, int H, int P,
                 int N, Str3 sx, Str3 sdt, Str3 sB, Str3 sC, int vec) {
  using Cf = Cfg<NT>;
  constexpr int STAGES = Cf::STAGES;
  constexpr int CBUFS = Cf::CBUFS;
  extern __shared__ uint8_t smem_raw[];
  // c_full[2], c_empty[2], full[MAX_STAGES], empty[MAX_STAGES]
  __shared__ __align__(8) uint64_t bars[4 + 2 * MAX_STAGES];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // C buffer c: hi at base + 2 c TILE, lo after it
  uint8_t* ring = base + CBUFS * 2 * Cf::TILE;   // stage s: B hi, B lo, X hi, X lo
  float* cum = reinterpret_cast<float*>(base + Cf::TILES);
  float* wsum = cum + ((Q + 3) & ~3);
  uint64_t* c_full = bars;
  uint64_t* c_empty = bars + 2;
  uint64_t* full = bars + 4;
  uint64_t* empty = bars + 4 + MAX_STAGES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y;
  const float Ah = A[h];
  const float* xb = x + b * sx.b + h * sx.h;
  const float* dtb = dt + b * sdt.b + h * sdt.h;
  const float* Bb = Bm + b * sB.b + h * sB.h;
  const float* Cb = Cm + b * sC.b + h * sC.h;
  const int64_t sbh = ((int64_t)b * H + h) * P * N;
  const float* st = state + sbh;
  float* so = state_out + sbh;

  if (tid == 0) {
    for (int c = 0; c < CBUFS; ++c) {
      mbar_init(&c_full[c], PRODUCERS);
      mbar_init(&c_empty[c], CONSUMERS);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], PRODUCERS);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // cum: inclusive prefix sum of dt * A, THREADS rows at a time
  float carry = 0.f;
  for (int base_q = 0; base_q < Q; base_q += THREADS) {
    const int qi = base_q + tid;
    float val = qi < Q ? dtb[(int64_t)qi * sdt.q] * Ah : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, val, off);
      if (lane >= off) val += t;
    }
    if (lane == 31) wsum[warp] = val;
    __syncthreads();
    float before = carry, total = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      if (w < warp) before += wsum[w];
      total += wsum[w];
    }
    if (qi < Q) cum[qi] = before + val;
    __syncthreads();
    carry += total;
  }
  __syncthreads();   // the barriers are initialised, cum is complete

  const int n_tiles = (Q + T - 1) / T;
  const float c_last = cum[Q - 1];

  if (tid >= CONSUMERS) {
    // ---------------------------------------------------------- producer
    const int ptid = tid - CONSUMERS;
    int t = 0;   // ring tiles filled
    auto acquire = [&]() {
      const int s = t % STAGES;
      mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
      return ring + s * Cf::STAGE;
    };
    auto publish = [&]() {
      fence_async_shared();
      mbar_arrive(&full[t % STAGES]);
      ++t;
    };
    const bool vx = vec & 1, vb = vec & 2, vc = vec & 4, vs = vec & 8;
    // xbar_j = x_j dt_j (times w_j = exp(cum_last - cum_j) in the state pass)
    auto x_scale = [&](int j0, bool weighted) {
      return [=](int jj, bool ok, float& s1, float& s2) {
        const int j = j0 + jj;
        s1 = ok ? __ldg(dtb + (int64_t)j * sdt.q) : 0.f;
        s2 = (ok && weighted) ? expf(c_last - cum[j]) : 1.f;
      };
    };
    auto unit = [](int, bool, float& s1, float& s2) { s1 = s2 = 1.f; };
    Rows<NT, PRODUCERS> rows;
    Cols<T, PRODUCERS> xs;
    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * T;
      rows.load(Cb + (int64_t)i0 * sC.q, sC.q, min(T, Q - i0), N, vc, ptid);
      const int cbuf = it % CBUFS;
      mbar_wait(&c_empty[cbuf], ((it / CBUFS) & 1) ^ 1);
      rows.store(base + cbuf * 2 * Cf::TILE, base + (cbuf * 2 + 1) * Cf::TILE, ptid);
      fence_async_shared();
      mbar_arrive(&c_full[cbuf]);
      rows.load(st, N, P, N, vs, ptid);   // state (p, n)
      uint8_t* slot = acquire();
      rows.store(slot, slot + Cf::TILE, ptid);
      publish();
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * T, nj = min(T, Q - j0);
        rows.load(Bb + (int64_t)j0 * sB.q, sB.q, nj, N, vb, ptid);
        xs.load(xb + (int64_t)j0 * sx.q, sx.q, nj, P, vx, x_scale(j0, false), ptid);
        slot = acquire();
        rows.store(slot, slot + Cf::TILE, ptid);
        xs.store(slot + 2 * Cf::TILE, slot + 2 * Cf::TILE + Cf::XT, ptid);
        publish();
      }
    }
    Cols<NT, PRODUCERS> bt;
    for (int jt = 0; jt < n_tiles; ++jt) {
      const int j0 = jt * T, nj = min(T, Q - j0);
      bt.load(Bb + (int64_t)j0 * sB.q, sB.q, nj, N, vb, unit, ptid);   // B_j^T (n, j)
      xs.load(xb + (int64_t)j0 * sx.q, sx.q, nj, P, vx, x_scale(j0, true), ptid);
      uint8_t* slot = acquire();
      bt.store(slot, slot + Cf::TILE, ptid);
      xs.store(slot + 2 * Cf::TILE, slot + 2 * Cf::TILE + Cf::XT, ptid);
      publish();
    }
    return;
  }

  // ------------------------------------------------------------ consumer
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = warp * 16 + g;   // accumulator rows row0 and row0 + 8
  float yacc[32], gacc[32];
  uint32_t a_hi[32], a_lo[32];
  int t_take = 0, t_give = 0;   // ring tiles waited for and given back
  auto take = [&]() {
    const int s = t_take % STAGES;
    mbar_wait(&full[s], (t_take / STAGES) & 1);
    ++t_take;
    return smem_u32(ring + s * Cf::STAGE);
  };
  auto give_back = [&]() {
    mbar_arrive(&empty[t_give % STAGES]);
    ++t_give;
  };
  const int64_t ys = (int64_t)H * P;
  float* yb = y + ((int64_t)b * Q * H + h) * P;

  for (int it = 0; it < n_tiles; ++it) {
    const int i0 = it * T;
    const int cbuf = it % CBUFS;
    mbar_wait(&c_full[cbuf], (it / CBUFS) & 1);
    const uint32_t ch = smem_u32(base + cbuf * 2 * Cf::TILE), cl = ch + Cf::TILE;
    // state term, scaled per row by exp(cum_i)
    uint32_t slot = take();
    zero(yacc);
    wg_fence();
    mma3_ss_n64(yacc, ch, cl, slot, slot + Cf::TILE, NT / 8, T);
    wg_commit();
    wg_wait_all();
    fence_regs(yacc);
    give_back();
    const int ia = i0 + row0, ib = ia + 8;
    const float ca = ia < Q ? cum[ia] : 0.f, cb = ib < Q ? cum[ib] : 0.f;
    const float ea = ia < Q ? expf(ca) : 0.f, eb = ib < Q ? expf(cb) : 0.f;
#pragma unroll
    for (int r = 0; r < 32; ++r) yacc[r] *= (r & 2) ? eb : ea;

    // G of the first j-tile; each later one after the tile before is done
    slot = take();
    zero(gacc);
    wg_fence();
    mma3_ss_n64(gacc, ch, cl, slot, slot + Cf::TILE, NT / 8, T);
    wg_commit();
    wg_wait_all();
    fence_regs(gacc);
    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * T;
      // S = G (.) exp(cum_i - cum_j), masked before the exp, split into the
      // A fragments: slot t of k step kk is column 2t, slot t + 4 is 2t + 1
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int ja = j0 + kk * 8 + 2 * t4;
        const float cja = ja < Q ? cum[ja] : 0.f, cjb = ja + 1 < Q ? cum[ja + 1] : 0.f;
        float v[4];
        // d[4kk + q]: q = 0 (ia, ja), 1 (ia, ja + 1), 2 (ib, ja), 3 (ib, ja + 1)
        v[0] = (ja <= ia && ia < Q) ? gacc[4 * kk + 0] * expf(ca - cja) : 0.f;
        v[1] = (ja + 1 <= ia && ia < Q) ? gacc[4 * kk + 1] * expf(ca - cjb) : 0.f;
        v[2] = (ja <= ib && ib < Q) ? gacc[4 * kk + 2] * expf(cb - cja) : 0.f;
        v[3] = (ja + 1 <= ib && ib < Q) ? gacc[4 * kk + 3] * expf(cb - cjb) : 0.f;
        // A fragment: a0 (row g, slot t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
        split(v[0], a_hi[4 * kk + 0], a_lo[4 * kk + 0]);
        split(v[2], a_hi[4 * kk + 1], a_lo[4 * kk + 1]);
        split(v[1], a_hi[4 * kk + 2], a_lo[4 * kk + 2]);
        split(v[3], a_hi[4 * kk + 3], a_lo[4 * kk + 3]);
      }
      const uint32_t x_hi = slot + 2 * Cf::TILE, x_lo = x_hi + Cf::XT;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        wgmma_tf32_rs_n64(yacc, a_lo + 4 * kk, desc_k(x_hi, kk, T));
        wgmma_tf32_rs_n64(yacc, a_hi + 4 * kk, desc_k(x_lo, kk, T));
        wgmma_tf32_rs_n64(yacc, a_hi + 4 * kk, desc_k(x_hi, kk, T));
      }
      wg_commit();
      wg_wait_all();
      fence_regs(yacc);
      give_back();
      if (jt < it) {
        slot = take();
        zero(gacc);
        wg_fence();
        mma3_ss_n64(gacc, ch, cl, slot, slot + Cf::TILE, NT / 8, T);
        wg_commit();
        wg_wait_all();
        fence_regs(gacc);
      }
    }
    mbar_arrive(&c_empty[cbuf]);
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int i = (r & 2) ? ib : ia;
      const int p = (r >> 2) * 8 + 2 * t4 + (r & 1);
      if (i < Q && p < P) yb[(int64_t)i * ys + p] = yacc[r];
    }
  }

  // state' (p, n) = exp(cum_last) state + (xbar w)^T (p, j) . B^T (n, j)
  const float decay = expf(c_last);
  constexpr int SREG = NT / 2;
  float sacc[SREG];
  zero(sacc);
  for (int jt = 0; jt < n_tiles; ++jt) {
    const uint32_t slot = take();
    const uint32_t x_hi = slot + 2 * Cf::TILE, x_lo = x_hi + Cf::XT;
    wg_fence();
    if constexpr (NT == 128)
      mma3_ss_n128(sacc, x_hi, x_lo, slot, slot + Cf::TILE, T / 8);
    else
      mma3_ss_n64(sacc, x_hi, x_lo, slot, slot + Cf::TILE, T / 8, NT);
    wg_commit();
    wg_wait_all();
    fence_regs(sacc);
    give_back();
  }
#pragma unroll
  for (int r = 0; r < SREG; ++r) {
    const int p = row0 + ((r & 2) ? 8 : 0);
    const int n = (r >> 2) * 8 + 2 * t4 + (r & 1);
    if (p < P && n < N) so[(int64_t)p * N + n] = st[(int64_t)p * N + n] * decay + sacc[r];
  }
}

template <int NT>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* state, void* y, void* state_out, int64_t B, int64_t Q, int64_t H,
           int64_t P, int64_t N, Str3 sx, Str3 sdt, Str3 sB, Str3 sC, cudaStream_t stream) {
  auto kern = ssd_chunk_kernel<NT>;
  // which of x, B, C and the state take 16-byte loads (bits 0-3)
  auto v16 = [](const void* p, int64_t cols, Str3 s) {
    return ((uintptr_t)p % 16 == 0) && cols % 4 == 0 && s.b % 4 == 0 && s.q % 4 == 0 &&
           s.h % 4 == 0;
  };
  const int vec = (v16(x, P, sx) ? 1 : 0) | (v16(Bm, N, sB) ? 2 : 0) | (v16(Cm, N, sC) ? 4 : 0) |
                  (v16(state, N, Str3{P * N, N, 0}) ? 8 : 0);
  const size_t smem = smem_bytes((int)Q, NT);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)H, (unsigned)B);
  kern<<<grid, THREADS, smem, stream>>>((const float*)x, (const float*)dt, (const float*)A,
                                        (const float*)Bm, (const float*)Cm,
                                        (const float*)state, (float*)y, (float*)state_out,
                                        (int)Q, (int)H, (int)P, (int)N, sx, sdt, sB, sC,
                                        vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory of one block (bytes) at chunk length Q and state width N;
// 0 for a shape the kernel does not take.
extern "C" int64_t ssd_chunk_smem_bytes(int64_t Q, int64_t N) {
  if (Q <= 0 || N <= 0 || N > 2 * T || Q > ((int64_t)1 << 20)) return 0;
  return (int64_t)smem_bytes((int)Q, N <= T ? T : 2 * T);
}

// Returns the CUDA error of the launch (0 on success), or -1 for a shape the
// kernel does not take (P > 64, N > 128, an empty chunk, or more shared
// memory than a block may have).  Strides are in elements: (batch, row,
// head) for each of x, dt, B and C; B's and C's head stride may be 0.
extern "C" int ssd_chunk_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                             const void* Cm, const void* state, void* y, void* state_out,
                             int64_t B, int64_t Q, int64_t H, int64_t P, int64_t N,
                             int64_t xb, int64_t xq, int64_t xh, int64_t db, int64_t dq,
                             int64_t dh, int64_t bb, int64_t bq, int64_t bh, int64_t cb,
                             int64_t cq, int64_t ch, int device, void* stream) {
  if (B <= 0 || Q <= 0 || H <= 0 || P <= 0 || N <= 0 || P > T || N > 2 * T ||
      B > 65535 || H > ((int64_t)1 << 30))
    return -1;
  const int64_t smem = ssd_chunk_smem_bytes(Q, N);
  if (smem == 0 || smem > 232448) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Str3 sx{xb, xq, xh}, sdt{db, dq, dh}, sB{bb, bq, bh}, sC{cb, cq, ch};
  cudaStream_t st = (cudaStream_t)stream;
  if (N <= T) return launch<T>(x, dt, A, Bm, Cm, state, y, state_out, B, Q, H, P, N, sx, sdt, sB, sC, st);
  return launch<2 * T>(x, dt, A, Bm, Cm, state, y, state_out, B, Q, H, P, N, sx, sdt, sB, sC, st);
}
