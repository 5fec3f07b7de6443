// MLA's absorbed attention, forward and backward, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes this attention with
// XLA code (`attention.attention` as src/repro/models/mla.py:130 calls it,
// its chunked flash VJP or its naive path).  It is the one attention on the
// port's served and trained paths that the flash kernels cannot take (one
// shared key head Dk wide and one shared value head Dv wide, Dk != Dv, up
// to 576 and 512), so it has kernels of its own:
//
//   q (B,Sq,H,Dk), k (B,Sk,Dk), v (B,Sk,Dv), one key and one value head
//   shared by all H query heads  ->  o (B,Sq,H,Dv) in q's type and
//   lse (B,H,Sq) float32,
//   o = softmax(scale * q.k^T [masked]) . v,  lse = m + log(max(l, 1e-30))
//
// with the causal mask qpos >= kpos when `causal` (q's first row at
// position 0); masked scores are -1e30 and the row sum is floored at 1e-30,
// as ref.flash_attention_fwd_lse computes.  The backward takes (q, k, v,
// lse, do) and returns dq, dk, dv in q's type, with the port's D =
// rowsum(p * dp) / rowsum(p) from the probabilities it recomputes
// (ref.flash_attention_bwd), ds = p * (dp - D) * scale.
//
// The rows.  A key tile is shared by every head, so the kernels see one
// matrix of M = Sq * H query rows per batch row, row r = (position r / H,
// head r % H) as q lies in memory: a 64-row tile is 64 heads of one
// position at H = 128 (every row the same causal limit, each key tile read
// once for 64 heads) and 16 positions of 4 heads at H = 4.  Every tile
// masks by its rows' own positions.
//
// What bounds it, at deepseek-v2's training shape (B = 2, S = 256, H =
// 128, Dk = 576, Dv = 512, causal): the forward moves 143.7 MB of bf16 (q
// in, o out; 42.9 us at 3.35 TB/s) and needs 18.3 GFLOP (18.5 us at the
// bf16 tensor-core peak), so bytes bound it; the backward moves 220 MB
// (65.9 us) and needs 46.3 GFLOP (46.9 us): nearly balanced.  Every byte
// of q, o, do and dq is a row tile's, so the design reads each row tile
// once a launch and keeps the products on the tensor cores.
//
// Two routes, by the input type, apart by name:
//
// bfloat16: wgmma fed by TMA (mla_attention_wgmma.cuh: the tiles, the
//   rings, the warpgroups' roles).  Every shape the contract takes runs
//   these kernels: the products always run over the widest head's 64-column
//   boxes (9 of Dk, 8 of Dv, unrolled), and a narrower head loads fewer
//   boxes into zeroed shared memory (the TMA fills a box's columns past the
//   width with zeros); H and the lengths set only the row tiles' positions
//   and the number of key stages.
//   - Forward, mla_fwd_wgmma_kernel: a block per 64-row tile (the last
//     tiles first), one consumer warpgroup per 256 columns of O (two at Dv
//     > 256, then with a producer warpgroup whose registers setmaxnreg
//     moves to them: 232 a consumer thread; at Dv <= 256 a producer warp).
//     The Q tile is read once (9 boxes, 72 KB) and stays; K and V stream
//     through a two-stage ring of 32-key stages (36 + 32 KB a stage: 208 KB
//     with Q; 64-key stages would leave room for one).  Each warpgroup
//     computes S = Q.K^T of a stage whole (m64n32k16; 1.53x the least
//     products, still under the byte bound, and no barrier between the
//     warpgroups) and the online softmax in registers, and O += P.V over
//     its 256 columns (m64n256k16, P in registers: 128 accumulators a
//     thread); S of stage t is issued with P.V of stage t - 1.  O leaves
//     through shared memory by TMA, the lse from warpgroup 0.
//   - Backward: three launches, no atomics: rows (a block per row tile, two
//     consumer warpgroups and a producer warpgroup, setmaxnreg as above: Q
//     and dO read once and kept, 136 KB; K and V streamed twice in 32-key
//     stages, one each; warpgroup 0 computes S and P, warpgroup 1 dP, and P
//     passes between them through shared memory; a first pass sums the
//     port's D, a second writes P and dS to the scratch and accumulates dQ
//     = dS.K in registers over both warpgroups, 256 + 320 columns), keys
//     (a block per 128 keys, 256-column slab of dK or dV and chunk of 32
//     row tiles, a warpgroup per 64 keys sharing the slab: dK = dS^T.Q, dV
//     = P^T.dO, both operands MN-major in a four-stage ring, into the
//     chunk's float32 partial) and finish (the partials summed in chunk
//     order).  S and dP are computed twice (1.4x the least products); each
//     dS tile is read three times (dK's three slabs), each P tile twice.
//     The rows launch holds one K and one V stage (what shared memory
//     leaves), so in the second pass a K stage loads only once the dQ
//     products over the one before are done: its tensor cores are busy
//     about half the time (PERF.md).
//   Shared memory (mirrored by mla_smem_bytes / mla_bwd_smem_bytes in
//   kernels/mla_attention_cuda.py): forward 214,016 bytes at Dv > 256 (Q
//   72 KB + 2 x (K 36 + V 32 KB) + 1 KiB of alignment), 181,248 below (V
//   16 KB a stage); rows 222,208 (Q 72 + dO 64 + K 36 + V 32 + P 8 + dS 4
//   KB + 1 KiB); keys 197,632 (4 x (16 + 32 KB) + 1 KiB): one block a SM.
//
// float32: mma.sync at float32 accuracy (3xTF32), the first design of these
//   kernels (not yet redesigned): 256 threads, eight warps on m16n8k8
//   products, each float32 operand split into tf32 hi and lo by
//   round-to-nearest, lo.hi + hi.lo + hi.hi accumulated in float32, operands
//   staged in shared memory tiles of 64 rows by 64 columns (a 16-byte pad a
//   row) by 16-byte loads with zeros past the edges.
//   - Forward, mla_fwd_mma_kernel: a block per (64-row tile, 256-column
//     slab of Dv, batch row).  S = Q.K^T accumulates over 64-column slabs
//     of Dk, is scaled and masked into shared memory, and four threads a row
//     take the online softmax; O (64 x 256 float32) is rescaled and
//     accumulates P.V.  The output's 512 columns take two blocks, each
//     recomputing S.  Causal tiles load no key tile past their last row's
//     position.
//   - Backward, three launches: rows (mla_bwd_rows_mma_kernel: a block per
//     (64-row tile, batch row) recomputes S and dP over the key tiles its
//     rows see, sums p * dp and p a row, recomputes them and writes P and
//     dS to the scratch, then dQ = dS.K 64 columns at a time from its own
//     dS), keys (mla_bwd_keys_mma_kernel: a block per (64-key tile,
//     64-column slab of dK or dV, batch row x chunk of 32 row tiles) sums
//     dS^T.Q (P^T.dO) into the chunk's float32 partial) and finish.
//
// The backward's scratch (P and dS, B x rows x keys padded to 64-row and
// 64-key tiles, of q's type) and partials (chunks x B x Sk x (Dk + Dv)
// float32) are allocated by the wrapper (kernels/mla_attention_cuda.py)
// and checked here against their sizes.  Card times: PERF.md rows 4m and
// 4mb (tools/bwd_kernel_timing.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mla_attention_wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 64;          // query rows a tile
constexpr int BN = 64;          // keys a tile
constexpr int BK = 64;          // columns of a slab of Dk or Dv
constexpr int DVS = 256;        // output columns of a forward block
constexpr int THREADS = 256;    // eight warps
constexpr int ROW_CHUNK = 32;   // row tiles of a keys block's chunk
constexpr int LS = BN + 4;      // float32 score rows in shared memory
constexpr float NEG = -1e30f;

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// the row stride (elements) of a shared tile `cols` wide: 16 bytes of pad
template <typename T>
__host__ __device__ constexpr int pitch(int cols) {
  return cols + 16 / (int)sizeof(T);
}

// a shared R x C tile (row stride ld) from rows r0.. and columns c0.. of a
// global matrix (row stride gld), zero at rows >= rows or columns >= cols;
// 16-byte loads and stores: gld, cols, c0 and ld are multiples of a vector
// (the wrapper's contract: Dk and Dv multiples of 8, bases 16-byte aligned)
template <typename T, int R, int C>
__device__ __forceinline__ void load_tile(T* s, int ld, const T* g, int64_t gld, int64_t r0,
                                          int c0, int64_t rows, int cols) {
  constexpr int V = 16 / (int)sizeof(T), CV = C / V;
  static_assert(C % V == 0, "a tile row is whole vectors");
  for (int i = threadIdx.x; i < R * CV; i += THREADS) {
    const int r = i / CV, c = (i % CV) * V;
    const int64_t gr = r0 + r;
    const int gc = c0 + c;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (gr < rows && gc < cols) x = *reinterpret_cast<const uint4*>(g + gr * gld + gc);
    *reinterpret_cast<uint4*>(s + r * ld + c) = x;
  }
}

// ------------------------------------------------------------ mma.sync
//
// A warp's product tile (3xTF32, the float32 route): acc[nt] is the m16n8
// float32 accumulator of rows 0-15 and columns 8 nt .. 8 nt + 7 of the
// warp's output; a thread holds (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8,
// 2t + 1), g = lane / 4, t = lane % 4.  Operands come from shared memory:
// A(m, k) = at<AKM>(a, lda, a0 + m, k), stored [m][k] or, with AKM, [k][m];
// B(k, n) = at<BKN>(b, ldb, b0 + n, k), stored [n][k] or, with BKN, [k][n].
// K = 64 a call.

template <bool KM, typename T>
__device__ __forceinline__ T at(const T* s, int ld, int i, int k) {
  return KM ? s[k * ld + i] : s[i * ld + k];
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + e, |e| ~2^-22 |x|; a NaN gives NaN halves
__device__ __forceinline__ void split_rna(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

template <bool AKM, bool BKN, int NT>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const float* a, int lda, int a0,
                                         const float* b, int ldb, int b0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k0 = 0; k0 < BK; k0 += 8) {
    uint32_t ah[4], al[4];
    split_rna(at<AKM>(a, lda, a0 + g, k0 + t), ah[0], al[0]);
    split_rna(at<AKM>(a, lda, a0 + g + 8, k0 + t), ah[1], al[1]);
    split_rna(at<AKM>(a, lda, a0 + g, k0 + t + 4), ah[2], al[2]);
    split_rna(at<AKM>(a, lda, a0 + g + 8, k0 + t + 4), ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = b0 + nt * 8 + g;
      uint32_t bh[2], bl[2];
      split_rna(at<BKN>(b, ldb, n, k0 + t), bh[0], bl[0]);
      split_rna(at<BKN>(b, ldb, n, k0 + t + 4), bh[1], bl[1]);
      mma_tf32(acc[nt], al, bh);
      mma_tf32(acc[nt], ah, bl);
      mma_tf32(acc[nt], ah, bh);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
}

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// the last position a row tile holds (key tiles past it are masked whole)
__device__ __forceinline__ int64_t last_pos(int64_t r0, int64_t M, int H) {
  return (min64(r0 + BM, M) - 1) / H;
}

// ------------------------------------------------------------- forward

template <typename T>
constexpr size_t fwd_smem() {
  return (size_t)(3 * BM * pitch<T>(BK) + BN * pitch<T>(DVS)) * sizeof(T) +
         (size_t)(BM * LS + 3 * BM) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    mla_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                       int Sq, int Sk, int H, int Dk, int Dv, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LK = pitch<T>(BK), LV = pitch<T>(DVS);
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + BM * LK;
  T* Ps = Ks + BN * LK;
  T* Vs = Ps + BM * LK;
  float* Ss = reinterpret_cast<float*>(Vs + BN * LV);
  float* m_s = Ss + BM * LS;
  float* l_s = m_s + BM;
  float* a_s = l_s + BM;

  const int64_t M = (int64_t)Sq * H;
  const int64_t r0 = (int64_t)blockIdx.x * BM;
  const int c0 = blockIdx.y * DVS;
  const int64_t b = blockIdx.z;
  const T* qb = q + b * M * Dk;
  const T* kb = k + b * (int64_t)Sk * Dk;
  const T* vb = v + b * (int64_t)Sk * Dv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rg = warp & 3, half = warp >> 2;
  const int kv_end = causal ? (int)min64(Sk, last_pos(r0, M, H) + 1) : Sk;
  if (threadIdx.x < BM) {
    m_s[threadIdx.x] = NEG;
    l_s[threadIdx.x] = 0.f;
  }
  float acc[16][4];
  zero(acc);

  for (int kt = 0; kt < kv_end; kt += BN) {
    float s[4][4];
    zero(s);
    for (int d0 = 0; d0 < Dk; d0 += BK) {
      __syncthreads();
      load_tile<T, BM, BK>(Qs, LK, qb, Dk, r0, d0, M, Dk);
      load_tile<T, BN, BK>(Ks, LK, kb, Dk, kt, d0, Sk, Dk);
      __syncthreads();
      warp_mma<false, false, 4>(s, Qs, LK, rg * 16, Ks, LK, half * 32);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = rg * 16 + g + (i >= 2 ? 8 : 0);
        const int key = half * 32 + nt * 8 + 2 * t + (i & 1);
        const int64_t rr = r0 + row;
        const int kj = kt + key;
        const bool ok = rr < M && kj < Sk && (!causal || kj <= rr / H);
        Ss[row * LS + key] = ok ? s[nt][i] * scale : NEG;
      }
    __syncthreads();
    {   // the online softmax, four neighbouring threads a row, keys j = 4 jj + part
      const int row = threadIdx.x >> 2, part = threadIdx.x & 3;
      float mx = NEG;
#pragma unroll
      for (int jj = 0; jj < BN / 4; ++jj) mx = fmaxf(mx, Ss[row * LS + 4 * jj + part]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[row], m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < BN / 4; ++jj) {
        const int j = 4 * jj + part;
        const float p = expf(Ss[row * LS + j] - m_new);
        Ps[row * LK + j] = from_f<T>(p);
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {   // after the shuffles: the row's four threads have read m_old
        const float alpha = expf(m_old - m_new);
        l_s[row] = l_s[row] * alpha + sum;
        m_s[row] = m_new;
        a_s[row] = alpha;
      }
    }
    load_tile<T, BN, DVS>(Vs, LV, vb, Dv, kt, c0, Sk, Dv);
    __syncthreads();
    const float al0 = a_s[rg * 16 + g], al1 = a_s[rg * 16 + g + 8];
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      acc[nt][0] *= al0;
      acc[nt][1] *= al0;
      acc[nt][2] *= al1;
      acc[nt][3] *= al1;
    }
    warp_mma<false, true, 16>(acc, Ps, LK, rg * 16, Vs, LV, half * 128);
  }
  __syncthreads();
  T* ob = o + b * M * Dv;
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rg * 16 + g + (i >= 2 ? 8 : 0);
      const int col = c0 + half * 128 + nt * 8 + 2 * t + (i & 1);
      const int64_t rr = r0 + row;
      if (rr < M && col < Dv)
        ob[rr * Dv + col] = from_f<T>(acc[nt][i] / fmaxf(l_s[row], 1e-30f));
    }
  if (lse != nullptr && blockIdx.y == 0 && threadIdx.x < BM) {
    const int64_t rr = r0 + threadIdx.x;
    if (rr < M) {
      const int64_t pos = rr / H, h = rr % H;
      lse[(b * H + h) * Sq + pos] =
          m_s[threadIdx.x] + logf(fmaxf(l_s[threadIdx.x], 1e-30f));
    }
  }
}

// ------------------------------------------------------------ backward

struct BwdArgs {
  int Sq, Sk, H, Dk, Dv;
  float scale;
  int causal;
  int64_t rows_pad, keys_pad;   // the scratch's (rows, keys) a batch row
};

// S = Q.K^T and dP = dO.V^T of key tile kt for the block's 64 rows (a
// warp's 16 rows by its half's 32 keys), both in float32 accumulators
template <typename T>
__device__ __forceinline__ void scores(float (&s)[4][4], float (&dp)[4][4], T* As, T* Bs,
                                       const T* qb, const T* kb, const T* vb, const T* db,
                                       int64_t r0, int kt, int64_t M, const BwdArgs& a) {
  constexpr int LK = pitch<T>(BK);
  const int warp = threadIdx.x >> 5, rg = warp & 3, half = warp >> 2;
  zero(s);
  zero(dp);
  for (int d0 = 0; d0 < a.Dk; d0 += BK) {
    __syncthreads();
    load_tile<T, BM, BK>(As, LK, qb, a.Dk, r0, d0, M, a.Dk);
    load_tile<T, BN, BK>(Bs, LK, kb, a.Dk, kt, d0, a.Sk, a.Dk);
    __syncthreads();
    warp_mma<false, false, 4>(s, As, LK, rg * 16, Bs, LK, half * 32);
  }
  for (int c0 = 0; c0 < a.Dv; c0 += BK) {
    __syncthreads();
    load_tile<T, BM, BK>(As, LK, db, a.Dv, r0, c0, M, a.Dv);
    load_tile<T, BN, BK>(Bs, LK, vb, a.Dv, kt, c0, a.Sk, a.Dv);
    __syncthreads();
    warp_mma<false, false, 4>(dp, As, LK, rg * 16, Bs, LK, half * 32);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    mla_bwd_rows_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const float* __restrict__ lse,
                            const T* __restrict__ dout, T* P, T* dS, T* __restrict__ dq,
                            BwdArgs a) {
  constexpr int LK = pitch<T>(BK);
  __shared__ __align__(16) T As[BM * LK];
  __shared__ __align__(16) T Bs[BN * LK];
  __shared__ float lse_s[BM], dsum_s[BM];
  __shared__ float red[4][BM];   // (p.dp, p) of each half's keys, a row

  const int64_t M = (int64_t)a.Sq * a.H;
  const int64_t r0 = (int64_t)blockIdx.x * BM;
  const int64_t b = blockIdx.y;
  const T* qb = q + b * M * a.Dk;
  const T* kb = k + b * (int64_t)a.Sk * a.Dk;
  const T* vb = v + b * (int64_t)a.Sk * a.Dv;
  const T* db = dout + b * M * a.Dv;
  T* Pb = P + b * a.rows_pad * a.keys_pad;
  T* dSb = dS + b * a.rows_pad * a.keys_pad;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rg = warp & 3, half = warp >> 2;
  const int kv_end = a.causal ? (int)min64(a.Sk, last_pos(r0, M, a.H) + 1) : a.Sk;
  if (threadIdx.x < BM) {
    const int64_t rr = r0 + threadIdx.x;
    lse_s[threadIdx.x] = rr < M ? lse[(b * a.H + rr % a.H) * a.Sq + rr / a.H] : 0.f;
  }
  __syncthreads();

  float s[4][4], dp[4][4];
  // p of accumulator element (nt, i), score sv, of key tile kt; 0 where masked
  auto prob = [&](float sv, int nt, int i, int kt, bool& ok) {
    const int row = rg * 16 + g + (i >= 2 ? 8 : 0);
    const int key = half * 32 + nt * 8 + 2 * t + (i & 1);
    const int64_t rr = r0 + row;
    const int kj = kt + key;
    ok = rr < M && kj < a.Sk && (!a.causal || kj <= rr / a.H);
    return ok ? expf(sv * a.scale - lse_s[row]) : 0.f;
  };

  // pass 1: sum(p * dp) and sum(p) a row
  float pdp[2] = {0.f, 0.f}, ps[2] = {0.f, 0.f};
  for (int kt = 0; kt < kv_end; kt += BN) {
    scores(s, dp, As, Bs, qb, kb, vb, db, r0, kt, M, a);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bool ok;
        const float p = prob(s[nt][i], nt, i, kt, ok);
        pdp[i >> 1] += p * dp[nt][i];
        ps[i >> 1] += p;
      }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    pdp[j] += __shfl_xor_sync(0xffffffffu, pdp[j], 1);
    pdp[j] += __shfl_xor_sync(0xffffffffu, pdp[j], 2);
    ps[j] += __shfl_xor_sync(0xffffffffu, ps[j], 1);
    ps[j] += __shfl_xor_sync(0xffffffffu, ps[j], 2);
  }
  if (t == 0) {
    red[half][rg * 16 + g] = pdp[0];
    red[half][rg * 16 + g + 8] = pdp[1];
    red[2 + half][rg * 16 + g] = ps[0];
    red[2 + half][rg * 16 + g + 8] = ps[1];
  }
  __syncthreads();
  if (threadIdx.x < BM) {
    const int row = threadIdx.x;
    dsum_s[row] = (red[0][row] + red[1][row]) / (red[2][row] + red[3][row]);
  }
  __syncthreads();

  // pass 2: P and dS = P * (dP - D) * scale into the scratch
  for (int kt = 0; kt < kv_end; kt += BN) {
    scores(s, dp, As, Bs, qb, kb, vb, db, r0, kt, M, a);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        bool ok;
        const float p = prob(s[nt][i], nt, i, kt, ok);
        const int row = rg * 16 + g + (i >= 2 ? 8 : 0);
        const int key = half * 32 + nt * 8 + 2 * t + (i & 1);
        const float ds = ok ? p * (dp[nt][i] - dsum_s[row]) * a.scale : 0.f;
        const int64_t off = (r0 + row) * a.keys_pad + kt + key;
        Pb[off] = from_f<T>(p);
        dSb[off] = from_f<T>(ds);
      }
  }

  // pass 3: dQ = dS.K, 64 columns of Dk at a time (the block reads back the
  // dS it wrote; __syncthreads makes its writes visible to its threads)
  T* dqb = dq + b * M * a.Dk;
  for (int d0 = 0; d0 < a.Dk; d0 += BK) {
    float acc[4][4];
    zero(acc);
    for (int kt = 0; kt < kv_end; kt += BN) {
      __syncthreads();
      load_tile<T, BM, BN>(As, LK, dSb, a.keys_pad, r0, kt, a.rows_pad, (int)a.keys_pad);
      load_tile<T, BN, BK>(Bs, LK, kb, a.Dk, kt, d0, a.Sk, a.Dk);
      __syncthreads();
      warp_mma<false, true, 4>(acc, As, LK, rg * 16, Bs, LK, half * 32);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t rr = r0 + rg * 16 + g + (i >= 2 ? 8 : 0);
        const int col = d0 + half * 32 + nt * 8 + 2 * t + (i & 1);
        if (rr < M && col < a.Dk) dqb[rr * a.Dk + col] = from_f<T>(acc[nt][i]);
      }
  }
}

// dK (or dV) of one key tile and 64-column slab over one chunk of row
// tiles: sum of dS^T.Q (P^T.dO), into the chunk's float32 partial
template <typename T>
__global__ void __launch_bounds__(THREADS)
    mla_bwd_keys_mma_kernel(const T* __restrict__ q, const T* __restrict__ dout,
                            const T* __restrict__ P, const T* __restrict__ dS,
                            float* __restrict__ part, int B, int n_dk_slabs, BwdArgs a) {
  constexpr int LK = pitch<T>(BK);
  __shared__ __align__(16) T Xs[BM * LK];
  __shared__ __align__(16) T Ys[BM * LK];

  const int64_t M = (int64_t)a.Sq * a.H;
  const int kt = blockIdx.x * BN;
  const bool is_k = (int)blockIdx.y < n_dk_slabs;
  const int c0 = (is_k ? blockIdx.y : blockIdx.y - n_dk_slabs) * BK;
  const int width = is_k ? a.Dk : a.Dv;
  const int64_t b = blockIdx.z % B, chunk = blockIdx.z / B;
  const T* src = (is_k ? dS : P) + b * a.rows_pad * a.keys_pad;
  const T* rows = is_k ? q + b * M * a.Dk : dout + b * M * a.Dv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rg = warp & 3, half = warp >> 2;
  const int64_t n_rt = (M + BM - 1) / BM;
  const int64_t rt_end = min64(n_rt, (chunk + 1) * ROW_CHUNK);
  float acc[4][4];
  zero(acc);
  for (int64_t rt = chunk * ROW_CHUNK; rt < rt_end; ++rt) {
    const int64_t r0 = rt * BM;
    if (a.causal && kt > last_pos(r0, M, a.H)) continue;   // the rows kernel skipped it
    __syncthreads();
    load_tile<T, BM, BN>(Xs, LK, src, a.keys_pad, r0, kt, a.rows_pad, (int)a.keys_pad);
    load_tile<T, BM, BK>(Ys, LK, rows, width, r0, c0, M, width);
    __syncthreads();
    warp_mma<true, true, 4>(acc, Xs, LK, rg * 16, Ys, LK, half * 32);
  }
  const int W = a.Dk + a.Dv;
  float* pb = part + (chunk * B + b) * (int64_t)a.Sk * W;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = kt + rg * 16 + g + (i >= 2 ? 8 : 0);
      const int col = c0 + half * 32 + nt * 8 + 2 * t + (i & 1);
      if (key < a.Sk && col < width)
        pb[(int64_t)key * W + (is_k ? 0 : a.Dk) + col] = acc[nt][i];
    }
}

// dk and dv: the chunks' partials summed in chunk order
template <typename T>
__global__ void mla_bwd_finish_kernel(const float* __restrict__ part, T* __restrict__ dk,
                                      T* __restrict__ dv, int64_t n, int chunks, int Dk,
                                      int Dv) {
  const int W = Dk + Dv;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int c = 0; c < chunks; ++c) acc += part[c * n + i];
    const int64_t key = i / W;
    const int col = (int)(i % W);
    if (col < Dk)
      dk[key * Dk + col] = from_f<T>(acc);
    else
      dv[key * Dv + col - Dk] = from_f<T>(acc);
  }
}

// ------------------------------------------------------------ launches

__host__ __device__ __forceinline__ int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// the float32 forward
int fwd_f32(const void* q, const void* k, const void* v, void* o, float* lse, int64_t B,
            int64_t Sq, int64_t Sk, int64_t H, int Dk, int Dv, float scale, int causal,
            cudaStream_t st) {
  const size_t smem = fwd_smem<float>();
  auto kern = mla_fwd_mma_kernel<float>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)cdiv(Sq * H, BM), (unsigned)cdiv(Dv, DVS), (unsigned)B);
  kern<<<grid, THREADS, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, (int)Sq, (int)Sk,
      (int)H, Dk, Dv, scale, causal);
  return (int)cudaGetLastError();
}

// the float32 backward's rows and keys launches
int bwd_f32(const void* q, const void* k, const void* v, const float* lse, const void* dout,
            void* P, void* dS, float* part, void* dq, int64_t B, int64_t Sq, int64_t Sk,
            int64_t H, int Dk, int Dv, float scale, int causal, cudaStream_t st) {
  typedef float T;
  const int64_t n_rt = cdiv(Sq * H, BM), chunks = cdiv(n_rt, ROW_CHUNK);
  const BwdArgs a{(int)Sq, (int)Sk, (int)H, Dk, Dv, scale, causal, n_rt * BM, cdiv(Sk, BN) * BN};
  mla_bwd_rows_mma_kernel<T><<<dim3((unsigned)n_rt, (unsigned)B), THREADS, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, lse, (const T*)dout, (T*)P, (T*)dS, (T*)dq, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_dk = (int)cdiv(Dk, BK), n_dv = (int)cdiv(Dv, BK);
  mla_bwd_keys_mma_kernel<T><<<dim3((unsigned)cdiv(Sk, BN), (unsigned)(n_dk + n_dv),
                                    (unsigned)(B * chunks)),
                               THREADS, 0, st>>>((const T*)q, (const T*)dout, (const T*)P,
                                                 (const T*)dS, part, (int)B, n_dk, a);
  return (int)cudaGetLastError();
}

// the backward's last launch, both routes: dk and dv from the partials
template <typename T>
int finish(const float* part, void* dk, void* dv, int64_t B, int64_t Sq, int64_t Sk,
           int64_t H, int Dk, int Dv, cudaStream_t st) {
  const int64_t chunks = cdiv(cdiv(Sq * H, BM), ROW_CHUNK);
  const int64_t n = B * Sk * (Dk + Dv);
  const int blocks = (int)min64(cdiv(n, 256), 4096);
  mla_bwd_finish_kernel<T><<<blocks, 256, 0, st>>>(part, (T*)dk, (T*)dv, n, (int)chunks, Dk, Dv);
  return (int)cudaGetLastError();
}

bool shape_ok(int64_t B, int64_t Sq, int64_t Sk, int64_t H, int64_t Dk, int64_t Dv) {
  return B > 0 && Sq > 0 && Sk > 0 && H > 0 && B <= 65535 && Dk > 0 && Dv > 0 &&
         Dk <= 576 && Dv <= 512 && Dk % 8 == 0 && Dv % 8 == 0 && Sk <= ((int64_t)1 << 30) &&
         Sq * H <= ((int64_t)1 << 30);
}

static_assert(BM == mlawg::BM && BN == mlawg::KEY_TILE && ROW_CHUNK == mlawg::ROW_CHUNK,
              "both routes use one scratch and one partials layout");

}  // namespace

// Dynamic shared memory (bytes) of a launch at value width Dv, as
// kernels/mla_attention_cuda.py mirrors it: `launch` 0 the forward, 1 the
// backward's rows launch, 2 its keys launch (the bf16 plan holds the
// widest key head at every Dk; the float32 route's backward takes static
// shared memory).
extern "C" int64_t mla_attention_smem_bytes(int64_t Dv, int dtype, int launch) {
  const int nvb = mlawg::boxes(Dv);
  if (dtype == 1)
    return launch == 0 ? (int64_t)mlawg::fwd_smem(nvb)
         : launch == 1 ? (int64_t)mlawg::rows_smem()
                       : (int64_t)mlawg::keys_smem();
  return launch == 0 ? (int64_t)fwd_smem<float>() : 0;
}

// The sizes the backward's buffers must have, in elements: the scratch of P
// (and of dS), B x rows_pad x keys_pad of q's type, and the partials,
// chunks x B x Sk x (Dk + Dv) float32.
extern "C" void mla_attention_bwd_sizes(int64_t B, int64_t Sq, int64_t Sk, int64_t H,
                                        int64_t Dk, int64_t Dv, int64_t* out) {
  const int64_t n_rt = cdiv(Sq * H, BM);
  out[0] = B * n_rt * BM * cdiv(Sk, BN) * BN;
  out[1] = cdiv(n_rt, ROW_CHUNK) * B * Sk * (Dk + Dv);
}

// Returns the CUDA error of the launch (0 on success); -1 for a shape the
// kernels do not take (Dk > 576, Dv > 512, either not a multiple of 8, an
// empty or oversized tensor), -2 for a dtype code other than 0 (float32) or
// 1 (bfloat16), -3 when a tensor map cannot be encoded (bfloat16: bases
// 16-byte aligned).  Every tensor is contiguous: q (B,Sq,H,Dk), k (B,Sk,Dk),
// v (B,Sk,Dv), o (B,Sq,H,Dv); `lse` null or float32 (B,H,Sq).
extern "C" int mla_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                 void* lse, int64_t B, int64_t Sq, int64_t Sk, int64_t H,
                                 int64_t Dk, int64_t Dv, float scale, int causal, int dtype,
                                 int device, void* stream) {
  if (!shape_ok(B, Sq, Sk, H, Dk, Dv)) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return fwd_f32(q, k, v, o, (float*)lse, B, Sq, Sk, H, (int)Dk, (int)Dv, scale, causal, st);
  if (dtype == 1)
    return mlawg::fwd(q, k, v, o, (float*)lse, B, Sq, Sk, H, (int)Dk, (int)Dv, scale, causal,
                      st);
  return -2;
}

// The backward: dq (B,Sq,H,Dk), dk (B,Sk,Dk), dv (B,Sk,Dv) of q's type from
// (q, k, v, lse, do), contiguous.  `P` and `dS` are scratch of
// `scratch_elems` elements of q's type each and `part` one of `part_elems`
// float32, the sizes mla_attention_bwd_sizes gives (-3 if they differ).
extern "C" int mla_attention_bwd(const void* q, const void* k, const void* v, const void* lse,
                                 const void* dout, void* P, void* dS, void* part, void* dq,
                                 void* dk, void* dv, int64_t scratch_elems, int64_t part_elems,
                                 int64_t B, int64_t Sq, int64_t Sk, int64_t H, int64_t Dk,
                                 int64_t Dv, float scale, int causal, int dtype, int device,
                                 void* stream) {
  if (!shape_ok(B, Sq, Sk, H, Dk, Dv) || B * cdiv(cdiv(Sq * H, BM), ROW_CHUNK) > 65535)
    return -1;
  int64_t sizes[2];
  mla_attention_bwd_sizes(B, Sq, Sk, H, Dk, Dv, sizes);
  if (sizes[0] != scratch_elems || sizes[1] != part_elems) return -3;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype != 0 && dtype != 1) return -2;
  const int rc = dtype == 0 ? bwd_f32(q, k, v, (const float*)lse, dout, P, dS, (float*)part, dq,
                                      B, Sq, Sk, H, (int)Dk, (int)Dv, scale, causal, st)
                            : mlawg::bwd(q, k, v, (const float*)lse, dout, P, dS, (float*)part,
                                         dq, B, Sq, Sk, H, (int)Dk, (int)Dv, scale, causal, st);
  if (rc != 0) return rc;
  const float* pt = (const float*)part;
  return dtype == 0 ? finish<float>(pt, dk, dv, B, Sq, Sk, H, (int)Dk, (int)Dv, st)
                    : finish<bf16>(pt, dk, dv, B, Sq, Sk, H, (int)Dk, (int)Dv, st);
}
