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
// What bounds it: at deepseek-v2's training shape (B = 2, S = 256, H =
// 128, Dk = 576, Dv = 512, causal) the forward moves 143.7 MB of bf16
// (42.9 us at 3.35 TB/s) and needs 18.3 GFLOP (18.5 us at the bf16
// tensor-core peak): bytes bound it, operations near.  Design (simple
// first; not pipelined): 256 threads, eight warps on mma.sync tensor-core
// products, bf16 (m16n8k16) for bf16 inputs and 3xTF32 (m16n8k8, each
// float32 operand split into tf32 hi and lo by round-to-nearest, lo.hi +
// hi.lo + hi.hi) for float32, accumulating in float32.  Operands are staged
// in shared memory tiles of 64 rows by 64 columns (a 16-byte pad a row, no
// bank conflicts in the fragment loads), filled by 16-byte loads with
// zeros past the edges.
//
// Forward: a block per (64-row tile, 256-column slab of Dv, batch row).  S
// = Q.K^T accumulates over 64-column slabs of Dk (Q's and K's slabs
// streamed through shared memory, so Dk = 576 needs 17 KB of float32 a
// tile, not 144 KB), is scaled and masked into shared memory, and four
// threads a row take the online softmax (row max, P rounded to the input
// type, rescale factor); O (64 x 256 float32, 64 registers a thread in
// eight warps) is rescaled and accumulates P.V.  The output's 512 columns
// take two blocks, each recomputing S (1.5x the least products).  Causal
// tiles load no key tile past their last row's position.
//
// Backward, three launches, no atomics (every call repeats bitwise):
//  1. rows: a block per (64-row tile, batch row) recomputes S and dP =
//     dO.V^T over the key tiles its rows see, sums p * dp and p a row, then
//     recomputes them again and writes P and dS (the input type) to a
//     scratch of (B, rows, keys) padded to whole tiles, then dQ = dS.K,
//     64 columns of Dk at a time, reading back its own dS.
//  2. keys: a block per (64-key tile, 64-column slab of dK's Dk or dV's Dv
//     columns, batch row x chunk of 32 row tiles) sums dS^T.Q (or P^T.dO)
//     over the chunk's row tiles that see the keys, into a float32 partial
//     of its own.
//  3. finish: the partials of the chunks summed in chunk order and written
//     to dk and dv.
// The scratch and the partials are allocated by the wrapper
// (kernels/mla_attention_cuda.py) and checked here against their sizes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// A warp's product tile: acc[nt] is the m16n8 float32 accumulator of rows
// 0-15 and columns 8 nt .. 8 nt + 7 of the warp's output; a thread holds
// (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1), g = lane / 4, t =
// lane % 4.  Operands come from shared memory: A(m, k) = at<AKM>(a, lda,
// a0 + m, k), stored [m][k] or, with AKM, [k][m]; B(k, n) = at<BKN>(b, ldb,
// b0 + n, k), stored [n][k] or, with BKN, [k][n].  K = 64 a call.

template <bool KM, typename T>
__device__ __forceinline__ T at(const T* s, int ld, int i, int k) {
  return KM ? s[k * ld + i] : s[i * ld + k];
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// elements (i, k) and (i, k + 1), packed; one 32-bit load where adjacent
template <bool KM>
__device__ __forceinline__ uint32_t pair(const bf16* s, int ld, int i, int k) {
  if constexpr (KM)
    return pack_bf16(s[k * ld + i], s[(k + 1) * ld + i]);
  else
    return *reinterpret_cast<const uint32_t*>(s + i * ld + k);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

template <bool AKM, bool BKN, int NT>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const bf16* a, int lda, int a0,
                                         const bf16* b, int ldb, int b0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < BK; k0 += 16) {
    uint32_t af[4];
    af[0] = pair<AKM>(a, lda, a0 + g, k0 + 2 * t);
    af[1] = pair<AKM>(a, lda, a0 + g + 8, k0 + 2 * t);
    af[2] = pair<AKM>(a, lda, a0 + g, k0 + 2 * t + 8);
    af[3] = pair<AKM>(a, lda, a0 + g + 8, k0 + 2 * t + 8);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = b0 + nt * 8 + g;
      uint32_t bfr[2];
      bfr[0] = pair<BKN>(b, ldb, n, k0 + 2 * t);
      bfr[1] = pair<BKN>(b, ldb, n, k0 + 2 * t + 8);
      mma_bf16(acc[nt], af, bfr);
    }
  }
}

template <bool AKM, bool BKN, int NT>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const float* a, int lda, int a0,
                                         const float* b, int ldb, int b0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k0 = 0; k0 < BK; k0 += 8) {
    uint32_t ah[4], al[4];
    split(at<AKM>(a, lda, a0 + g, k0 + t), ah[0], al[0]);
    split(at<AKM>(a, lda, a0 + g + 8, k0 + t), ah[1], al[1]);
    split(at<AKM>(a, lda, a0 + g, k0 + t + 4), ah[2], al[2]);
    split(at<AKM>(a, lda, a0 + g + 8, k0 + t + 4), ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = b0 + nt * 8 + g;
      uint32_t bh[2], bl[2];
      split(at<BKN>(b, ldb, n, k0 + t), bh[0], bl[0]);
      split(at<BKN>(b, ldb, n, k0 + t + 4), bh[1], bl[1]);
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
    mla_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int H, int Dk,
                   int Dv, float scale, int causal) {
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
    mla_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
    mla_bwd_keys_kernel(const T* __restrict__ q, const T* __restrict__ dout,
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

template <typename T>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse, int64_t B,
        int64_t Sq, int64_t Sk, int64_t H, int Dk, int Dv, float scale, int causal,
        cudaStream_t st) {
  const size_t smem = fwd_smem<T>();
  auto kern = mla_fwd_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)cdiv(Sq * H, BM), (unsigned)cdiv(Dv, DVS), (unsigned)B);
  kern<<<grid, THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, (int)Sq, (int)Sk, (int)H, Dk, Dv,
      scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* q, const void* k, const void* v, const float* lse, const void* dout,
        void* P, void* dS, float* part, void* dq, void* dk, void* dv, int64_t B, int64_t Sq,
        int64_t Sk, int64_t H, int Dk, int Dv, float scale, int causal, cudaStream_t st) {
  const int64_t n_rt = cdiv(Sq * H, BM), chunks = cdiv(n_rt, ROW_CHUNK);
  const BwdArgs a{(int)Sq, (int)Sk, (int)H, Dk, Dv, scale, causal, n_rt * BM, cdiv(Sk, BN) * BN};
  mla_bwd_rows_kernel<T><<<dim3((unsigned)n_rt, (unsigned)B), THREADS, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, lse, (const T*)dout, (T*)P, (T*)dS, (T*)dq, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_dk = (int)cdiv(Dk, BK), n_dv = (int)cdiv(Dv, BK);
  mla_bwd_keys_kernel<T><<<dim3((unsigned)cdiv(Sk, BN), (unsigned)(n_dk + n_dv),
                               (unsigned)(B * chunks)),
                          THREADS, 0, st>>>((const T*)q, (const T*)dout, (const T*)P,
                                            (const T*)dS, part, (int)B, n_dk, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
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

}  // namespace

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
// 1 (bfloat16).  Every tensor is contiguous: q (B,Sq,H,Dk), k (B,Sk,Dk), v
// (B,Sk,Dv), o (B,Sq,H,Dv); `lse` null or float32 (B,H,Sq).
extern "C" int mla_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                 void* lse, int64_t B, int64_t Sq, int64_t Sk, int64_t H,
                                 int64_t Dk, int64_t Dv, float scale, int causal, int dtype,
                                 int device, void* stream) {
  if (!shape_ok(B, Sq, Sk, H, Dk, Dv)) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return fwd<float>(q, k, v, o, (float*)lse, B, Sq, Sk, H, (int)Dk, (int)Dv, scale, causal,
                      st);
  if (dtype == 1)
    return fwd<bf16>(q, k, v, o, (float*)lse, B, Sq, Sk, H, (int)Dk, (int)Dv, scale, causal,
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
  if (dtype == 0)
    return bwd<float>(q, k, v, (const float*)lse, dout, P, dS, (float*)part, dq, dk, dv, B, Sq,
                      Sk, H, (int)Dk, (int)Dv, scale, causal, st);
  if (dtype == 1)
    return bwd<bf16>(q, k, v, (const float*)lse, dout, P, dS, (float*)part, dq, dk, dv, B, Sq,
                     Sk, H, (int)Dk, (int)Dv, scale, causal, st);
  return -2;
}
