// Blocked online-softmax attention (forward) for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention_pallas (the
// Pallas body `_kernel`):
//
//   q (B,Sq,H,D), k and v (B,Sk,H,D), one head count H (GQA callers expand
//   K/V first)  ->  o (B,Sq,H,D) in q's type,
//   o = softmax(scale * q.k^T [masked]) . v
//
// with the causal mask qpos >= kpos (no offset) when `causal`.  Inputs are
// float32 or bfloat16 (all the same type); every product, the running max,
// the running sum and the accumulator are float32, as in the TPU kernel:
// q is scaled in float32 before the product (`_kernel` line 48), masked
// scores are -1e30, and the sum is floored at 1e-30 before the division.
// D is 16, 32, 64 or 128 (a template parameter: zamba2 and the dense
// configs have 64 or 128, their reduced test configs 16); q, k and v are read
// through their batch, sequence and head strides (the last dimension must be
// contiguous).
//
// Design: one block of 256 threads per (64-row q tile, head, batch).  The
// q tile is loaded once, transposed and pre-scaled, into shared memory; the
// block then walks 64-row K/V tiles, staged in shared memory, and stops at
// the diagonal when causal (the tiles the Pallas kernel skips with
// `pl.when` are never loaded).  Each thread owns a 4 x 4 patch of the
// 64 x 64 score tile and 4 rows x 4 columns of each 64-column block of the
// output accumulator (D < 64 is padded to one block with zeros), so every
// k step of both products costs two 16-byte shared-memory loads for 16 (or
// 32) FMAs.  The row max and row sum are reduced across the 16 threads that
// share a row with warp shuffles; the row statistics stay in registers.
// Rows past Sq and columns past Sk (ragged S: the TPU kernel asserts
// S % block == 0, this one masks) are loaded as zeros and masked.
//
// What bounds it: at zamba2-1.2b's prefill (B=4, S=512, H=32, D=64, bf16,
// causal) one call moves 16.8 MB (~5 us at 3.35 TB/s) and needs 4.3 GFLOP
// of products (~4.4 us on the bf16 tensor cores), so the bound is bytes.
// This kernel does its products in float32 FFMA (no tensor cores, no TMA,
// no wgmma), so the FFMA rate (67 TFLOP/s) is its practical ceiling: a
// first, simple kernel; wgmma with TMA-fed tiles is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // q rows per block
constexpr int BN = 64;          // k/v rows per tile
constexpr int LDT = BM + 4;     // row length of the transposed tiles (floats)
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

struct Strides {
  int64_t b, s, h;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// the output patch's width: D rounded up to whole 64-column blocks
template <int D>
__host__ __device__ constexpr int padded_d() { return D < 64 ? 64 : D; }

template <int D>
constexpr size_t smem_floats() {
  // q^T, k^T: D x LDT; v: BN x (padded D + 4); p^T: BN x LDT
  return (size_t)2 * D * LDT + (size_t)BN * (padded_d<D>() + 4) + (size_t)BN * LDT;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                       Strides sq, Strides sk, Strides sv, Strides so, float scale,
                       int causal) {
  constexpr int DW = padded_d<D>();
  constexpr int LDV = DW + 4;
  constexpr int NB = DW / 64;   // 64-column blocks of the output
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);   // [D][LDT]  q tile^T * scale
  float* Kt = Qt + D * LDT;                      // [D][LDT]  k tile^T
  float* Vs = Kt + D * LDT;                      // [BN][LDV] v tile
  float* Pt = Vs + BN * LDV;                     // [BN][LDT] probabilities^T

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  T* ob = o + b * so.b + h * so.h;

  for (int e = tid; e < BM * D; e += THREADS) {
    const int i = e / D, d = e % D;
    Qt[d * LDT + i] = (q0 + i < Sq) ? to_f(qb[(int64_t)(q0 + i) * sq.s + d]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][4 * NB];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NB; ++c) acc[r][c] = 0.f;
  }

  int n_tiles = (Sk + BN - 1) / BN;
  if (causal) {
    const int last_row = min(q0 + BM, Sq) - 1;
    n_tiles = min(n_tiles, last_row / BN + 1);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BN;
    __syncthreads();   // the previous tile's Kt, Vs and Pt are consumed
    for (int e = tid; e < BN * D; e += THREADS) {
      const int j = e / D, d = e % D;
      Kt[d * LDT + j] = k0 + j < Sk ? to_f(kb[(int64_t)(k0 + j) * sk.s + d]) : 0.f;
    }
    for (int e = tid; e < BN * DW; e += THREADS) {
      const int j = e / DW, d = e % DW;
      Vs[j * LDV + d] = (k0 + j < Sk && d < D) ? to_f(vb[(int64_t)(k0 + j) * sv.s + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * LDT + ty * 4);
      const float4 bk = *reinterpret_cast<const float4*>(Kt + d * LDT + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(av[r], bv[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ty * 4 + r;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tx * 4 + c;
        if (j >= Sk || (causal && j > i)) s[r][c] = NEG_INF;
        mx = fmaxf(mx, s[r][c]);
      }
      // the 16 threads of a row are the 16-lane half of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - m_new);
        sum += p;
        Pt[(tx * 4 + c) * LDT + ty * 4 + r] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NB; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(Pt + j * LDT + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const float4 bv4 = *reinterpret_cast<const float4*>(Vs + j * LDV + nb * 64 + tx * 4);
        const float bv[4] = {bv4.x, bv4.y, bv4.z, bv4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[r][nb * 4 + c] = fmaf(av[r], bv[c], acc[r][nb * 4 + c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + ty * 4 + r;
    if (i >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = ob + (int64_t)i * so.s;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = nb * 64 + tx * 4 + c;
        if (D >= 64 || d < D) put(orow + d, acc[r][nb * 4 + c] / denom);
      }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B, int64_t Sq,
           int64_t Sk, int64_t H, Strides sq, Strides sk, Strides sv, Strides so,
           float scale, int causal, cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, D>;
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Sq + BM - 1) / BM), (unsigned)H, (unsigned)B);
  kern<<<grid, THREADS, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)o,
                                        (int)Sq, (int)Sk, sq, sk, sv, so, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int64_t B, int64_t Sq,
             int64_t Sk, int64_t H, int64_t D, Strides sq, Strides sk, Strides sv,
             Strides so, float scale, int causal, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Sk, H, sq, sk, sv, so, scale, causal, st);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Sk, H, sq, sk, sv, so, scale, causal, st);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, sq, sk, sv, so, scale, causal, st);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, sq, sk, sv, so, scale, causal, st);
    default: return -1;
  }
}

}  // namespace

// Returns the CUDA error of the launch (0 on success); -1 for a shape the
// kernel does not take (D not 16, 32, 64 or 128, an empty or oversized
// grid), -2 for
// a dtype code other than 0 (float32) or 1 (bfloat16).  Strides are in
// elements: (batch, sequence, head) for each of q, k, v and o.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int64_t B, int64_t Sq, int64_t Sk, int64_t H, int64_t D,
                                   int64_t qb, int64_t qs, int64_t qh, int64_t kb,
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
  if (dtype == 0) return dispatch<float>(q, k, v, o, B, Sq, Sk, H, D, sq, sk, sv, so, scale, causal, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, D, sq, sk, sv, so, scale, causal, st);
  return -2;
}
