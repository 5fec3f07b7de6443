// One Mamba2 SSD chunk (state-space duality) for Hopper (sm_90a).
//
// Replaces src/repro/kernels/ssd_scan.py:ssd_chunk_pallas (the Pallas body
// `_kernel`), the TPU version of src/repro/models/ssd.py:_chunk_scan_step.
// Per (batch b, head h), with a = dt * A and cum its inclusive prefix sum
// over the chunk's Q rows:
//
//   y[i]   = sum_{j <= i} exp(cum_i - cum_j) (C_i . B_j) dt_j x_j
//            + exp(cum_i) (C_i . state)
//   state' = exp(cum_{Q-1}) state + sum_j exp(cum_{Q-1} - cum_j) dt_j x_j (x) B_j
//
//   x (B,Q,H,P), dt (B,Q,H), A (H,), B and C (B,Q,H,N), state (B,H,P,N), all
//   float32  ->  y (B,Q,H,P), state' (B,H,P,N), float32, contiguous.
//
// x, dt, B and C are read through their (batch, row, head) strides, so a
// chunk's slice of a whole-sequence tensor needs no copy; their last
// dimension must be contiguous.  P <= 64 and N <= 128 (every config of the
// repo: P = 64, N = 64 or 128).
//
// Design: one block of 256 threads per (h, b).  cum (Q floats) is computed
// once into shared memory with a warp-shuffle scan.  The TPU kernel holds
// the whole (Q, Q) score tile (256 KiB at Q = 256, over the 227 KB a block
// may have), so here the rows are walked in 64-row i-tiles and, inside each,
// 64-row j-tiles up to the diagonal: C_i^T, B_j^T and dt_j x_j are staged in
// shared memory, the 64 x 64 tile (C_i . B_j) exp(cum_i - cum_j) is built
// with the upper triangle masked BEFORE the exp (there cum_i - cum_j > 0 and
// overflows, ssd.py:85-91), and multiplied into the 64 x P output tile held
// in registers.  The state term is one more product per i-tile, and the new
// state a last pass over the j-tiles, 64 state columns at a time.  Every
// product is one routine: a thread owns a 4 x 4 output patch and each k step
// costs two 16-byte shared-memory loads for 16 FFMAs.  Shared memory:
// 88 KB at N = 64 (two blocks per SM), 140 KB at N = 128.
//
// Precision: float32 FFMA throughout (TF32 would not hold the 1e-4 the
// plain version is held to).  What bounds it: at zamba2-1.2b's chunk
// (B=4, Q=256, H=64, P=N=64) one call moves ~74 MB (22 us at 3.35 TB/s) and
// needs ~3.2 GFLOP of float32 products (48 us at 67 TFLOP/s): operations.
// No tensor cores and no TMA in this first kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 64;          // rows per i-tile and j-tile, columns per block
constexpr int LD = T + 4;      // row length of every staged tile (floats)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

struct Str3 {
  int64_t b, q, h;
};

// acc[r][c] += sum_k At[k][i0 + r] * Bk[k][j0 + c], both operands k-major
// with rows of LD floats.
__device__ __forceinline__ void mm4x4(float (&acc)[4][4], const float* At, const float* Bk,
                                      int K, int i0, int j0) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(At + k * LD + i0);
    const float4 b = *reinterpret_cast<const float4*>(Bk + k * LD + j0);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
}

size_t smem_floats(int Q, int N) {
  const size_t qp = ((size_t)Q + 3) & ~(size_t)3;
  const size_t nt = (size_t)(N > T ? N : T);
  // cum, C_i^T (N x LD), B_j^T or B_j (max(N, T) x LD), dt x (T x LD),
  // scores^T (T x LD), state^T (N x LD), warp sums
  return qp + (size_t)N * LD + nt * LD + 2 * (size_t)T * LD + (size_t)N * LD + WARPS;
}

__global__ void __launch_bounds__(THREADS)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, const float* __restrict__ state,
                 float* __restrict__ y, float* __restrict__ state_out, int Q, int H, int P,
                 int N, Str3 sx, Str3 sdt, Str3 sB, Str3 sC) {
  extern __shared__ float4 smem4[];
  const int qp = (Q + 3) & ~3;
  const int nt = N > T ? N : T;
  float* cum = reinterpret_cast<float*>(smem4);
  float* Ct = cum + qp;          // [N][LD]   C_i^T
  float* Bt = Ct + N * LD;       // [N][LD]   B_j^T; [T][LD] B_j in the state pass
  float* Xj = Bt + nt * LD;      // [T][LD]   dt_j x_j (times the decay in the state pass)
  float* St = Xj + T * LD;       // [T][LD]   masked scores^T, [j][i]
  float* Sst = St + T * LD;      // [N][LD]   state^T, [n][p]
  float* wsum = Sst + N * LD;    // [WARPS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const float Ah = A[h];
  const float* xb = x + b * sx.b + h * sx.h;
  const float* dtb = dt + b * sdt.b + h * sdt.h;
  const float* Bb = Bm + b * sB.b + h * sB.h;
  const float* Cb = Cm + b * sC.b + h * sC.h;
  const int64_t sbh = ((int64_t)b * H + h) * P * N;
  const float* st = state + sbh;
  float* so = state_out + sbh;
  float* yb = y + ((int64_t)b * Q * H + h) * P;
  const int64_t ys = (int64_t)H * P;

  // cum: inclusive prefix sum of dt * A, 256 rows at a time
  float carry = 0.f;
  for (int base = 0; base < Q; base += THREADS) {
    const int qi = base + tid;
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
  for (int e = tid; e < N * T; e += THREADS) {
    const int n = e / T, p = e % T;
    Sst[n * LD + p] = p < P ? st[(int64_t)p * N + n] : 0.f;
  }

  const int n_tiles = (Q + T - 1) / T;
  for (int it = 0; it < n_tiles; ++it) {
    const int i0 = it * T;
    __syncthreads();
    for (int e = tid; e < T * N; e += THREADS) {
      const int i = e / N, n = e % N;
      Ct[n * LD + i] = i0 + i < Q ? Cb[(int64_t)(i0 + i) * sC.q + n] : 0.f;
    }
    __syncthreads();

    // state term: exp(cum_i) (C_i . state[p])
    float acc[4][4];
    zero(acc);
    mm4x4(acc, Ct, Sst, N, ty * 4, tx * 4);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r;
      const float e_i = i < Q ? expf(cum[i]) : 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] *= e_i;
    }

    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * T;
      __syncthreads();
      for (int e = tid; e < T * N; e += THREADS) {
        const int j = e / N, n = e % N;
        Bt[n * LD + j] = j0 + j < Q ? Bb[(int64_t)(j0 + j) * sB.q + n] : 0.f;
      }
      for (int e = tid; e < T * T; e += THREADS) {
        const int j = e / T, p = e % T;
        float val = 0.f;
        if (j0 + j < Q && p < P)
          val = xb[(int64_t)(j0 + j) * sx.q + p] * dtb[(int64_t)(j0 + j) * sdt.q];
        Xj[j * LD + p] = val;
      }
      __syncthreads();
      float s[4][4];
      zero(s);
      mm4x4(s, Ct, Bt, N, ty * 4, tx * 4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty * 4 + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j0 + tx * 4 + c;
          // mask before the exp: above the diagonal cum_i - cum_j > 0
          const float val = (j <= i && i < Q) ? s[r][c] * expf(cum[i] - cum[j]) : 0.f;
          St[(tx * 4 + c) * LD + ty * 4 + r] = val;
        }
      }
      __syncthreads();
      mm4x4(acc, St, Xj, T, ty * 4, tx * 4);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r;
      if (i >= Q) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int p = tx * 4 + c;
        if (p < P) yb[(int64_t)i * ys + p] = acc[r][c];
      }
    }
  }

  // state' = exp(cum_last) state + sum_j exp(cum_last - cum_j) dt_j x_j (x) B_j
  const float c_last = cum[Q - 1];
  const float decay = expf(c_last);
  for (int n0 = 0; n0 < N; n0 += T) {
    float acc[4][4];
    zero(acc);
    for (int jt = 0; jt < n_tiles; ++jt) {
      const int j0 = jt * T;
      __syncthreads();
      for (int e = tid; e < T * T; e += THREADS) {
        const int j = e / T, c = e % T;
        const bool row = j0 + j < Q;
        float xv = 0.f;
        if (row && c < P)
          xv = xb[(int64_t)(j0 + j) * sx.q + c] * dtb[(int64_t)(j0 + j) * sdt.q] *
               expf(c_last - cum[j0 + j]);
        Xj[j * LD + c] = xv;
        Bt[j * LD + c] = row && n0 + c < N ? Bb[(int64_t)(j0 + j) * sB.q + n0 + c] : 0.f;
      }
      __syncthreads();
      mm4x4(acc, Xj, Bt, T, ty * 4, tx * 4);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = ty * 4 + r;
      if (p >= P) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = n0 + tx * 4 + c;
        if (n < N) so[(int64_t)p * N + n] = st[(int64_t)p * N + n] * decay + acc[r][c];
      }
    }
  }
}

}  // namespace

// Returns the CUDA error of the launch (0 on success), or -1 for a shape the
// kernel does not take (P > 64, N > 128, an empty chunk, or more shared
// memory than a block may have).  Strides are in elements: (batch, row,
// head) for each of x, dt, B and C.
extern "C" int ssd_chunk_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                             const void* Cm, const void* state, void* y, void* state_out,
                             int64_t B, int64_t Q, int64_t H, int64_t P, int64_t N,
                             int64_t xb, int64_t xq, int64_t xh, int64_t db, int64_t dq,
                             int64_t dh, int64_t bb, int64_t bq, int64_t bh, int64_t cb,
                             int64_t cq, int64_t ch, int device, void* stream) {
  if (B <= 0 || Q <= 0 || H <= 0 || P <= 0 || N <= 0 || P > T || N > 2 * T ||
      B > 65535 || H > ((int64_t)1 << 30))
    return -1;
  const size_t smem = smem_floats((int)Q, (int)N) * sizeof(float);
  if (Q > ((int64_t)1 << 20) || smem > 232448) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)H, (unsigned)B);
  ssd_chunk_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)dt, (const float*)A, (const float*)Bm,
      (const float*)Cm, (const float*)state, (float*)y, (float*)state_out, (int)Q, (int)H,
      (int)P, (int)N, Str3{xb, xq, xh}, Str3{db, dq, dh}, Str3{bb, bq, bh},
      Str3{cb, cq, ch});
  return (int)cudaGetLastError();
}
