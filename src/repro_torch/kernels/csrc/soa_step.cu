// SoA sweep inner step for Hopper (sm_90a): float64 EWMA fold + int64
// segmented boundary min, in one launch.
//
// Replaces src/repro/kernels/soa_step.py:soa_step_fused (the Pallas body
// `_build_fused.kernel`) and, through the fold-only entry point, the Pallas
// branch of src/repro/kernels/soa_step.py:ewma_fold.
//
//   obs (F,L) float64 row-major, lens (F,) int64, m0 (F,) float64,
//   first (F,) bool, ewma (F,) float64           -> m (F,) float64
//   next_k (N,) int64, row_rep (N,) int64 in [0,R) -> seg (R,) int64
//
// Fold, per row i: m = first[i] ? 0 : m0[i]; then for j < lens[i] (capped at
// L), m = obs[i,j] on the first observation of a `first` row, else
// m = (1-a) m + a obs[i,j].  Min: seg[r] = min of next_k over the rows with
// row_rep == r; the wrapper fills seg with 2^60 (the sweep's "not running")
// before the launch, so an empty segment stays 2^60.
//
// Exactness: the sweep holds this fold bit-exact to numpy's
// `b * m + a * col`, which rounds each product and the sum apart.  nvcc
// would contract that into one FMA (one rounding), so the products and the
// sum are written with the round-to-nearest intrinsics, which it never
// contracts, in numpy's order: b*m, then + a*o.  The result is exact for
// any alpha, not only the dyadic 0.5.  The min is exact whatever order the
// atomics land in.
//
// What bounds it on this card: not bytes (a recorded 1000-replica round,
// F=319, L=354, sum(lens)=45,879, N=32,000, R=1000, moves ~0.9 MB, 0.27 us
// at 3.35 TB/s) but the longest row's dependent float64 chain: each step is
// a multiply of m and an add that waits for it, and the rounding order
// forbids splitting the row into parallel pieces.  The first kernel gave
// each row one thread that walked it with one strided 8-byte global load
// per step, so every step waited a memory latency (~170 cycles), and all
// rows sat on two SMs.  Here:
//   * each fold row has its own warp (4 rows a block, so F=319 rows spread
//     over 80 SMs);
//   * the warp reads its row 64 observations at a time with coalesced
//     loads (two per lane), the next 64 in flight while the chain runs on
//     the current ones; every lane runs the same chain and takes step k's
//     observation by a warp shuffle, which does not depend on m, so only
//     the multiply-add waits on the step before;
//   * `first` is peeled (m = obs[0], the walk starts at 1), so the loop
//     has no branch but the tail's bound;
//   * the min half gives each boundary row one lane; a warp reduces runs of
//     equal row_rep (the sweep's row_rep is sorted) with shuffles, and only
//     the first lane of each run issues the 64-bit atomicMin: ~2 atomics a
//     warp instead of 32 at the recorded round.  Unsorted row_rep is exact
//     too: each contiguous run of a key in a warp has its own first lane.
// The min rows run in the blocks after the fold blocks of the same grid.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int ROWS_PER_BLOCK = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ double step(double m, double a, double b, double o) {
  return __dadd_rn(__dmul_rn(b, m), __dmul_rn(a, o));
}

__device__ void fold_row(const double* __restrict__ obs, const int64_t* __restrict__ lens,
                         const double* __restrict__ m0, const bool* __restrict__ first,
                         const double* __restrict__ ewma, double* __restrict__ m_out,
                         int64_t i, int64_t L, int lane) {
  const double a = ewma[i];
  const double b = __dsub_rn(1.0, a);
  int64_t n = lens[i];
  if (n > L) n = L;
  if (n < 0) n = 0;
  const double* row = obs + i * L;
  double m;
  int64_t j = 0;
  if (first[i]) {
    m = n > 0 ? row[0] : 0.0;
    j = n > 0 ? 1 : 0;
  } else {
    m = m0[i];
  }
  // lane l holds observations j + l and j + 32 + l of the current 64
  double lo = j + lane < n ? row[j + lane] : 0.0;
  double hi = j + 32 + lane < n ? row[j + 32 + lane] : 0.0;
  while (n - j >= 64) {
    const int64_t jn = j + 64;
    const double nlo = jn + lane < n ? row[jn + lane] : 0.0;
    const double nhi = jn + 32 + lane < n ? row[jn + 32 + lane] : 0.0;
#pragma unroll
    for (int k = 0; k < 32; ++k) m = step(m, a, b, __shfl_sync(FULL, lo, k));
#pragma unroll
    for (int k = 0; k < 32; ++k) m = step(m, a, b, __shfl_sync(FULL, hi, k));
    lo = nlo;
    hi = nhi;
    j = jn;
  }
  const int rem = (int)(n - j);   // < 64, the same in every lane
  for (int k = 0; k < rem && k < 32; ++k) m = step(m, a, b, __shfl_sync(FULL, lo, k));
  for (int k = 32; k < rem; ++k) m = step(m, a, b, __shfl_sync(FULL, hi, k - 32));
  if (lane == 0) m_out[i] = m;
}

__global__ void __launch_bounds__(THREADS)
soa_step_kernel(const double* __restrict__ obs, const int64_t* __restrict__ lens,
                const double* __restrict__ m0, const bool* __restrict__ first,
                const double* __restrict__ ewma, const int64_t* __restrict__ next_k,
                const int64_t* __restrict__ row_rep, double* __restrict__ m_out,
                long long* __restrict__ seg_out, int64_t F, int64_t L, int64_t N, int64_t R,
                int64_t fold_blocks) {
  const int lane = threadIdx.x & 31;
  if ((int64_t)blockIdx.x < fold_blocks) {
    const int64_t i = (int64_t)blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
    if (i < F) fold_row(obs, lens, m0, first, ewma, m_out, i, L, lane);
    return;
  }
  const int64_t idx = ((int64_t)blockIdx.x - fold_blocks) * THREADS + threadIdx.x;
  long long key = -1, v = 0;
  if (idx < N) {
    const int64_t r = row_rep[idx];
    if (r >= 0 && r < R) {
      key = r;
      v = (long long)next_k[idx];
    }
  }
  // min over the contiguous run of equal keys that starts at each lane
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long v2 = __shfl_down_sync(FULL, v, off);
    const long long k2 = __shfl_down_sync(FULL, key, off);
    if (lane + off < 32 && k2 == key && v2 < v) v = v2;
  }
  const long long kprev = __shfl_up_sync(FULL, key, 1);
  if (key >= 0 && (lane == 0 || kprev != key)) atomicMin(seg_out + key, v);
}

int launch(const void* obs, const void* lens, const void* m0, const void* first,
           const void* ewma, const void* next_k, const void* row_rep, void* m_out,
           void* seg_out, int64_t F, int64_t L, int64_t N, int64_t R, int device,
           void* stream) {
  if (F < 0 || L < 0 || N < 0 || R < 0) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t fold_blocks = (F + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const int64_t min_blocks = (N + THREADS - 1) / THREADS;
  const int64_t blocks = fold_blocks + min_blocks;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffff) return -1;
  soa_step_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const double*)obs, (const int64_t*)lens, (const double*)m0, (const bool*)first,
      (const double*)ewma, (const int64_t*)next_k, (const int64_t*)row_rep,
      (double*)m_out, (long long*)seg_out, F, L, N, R, fold_blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// Both entry points return the CUDA error of the launch (0 on success, and
// 0 with nothing launched when there is no row); a negative size returns -1.
extern "C" int soa_step_fused(const void* obs, const void* lens, const void* m0,
                              const void* first, const void* ewma, const void* next_k,
                              const void* row_rep, void* m_out, void* seg_out,
                              int64_t F, int64_t L, int64_t N, int64_t R, int device,
                              void* stream) {
  return launch(obs, lens, m0, first, ewma, next_k, row_rep, m_out, seg_out, F, L, N,
                R, device, stream);
}

// The fold half alone (src/repro/kernels/soa_step.py:ewma_fold's Pallas body).
extern "C" int soa_ewma_fold(const void* obs, const void* lens, const void* m0,
                             const void* first, const void* ewma, void* m_out,
                             int64_t F, int64_t L, int device, void* stream) {
  return launch(obs, lens, m0, first, ewma, nullptr, nullptr, m_out, nullptr, F, L, 0,
                0, device, stream);
}
