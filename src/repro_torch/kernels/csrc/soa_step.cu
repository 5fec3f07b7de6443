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
// contracts.  The result is exact for any alpha, not only the dyadic 0.5.
// The min is exact whatever order the atomics land in.
//
// What bounds it: at a 1000-replica round (F ~ 128, L ~ 16, N ~ 32000,
// R = 1000) one call moves ~0.55 MB (next_k and row_rep are most of it),
// ~0.16 us at 3.35 TB/s, and does a few thousand float64 operations.  The
// launch (a few microseconds) is the bound, so the design is one launch,
// no scratch, no second pass: thread i < F folds row i in registers, and
// thread i < N does one 64-bit atomicMin into seg[row_rep[i]].  Neighbouring
// threads read neighbouring next_k / row_rep entries (coalesced); the fold's
// row walk is strided but touches only F*L*8 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void soa_step_kernel(const double* __restrict__ obs,
                                const int64_t* __restrict__ lens,
                                const double* __restrict__ m0,
                                const bool* __restrict__ first,
                                const double* __restrict__ ewma,
                                const int64_t* __restrict__ next_k,
                                const int64_t* __restrict__ row_rep,
                                double* __restrict__ m_out,
                                long long* __restrict__ seg_out,
                                int64_t F, int64_t L, int64_t N, int64_t R) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < F) {
    const double a = ewma[i];
    const double b = __dsub_rn(1.0, a);
    bool fr = first[i];
    double m = fr ? 0.0 : m0[i];
    int64_t n = lens[i];
    if (n > L) n = L;
    const double* row = obs + i * L;
    for (int64_t j = 0; j < n; ++j) {
      const double o = row[j];
      if (fr) {
        m = o;
        fr = false;
      } else {
        m = __dadd_rn(__dmul_rn(b, m), __dmul_rn(a, o));
      }
    }
    m_out[i] = m;
  }
  if (i < N) {
    const int64_t r = row_rep[i];
    if (r >= 0 && r < R) atomicMin(seg_out + r, (long long)next_k[i]);
  }
}

int launch(const void* obs, const void* lens, const void* m0, const void* first,
           const void* ewma, const void* next_k, const void* row_rep, void* m_out,
           void* seg_out, int64_t F, int64_t L, int64_t N, int64_t R, int device,
           void* stream) {
  if (F < 0 || L < 0 || N < 0 || R < 0) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t total = F > N ? F : N;
  if (total == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  soa_step_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const double*)obs, (const int64_t*)lens, (const double*)m0, (const bool*)first,
      (const double*)ewma, (const int64_t*)next_k, (const int64_t*)row_rep,
      (double*)m_out, (long long*)seg_out, F, L, N, R);
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
