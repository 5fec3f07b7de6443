// Grouped fused LSTM cell for Hopper (sm_90a).
//
// Replaces src/repro/kernels/lstm_cell.py:lstm_cell_pallas (the Pallas body
// `_kernel`): one LSTM step, gates = x.W_ih + h.W_hh + b in gate order
// i, f, g, o; c' = sigmoid(f) c + sigmoid(i) tanh(g); h' = sigmoid(o) tanh(c').
// The JAX package vmaps that kernel over per-market parameter stacks; here
// the group dimension G is explicit:
//
//   x (G,B,I), h and c (G,B,H), w_ih (G,I,4H), w_hh (G,H,4H), b (G,4H)
//   -> h' and c' (G,B,H)
//
// G = 1 is exactly lstm_cell_pallas; each group's arithmetic reads only its
// own rows, so a group's result does not depend on its neighbours.
// Inputs are float32 or bfloat16 (all the same type); the arithmetic is
// float32 and the outputs are written in the input type.
//
// What bounds it: at RevPred's shapes (B = 1, I <= 32, H = 32, G <= 6) one
// call moves at most 6 * (32 + 32) * 128 * 4 bytes = 192 KiB of weights and
// does ~50 kFLOP, a few tens of nanoseconds of memory time and far less of
// arithmetic; the launch itself (a few microseconds) is the bound.  The
// design therefore keeps the cell to a single launch with no scratch, no
// second pass and no synchronisation: one thread per (g, b, j) hidden unit
// accumulates its four gate dot products over I + H and then runs the
// elementwise tail in registers.  Neighbouring threads take neighbouring j,
// so each weight row is read coalesced (32 consecutive floats per warp and
// gate at H = 32), and the x / h operands a warp shares are broadcast loads.
// No tensor cores (wgmma) and no TMA: the products are far too small.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid_f(float v) { return 1.0f / (1.0f + expf(-v)); }

template <typename T>
__global__ void lstm_cell_kernel(const T* __restrict__ x, const T* __restrict__ h,
                                 const T* __restrict__ c, const T* __restrict__ w_ih,
                                 const T* __restrict__ w_hh, const T* __restrict__ b,
                                 T* __restrict__ h_out, T* __restrict__ c_out,
                                 int G, int B, int I, int H) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = (int64_t)G * B * H;
  if (n >= total) return;
  const int j = (int)(n % H);
  const int64_t gb = n / H;           // flattened (g, b) row
  const int64_t g = gb / B;
  const int64_t H4 = 4 * (int64_t)H;

  const T* xr = x + gb * I;
  const T* hr = h + gb * H;
  const T* wi = w_ih + g * I * H4 + j;
  const T* wh = w_hh + g * H * H4 + j;
  const T* bg = b + g * H4 + j;

  // x.W_ih and h.W_hh summed apart, then added with the bias, as the
  // reference evaluates x @ w_ih + h @ w_hh + b
  float xi = 0.f, xf = 0.f, xg = 0.f, xo = 0.f;
  for (int k = 0; k < I; ++k) {
    const float v = load_f(xr, k);
    const int64_t row = (int64_t)k * H4;
    xi = fmaf(v, load_f(wi, row), xi);
    xf = fmaf(v, load_f(wi, row + H), xf);
    xg = fmaf(v, load_f(wi, row + 2 * (int64_t)H), xg);
    xo = fmaf(v, load_f(wi, row + 3 * (int64_t)H), xo);
  }
  float hi = 0.f, hf = 0.f, hg = 0.f, ho = 0.f;
  for (int k = 0; k < H; ++k) {
    const float v = load_f(hr, k);
    const int64_t row = (int64_t)k * H4;
    hi = fmaf(v, load_f(wh, row), hi);
    hf = fmaf(v, load_f(wh, row + H), hf);
    hg = fmaf(v, load_f(wh, row + 2 * (int64_t)H), hg);
    ho = fmaf(v, load_f(wh, row + 3 * (int64_t)H), ho);
  }
  const float gi = sigmoid_f(xi + hi + load_f(bg, 0));
  const float gf = sigmoid_f(xf + hf + load_f(bg, H));
  const float gg = tanhf(xg + hg + load_f(bg, 2 * (int64_t)H));
  const float go = sigmoid_f(xo + ho + load_f(bg, 3 * (int64_t)H));
  const float c2 = gf * load_f(c, n) + gi * gg;
  store_f(c_out, n, c2);
  store_f(h_out, n, go * tanhf(c2));
}

template <typename T>
int launch(const void* x, const void* h, const void* c, const void* w_ih,
           const void* w_hh, const void* b, void* h_out, void* c_out,
           int G, int B, int I, int H, cudaStream_t stream) {
  const int64_t total = (int64_t)G * B * H;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  lstm_cell_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      (const T*)x, (const T*)h, (const T*)c, (const T*)w_ih, (const T*)w_hh,
      (const T*)b, (T*)h_out, (T*)c_out, G, B, I, H);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the CUDA error of the launch
// (0 on success); an unknown dtype or an empty shape returns -1.
extern "C" int lstm_cell_fwd(const void* x, const void* h, const void* c,
                             const void* w_ih, const void* w_hh, const void* b,
                             void* h_out, void* c_out, int G, int B, int I, int H,
                             int dtype, int device, void* stream) {
  if (G <= 0 || B <= 0 || I <= 0 || H <= 0) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, h, c, w_ih, w_hh, b, h_out, c_out, G, B, I, H, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, h, c, w_ih, w_hh, b, h_out, c_out, G, B, I, H, s);
  return -1;
}
