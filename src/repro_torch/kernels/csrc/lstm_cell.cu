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
//
// lstm_stack_fwd: RevPred's whole LSTM stack in one launch.  The callers
// (RevPred and Tributary forwards) run L = 3 layers over T = 59 or 60 steps:
// launched cell by cell that is 177 launches per forward, each a few
// microseconds of kernel and tens of microseconds of host work around it,
// so the forward was bound by launches, not by the card.  The stack kernel
// takes the whole recurrence in one launch:
//
//   xs (G,B,T,I), layers l = 0..L-1 with w_ih (G,I_l,4H), w_hh (G,H,4H),
//   b (G,4H), I_0 = I and I_l = H above  ->  the top layer's last h (G,B,H)
//
// One block per (group g, tile of `rows` batch rows).  The layers run in
// waves: all L layers at once where their weights fit in shared memory
// (H = 16 and 32: 3 layers are 108 KiB of float32 at H = 32), one at a time
// where they do not (H = 64: one layer is 136 KiB); the wrapper picks the
// wave and the rows per block.  Within a wave the layers form a wavefront:
// at diagonal step d, layer w of the wave runs its step t = d - w, so a
// 3-layer stack over 59 steps takes 61 dependent steps instead of 177.
// Each layer writes its output sequence to its own (T, rows, H) buffer in
// shared memory (the layer above reads it as input; it never leaves the
// block), so one barrier per diagonal step suffices: step t reads x_t (the
// layer below wrote it a diagonal earlier) and h_{t-1} (its own, a diagonal
// earlier) and writes h_t, which nobody reads in the same diagonal.
// Threads: per (layer of the wave, batch row) 8 per hidden unit j, two k
// lanes for each of its four gate columns.  A lane sums every second term
// of x.W_ih and of h.W_hh from the weight column in shared memory (columns
// stored unit by unit, j * 4 + gate, rows padded by 16 floats, so a warp's
// 32 lanes read 32 different banks; x and h are near-broadcasts); the two
// lanes join with one shuffle and add the two products and b, in that
// order, as the cell kernel and ref.lstm_cell_ref do; three more shuffles
// bring the unit's four gates to its first lane, which applies the
// nonlinearities, keeps c in a register and writes h.  h and c round to
// the input type after every step, as the cell's outputs do, so a bfloat16
// stack computes what 3 x T bfloat16 cell calls compute.
//
// What bounds it: at G = 6, H = 32, T = 59 the operations (15.5 MFLOP of
// products and gate arithmetic, ~0.23 us at 67 TFLOP/s) and the bytes (the
// weights, x and the output, ~0.5 MB, ~0.15 us at 3.35 TB/s) are tiny; the
// recurrence is T + L - 1 dependent steps (a wave of all L layers) of one
// barrier, an (I + H) / 2-long dot product and the gate arithmetic each,
// which is what the time is made of.
//
// Training: lstm_stack_fwd_train and lstm_stack_bwd.  The JAX package
// trains RevPred and Tributary by differentiating the lax.scan of
// lstm_cell_pallas (src/repro/core/revpred.py:289-297, jax.value_and_grad);
// it has no Pallas backward.  Here the recurrence lives in one launch, so
// its gradient is a kernel of its own.  lstm_stack_fwd_train is the stack
// kernel above (SAVE = true, float32) writing, for every layer, step and
// batch row, the four gates after their nonlinearities, c_t and h_t to
// global memory, laid out (L, G, B, T, .).  lstm_stack_bwd runs BPTT as a
// reverse wavefront, the mirror of the forward's: at reverse diagonal d,
// slot s of the wave runs layer lt - s at step t = T - 1 - d + s, so it
// finds dh_t's two parts ready, its own step t + 1's dgates . W_hh^T and
// the layer above's dx_t, both written one diagonal earlier; 3 layers over
// 59 steps are again 61 dependent steps.  Per (layer, step, row), phase A
// (a thread per hidden unit j) forms dc_t = dc_carry + dh_t o (1 - tanh^2
// c_t), the four pre-activation gradients from the saved gates, c_t and
// c_{t-1}, and dc_carry = dc_t f; it writes dgates to shared memory and to
// global memory and loads the next step's saved values a diagonal ahead.
// After a barrier, phase B (four lanes per output, a weight row each, held
// in shared memory like the forward's) forms dh_{t-1} = dgates . W_hh^T and
// dx_t = dgates . W_ih^T for the layer below (layer 0's dx is skipped: the
// inputs take no gradient).  Two barriers a diagonal.  The weight
// gradients have no recurrence: the kernel writes dgates (L,G,B,T,4H) and
// the wrapper forms dW_ih = sum_t x_t^T dgates_t, dW_hh = sum_t
// h_{t-1}^T dgates_t and db = sum dgates with one torch.bmm (or sum) per
// weight.
//
// What bounds the backward: at RevPred's training batch (G = 1, B = 256,
// T = 59, H = 32, 3 layers) it reads the saved gates and c (~29 MB) and
// writes dgates (~23 MB), ~16 us at 3.35 TB/s, and does ~0.64 GFLOP of
// products (~10 us at 67 TFLOP/s); the chain of 61 dependent diagonals of
// two barriers each (one block per batch row, 256 blocks in two waves over
// the 132 SMs) is what its time is made of, as in the forward.

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


constexpr int MAX_LAYERS = 8;
constexpr int MAX_THREADS = 1024;
constexpr int KSPLIT = 2;               // k lanes per gate column
constexpr int LANES = 4 * KSPLIT;       // threads per hidden unit
constexpr int WPAD = 16;                // weight row padding (floats)
constexpr size_t SMEM_LIMIT = 232448;   // what one block may have on sm_90

struct StackLayers {
  const void* w_ih[MAX_LAYERS];
  const void* w_hh[MAX_LAYERS];
  const void* b[MAX_LAYERS];
};

// What the training forward keeps for the backward, float32, laid out
// (L, G, B, T, .) so that one layer's slice is (G, B*T, .) for torch.bmm
struct TrainSave {
  float* gates;   // (L, G, B, T, 4H): sigmoid(i), sigmoid(f), tanh(g), sigmoid(o)
  float* c;       // (L, G, B, T, H): c_t
  float* h;       // (L, G, B, T, H): h_t
};

__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// output buffers a stack needs: one per layer of a wave, and one more to
// carry a wave's last output into the next wave
__host__ __device__ inline int stack_buffers(int L, int wave) { return wave >= L ? L : wave + 1; }

// floats of shared memory one block uses; mirrored by the wrapper's
// lstm_stack_smem_bytes
__host__ __device__ inline size_t stack_smem_floats(int I, int H, int T, int rows, int L,
                                                    int wave) {
  const size_t H4 = 4 * (size_t)H, WS = H4 + WPAD;
  const size_t w_rows = (size_t)(I > H ? I : H) + H + (size_t)(wave - 1) * 2 * H;
  return w_rows * WS + (size_t)wave * H4 + (size_t)T * rows * I +
         (size_t)stack_buffers(L, wave) * T * rows * H;
}

// HT > 0 fixes the hidden size at compile time (16, 32, 64: the loops over
// H unroll, so a lane's shared-memory loads are all in flight at once);
// HT = 0 takes it from the argument.  SAVE (the training forward, float32)
// also writes every step's gates, c and h to `sv`.
template <typename T, int HT, bool SAVE>
__global__ void lstm_stack_kernel(const T* __restrict__ x, StackLayers p,
                                  T* __restrict__ h_out, TrainSave sv, int n_layers, int B,
                                  int Tn, int I, int h_arg, int rows, int wave) {
  extern __shared__ float sm[];
  const int H = HT > 0 ? HT : h_arg;
  const int H4 = 4 * H;
  const int WS = H4 + WPAD;
  const int W0 = I > H ? I : H;      // input rows of a wave's first layer slot
  const int nb = stack_buffers(n_layers, wave);
  float* w_s = sm;                   // per slot: [in rows + H rows][WS]
  float* b_s = w_s + ((size_t)W0 + H + (size_t)(wave - 1) * 2 * H) * WS;   // [wave][4H]
  float* xbuf = b_s + (size_t)wave * H4;                                 // [T][rows][I]
  float* bufs = xbuf + (size_t)Tn * rows * I;                            // [nb][T][rows][H]
  const size_t buf_len = (size_t)Tn * rows * H;

  const int64_t g = blockIdx.x;
  const int r0 = blockIdx.y * rows;
  const int nr = min(rows, B - r0);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  // thread (layer slot w, row r, unit j, gate q, k lane ks); a unit's 8
  // lanes are neighbours, and a (slot, row)'s 8H threads whole warps
  const int per_row = H * LANES;
  const int w = tid / (rows * per_row);
  const int r = (tid / per_row) % rows;
  const int u = tid % per_row;
  const int j = u / LANES, q = (u / KSPLIT) % 4, ks = u % KSPLIT;
  const int lane0 = (threadIdx.x & 31) & ~(LANES - 1);   // the unit's first lane

  for (int e = tid; e < nr * Tn * I; e += nthreads) {
    const int rr = e / (Tn * I), rem = e % (Tn * I);
    const int t = rem / I, k = rem % I;
    xbuf[((size_t)t * rows + rr) * I + k] =
        load_f(x, ((g * B + r0 + rr) * Tn + t) * (int64_t)I + k);
  }

  // slot w's weights start after the slots below it: slot 0 has W0 input
  // rows, the others H
  auto slot_w = [&](int s) { return w_s + (size_t)(s == 0 ? 0 : W0 + H + (s - 1) * 2 * H) * WS; };

  float c = 0.f;   // held by lane (q = 0, ks = 0) of each unit
  for (int l0 = 0; l0 < n_layers; l0 += wave) {
    const int nw = min(wave, n_layers - l0);
    __syncthreads();   // x is staged; the previous wave's weights are read
    for (int s = 0; s < nw; ++s) {
      const int l = l0 + s, in = l == 0 ? I : H;
      const T* wi = (const T*)p.w_ih[l] + g * in * H4;
      const T* wh = (const T*)p.w_hh[l] + g * H * H4;
      const T* bg = (const T*)p.b[l] + g * H4;
      float* ws = slot_w(s);
      // column q * H + jj of the weights goes to column jj * 4 + q
#pragma unroll 4
      for (int e = tid; e < in * H4; e += nthreads)
        ws[(size_t)(e / H4) * WS + (e % H) * 4 + (e % H4) / H] = load_f(wi, e);
#pragma unroll 4
      for (int e = tid; e < H * H4; e += nthreads)
        ws[(size_t)(in + e / H4) * WS + (e % H) * 4 + (e % H4) / H] = load_f(wh, e);
      for (int e = tid; e < H4; e += nthreads) b_s[s * H4 + (e % H) * 4 + e / H] = load_f(bg, e);
    }
    c = 0.f;
    __syncthreads();
    const int l = l0 + w;
    const bool active = w < nw && r < nr;   // uniform over each warp
    const int in = l == 0 ? I : H;
    const float* inb = l == 0 ? xbuf : bufs + (size_t)((l - 1) % nb) * buf_len;
    float* outb = bufs + (size_t)(l % nb) * buf_len;
    const float* wcol = slot_w(w) + j * 4 + q;
    const float bias = active ? b_s[w * H4 + j * 4 + q] : 0.f;
    for (int d = 0; d < Tn + nw - 1; ++d) {
      const int t = d - w;
      if (active && t >= 0 && t < Tn) {
        const float* xr = inb + ((size_t)t * rows + r) * in;
        float xs = 0.f;
        if (l == 0) {
          for (int k = ks; k < I; k += KSPLIT) xs = fmaf(xr[k], wcol[(size_t)k * WS], xs);
        } else {
#pragma unroll
          for (int k = ks; k < H; k += KSPLIT) xs = fmaf(xr[k], wcol[(size_t)k * WS], xs);
        }
        float hs = 0.f;
        if (t > 0) {
          const float* hr = outb + ((size_t)(t - 1) * rows + r) * H;
          const float* wh = wcol + (size_t)in * WS;
#pragma unroll
          for (int k = ks; k < H; k += KSPLIT) hs = fmaf(hr[k], wh[(size_t)k * WS], hs);
        }
        xs += __shfl_xor_sync(0xffffffffu, xs, 1);
        hs += __shfl_xor_sync(0xffffffffu, hs, 1);
        const float gate = xs + hs + bias;
        const float gi = __shfl_sync(0xffffffffu, gate, lane0);
        const float gf = __shfl_sync(0xffffffffu, gate, lane0 + KSPLIT);
        const float gg = __shfl_sync(0xffffffffu, gate, lane0 + 2 * KSPLIT);
        const float go = __shfl_sync(0xffffffffu, gate, lane0 + 3 * KSPLIT);
        if (q == 0 && ks == 0) {
          const float si = sigmoid_f(gi), sf = sigmoid_f(gf), tg = tanhf(gg);
          const float so = sigmoid_f(go);
          const float c2 = sf * c + si * tg;
          c = round_as(c2, x);
          const float h2 = so * tanhf(c2);
          outb[((size_t)t * rows + r) * H + j] = round_as(h2, x);
          if (SAVE) {
            const size_t row = (((size_t)l * gridDim.x + g) * B + r0 + r) * Tn + t;
            float* gs = sv.gates + row * H4;
            gs[j] = si;
            gs[H + j] = sf;
            gs[2 * H + j] = tg;
            gs[3 * H + j] = so;
            sv.c[row * H + j] = c2;
            sv.h[row * H + j] = h2;
          }
        }
      }
      __syncthreads();
    }
  }
  const int top = (n_layers - 1) % nb;
  for (int e = tid; e < nr * H; e += nthreads) {
    const int rr = e / H, jj = e % H;
    store_f(h_out, (g * B + r0 + rr) * (int64_t)H + jj,
            bufs[(size_t)top * buf_len + ((size_t)(Tn - 1) * rows + rr) * H + jj]);
  }
}

template <typename T, bool SAVE>
int launch_stack(const void* x, const StackLayers& p, void* h_out, const TrainSave& sv,
                 int n_layers, int G, int B, int Tn, int I, int H, int rows, int wave,
                 cudaStream_t stream) {
  const size_t smem = stack_smem_floats(I, H, Tn, rows, n_layers, wave) * sizeof(float);
  if (smem > SMEM_LIMIT) return -1;
  auto kern = H == 16   ? lstm_stack_kernel<T, 16, SAVE>
              : H == 32 ? lstm_stack_kernel<T, 32, SAVE>
              : H == 64 ? lstm_stack_kernel<T, 64, SAVE>
                        : lstm_stack_kernel<T, 0, SAVE>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)G, (unsigned)((B + rows - 1) / rows));
  kern<<<grid, wave * rows * H * LANES, smem, stream>>>((const T*)x, p, (T*)h_out, sv,
                                                        n_layers, B, Tn, I, H, rows, wave);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------------
// lstm_stack_bwd: the stack's backward (BPTT), the reverse wavefront
// ------------------------------------------------------------------------

constexpr int BWD_WPAD = 4;   // weight row padding (floats): 8 rows x 4 parts hit 32 banks

// dx sequence buffers: one per layer that receives one when all layers run
// at once, two used in turn when the layers run one at a time
__host__ __device__ inline int bwd_dx_buffers(int L, int wave) {
  return wave >= L ? (L > 1 ? L - 1 : 1) : 2;
}

// floats of shared memory one backward block uses; mirrored by the
// wrapper's lstm_stack_bwd_smem_bytes
__host__ __device__ inline size_t bwd_smem_floats(int H, int T, int rows, int L, int wave) {
  const size_t H4 = 4 * (size_t)H, WS = H4 + BWD_WPAD;
  return (size_t)wave * 2 * H * WS + (size_t)wave * rows * (H4 + H) +
         (size_t)bwd_dx_buffers(L, wave) * T * rows * H;
}

template <int HT>
__global__ void lstm_stack_bwd_kernel(const float* __restrict__ dh_top,
                                      const float* __restrict__ gates,
                                      const float* __restrict__ cs, StackLayers p,
                                      float* __restrict__ dgates, int n_layers, int B, int Tn,
                                      int h_arg, int rows, int wave) {
  extern __shared__ float sm[];
  const int H = HT > 0 ? HT : h_arg;
  const int H4 = 4 * H;
  const int WS = H4 + BWD_WPAD;
  const int nbx = bwd_dx_buffers(n_layers, wave);
  float* w_s = sm;                                   // [wave][2H][WS]: W_hh rows, W_ih rows
  float* dg_s = w_s + (size_t)wave * 2 * H * WS;     // [wave][rows][4H]
  float* dhh_s = dg_s + (size_t)wave * rows * H4;    // [wave][rows][H]
  float* dx_s = dhh_s + (size_t)wave * rows * H;     // [nbx][T][rows][H]
  const size_t dx_len = (size_t)Tn * rows * H;

  const int64_t g = blockIdx.x, G = gridDim.x;
  const int r0 = blockIdx.y * rows;
  const int nr = min(rows, B - r0);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  // thread (slot s, row r, u): phase A takes unit j = u < H, phase B
  // output o = u / 4 (dh_{t-1} for o < H, dx_t for o >= H), part pp = u % 4
  const int per_row = H * LANES;
  const int s = tid / (rows * per_row);
  const int r = (tid / per_row) % rows;
  const int u = tid % per_row;
  const int o = u / 4, pp = u % 4;

  for (int lt = n_layers - 1; lt >= 0; lt -= wave) {
    const int nw = min(wave, lt + 1);   // slot w runs layer lt - w
    __syncthreads();                    // the previous wave's weights are read
    for (int w = 0; w < nw; ++w) {
      const int l = lt - w;
      float* ws = w_s + (size_t)w * 2 * H * WS;
      const float* wh = (const float*)p.w_hh[l] + g * H * H4;
      for (int e = tid; e < H * H4; e += nthreads) ws[(size_t)(e / H4) * WS + e % H4] = wh[e];
      if (l > 0) {
        const float* wi = (const float*)p.w_ih[l] + g * H * H4;
        for (int e = tid; e < H * H4; e += nthreads)
          ws[(size_t)(H + e / H4) * WS + e % H4] = wi[e];
      }
    }
    __syncthreads();
    const bool active = s < nw && r < nr;   // uniform over each warp
    const int l = active ? lt - s : 0;
    const int64_t brow = g * B + r0 + r;
    const int64_t lrow = ((int64_t)l * G * B + brow) * Tn;   // (l, g, b, t = 0)
    const float* gl = gates + lrow * H4;
    const float* cl = cs + lrow * H;
    float* dgl = dgates + lrow * H4;
    const float* dx_in = dx_s + (size_t)(l % nbx) * dx_len;            // from layer l + 1
    float* dx_out = dx_s + (size_t)((l + nbx - 1) % nbx) * dx_len;     // to layer l - 1
    const float* wrow = w_s + ((size_t)s * 2 * H + o) * WS;
    float* dgs = dg_s + (size_t)(s * rows + r) * H4;
    float* dhh = dhh_s + (size_t)(s * rows + r) * H;
    const bool unit = u < H;

    // phase A's inputs for the step this thread runs next, loaded a
    // diagonal ahead so their latency hides behind phase B and the barriers
    float ig = 0.f, fg = 0.f, gg = 0.f, og = 0.f, ct = 0.f, cp = 0.f;
    auto fetch = [&](int t) {
      if (t < 0) return;
      const float* gt = gl + (size_t)t * H4;
      ig = gt[u];
      fg = gt[H + u];
      gg = gt[2 * H + u];
      og = gt[3 * H + u];
      ct = cl[(size_t)t * H + u];
      cp = t > 0 ? cl[(size_t)(t - 1) * H + u] : 0.f;
    };
    if (active && unit) fetch(Tn - 1);
    float dc = 0.f;
    for (int d = 0; d < Tn + nw - 1; ++d) {
      const int t = Tn - 1 - d + s;
      const bool run = active && t >= 0 && t < Tn;
      if (run && unit) {
        // dh_t: from this layer's step t + 1, from the layer above's dx_t,
        // or (top layer, last step) the upstream gradient
        float dh = t < Tn - 1 ? dhh[u] : 0.f;
        if (l < n_layers - 1)
          dh += dx_in[((size_t)t * rows + r) * H + u];
        else if (t == Tn - 1)
          dh += dh_top[brow * H + u];
        const float tc = tanhf(ct);
        dc += dh * og * (1.f - tc * tc);
        const float d_i = dc * gg * ig * (1.f - ig);
        const float d_f = dc * cp * fg * (1.f - fg);
        const float d_g = dc * ig * (1.f - gg * gg);
        const float d_o = dh * tc * og * (1.f - og);
        dc *= fg;
        dgs[u] = d_i;
        dgs[H + u] = d_f;
        dgs[2 * H + u] = d_g;
        dgs[3 * H + u] = d_o;
        float* dgt = dgl + (size_t)t * H4;
        dgt[u] = d_i;
        dgt[H + u] = d_f;
        dgt[2 * H + u] = d_g;
        dgt[3 * H + u] = d_o;
        fetch(t - 1);
      }
      __syncthreads();
      if (run) {
        // dh_{t-1} = dgates . W_hh^T and dx_t = dgates . W_ih^T, a row of
        // the weight each, summed by four lanes
        float acc = 0.f;
#pragma unroll
        for (int n = pp; n < (HT > 0 ? 4 * HT : H4); n += 4) acc = fmaf(dgs[n], wrow[n], acc);
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        if (pp == 0) {
          if (o < H) {
            if (t > 0) dhh[o] = acc;
          } else if (l > 0) {
            dx_out[((size_t)t * rows + r) * H + (o - H)] = acc;
          }
        }
      }
      __syncthreads();
    }
  }
}

int launch_stack_bwd(const float* dh_top, const float* gates, const float* cs,
                     const StackLayers& p, float* dgates, int n_layers, int G, int B, int Tn,
                     int H, int rows, int wave, cudaStream_t stream) {
  const size_t smem = bwd_smem_floats(H, Tn, rows, n_layers, wave) * sizeof(float);
  if (smem > SMEM_LIMIT) return -1;
  auto kern = H == 16   ? lstm_stack_bwd_kernel<16>
              : H == 32 ? lstm_stack_bwd_kernel<32>
              : H == 64 ? lstm_stack_bwd_kernel<64>
                        : lstm_stack_bwd_kernel<0>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)G, (unsigned)((B + rows - 1) / rows));
  kern<<<grid, wave * rows * H * LANES, smem, stream>>>(dh_top, gates, cs, p, dgates, n_layers,
                                                        B, Tn, H, rows, wave);
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

// The whole stack: xs (G,B,T,I) and n_layers layers of weights (host arrays
// of device pointers, w_ih[l] (G,I_l,4H), w_hh[l] (G,H,4H), b[l] (G,4H))
// -> h_out (G,B,H), the top layer's last h.  `rows` batch rows per block
// and `wave` layers resident at once (the wrapper picks both under the
// thread and shared-memory limits).  Returns the CUDA error of the launch
// (0 on success); -1 for a shape it does not take (empty, more than 8
// layers, more than 1024 threads a block, more shared memory than a block
// may have), -2 for an unknown dtype.
extern "C" int lstm_stack_fwd(const void* x, const void* const* w_ih,
                              const void* const* w_hh, const void* const* b,
                              int n_layers, void* h_out, int G, int B, int T, int I,
                              int H, int rows, int wave, int dtype, int device, void* stream) {
  if (G <= 0 || B <= 0 || T <= 0 || I <= 0 || H <= 0 || rows <= 0 || n_layers <= 0 ||
      n_layers > MAX_LAYERS || wave <= 0 || wave > n_layers || H % 4 != 0 ||
      (B + rows - 1) / rows > 65535 || (int64_t)wave * rows * H * LANES > MAX_THREADS)
    return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  StackLayers p{};
  for (int l = 0; l < n_layers; ++l) {
    p.w_ih[l] = w_ih[l];
    p.w_hh[l] = w_hh[l];
    p.b[l] = b[l];
  }
  cudaStream_t s = (cudaStream_t)stream;
  const TrainSave none{};
  if (dtype == 0)
    return launch_stack<float, false>(x, p, h_out, none, n_layers, G, B, T, I, H, rows, wave, s);
  if (dtype == 1)
    return launch_stack<__nv_bfloat16, false>(x, p, h_out, none, n_layers, G, B, T, I, H, rows,
                                              wave, s);
  return -2;
}

// The training forward (float32): what lstm_stack_fwd computes, and every
// layer's gates (L,G,B,T,4H; after the nonlinearities), c and h
// (L,G,B,T,H) for the backward.  Returns as lstm_stack_fwd does.
extern "C" int lstm_stack_fwd_train(const void* x, const void* const* w_ih,
                                    const void* const* w_hh, const void* const* b,
                                    int n_layers, void* h_out, void* gates, void* c, void* h,
                                    int G, int B, int T, int I, int H, int rows, int wave,
                                    int device, void* stream) {
  if (G <= 0 || B <= 0 || T <= 0 || I <= 0 || H <= 0 || rows <= 0 || n_layers <= 0 ||
      n_layers > MAX_LAYERS || wave <= 0 || wave > n_layers || H % 4 != 0 ||
      (B + rows - 1) / rows > 65535 || (int64_t)wave * rows * H * LANES > MAX_THREADS)
    return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  StackLayers p{};
  for (int l = 0; l < n_layers; ++l) {
    p.w_ih[l] = w_ih[l];
    p.w_hh[l] = w_hh[l];
    p.b[l] = b[l];
  }
  const TrainSave sv{(float*)gates, (float*)c, (float*)h};
  return launch_stack<float, true>(x, p, h_out, sv, n_layers, G, B, T, I, H, rows, wave,
                                   (cudaStream_t)stream);
}

// The stack's backward (float32): dh_top (G,B,H), the upstream gradient of
// the top layer's last h, and the training forward's gates and c ->
// dgates (L,G,B,T,4H), the gradient of every layer's pre-activation gates
// (i, f, g, o).  w_ih[l] is read for l >= 1 only (layer 0's dx is not
// computed).  `wave` is n_layers or 1.  Returns as lstm_stack_fwd does.
extern "C" int lstm_stack_bwd(const void* dh_top, const void* gates, const void* c,
                              const void* const* w_ih, const void* const* w_hh, int n_layers,
                              void* dgates, int G, int B, int T, int H, int rows, int wave,
                              int device, void* stream) {
  if (G <= 0 || B <= 0 || T <= 0 || H <= 0 || rows <= 0 || n_layers <= 0 ||
      n_layers > MAX_LAYERS || (wave != n_layers && wave != 1) || H % 4 != 0 ||
      (B + rows - 1) / rows > 65535 || (int64_t)wave * rows * H * LANES > MAX_THREADS)
    return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  StackLayers p{};
  for (int l = 0; l < n_layers; ++l) {
    p.w_ih[l] = l > 0 ? w_ih[l] : nullptr;
    p.w_hh[l] = w_hh[l];
  }
  return launch_stack_bwd((const float*)dh_top, (const float*)gates, (const float*)c, p,
                          (float*)dgates, n_layers, G, B, T, H, rows, wave,
                          (cudaStream_t)stream);
}
