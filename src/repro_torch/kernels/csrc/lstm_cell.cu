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
// its gradient is a kernel of its own.  lstm_stack_fwd_train computes what
// lstm_stack_fwd computes (float32) and writes, for every layer, step and
// batch row, the four gates after their nonlinearities, c_t and h_t to
// global memory, laid out (L, G, B, T, .).  lstm_stack_bwd runs BPTT as a
// reverse wavefront, the mirror of the forward's: at reverse diagonal d,
// slot s of the wave runs layer lt - s at step t = T - 1 - d + s, so it
// finds dh_t's two parts ready, its own step t + 1's dgates . W_hh^T and
// the layer above's dx_t, both written one diagonal earlier.  The weight
// gradients have no recurrence: the kernel writes dgates (L,G,B,T,4H) and
// the wrapper forms dW_ih = sum_t x_t^T dgates_t, dW_hh = sum_t
// h_{t-1}^T dgates_t and db = sum dgates with one torch.bmm (or sum) per
// weight.
//
// What bounds them: at RevPred's training batch (G = 1, B = 256, T = 59,
// I = 6, H = 32, 3 layers) the forward writes ~35 MB of saved gates, c and
// h (~10.5 us at 3.35 TB/s) and does ~0.66 GFLOP (~9.9 us at 67 TFLOP/s
// FFMA); the backward reads the saved gates and c (~29 MB) and writes
// dgates (~23 MB), ~16 us, and does ~0.64 GFLOP.  Neither is reached: both
// are chains of T + L - 1 = 61 dependent diagonals.  Within a diagonal an
// SM's FMAs are few (3 layers x rows x 128 columns x 64 terms), and what
// limits it is shared memory feeding them: an SM delivers 128 bytes a
// cycle from shared memory to registers, so a design where each loaded
// operand feeds one FMA (a thread a gate column) spends four times the
// FMAs' issue time on loads.  The design:
//
// * One wave over the SMs.  A block owns R = 1, 2 or 4 batch rows (a
//   template argument) and all of them share its threads; the wrapper
//   picks the fewest rows with G * ceil(B / R) blocks at most the card's SM
//   count (B = 256: 2 rows, 128 blocks), so the chain is paid once, not
//   once per wave of blocks.
// * Register tiles.  Forward: the four threads (k-lanes) of a unit j
//   split x and h in four segments; each holds, in registers and for its
//   segments, the unit's four gate columns of W_ih and W_hh (2C floats, C =
//   16, 32 or 64 the smallest that holds max(I, H); loaded once per
//   launch) and sums them for every row, so each float4 of x or h read
//   from shared memory feeds 16 FMAs a row and each weight R FMAs.
//   Backward: eight k-lanes split the 4H dgates of a row; each holds, for
//   its segment, four rows of W_hh (outputs dh_{t-1}, o < H) or, above
//   layer 0, of W_ih (dx_t) and sums dgates . W^T for every row.  Segments
//   are padded by 4 floats so that the lanes' float4 reads of one row fall
//   on different banks.
// * The lanes' partial sums meet by shuffles that halve what each lane
//   holds (xor 2, xor 1; the backward also xor 4), so a lane ends with
//   whole sums: in the forward the four gates of one (row, unit), and each
//   thread applies the nonlinearities and updates that cell itself (R = 4:
//   every thread its own; R = 2: two lanes alike, one writes), keeps c in
//   a register and writes h to a two-step ring per layer in shared memory
//   and the saved gates, c and h to global memory (32-byte sectors, the 8
//   units of a warp's row).  One barrier a diagonal: the gates never pass
//   through shared memory.  The backward keeps two: the (row, unit) threads
//   form dc and the four dgates (phase A) for every thread's product
//   (phase B).  Each (row, unit) thread brings its next steps' saved gates
//   and c_{t-1} into shared memory with cp.async, two diagonals ahead, so
//   no load of the saved state waits on the chain.
//
// Tensor cores do not pay here: a step's product at R <= 4 is a
// (R x 64) . (64 x 128) tile, which fills at most 4 of an m16 MMA's 16
// rows.

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
// HT = 0 takes it from the argument.
template <typename T, int HT>
__global__ void lstm_stack_kernel(const T* __restrict__ x, StackLayers p,
                                  T* __restrict__ h_out, int n_layers, int B,
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

template <typename T>
int launch_stack(const void* x, const StackLayers& p, void* h_out, int n_layers, int G, int B,
                 int Tn, int I, int H, int rows, int wave, cudaStream_t stream) {
  const size_t smem = stack_smem_floats(I, H, Tn, rows, n_layers, wave) * sizeof(float);
  if (smem > SMEM_LIMIT) return -1;
  auto kern = H == 16   ? lstm_stack_kernel<T, 16>
              : H == 32 ? lstm_stack_kernel<T, 32>
              : H == 64 ? lstm_stack_kernel<T, 64>
                        : lstm_stack_kernel<T, 0>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)G, (unsigned)((B + rows - 1) / rows));
  kern<<<grid, wave * rows * H * LANES, smem, stream>>>((const T*)x, p, (T*)h_out, n_layers,
                                                        B, Tn, I, H, rows, wave);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------------
// Training: lstm_stack_fwd_train and lstm_stack_bwd (design in the header)
// ------------------------------------------------------------------------

// What the training forward keeps for the backward, float32, laid out
// (L, G, B, T, .) so that one layer's slice is (G, B*T, .) for torch.bmm
struct TrainSave {
  float* gates;   // (L, G, B, T, 4H): sigmoid(i), sigmoid(f), tanh(g), sigmoid(o)
  float* c;       // (L, G, B, T, H): c_t
  float* h;       // (L, G, B, T, H): h_t
};

constexpr unsigned FULL = 0xffffffffu;
constexpr int BWD_DEPTH = 3;   // the backward's cp.async ring: steps in shared memory
constexpr int BWD_PREF = 5;    // floats it fetches per (row, unit) and step: 4 gates, c_{t-1}

// C, the capacity of a thread's registers for weights (2C floats), is the
// smallest of 16, 32, 64 that holds the widths; the threads a block may
// have at C keep its registers within the SM's 64 Ki
__host__ __device__ constexpr int train_max_threads(int C) {
  return C == 16 ? 512 : C == 32 ? 384 : 256;
}
__host__ __device__ inline int train_cap(int n) {
  return n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : 0;
}
__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }
// 4H threads a layer of the wave, in whole warps
__host__ __device__ inline int train_threads(int H, int wave) { return round_up(wave * 4 * H, 32); }

// A row of a vector split over k-lanes: lane q's segment of SL floats (a
// multiple of 4, for float4 loads; zeros past the vector's end) starts at
// q (SL + 4), so that the lanes' float4 loads of one row fall on different
// banks.  The forward splits x and h over 4 lanes (SL = C / 4), the
// backward the 4H dgates over 8 (SL = C / 2).
__host__ __device__ constexpr int seg_row(int SL, int lanes) { return lanes * (SL + 4); }
__device__ __forceinline__ int seg_at(int k, int SL) { return k / SL * (SL + 4) + k % SL; }

// floats of shared memory of one training-forward block: the wave's input
// sequence (T, rows, a segmented row) and per layer slot a two-step ring
// of h (2, rows, a segmented row); mirrored by lstm_stack_train_smem_bytes
__host__ __device__ inline size_t train_smem_floats(int I, int H, int T, int rows, int L,
                                                    int wave) {
  const int C = train_cap(I > H ? I : H);
  return ((size_t)T + (size_t)wave * 2) * rows * seg_row(C / 4, 4);
}

// sigmoid and tanh from the SFU's exp2 and reciprocal, for the training
// kernels' chain: no subroutine, within ~1e-7 of the exact values
__device__ __forceinline__ float sigmoid_fast(float v) {
  return __fdividef(1.f, 1.f + __expf(-v));
}
__device__ __forceinline__ float tanh_fast(float v) {
  return 1.f - __fdividef(2.f, 1.f + __expf(2.f * v));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// acc[r][i] += v_r . w[i] over a lane's segment of N floats, for the
// block's R rows and 4 outputs i: each float4 read from shared memory feeds
// 16 FMAs, each weight register R.  No branch: rows past the batch's end
// and the segment's padding hold finite values, so every load of the
// segment can be in flight at once.
template <int R, int N>
__device__ __forceinline__ void dot_seg(float (&acc)[R][4], const float* v, int stride,
                                        const float (&w)[4][N]) {
#pragma unroll
  for (int k0 = 0; k0 < N; k0 += 4) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(v + r * stride + k0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[r][i] = fmaf(a.x, w[i][k0], acc[r][i]);
        acc[r][i] = fmaf(a.y, w[i][k0 + 1], acc[r][i]);
        acc[r][i] = fmaf(a.z, w[i][k0 + 2], acc[r][i]);
        acc[r][i] = fmaf(a.w, w[i][k0 + 3], acc[r][i]);
      }
    }
  }
}

__device__ __forceinline__ float pick(bool hi, float lo_v, float hi_v) { return hi ? hi_v : lo_v; }

// The forward's four k-lanes p of a unit hold partial sums of its 4 gates
// for R rows; sum them so that lane p ends with the 4 gates of row
// rows_of_lane(p) (R = 4: every lane its own row; R = 2: lanes 2r, 2r + 1
// row r; R = 1: every lane row 0), exchanging halves (xor 2, then xor 1).
template <int R>
__device__ __forceinline__ void reduce_gates(float (&v)[R][4], float (&out)[4], int p) {
  const bool b1 = p & 2, b0 = p & 1;
  if constexpr (R == 4) {
    float w[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[r][i] = pick(b1, v[r][i], v[2 + r][i]) +
                  __shfl_xor_sync(FULL, pick(b1, v[2 + r][i], v[r][i]), 2);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      out[i] = pick(b0, w[0][i], w[1][i]) + __shfl_xor_sync(FULL, pick(b0, w[1][i], w[0][i]), 1);
  } else if constexpr (R == 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = pick(b1, v[0][i], v[1][i]) +
                      __shfl_xor_sync(FULL, pick(b1, v[1][i], v[0][i]), 2);
      out[i] = a + __shfl_xor_sync(FULL, a, 1);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = v[0][i] + __shfl_xor_sync(FULL, v[0][i], 2);
      out[i] = a + __shfl_xor_sync(FULL, a, 1);
    }
  }
}
template <int R>
__device__ __forceinline__ int rows_of_lane(int p) { return R == 4 ? p : R == 2 ? p >> 1 : 0; }

template <int C, int R>
__global__ void __launch_bounds__(train_max_threads(C), 1)
    lstm_stack_fwd_train_kernel(const float* __restrict__ x, StackLayers p,
                                float* __restrict__ h_out, TrainSave sv, int n_layers, int B,
                                int Tn, int I, int H, int wave) {
  extern __shared__ __align__(16) float tsm[];
  constexpr int SL = C / 4, XS = seg_row(SL, 4);   // a k-lane's segment, a row
  const int H4 = 4 * H;
  float* xbuf = tsm;                                // [T][R][XS]: the wave's input
  float* ring = xbuf + (size_t)Tn * R * XS;         // [wave][2][R][XS]: h_t by step parity

  const int64_t g = blockIdx.x, G = gridDim.x;
  const int r0 = blockIdx.y * R;
  const int nr = min(R, B - r0);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  // thread (slot w, unit j, k-lane q): the unit's 4 gate columns over the
  // lane's segment of x and of h, for every row; then the cell of its row
  const int w = tid / H4, u = tid % H4;
  const int j = u >> 2, q = u & 3;
  const int rq = rows_of_lane<R>(q);
  // one of the 4 / R lanes that hold a cell writes it
  const bool writer = q % (4 / R) == 0 && rq < nr;
  auto row_of = [&](int l, int r, int t) {   // (l, g, b, t) in the saved state
    return (((size_t)l * G + g) * B + r0 + r) * Tn + t;
  };
  // slot s writes its h_t at diagonal t + s; the slot above reads it as
  // x_t and slot s as h_{t-1} one diagonal later, so two steps suffice
  auto ring_at = [&](int s, int t) { return ring + (size_t)(s * 2 + (t & 1)) * R * XS; };

  float c = 0.f;
  int top = 0;
  for (int l0 = 0; l0 < n_layers; l0 += wave) {
    const int nw = min(wave, n_layers - l0);
    const int in0 = l0 == 0 ? I : H;
    top = nw - 1;
    __syncthreads();   // the previous wave is done with xbuf and the ring
    // the wave's input, segmented (zeros in the padding and past the batch):
    // xs, or the layer below's h this block saved; h_{-1} = 0 in the ring
    for (int e = tid; e < Tn * R * XS; e += nthreads) {
      const int kk = e % XS, t = (e / XS) % Tn, rr = e / (XS * Tn);
      const int k = kk / (SL + 4) * SL + kk % (SL + 4);
      float v = 0.f;
      if (kk % (SL + 4) < SL && k < in0 && rr < nr)
        v = l0 == 0 ? x[((g * B + r0 + rr) * Tn + t) * (int64_t)I + k]
                    : sv.h[row_of(l0 - 1, rr, t) * H + k];
      xbuf[((size_t)t * R + rr) * XS + kk] = v;
    }
    for (int e = tid; e < 2 * wave * R * XS; e += nthreads) ring[e] = 0.f;
    const int l = l0 + w;
    const bool slot = w < nw;
    const int in = l == 0 ? I : H;
    // the unit's 4 gate columns over this lane's segments, zero past the width
    float wx[4][SL], wh[4][SL], bias[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bias[i] = 0.f;
#pragma unroll
      for (int k = 0; k < SL; ++k) wx[i][k] = wh[i][k] = 0.f;
    }
    float *gsave = nullptr, *csave = nullptr, *hsave = nullptr;
    if (slot) {
      const float* wi = (const float*)p.w_ih[l] + g * in * H4 + j;
      const float* whh = (const float*)p.w_hh[l] + g * H * H4 + j;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int k = 0; k < SL; ++k) {
          if (q * SL + k < in) wx[i][k] = wi[(size_t)(q * SL + k) * H4 + i * H];
          if (q * SL + k < H) wh[i][k] = whh[(size_t)(q * SL + k) * H4 + i * H];
        }
        bias[i] = ((const float*)p.b[l])[g * H4 + i * H + j];
      }
      const size_t row = row_of(l, rq < nr ? rq : 0, 0);
      gsave = sv.gates + row * H4 + j;
      csave = sv.c + row * H + j;
      hsave = sv.h + row * H + j;
    }
    const int hpos = rq * XS + seg_at(j, SL);   // this cell's h in a ring row
    c = 0.f;
    __syncthreads();   // xbuf staged

    for (int d = 0; d < Tn + nw - 1; ++d) {
      const int t = d - w;
      const bool run = slot && t >= 0 && t < Tn;
      // x.W_ih and h.W_hh of the lane's segments, summed apart
      float ax[R][4], ah[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) ax[r][i] = ah[r][i] = 0.f;
      if (run) {
        const float* xin = (w == 0 ? xbuf + (size_t)t * R * XS : ring_at(w - 1, t)) + q * (SL + 4);
        dot_seg<R, SL>(ax, xin, XS, wx);
        dot_seg<R, SL>(ah, ring_at(w, t - 1) + q * (SL + 4), XS, wh);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int i = 0; i < 4; ++i) ax[r][i] += ah[r][i];
      }
      float pre[4];
      reduce_gates<R>(ax, pre, q);   // every thread: the shuffles need whole warps
      if (run) {
        const float si = sigmoid_fast(pre[0] + bias[0]), sf = sigmoid_fast(pre[1] + bias[1]);
        const float tg = tanh_fast(pre[2] + bias[2]), so = sigmoid_fast(pre[3] + bias[3]);
        c = sf * c + si * tg;
        const float h2 = so * tanh_fast(c);
        if (writer) {
          ring_at(w, t)[hpos] = h2;
          float* gt = gsave + (size_t)t * H4;
          gt[0] = si;
          gt[H] = sf;
          gt[2 * H] = tg;
          gt[3 * H] = so;
          csave[(size_t)t * H] = c;
          hsave[(size_t)t * H] = h2;
        }
      }
      __syncthreads();   // h_t is in the ring
    }
  }
  const float* last = ring_at(top, Tn - 1);   // the top layer's last h
  for (int e = tid; e < nr * H; e += nthreads)
    h_out[(g * B + r0 + e / H) * (int64_t)H + e % H] = last[e / H * XS + seg_at(e % H, SL)];
}

// floats of shared memory of one backward block; mirrored by the wrapper's
// lstm_stack_bwd_smem_bytes: dgates (rows of 4H, segmented over 8 k-lanes),
// the recurrent dh, the dx handed down (a two-step ring per handing slot
// when the whole stack is one wave, else a (T, rows, H) sequence for each
// layer parity) and the cp.async ring of the saved state
__host__ __device__ inline size_t bwd_smem_floats(int H, int T, int rows, int L, int wave) {
  const size_t pairs = (size_t)wave * rows * H;
  const size_t dx = wave >= L ? (size_t)(wave - 1) * 2 * rows * H : (size_t)2 * T * rows * H;
  return (size_t)wave * rows * seg_row(train_cap(H) / 2, 8) + pairs + dx +
         (size_t)BWD_DEPTH * BWD_PREF * pairs;
}

// The backward's eight k-lanes p of an output group hold partial sums of
// its 4 outputs for R rows; sum them so that each lane ends with whole
// outputs: R = 4 two (row p >> 1, outputs 2 (p & 1) and 2 (p & 1) + 1),
// R = 2 one (row p >> 2, output p & 3), R = 1 one (output p >> 1, lanes
// 2i and 2i + 1 alike), exchanging halves (xor 4, xor 2, xor 1).
template <int R>
__device__ __forceinline__ void reduce_outs(float (&v)[R][4], float (&out)[2], int p) {
  const bool b2 = p & 4, b1 = p & 2, b0 = p & 1;
  if constexpr (R == 4) {
    float w[2][4], x4[4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[r][i] = pick(b2, v[r][i], v[2 + r][i]) +
                  __shfl_xor_sync(FULL, pick(b2, v[2 + r][i], v[r][i]), 4);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x4[i] = pick(b1, w[0][i], w[1][i]) + __shfl_xor_sync(FULL, pick(b1, w[1][i], w[0][i]), 2);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      out[i] = pick(b0, x4[i], x4[2 + i]) +
               __shfl_xor_sync(FULL, pick(b0, x4[2 + i], x4[i]), 1);
  } else if constexpr (R == 2) {
    float x4[4], y[2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x4[i] = pick(b2, v[0][i], v[1][i]) + __shfl_xor_sync(FULL, pick(b2, v[1][i], v[0][i]), 4);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      y[i] = pick(b1, x4[i], x4[2 + i]) + __shfl_xor_sync(FULL, pick(b1, x4[2 + i], x4[i]), 2);
    out[0] = pick(b0, y[0], y[1]) + __shfl_xor_sync(FULL, pick(b0, y[1], y[0]), 1);
    out[1] = 0.f;
  } else {
    float y[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      y[i] = pick(b2, v[0][i], v[0][2 + i]) +
             __shfl_xor_sync(FULL, pick(b2, v[0][2 + i], v[0][i]), 4);
    const float z = pick(b1, y[0], y[1]) + __shfl_xor_sync(FULL, pick(b1, y[1], y[0]), 2);
    out[0] = z + __shfl_xor_sync(FULL, z, 1);
    out[1] = 0.f;
  }
}

template <int C, int R>
__global__ void __launch_bounds__(train_max_threads(C), 1)
    lstm_stack_bwd_kernel(const float* __restrict__ dh_top, const float* __restrict__ gates,
                          const float* __restrict__ cs, StackLayers p,
                          float* __restrict__ dgates, int n_layers, int B, int Tn, int H,
                          int wave) {
  extern __shared__ __align__(16) float tsm[];
  constexpr int SB = C / 2, DS = seg_row(SB, 8);   // a k-lane's segment, a row
  const int H4 = 4 * H;
  const int npairs = wave * R * H;
  float* dg_s = tsm;                                // [wave][R][DS]
  float* dhh_s = dg_s + (size_t)wave * R * DS;      // [wave][R][H]
  float* dx_s = dhh_s + npairs;
  float* pre_s = dx_s + (wave >= n_layers ? (size_t)(wave - 1) * 2 * R * H
                                          : (size_t)2 * Tn * R * H);   // [DEPTH][5][npairs]

  const int64_t g = blockIdx.x, G = gridDim.x;
  const int r0 = blockIdx.y * R;
  const int nr = min(R, B - r0);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  // thread (slot s, u): phase A the (row pr, unit pj) pair where row pr
  // exists; phase B k-lane kp of output group og: outputs 4 og .. 4 og + 3
  // of dh_{t-1} (o < H) and dx_t (o >= H) over the lane's segment of dgates
  const int s = tid / H4, u = tid % H4;
  const int pr = u / H, pj = u % H;
  const int og = u >> 3, kp = u & 7;
  const int pi = (s * R + pr) * H + pj;
  // the outputs this lane holds after reduce_outs: row, first output, count
  const int out_r = R == 4 ? kp >> 1 : R == 2 ? kp >> 2 : 0;
  const int out_o = 4 * og + (R == 4 ? 2 * (kp & 1) : R == 2 ? (kp & 3) : kp >> 1);
  const int n_out = R == 4 ? 2 : (R == 2 || !(kp & 1)) ? 1 : 0;
  auto row_of = [&](int l, int r, int t) {
    return (((size_t)l * G + g) * B + r0 + r) * Tn + t;
  };
  // dx for layer `recv` at step t, written by slot `from`
  auto dx_at = [&](int recv, int from, int t) {
    return wave >= n_layers ? dx_s + (size_t)(from * 2 + (t & 1)) * R * H
                            : dx_s + ((size_t)(recv & 1) * Tn + t) * R * H;
  };

  // zeros in the padding and in the rows past the batch's end, for good
  for (int e = tid; e < wave * R * DS; e += nthreads) dg_s[e] = 0.f;
  for (int lt = n_layers - 1; lt >= 0; lt -= wave) {
    const int nw = min(wave, lt + 1);   // slot s runs layer lt - s
    const bool slot = s < nw;
    const bool pair = slot && pr < nr;
    const int l = slot ? lt - s : 0;
    // rows 4 og .. 4 og + 3 of W_hh (o < H) or, above layer 0, of W_ih,
    // over this lane's segment of the 4H gate columns
    float wb[4][SB];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < SB; ++k) wb[i][k] = 0.f;
    if (slot && (4 * og < H || l > 0)) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int o = 4 * og + i;
        const float* src = o < H ? (const float*)p.w_hh[l] + (g * H + o) * H4
                                 : (const float*)p.w_ih[l] + (g * H + o - H) * H4;
#pragma unroll
        for (int k = 0; k < SB; ++k)
          if (kp * SB + k < H4) wb[i][k] = src[kp * SB + k];
      }
    }
    __syncthreads();   // the previous wave is done with the shared buffers

    // the pair's saved state: c_t in a register, each step's gates and
    // c_{t-1} in its own slots of the ring, two steps ahead
    const size_t row0 = row_of(l, pair ? pr : 0, 0);
    const float* gl = gates + row0 * H4 + pj;
    const float* cl = cs + row0 * H + pj;
    float* dgl = dgates + row0 * H4 + pj;
    float* dgr = dg_s + (size_t)(s * R + pr) * DS;
    auto fetch = [&](int t) {
      if (t >= 0) {
        float* dst = pre_s + (size_t)(t % BWD_DEPTH) * BWD_PREF * npairs + pi;
        const float* gt = gl + (size_t)t * H4;
#pragma unroll
        for (int k = 0; k < 4; ++k) cp_async4(dst + k * npairs, gt + k * H);
        if (t > 0) cp_async4(dst + 4 * npairs, cl + (size_t)(t - 1) * H);
      }
      cp_async_commit();
    };
    float dc = 0.f, ct = 0.f;
    if (pair) {
      ct = cl[(size_t)(Tn - 1) * H];
      fetch(Tn - 1);
      fetch(Tn - 2);
    }
    for (int d = 0; d < Tn + nw - 1; ++d) {
      const int t = Tn - 1 - d + s;
      const bool run = slot && t >= 0 && t < Tn;
      if (run && pr < nr) {
        cp_async_wait<1>();   // this thread's copies of step t have landed
        const float* pv = pre_s + (size_t)(t % BWD_DEPTH) * BWD_PREF * npairs + pi;
        const float ig = pv[0], fg = pv[npairs], gg = pv[2 * npairs], og_ = pv[3 * npairs];
        const float cp = t > 0 ? pv[4 * npairs] : 0.f;
        // dh_t: from this layer's step t + 1, from the layer above's dx_t,
        // or (top layer, last step) the upstream gradient
        float dh = t < Tn - 1 ? dhh_s[pi] : 0.f;
        if (l < n_layers - 1)
          dh += dx_at(l, s - 1, t)[pr * H + pj];
        else if (t == Tn - 1)
          dh += dh_top[(g * B + r0 + pr) * (int64_t)H + pj];
        const float tc = tanh_fast(ct);
        dc += dh * og_ * (1.f - tc * tc);
        const float dgv[4] = {dc * gg * ig * (1.f - ig), dc * cp * fg * (1.f - fg),
                              dc * ig * (1.f - gg * gg), dh * tc * og_ * (1.f - og_)};
        dc *= fg;
        ct = cp;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dgr[seg_at(i * H + pj, SB)] = dgv[i];
          dgl[(size_t)t * H4 + i * H] = dgv[i];
        }
        fetch(t - 2);
      }
      __syncthreads();   // the step's dgates are in dg_s
      // dh_{t-1} = dgates . W_hh^T and dx_t = dgates . W_ih^T
      float acc[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
      if (run) dot_seg<R, SB>(acc, dg_s + (size_t)s * R * DS + kp * (SB + 4), DS, wb);
      float sum[2];
      reduce_outs<R>(acc, sum, kp);   // every thread: the shuffles need whole warps
      if (run && out_r < nr) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int o = out_o + i;
          if (i < n_out) {
            if (o < H) {
              if (t > 0) dhh_s[(s * R + out_r) * H + o] = sum[i];
            } else if (l > 0) {
              dx_at(l - 1, s, t)[out_r * H + o - H] = sum[i];
            }
          }
        }
      }
      __syncthreads();   // dh_{t-1} and dx_t are in shared memory
    }
  }
}

template <int C, int R>
int launch_fwd_train(const float* x, const StackLayers& p, float* h_out, const TrainSave& sv,
                     int n_layers, int G, int B, int Tn, int I, int H, int wave, size_t smem,
                     cudaStream_t stream) {
  auto kern = lstm_stack_fwd_train_kernel<C, R>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)G, (unsigned)((B + R - 1) / R));
  kern<<<grid, train_threads(H, wave), smem, stream>>>(x, p, h_out, sv, n_layers, B, Tn, I, H,
                                                      wave);
  return (int)cudaGetLastError();
}

template <int C, int R>
int launch_bwd(const float* dh_top, const float* gates, const float* cs, const StackLayers& p,
               float* dgates, int n_layers, int G, int B, int Tn, int H, int wave, size_t smem,
               cudaStream_t stream) {
  auto kern = lstm_stack_bwd_kernel<C, R>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)G, (unsigned)((B + R - 1) / R));
  kern<<<grid, train_threads(H, wave), smem, stream>>>(dh_top, gates, cs, p, dgates, n_layers,
                                                      B, Tn, H, wave);
  return (int)cudaGetLastError();
}

// a training launch the kernels take: a capacity for the widths, 1, 2 or 4
// rows a block, the block's threads within what the capacity allows and
// its shared memory within a block's
bool train_shape_ok(int C, int B, int H, int rows, int wave, size_t smem_floats) {
  return C > 0 && H % 4 == 0 && (rows == 1 || rows == 2 || rows == 4) &&
         (B + rows - 1) / rows <= 65535 && train_threads(H, wave) <= train_max_threads(C) &&
         smem_floats * sizeof(float) <= SMEM_LIMIT;
}

using FwdLaunch = int (*)(const float*, const StackLayers&, float*, const TrainSave&, int, int,
                         int, int, int, int, int, size_t, cudaStream_t);
using BwdLaunch = int (*)(const float*, const float*, const float*, const StackLayers&, float*,
                          int, int, int, int, int, int, size_t, cudaStream_t);
template <int C>
FwdLaunch fwd_launcher(int R) {
  return R == 1 ? launch_fwd_train<C, 1> : R == 2 ? launch_fwd_train<C, 2> : launch_fwd_train<C, 4>;
}
template <int C>
BwdLaunch bwd_launcher(int R) {
  return R == 1 ? launch_bwd<C, 1> : R == 2 ? launch_bwd<C, 2> : launch_bwd<C, 4>;
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
  if (dtype == 0)
    return launch_stack<float>(x, p, h_out, n_layers, G, B, T, I, H, rows, wave, s);
  if (dtype == 1)
    return launch_stack<__nv_bfloat16>(x, p, h_out, n_layers, G, B, T, I, H, rows, wave, s);
  return -2;
}

// The training forward (float32): what lstm_stack_fwd computes, and every
// layer's gates (L,G,B,T,4H; after the nonlinearities), c and h
// (L,G,B,T,H) for the backward.  `rows` (1, 2 or 4) batch rows a block and
// `wave` layers at once, I and H up to 64 (the wrapper's
// lstm_stack_train_plan picks both).  Returns the CUDA error of the launch
// (0 on success); -1 for a shape it does not take.
extern "C" int lstm_stack_fwd_train(const void* x, const void* const* w_ih,
                                    const void* const* w_hh, const void* const* b,
                                    int n_layers, void* h_out, void* gates, void* c, void* h,
                                    int G, int B, int T, int I, int H, int rows, int wave,
                                    int device, void* stream) {
  const int C = train_cap(I > H ? I : H);
  if (G <= 0 || B <= 0 || T <= 0 || I <= 0 || H <= 0 || rows <= 0 || n_layers <= 0 ||
      n_layers > MAX_LAYERS || wave <= 0 || wave > n_layers ||
      !train_shape_ok(C, B, H, rows, wave, train_smem_floats(I, H, T, rows, n_layers, wave)))
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
  const size_t smem = train_smem_floats(I, H, T, rows, n_layers, wave) * sizeof(float);
  const FwdLaunch launch = C == 16 ? fwd_launcher<16>(rows) : C == 32 ? fwd_launcher<32>(rows)
                                                           : fwd_launcher<64>(rows);
  return launch((const float*)x, p, (float*)h_out, sv, n_layers, G, B, T, I, H, wave, smem,
                (cudaStream_t)stream);
}

// The stack's backward (float32): dh_top (G,B,H), the upstream gradient of
// the top layer's last h, and the training forward's gates and c ->
// dgates (L,G,B,T,4H), the gradient of every layer's pre-activation gates
// (i, f, g, o).  w_ih[l] is read for l >= 1 only (layer 0's dx is not
// computed).  `wave` is n_layers or 1, `rows` 1, 2 or 4, H up to 64 (the
// wrapper's lstm_stack_bwd_plan).  Returns as lstm_stack_fwd_train does.
extern "C" int lstm_stack_bwd(const void* dh_top, const void* gates, const void* c,
                              const void* const* w_ih, const void* const* w_hh, int n_layers,
                              void* dgates, int G, int B, int T, int H, int rows, int wave,
                              int device, void* stream) {
  const int C = train_cap(H);
  if (G <= 0 || B <= 0 || T <= 0 || H <= 0 || rows <= 0 || n_layers <= 0 ||
      n_layers > MAX_LAYERS || (wave != n_layers && wave != 1) ||
      !train_shape_ok(C, B, H, rows, wave, bwd_smem_floats(H, T, rows, n_layers, wave)))
    return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  StackLayers p{};
  for (int l = 0; l < n_layers; ++l) {
    p.w_ih[l] = l > 0 ? w_ih[l] : nullptr;
    p.w_hh[l] = w_hh[l];
  }
  const size_t smem = bwd_smem_floats(H, T, rows, n_layers, wave) * sizeof(float);
  const BwdLaunch launch = C == 16 ? bwd_launcher<16>(rows) : C == 32 ? bwd_launcher<32>(rows)
                                                           : bwd_launcher<64>(rows);
  return launch((const float*)dh_top, (const float*)gates, (const float*)c, p, (float*)dgates,
                n_layers, G, B, T, H, wave, smem, (cudaStream_t)stream);
}
