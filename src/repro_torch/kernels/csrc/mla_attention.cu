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
// (65.9 us) and needs 46.3 GFLOP (46.9 us): nearly balanced.  In float32
// the same products take 111.1 and 280.9 us at the 3xTF32 rate (165
// TFLOP/s), which bounds both.  Every byte of q, o, do and dq is a row
// tile's, so the design reads each row tile once a launch where shared
// memory holds it and keeps the products on the tensor cores.
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
// float32: 3xTF32 on tf32 wgmma fed by TMA (mla_attention_tf32.cuh: the
//   units, the ring, the warpgroups' roles).  Every float32 operand x is
//   split into hi = trunc(x) and lo = x - hi, a product is lo.hi + hi.lo +
//   hi.hi accumulated in float32 (lo.lo dropped).  tf32 wgmma reads shared
//   memory K-major only, so every operand there is a 64 x 64 unit (hi and
//   lo, 32 KiB): K and V rows loaded raw by TMA and split in place by the
//   consumer warpgroup that reads them; V^T and K^T, which every row tile
//   reads alike, built once a call (mla_tunits_tf32_kernel, a launch of 4
//   us) and copied whole; Q and dO, the A operands of S and dP, read raw
//   into registers by ldmatrix, their lo formed there.  A Q tile with its
//   lo is 288 KB, over the 227 KB a block may take, so Q streams chunk by
//   chunk (64 columns) with K's in every 64-key tile.  One thread loads a
//   ring of units that two consumer warpgroups walk, a slot given back as
//   soon as its products are done (the ring is what the loads wait for).
//   - Forward, mla_fwd_tf32_kernel: a block per 64-row tile.  Warpgroup w
//     computes the partial S over Dk's chunks c = w (mod 2), the partials
//     pass through shared memory and both add them (S computed once),
//     take the online softmax, and O[:, 256 w ...] += P.V with P split in
//     registers; 128 accumulators a thread under setmaxnreg (232 a
//     consumer thread, 40 the loading warpgroup's).
//   - Backward, the units launch and three more: rows
//     (mla_bwd_rows_tf32_kernel: a block per row tile; warpgroup 0 S and
//     P, warpgroup 1 dP, each once a key tile; P to the scratch and,
//     through shared memory, to warpgroup 1, dP to the dS scratch; then
//     the port's D and dS over dP; then dQ = dS.K a chunk of Dk at a time,
//     dS read back into registers), keys (mla_bwd_keys_tf32_kernel: a
//     block per 128 keys, slab of four chunks of dK or dV and chunk of 32
//     row tiles; a producer warpgroup transposes the slab's Q^T (dO^T)
//     units, which both consumer warpgroups read, each for its 64 keys with
//     dS^T (P^T) read from the key-major scratch into registers; each dS
//     tile read three times, each P tile twice) and finish.
//   Shared memory (mirrored by mla_smem_bytes / mla_bwd_smem_bytes):
//   forward 230,400 bytes (six units, the two S partials of 16 KB, 1 KiB
//   of alignment), rows 214,016 (six units and P's 16 KB hand-over), keys
//   230,400 (seven units); one block a SM.

// The backward's scratch (P and dS, B x rows x keys padded to 64-row and
// 64-key tiles, of q's type: bf16 row-major, float32 key-major), its
// partials (chunks x B x Sk x (Dk + Dv) float32) and the float32 route's
// made units are allocated by the wrapper (kernels/mla_attention_cuda.py)
// and checked here against their sizes.  Card times: PERF.md rows 4m and
// 4mb (tools/bwd_kernel_timing.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mla_attention_tf32.cuh"
#include "mla_attention_wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 64;          // query rows a tile
constexpr int BN = 64;          // keys a tile of the scratch
constexpr int ROW_CHUNK = 32;   // row tiles of a keys block's chunk

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

// the backward's last launch, both routes: dk and dv from the partials
template <typename T>
int finish(const float* part, void* dk, void* dv, int64_t B, int64_t Sq, int64_t Sk,
           int64_t H, int Dk, int Dv, cudaStream_t st) {
  const int64_t chunks = cdiv(cdiv(Sq * H, BM), ROW_CHUNK);
  const int64_t n = B * Sk * (Dk + Dv);
  const int blocks = (int)mlawg::lmin(cdiv(n, 256), 4096);
  mla_bwd_finish_kernel<T><<<blocks, 256, 0, st>>>(part, (T*)dk, (T*)dv, n, (int)chunks, Dk, Dv);
  return (int)cudaGetLastError();
}

bool shape_ok(int64_t B, int64_t Sq, int64_t Sk, int64_t H, int64_t Dk, int64_t Dv) {
  return B > 0 && Sq > 0 && Sk > 0 && H > 0 && B <= 65535 && Dk > 0 && Dv > 0 &&
         Dk <= 576 && Dv <= 512 && Dk % 8 == 0 && Dv % 8 == 0 && Sk <= ((int64_t)1 << 30) &&
         Sq * H <= ((int64_t)1 << 30);
}

static_assert(BM == mlawg::BM && BN == mlawg::KEY_TILE && ROW_CHUNK == mlawg::ROW_CHUNK &&
                  BM == mlatf::BM && BN == mlatf::KT && ROW_CHUNK == mlatf::ROW_CHUNK,
              "both routes use one scratch size and one partials layout");

}  // namespace

// Dynamic shared memory (bytes) of a launch at value width Dv, as
// kernels/mla_attention_cuda.py mirrors it: `launch` 0 the forward, 1 the
// backward's rows launch, 2 its keys launch (both plans hold the widest
// key head at every Dk, and the float32 plan the widest value head too).
extern "C" int64_t mla_attention_smem_bytes(int64_t Dv, int dtype, int launch) {
  const int nvb = mlawg::boxes(Dv);
  if (dtype == 1)
    return launch == 0 ? (int64_t)mlawg::fwd_smem(nvb)
         : launch == 1 ? (int64_t)mlawg::rows_smem()
                       : (int64_t)mlawg::keys_smem();
  return launch == 0 ? (int64_t)mlatf::fwd_smem()
       : launch == 1 ? (int64_t)mlatf::rows_smem()
                     : (int64_t)mlatf::keys_smem();
}

// The sizes the backward's buffers must have, in elements: the scratch of P
// (and of dS), B x rows_pad x keys_pad of q's type (bf16 row-major, float32
// key-major), and the partials, chunks x B x Sk x (Dk + Dv) float32.
extern "C" void mla_attention_bwd_sizes(int64_t B, int64_t Sq, int64_t Sk, int64_t H,
                                        int64_t Dk, int64_t Dv, int64_t* out) {
  const int64_t n_rt = cdiv(Sq * H, BM);
  out[0] = B * n_rt * BM * cdiv(Sk, BN) * BN;
  out[1] = cdiv(n_rt, ROW_CHUNK) * B * Sk * (Dk + Dv);
}

// Floats of the float32 route's transposed units of a (B, Sk, D) tensor:
// the forward's `units` hold V's (D = Dv), the backward's K's (D = Dk).
extern "C" int64_t mla_attention_units_floats(int64_t B, int64_t Sk, int64_t D) {
  return mlatf::tunits_floats(B, Sk, D);
}

// Returns the CUDA error of the launch (0 on success); -1 for a shape the
// kernels do not take (Dk > 576, Dv > 512, either not a multiple of 8, an
// empty or oversized tensor), -2 for a dtype code other than 0 (float32) or
// 1 (bfloat16), -3 when a tensor map cannot be encoded (bases 16-byte
// aligned).  Every tensor is contiguous: q (B,Sq,H,Dk), k (B,Sk,Dk),
// v (B,Sk,Dv), o (B,Sq,H,Dv); `lse` null or float32 (B,H,Sq).  float32:
// `units` is scratch of `units_elems` floats, mla_attention_units_floats
// (B, Sk, Dv) (-3 if it differs); bfloat16 ignores it.
extern "C" int mla_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                 void* lse, void* units, int64_t units_elems, int64_t B,
                                 int64_t Sq, int64_t Sk, int64_t H, int64_t Dk, int64_t Dv,
                                 float scale, int causal, int dtype, int device, void* stream) {
  if (!shape_ok(B, Sq, Sk, H, Dk, Dv)) return -1;
  if (dtype == 0 && units_elems != mlatf::tunits_floats(B, Sk, Dv)) return -3;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return mlatf::fwd(q, k, v, o, (float*)lse, (float*)units, B, Sq, Sk, H, (int)Dk, (int)Dv,
                      scale, causal, st);
  if (dtype == 1)
    return mlawg::fwd(q, k, v, o, (float*)lse, B, Sq, Sk, H, (int)Dk, (int)Dv, scale, causal,
                      st);
  return -2;
}

// The backward: dq (B,Sq,H,Dk), dk (B,Sk,Dk), dv (B,Sk,Dv) of q's type from
// (q, k, v, lse, do), contiguous.  `P` and `dS` are scratch of
// `scratch_elems` elements of q's type each and `part` one of `part_elems`
// float32, the sizes mla_attention_bwd_sizes gives, and (float32) `units`
// one of `units_elems` floats, mla_attention_units_floats(B, Sk, Dk) (-3
// if any differs).
extern "C" int mla_attention_bwd(const void* q, const void* k, const void* v, const void* lse,
                                 const void* dout, void* P, void* dS, void* part, void* units,
                                 void* dq, void* dk, void* dv, int64_t scratch_elems,
                                 int64_t part_elems, int64_t units_elems, int64_t B, int64_t Sq,
                                 int64_t Sk, int64_t H, int64_t Dk, int64_t Dv, float scale,
                                 int causal, int dtype, int device, void* stream) {
  if (!shape_ok(B, Sq, Sk, H, Dk, Dv) || B * cdiv(cdiv(Sq * H, BM), ROW_CHUNK) > 65535)
    return -1;
  int64_t sizes[2];
  mla_attention_bwd_sizes(B, Sq, Sk, H, Dk, Dv, sizes);
  if (sizes[0] != scratch_elems || sizes[1] != part_elems) return -3;
  if (dtype == 0 && units_elems != mlatf::tunits_floats(B, Sk, Dk)) return -3;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype != 0 && dtype != 1) return -2;
  const int rc = dtype == 0 ? mlatf::bwd(q, k, v, (const float*)lse, dout, P, dS, (float*)part,
                                         (float*)units, dq, B, Sq, Sk, H, (int)Dk, (int)Dv,
                                         scale, causal, st)
                            : mlawg::bwd(q, k, v, (const float*)lse, dout, P, dS, (float*)part,
                                         dq, B, Sq, Sk, H, (int)Dk, (int)Dv, scale, causal, st);
  if (rc != 0) return rc;
  const float* pt = (const float*)part;
  return dtype == 0 ? finish<float>(pt, dk, dv, B, Sq, Sk, H, (int)Dk, (int)Dv, st)
                    : finish<bf16>(pt, dk, dv, B, Sq, Sk, H, (int)Dk, (int)Dv, st);
}
