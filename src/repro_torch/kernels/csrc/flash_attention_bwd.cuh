// The flash-attention backward for Hopper (sm_90a), on the tensor cores.
//
// Replaces no Pallas kernel: the JAX package's backward is XLA code
// (src/repro/models/attention.py:_flash_bwd_rule under flash_attention_vjp),
// and the port ran its plain version (ref.flash_attention_bwd) on the card
// in every training step.  It computes what that plain version computes:
//
//   q (B,Sq,H,D), k (B,Sk,H,D), v (B,Sk,H,Dv), do (B,Sq,H,Dv) (GQA callers
//   expand K/V first), lse (B,H,Sq) float32 as the forward stores it  ->
//   dq, dk, dv in q's type,
//   p  = exp(scale q.k^T - lse), masked as the forward masks (causal with
//        the query offset q_off, ragged Sq and Sk), 0 where masked
//   dp = do.v^T,  Dr = rowsum(p * dp) / rowsum(p) over all keys (the port's
//        D, from the recomputed p; not sum(do * o), see ref.py)
//   ds = p * (dp - Dr) * scale,  dq = ds.k,  dk = ds^T.q,  dv = p^T.do
//
// for the built (D, Dv) pairs: (16, 16), (32, 32), (64, 64), (96, 96),
// (128, 128) and (192, 128) (MLA's materialized head).  Both routes take
// two launches on the same stream and are deterministic (no atomics; each
// output element is written by one thread of one block): a dq pass, one
// block per (64-row q tile, head, batch), that first walks the key tiles
// for Dr (stored for the second launch) and then walks them again for dq;
// and a dk/dv pass, one block per (64-key tile, head, batch), over the q
// tiles whose rows see the key tile.  The grids walk the tiles with the
// most work first.  At (192, 128) the dk/dv pass is two launches, a dV
// pass and a dK pass (Cfg::SPLIT_KV, each recomputing S^T): on the bf16
// route the two accumulators (96 + 64 floats a thread) do not fit one
// warpgroup's registers beside S^T, dP^T and the split fragments; on the
// float32 route K and V resident (five units, 160 KiB) leave room for two
// ring units and no P^T tile.  The instances of one width keep the code
// they had before the pair existed.
//
// What bounds it (flash_attention_cuda.flash_bwd_cost): the five products
// over the causal pairs.  At zamba2-1.2b's training shape (B=2, S=512,
// H=32, D=64, causal) they are 5.38 GFLOP: 5.4 us at bf16's tensor-core
// rate, 32.6 us at the 3xTF32 rate, against 8.8 us (bf16) of bytes; at
// pixtral-12b's (B=2, S=1280, H=32, D=128) 67.9 us of bf16 operations.
// Both routes recompute S and dP in the dq pass (Dr needs every key before
// any dS): S and dP in the D pass, S, dP and dQ in the dq pass, S^T, dP^T,
// dV and dK in the dk/dv pass, nine products' work where the function
// needs five.
//
// bfloat16 (namespace bf16): bf16 wgmma, operands fed by TMA.
//   S = Q.K^T and dP = dO.V^T are m64n64k16 products of bf16 tiles, exact
//   products accumulated in float32, as in the forward.  p and dS keep
//   float32-class accuracy: each is split in registers into bf16 hi =
//   bf16(x) and lo = bf16(x - hi) (16 bits of mantissa between them), the
//   A fragments of two products (lo, then hi) into one float32
//   accumulator, so dV = P^T.dO, dK = dS^T.Q and dQ = dS.K are two bf16
//   products each: twelve bf16 products a call.
//   tests/test_torch_bwd_kernels.py repeats this arithmetic on the CPU (one
//   bf16 term for p and dS does measurably worse).
//   Every operand is a 64-row bf16 tile that TMA loads as it lies, through
//   the forward's tensor maps (tma.cuh): the K-major operand of a product
//   over D, or, through wgmma's transpose bit, the MN-major B operand of a
//   product over the tile's rows (K of dS.K, Q of dS^T.Q, dO of P^T.dO).
//   No transposed copy is staged, and no thread touches an operand on its
//   way to shared memory.  A block is one consumer warpgroup and one
//   producer warp, whose first thread issues the TMA loads into a ring of
//   stages (two tiles each) guarded by mbarriers.
//   dq pass: Q and dO resident, K and V streamed twice.  The D pass takes
//   S and dP of each key tile (p computed while dP finishes); the dq pass
//   recomputes them, forms dS, and issues dQ += dS.K, whose K tile is given
//   back when the next tile's S is in (the products run while the next
//   tile's loads and the elementwise work do).
//   dk/dv pass: K and V resident; for each q tile the producer warp streams
//   Q and dO by TMA and its lanes copy the tile's lse and Dr rows beside
//   them.  One consumer warpgroup computes S^T = K.Q^T once, P^T, issues
//   dV += P^T.dO, forms dS^T from dP^T = V.dO^T while dV runs, then issues
//   dK += dS^T.Q, which runs on while the next q tile's S^T and dP^T are
//   issued.  Both accumulators stay in registers.
//   Shared memory (Cfg<D, Dv>::SMEM, 1 KiB of alignment): two resident tiles
//   and ST stages of two, a tile 8 KiB at D <= 64 (ST 3: 65 KiB) and 16
//   KiB above (two 64-column boxes, ST 2: 97 KiB); two blocks an SM, but
//   one at D > 64 in the dk/dv pass (two accumulators of 64 floats).
//   At (192, 128) Q and K tiles are three boxes (24 KiB), dO and V two
//   (121 KiB); dQ += dS.K and dK += dS^T.Q are n = 192, three n64 products
//   a k step, one a box; one block an SM in every pass (the dq pass's dQ is
//   96 floats a thread beside S, dP and the fragments).
//
// float32 (namespace tf32): 3xTF32 on tf32 wgmma.  A float32 operand is
//   split into hi = x truncated to tf32 and lo = x - hi (hopper.cuh's
//   Round::trunc, tiles.cuh) and a product is lo.hi + hi.lo + hi.hi.  Every
//   operand is a "unit" (tiles.cuh: 64 x 64, hi then lo, K-major).  tf32
//   wgmma reads shared memory K-major only, so the products over the
//   sequence read transposed units (K^T, Q^T, dO^T).
//   Operands arrive by TMA, raw: float32 tensor maps (tma.cuh) land 32
//   columns x 64 rows a box in exactly sw_off's layout.  The tensor core
//   reads a tf32 operand's top 19 bits, so a row unit's raw rows are its hi
//   as they lie and the producer warpgroup writes only lo = x - trunc(x)
//   (lo_pass).  A transposed unit is built from raw rows in shared memory:
//   in the dk/dv pass at D <= 64 from its row unit's, in the same pass
//   (pair_pass); elsewhere from a second TMA of the rows (from L2) into its
//   own lo half (transpose_unit: hi^T, a barrier of the producers, lo^T).
//   One producer thread issues the loads, the next unit's ahead of this
//   unit's pass where its slot is already free.  The units stream through
//   a ring of slots, each guarded by a landed (TMA), a full (producers) and
//   an empty (consumers) mbarrier.  The producers also stage each q tile's
//   lse and Dr rows beside its Q and dO units for the dk/dv pass.
//   Products run back to back where their operands allow (S and dP), and
//   each consumer warpgroup waits for its own products before it touches
//   their registers: ptxas serialised every wgmma of a warpgroup that let
//   the next tile's products run over its elementwise work.
//   dq pass: at D <= 64 two consumer warpgroups over 128 q rows, both
//   reading every K, V and K^T unit (one producer stream for both), the
//   tensor cores running one's products while the other forms p, dS and
//   the D sums; above, one over 64 rows.  Q and dO resident, K and V
//   streamed twice (the D pass, then the dq pass) and K^T once.
//   dk/dv pass: K and V resident, two consumer warpgroups.  Warpgroup 0
//   computes S^T = K.Q^T once, forms P^T, hands it to warpgroup 1 through
//   shared memory (a 16 KiB tile, two at D <= 64, guarded by mbarriers) and
//   issues dV += P^T.dO; warpgroup 1 computes dP^T = V.dO^T, reads P^T,
//   forms dS^T and issues dK += dS^T.Q: 6 product units each a q tile, where
//   computing S^T in both took 6 and 9.  One accumulator each keeps every D
//   inside 168 registers; above 64 the A fragments are packed a half at a
//   time.  The mask is a branch on the whole tile (a choice per element
//   made the elementwise work 5x slower).
//   Shared memory (1 KiB of alignment): D <= 64 dq 4 resident units (two
//   warpgroups') and a ring of 3, dk/dv 2 and 4 and two P^T tiles (225 KiB
//   each); D = 96 and 128 dq 4 and 3, dk/dv 4 and 2 and one P^T tile (225
//   and 209 KiB); one block a SM.
//   At (192, 128): the dq pass holds Q (3 units) and dO (2) and a ring of
//   2 (225 KiB), so a product over D takes its K units one at a time, each
//   waited for and given back; the dV and dK passes (flash_bwd_part_kernel,
//   one consumer and one producer warpgroup) hold K (3) and V (2) and a
//   ring of 2 (225 KiB) and run every product a unit at a time: simple,
//   not fast.

// Card times against the bound, SDPA's backward and the plain version:
// PERF.md (chip_smoke.py's backward timing phase).

// Each input type is its own translation unit, so nvcc builds the two in
// parallel: flash_attention_bwd.cu (float32) and flash_attention_bwd_bf16.cu
// (bfloat16), each a library with the entry flash_attention_bwd.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "tiles.cuh"
#include "tma.cuh"

namespace {

constexpr int BT = 64;                        // rows of a q tile and a key tile
constexpr float LOG2E = 1.4426950408889634f;

// key tiles the causal rows [q0, q0 + rows) need (the forward's tiles_for)
__device__ __forceinline__ int key_tiles(int q0, int rows, int Sq, int Sk, int causal, int q_off) {
  const int n = (Sk + BT - 1) / BT;
  return causal ? min(n, (min(q0 + rows, Sq) - 1 + q_off) / BT + 1) : n;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename K>
int set_smem(K kern, size_t smem, bool* done, int device) {
  if (device >= 0 && device < 64 && done[device]) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (device >= 0 && device < 64) done[device] = true;
  return 0;
}

// ======================================================== float32: 3xTF32

namespace tf32 {

constexpr int MAX_ST = 4;
constexpr int PTILE = BT * BT * 4;     // bytes of the P^T tile one warpgroup hands the other

// D: the width of q and k; DV: v's (and dO's).  A pair of two widths takes
// whole chunks of both (every unit two boxes) and DV < D.
template <int D, int DV>
struct Cfg {
  static constexpr int NC = (D + 63) / 64;             // 64-column chunks of D
  static constexpr int NV = (DV + 63) / 64;            // 64-column chunks of DV
  static constexpr int QW = NC == 1 ? 2 : 1;           // dq pass: consumer warpgroups
  // dq pass: ring units (two where Q and dO resident take five)
  static constexpr int QST = NC + NV > 4 ? 2 : 3;
  static constexpr int KST = NC == 1 ? 4 : 2;          // dk/dv pass: ring units
  static constexpr int PB = NC == 1 ? 2 : 1;           // P^T buffers
  static constexpr size_t SMEM_Q = 1024 + (size_t)UNIT * ((NC + NV) * QW + QST);
  static constexpr size_t SMEM_KV = 1024 + (size_t)UNIT * (NC + NV + KST) + (size_t)PB * PTILE;
  // D != DV: the dk/dv pass as two launches of one consumer warpgroup (a
  // dV pass, a dK pass: K and V resident (five units) leave no room for a
  // P^T tile beside two ring units), no P^T tile
  static constexpr bool SPLIT_KV = D != DV;
  static constexpr size_t SMEM_PART = 1024 + (size_t)UNIT * (NC + NV + KST);
  // k steps of chunk c of a product over D, over DV
  static __device__ __forceinline__ int ks(int c) { return min(8, (D - 64 * c) / 8); }
  static __device__ __forceinline__ int ksv(int c) { return min(8, (DV - 64 * c) / 8); }
  // the 32-column TMA boxes of chunk c that hold columns below D
  static __host__ __device__ constexpr int boxes(int c) {
    return ((D - 64 * c < 64 ? D - 64 * c : 64) + 31) / 32;
  }
  // the boxes of a resident or streamed unit of chunk c, and of chunks 0 .. n - 1
  static __host__ __device__ constexpr int unit_boxes(int c) {
    return c == 0 ? boxes(0) : boxes(1);
  }
  static __host__ __device__ constexpr int chunk_boxes(int n) {
    int t = 0;
    for (int c = 0; c < n; ++c) t += unit_boxes(c);
    return t;
  }
  static_assert(D == DV || (D % 64 == 0 && DV % 64 == 0 && DV < D),
                "a pair of two widths: whole 64-column chunks, DV < D");
  static_assert(SMEM_Q <= 232448 - 1024 && (SPLIT_KV ? SMEM_PART : SMEM_KV) <= 232448 - 1024,
                "a block's shared memory");
};

// how a ring unit is made
enum How : int {
  ROW,    // TMA of the raw rows into its hi half, lo_pass
  COL,    // TMA of the raw rows into its lo half, transpose_unit
  PAIR,   // as ROW, and the next unit, its transpose, in the same pass
  MADE    // made by the previous unit's pass (PAIR)
};

// the source of a ring unit: rows [row, row + 64) and chunk c of a tensor
struct UnitSrc {
  const CUtensorMap* map;
  int row, c;
  How how;
};

// One producer thread: the TMA of unit n's raw rows into its slot (a row
// unit's hi half, a transposed unit's lo half), once the slot is free; a
// MADE unit's landed phase completes with no load (so that every slot's
// phases stay one a use).
template <typename C, int ST>
__device__ __forceinline__ void issue_unit(const UnitSrc& u, int n, uint8_t* ring,
                                           uint64_t* empty, uint64_t* landed, int h, int b) {
  const int s = n % ST;
  mbar_wait(&empty[s], ((n / ST) & 1) ^ 1);
  if (u.how == MADE) {
    mbar_arrive(&landed[s]);
    return;
  }
  const int nb = C::unit_boxes(u.c);
  mbar_expect_tx(&landed[s], nb * BOX_BYTES);
  uint8_t* dst = ring + s * UNIT + (u.how == COL ? UNIT_HALF : 0);
  for (int x = 0; x < nb; ++x)
    tma_load_4d(dst + x * BOX_BYTES, u.map, &landed[s], 64 * u.c + 32 * x, h, u.row, b);
}

// A row unit whose raw rows landed in its hi half, and its transpose, in
// one pass (PAIR): lo into the row unit's lo half, hi^T and lo^T into
// `tunit` (transpose_unit's layout and thread blocks; the rows' lo stored
// where they were read, so no barrier: the raw rows stay).
__device__ __forceinline__ void pair_pass(uint8_t* unit, uint8_t* tunit, int nb, int ptid) {
  const int c = ptid % 16, rot = (c >> 1) & 3;
  const int jj0 = 8 * (c >> 1) + (c & 1);
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    if (m < nb) {
      const int g = ptid / 16 + 8 * m;
      float4 v[4];
      uint32_t off[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        off[s] = sw_off(jj0 + 2 * ((s + rot) & 3), 4 * g, UROWS);
        v[s] = *reinterpret_cast<const float4*>(unit + off[s]);
      }
#pragma unroll
      for (int s = 0; s < 4; ++s)
        *reinterpret_cast<float4*>(unit + UNIT_HALF + off[s]) = lo4(v[s]);
      const float4 t0 = rot & 2 ? v[2] : v[0], t1 = rot & 2 ? v[3] : v[1];
      const float4 t2 = rot & 2 ? v[0] : v[2], t3 = rot & 2 ? v[1] : v[3];
      const float4 w0 = rot & 1 ? t3 : t0, w1 = rot & 1 ? t0 : t1;
      const float4 w2 = rot & 1 ? t1 : t2, w3 = rot & 1 ? t2 : t3;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t = make_float4(get(w0, i), get(w1, i), get(w2, i), get(w3, i));
        const uint32_t o = sw_off(4 * g + i, 4 * c, UROWS);
        *reinterpret_cast<float4*>(tunit + o) = t;
        *reinterpret_cast<float4*>(tunit + UNIT_HALF + o) = lo4(t);
      }
    }
  }
}

// The producer warpgroup: the resident units (for each of W 64-row blocks
// from `row`, NC units of tensor ra's rows, then NV of rb's), then units 0
// .. total - 1 of the stream (`unit(n)` their sources), each into ring slot
// n % ST; with `rows`, the first 64 threads also store rowval(n, ptid)
// into rows[64 slot + ptid] beside the unit (loaded before the pass, so
// that its latency is the pass's).  Thread 0 issues the TMA loads: unit
// n + 1's before unit n's pass where its slot is already free (so that its
// landing overlaps the pass; it never waits for a slot ahead of its turn,
// which the consumers may free only once unit n is in), else at its turn.
// Every thread then waits for the unit to land, takes its pass (lo_pass,
// transpose_unit, pair_pass) and publishes it (a PAIR with the next).
template <typename C, int ST, int W, typename U, typename R>
__device__ __forceinline__ void produce(const CUtensorMap* ra, const CUtensorMap* rb, int row,
                                        uint8_t* res, uint64_t* res_landed, uint64_t* res_full,
                                        U unit, R rowval, float* rows, int total, uint8_t* ring,
                                        uint64_t* landed, uint64_t* full, uint64_t* empty, int h,
                                        int b, int ptid) {
  constexpr int NC = C::NC, NV = C::NV, NR = NC + NV;
  if (ptid == 0) {
    mbar_expect_tx(res_landed, W * (C::chunk_boxes(NC) + C::chunk_boxes(NV)) * BOX_BYTES);
#pragma unroll
    for (int w = 0; w < W; ++w) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        for (int x = 0; x < C::unit_boxes(c); ++x) {
          tma_load_4d(res + (w * NR + c) * UNIT + x * BOX_BYTES, ra, res_landed,
                      64 * c + 32 * x, h, row + 64 * w, b);
          if (c < NV)
            tma_load_4d(res + (w * NR + NC + c) * UNIT + x * BOX_BYTES, rb, res_landed,
                        64 * c + 32 * x, h, row + 64 * w, b);
        }
      }
    }
    if (total > 0) issue_unit<C, ST>(unit(0), 0, ring, empty, landed, h, b);
  }
  mbar_wait(res_landed, 0);
#pragma unroll
  for (int c = 0; c < NR * W; ++c)
    lo_pass(res + c * UNIT, C::unit_boxes(c % NR < NC ? c % NR : c % NR - NC), ptid);
  fence_async_shared();
  mbar_arrive(res_full);
  int issued = 1;   // thread 0: the units whose loads it has issued
  for (int n = 0; n < total; ++n) {
    const UnitSrc u = unit(n);
    if (ptid == 0) {
      if (issued == n) issue_unit<C, ST>(u, n, ring, empty, landed, h, b);
      issued = n + 1;
      if (n + 1 < total && mbar_test(&empty[(n + 1) % ST], (((n + 1) / ST) & 1) ^ 1)) {
        issue_unit<C, ST>(unit(n + 1), n + 1, ring, empty, landed, h, b);
        issued = n + 2;
      }
    }
    if (u.how == MADE) continue;   // published with unit n - 1
    const int s = n % ST;
    const float x = rows != nullptr && ptid < 64 ? rowval(n, ptid) : 0.f;
    mbar_wait(&landed[s], (n / ST) & 1);
    const int nb = C::unit_boxes(u.c);
    const int s2 = (n + 1) % ST;
    if (u.how == PAIR) {
      mbar_wait(&empty[s2], (((n + 1) / ST) & 1) ^ 1);
      pair_pass(ring + s * UNIT, ring + s2 * UNIT, nb, ptid);
    } else if (u.how == COL) {
      transpose_unit(ring + s * UNIT, nb, ptid);
    } else {
      lo_pass(ring + s * UNIT, nb, ptid);
    }
    if (rows != nullptr && ptid < 64) rows[64 * s + ptid] = x;
    fence_async_shared();
    mbar_arrive(&full[s]);
    if (u.how == PAIR) mbar_arrive(&full[s2]);
  }
}

// a consumer warpgroup's view of the ring: unit n is in slot n % ST.  In
// the dk/dv pass at D <= 64 each warpgroup reads two units of a q tile's
// four, never more than ST apart, and only the one that reads a unit
// waits for it and gives it back: the slot's previous unit is then its
// own, so the barrier phase it waits for is the next.  Elsewhere every
// consumer warpgroup walks every unit and gives it back, skipping those it
// does not read (tiles.cuh's rings).
template <int ST>
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  uint8_t* slots;
  // the address of unit n, once it is full
  __device__ __forceinline__ uint32_t take(int n) const {
    mbar_wait(&full[n % ST], (n / ST) & 1);
    return smem_u32(slots + (n % ST) * UNIT);
  }
  __device__ __forceinline__ void give(int n) const { mbar_arrive(&empty[n % ST]); }
  __device__ __forceinline__ void skip(int n) const {
    take(n);
    give(n);
  }
};

// the dq pass

template <int D, int DV>
__global__ void __launch_bounds__(128 * (Cfg<D, DV>::QW + 1), 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse, float* __restrict__ Dsum,
                    float* __restrict__ dq, int Sq, int Sk, int H, int n_qb, float scale,
                    int causal, int q_off) {
  using C = Cfg<D, DV>;
  constexpr int NC = C::NC, NV = C::NV, ST = C::QST, W = C::QW;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 + 3 * MAX_ST];
  uint8_t* base = align1024(smem_raw);
  uint8_t* sQ = base;                  // each warpgroup's NC Q units, then its NV dO units
  uint8_t* ring = base + (NC + NV) * W * UNIT;
  uint64_t* res_landed = bars;
  uint64_t* res_full = bars + 1;
  uint64_t* landed = bars + 2;
  uint64_t* full = bars + 2 + MAX_ST;
  uint64_t* empty = bars + 2 + 2 * MAX_ST;

  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int q0 = (n_qb - 1 - (int)blockIdx.y) * BT * W;   // most key tiles first
  const int n_kt = key_tiles(q0, BT * W, Sq, Sk, causal, q_off);
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(res_landed, 1);
    mbar_init(res_full, 128);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&landed[s], 1);
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], 128 * W);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the stream: the D pass's K and V of each key tile (NC + NV units),
  // then the dq pass's K, V and K^T (2 NC + NV)
  constexpr int U1 = NC + NV, U2 = 2 * NC + NV;
  const int n1 = U1 * n_kt;
  const auto unit = [&](int n) {
    if (n < n1) {
      const int k = n % U1;
      return UnitSrc{k < NC ? &tk : &tv, n / U1 * BT, k < NC ? k : k - NC, ROW};
    }
    const int k = (n - n1) % U2;
    return UnitSrc{k < NC || k >= U1 ? &tk : &tv, (n - n1) / U2 * BT,
                   k < NC ? k : k < U1 ? k - NC : k - U1, k >= U1 ? COL : ROW};
  };

  // the role of this thread's warpgroup, warp-uniform for the compiler
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == W) {
    produce<C, ST, W>(&tq, &tdo, q0, sQ, res_landed, res_full, unit,
                      [](int, int) { return 0.f; }, nullptr, (U1 + U2) * n_kt, ring, landed,
                      full, empty, h, b, tid - 128 * W);
    return;
  }

  // ------------------------------------------------------- consumers
  // Warpgroup wg takes the 64 q rows from qw; every consumer warpgroup
  // reads every unit (the key tiles past its own rows' last it skips).
  // Each waits for its own products: the tensor cores run one warpgroup's
  // while the other forms p, dS and their sums.
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int qw = q0 + BT * wg, nw = key_tiles(qw, BT, Sq, Sk, causal, q_off);
  const int ia = qw + acc_row(warp, lane, 0), ib = ia + 8;
  const float* lrow = lse + ((int64_t)b * H + h) * Sq;
  const float la = ia < Sq ? lrow[ia] * LOG2E : 0.f, lb = ib < Sq ? lrow[ib] * LOG2E : 0.f;
  const float sl2 = scale * LOG2E;
  const uint32_t aQ = smem_u32(sQ + (NC + NV) * wg * UNIT), adO = aQ + NC * UNIT;
  const Ring<ST> in{full, empty, ring};

  // s becomes p for the key tile at k0, 0 where masked
  // (the mask a branch on the whole tile, as in the dk/dv pass's P^T)
  const auto probs = [&](float (&s)[32], int k0) {
    if (k0 + BT > Sk || (causal && k0 + BT - 1 > qw + q_off)) {
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const bool lower = (r % 4) >= 2;
        const int j = k0 + acc_col(lane, r), i = lower ? ib : ia;
        const float p = exp2f(s[r] * sl2 - (lower ? lb : la));
        s[r] = j >= Sk || (causal && j > i + q_off) ? 0.f : p;
      }
    } else {
#pragma unroll
      for (int r = 0; r < 32; ++r) s[r] = exp2f(s[r] * sl2 - ((r % 4) >= 2 ? lb : la));
    }
  };
  // S = Q.K^T into s (the K units from unit k) and dP = dO.V^T into dp (the
  // V units from unit k + NC), issued back to back; at NC = 2, whose ring
  // cannot hold both, S is waited and its units given back before V's are
  // taken; where the ring cannot hold NC units (D = 192), S is a unit at a
  // time, each waited and given back.  Waited by the caller; then give_kv.
  const auto sdp = [&](float (&s)[32], float (&dp)[32], int k) {
    uint32_t ak[NC], av[NV];
    if constexpr (NC > ST) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        ak[c] = in.take(k + c);
        wg_fence();
        mma_ss(s, aQ + c * UNIT, ak[c], C::ks(c), c == 0);
        wg_commit();
        wg_wait_all();
        fence_regs(s);
        in.give(k + c);
      }
#pragma unroll
      for (int c = 0; c < NV; ++c) av[c] = in.take(k + NC + c);
      wg_fence();
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c) ak[c] = in.take(k + c);
      if constexpr (NC == 1) av[0] = in.take(k + 1);
      wg_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c) mma_ss(s, aQ + c * UNIT, ak[c], C::ks(c), c == 0);
      if constexpr (NC > 1) {
        wg_commit();
        wg_wait_all();
        fence_regs(s);
#pragma unroll
        for (int c = 0; c < NC; ++c) in.give(k + c);
#pragma unroll
        for (int c = 0; c < NV; ++c) av[c] = in.take(k + NC + c);
        wg_fence();
      }
    }
#pragma unroll
    for (int c = 0; c < NV; ++c) mma_ss(dp, adO + c * UNIT, av[c], C::ksv(c), c == 0);
    wg_commit();
  };
  const auto give_kv = [&](int k) {
#pragma unroll
    for (int c = NC == 1 ? 0 : NC; c < NC + NV; ++c) in.give(k + c);
  };
  const auto skip = [&](int k, int n) {
    for (int i = 0; i < n; ++i) in.skip(k + i);
  };

  mbar_wait(res_full, 0);
  // the D pass: Dr = rowsum(p * dp) / rowsum(p) over every key
  float pdp_a = 0.f, pdp_b = 0.f, ps_a = 0.f, ps_b = 0.f;
  float s[32], dp[32];
  for (int t = 0; t < nw; ++t) {
    sdp(s, dp, U1 * t);
    wg_wait_all();
    fence_regs(s);
    fence_regs(dp);
    give_kv(U1 * t);
    probs(s, t * BT);
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      if ((r % 4) < 2) {
        pdp_a += s[r] * dp[r];
        ps_a += s[r];
      } else {
        pdp_b += s[r] * dp[r];
        ps_b += s[r];
      }
    }
  }
  skip(U1 * nw, U1 * (n_kt - nw));
  const float Da = row_sum4(pdp_a) / row_sum4(ps_a), Db = row_sum4(pdp_b) / row_sum4(ps_b);
  if (lane % 4 == 0) {
    float* drow = Dsum + ((int64_t)b * H + h) * Sq;
    if (ia < Sq) drow[ia] = Da;
    if (ib < Sq) drow[ib] = Db;
  }

  // the dq pass: dq = sum over key tiles of dS.K
  float acc[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c) zero(acc[c]);
  uint32_t ah[32], al[32];
  for (int t = 0; t < nw; ++t) {
    const int k = n1 + U2 * t;
    sdp(s, dp, k);
    wg_wait_all();
    fence_regs(s);
    fence_regs(dp);
    give_kv(k);
    probs(s, t * BT);
#pragma unroll
    for (int r = 0; r < 32; ++r) s[r] = s[r] * (dp[r] - ((r % 4) >= 2 ? Db : Da)) * scale;
    pack_a(s, ah, al);
    uint32_t akt[NC];
    if constexpr (NC > ST) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {     // dQ += dS.K, a K^T unit at a time
        akt[c] = in.take(k + U1 + c);
        wg_fence();
        mma_rs(acc[c], ah, al, akt[c]);
        wg_commit();
        wg_wait_all();
        fence_regs(acc[c]);
        in.give(k + U1 + c);
      }
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c) akt[c] = in.take(k + U1 + c);
      wg_fence();
#pragma unroll
      for (int c = 0; c < NC; ++c) mma_rs(acc[c], ah, al, akt[c]);   // dQ += dS.K
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
#pragma unroll
      for (int c = 0; c < NC; ++c) in.give(k + U1 + c);
    }
  }
  skip(n1 + U2 * nw, U2 * (n_kt - nw));

  // ----------------------------------------------------------- epilogue
  const int64_t rs = (int64_t)H * D;
  float* out = dq + ((int64_t)b * Sq * H + h) * D;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int r = 0; r < 32; r += 2) {
      const int i = (r % 4) >= 2 ? ib : ia;
      const int col = 64 * c + acc_col(lane, r);
      if (i < Sq && col < D) store2(out + i * rs + col, acc[c][r], acc[c][r + 1]);
    }
  }
}

// the dk/dv pass

// acc (NC chunks) += (v split, half by half: two sets of 16 fragment
// registers, for the kernels that cannot hold 64) . (units b[c]), each
// half waited
template <int NC>
__device__ __forceinline__ void mma_rs_halves(float (&acc)[NC][32], const float (&v)[32],
                                              const uint32_t (&b)[NC]) {
  uint32_t ah[16], al[16];
  pack_a_half<0>(v, ah, al);
  wg_fence();
#pragma unroll
  for (int c = 0; c < NC; ++c) mma_rs_half<0>(acc[c], ah, al, b[c]);
  wg_commit();
  wg_wait_all();
#pragma unroll
  for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
  pack_a_half<1>(v, ah, al);
  wg_fence();
#pragma unroll
  for (int c = 0; c < NC; ++c) mma_rs_half<1>(acc[c], ah, al, b[c]);
  wg_commit();
  wg_wait_all();
#pragma unroll
  for (int c = 0; c < NC; ++c) fence_regs(acc[c]);
}

template <int D>
__global__ void __launch_bounds__(384, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                      const float* __restrict__ Dsum, float* __restrict__ dk,
                      float* __restrict__ dv, int Sq, int Sk, int H, float scale, int causal,
                      int q_off) {
  using C = Cfg<D, D>;
  constexpr int NC = C::NC, ST = C::KST, PB = C::PB, U = 4 * NC;
  constexpr int READERS = NC == 1 ? 1 : 2;   // warpgroups that give back each unit
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 + 3 * MAX_ST + 4];
  // beside each slot: the q tile's lse * log2(e) with its Q rows (chunk 0),
  // its Dr with its dO rows, 0 past Sq
  __shared__ float rows[ST * BT];
  uint8_t* base = align1024(smem_raw);
  uint8_t* sK = base;                  // NC units, then V's NC
  uint8_t* ring = base + 2 * NC * UNIT;
  uint8_t* pbuf = ring + ST * UNIT;    // PB tiles of P^T
  uint64_t* res_landed = bars;
  uint64_t* res_full = bars + 1;
  uint64_t* landed = bars + 2;
  uint64_t* full = bars + 2 + MAX_ST;
  uint64_t* empty = bars + 2 + 2 * MAX_ST;
  uint64_t* pfull = bars + 2 + 3 * MAX_ST;
  uint64_t* pempty = pfull + 2;

  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int k0 = (int)blockIdx.y * BT;      // the first key tiles see the most q tiles
  const int n_qt = (Sq + BT - 1) / BT;
  // the first q tile with a row that sees a key of this tile
  const int it0 = causal ? max(0, k0 - q_off) / BT : 0;
  const int ntile = max(0, n_qt - it0);
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(res_landed, 1);
    mbar_init(res_full, 128);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&landed[s], 1);
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], 128 * READERS);
    }
    for (int p = 0; p < PB; ++p) {
      mbar_init(&pfull[p], 128);
      mbar_init(&pempty[p], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the stream, a q tile's 4 NC units (the offsets of dO, dO^T and Q^T
  // after Q): at D <= 64 Q rows (S^T; warpgroup 0) with Q^T (dK; 1) made
  // in the same pass, then dO rows (dP^T; 1) with dO^T (dV; 0); above, Q,
  // dO, dO^T, Q^T, NC units each
  constexpr int ODO = NC == 1 ? 2 : NC, ODOT = NC == 1 ? 3 : 2 * NC, OQT = NC == 1 ? 1 : 3 * NC;
  const auto unit = [&](int n) {
    const int k = n % U, row = (it0 + n / U) * BT;
    if (NC == 1) return UnitSrc{k < 2 ? &tq : &tdo, row, 0, k % 2 ? MADE : PAIR};
    const int kind = k / NC;
    return UnitSrc{kind == 0 || kind == 3 ? &tq : &tdo, row, k % NC, kind >= 2 ? COL : ROW};
  };

  if (__shfl_sync(0xffffffffu, tid / 128, 0) == 2) {
    const float* lrow = lse + ((int64_t)b * H + h) * Sq;
    const float* drow = Dsum + ((int64_t)b * H + h) * Sq;
    const auto rowval = [&](int n, int t) {
      const int k = n % U, i = (it0 + n / U) * BT + t;
      if (k != 0 && k != ODO || i >= Sq) return 0.f;
      return k == 0 ? __ldg(lrow + i) * LOG2E : __ldg(drow + i);
    };
    produce<C, ST, 1>(&tk, &tv, k0, sK, res_landed, res_full, unit, rowval, rows, U * ntile,
                      ring, landed, full, empty, h, b, tid - 256);
    return;
  }

  // ------------------------------------------------------- consumers
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);   // warp-uniform for the compiler
  const int wtid = tid % 128, warp = wtid / 32, lane = tid % 32;
  const int ja = k0 + acc_row(warp, lane, 0), jb = ja + 8;   // this thread's keys
  const float sl2 = scale * LOG2E;
  const Ring<ST> in{full, empty, ring};
  float acc[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c) zero(acc[c]);
  float s[32];
  float4* pw = reinterpret_cast<float4*>(pbuf) + wtid;   // this thread's P^T slice
  // s = A (the resident units at a) . B^T (the NC units from unit n) over
  // D, waited; v[2 (r / 4) + r % 2] gets the row value the producer staged
  // beside unit n for column acc_col(lane, r) (a load from shared memory:
  // from global memory, its latency would stall the elementwise work)
  float v[16];
  const auto over_d = [&](uint32_t a, int n) {
    uint32_t bu[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) bu[c] = in.take(n + c);
#pragma unroll
    for (int m = 0; m < 16; ++m)
      v[m] = rows[(n % ST) * BT + 8 * (m / 2) + 2 * (lane % 4) + m % 2];
    wg_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c) mma_ss(s, a + c * UNIT, bu[c], C::ks(c), c == 0);
    wg_commit();
    wg_wait_all();
    fence_regs(s);
#pragma unroll
    for (int c = 0; c < NC; ++c) in.give(n + c);
  };
  // acc += (s split) . (the NC units from unit n) over the q tile's rows,
  // waited: at D <= 64 one group, above a half of the split at a time
  const auto over_q = [&](int n) {
    uint32_t bu[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) bu[c] = in.take(n + c);
    if constexpr (NC == 1) {
      uint32_t ah[32], al[32];
      pack_a(s, ah, al);
      wg_fence();
      mma_rs(acc[0], ah, al, bu[0]);
      wg_commit();
      wg_wait_all();
      fence_regs(acc[0]);
    } else {
      mma_rs_halves<NC>(acc, s, bu);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) in.give(n + c);
  };
  // the NC units from unit n, where every warpgroup walks every unit
  const auto skip = [&](int n) {
    if (READERS == 2) {
#pragma unroll
      for (int c = 0; c < NC; ++c) in.skip(n + c);
    }
  };

  mbar_wait(res_full, 0);
  // Each warpgroup waits for its own products: the tensor cores run one
  // warpgroup's while the other forms P^T or dS^T.
  if (wg == 0) {
    // S^T = K.Q^T once, P^T, handed to warpgroup 1, and dV += P^T.dO
    const uint32_t aK = smem_u32(sK);
    for (int j = 0; j < ntile; ++j) {
      const int i0 = (it0 + j) * BT;
      over_d(aK, U * j);                        // S^T = K.Q^T; v: lse * log2(e)
      // P^T, masked on the tiles a mask cuts (a branch on the whole tile:
      // a per-element choice made the loop 5x slower)
      if (i0 + BT > Sq || (causal && k0 + BT - 1 > i0 + q_off)) {
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          const int i = i0 + acc_col(lane, r), jk = (r % 4) >= 2 ? jb : ja;
          const bool keep = i < Sq && !(causal && jk > i + q_off);
          s[r] = keep ? exp2f(s[r] * sl2 - v[2 * (r / 4) + r % 2]) : 0.f;
        }
      } else {
#pragma unroll
        for (int r = 0; r < 32; ++r) s[r] = exp2f(s[r] * sl2 - v[2 * (r / 4) + r % 2]);
      }
      const int pb = j % PB;
      mbar_wait(&pempty[pb], ((j / PB) & 1) ^ 1);
#pragma unroll
      for (int m = 0; m < 8; ++m)
        pw[pb * (PTILE / 16) + m * 128] = make_float4(s[4 * m], s[4 * m + 1], s[4 * m + 2],
                                                      s[4 * m + 3]);
      mbar_arrive(&pfull[pb]);
      skip(U * j + ODO);                        // dO rows
      over_q(U * j + ODOT);                     // dV += P^T.dO
      skip(U * j + OQT);                        // Q^T
    }
  } else {
    // dP^T = V.dO^T, dS^T from warpgroup 0's P^T, and dK += dS^T.Q
    const uint32_t aV = smem_u32(sK) + NC * UNIT;
    for (int j = 0; j < ntile; ++j) {
      skip(U * j);                              // Q rows
      over_d(aV, U * j + ODO);                  // dP^T = V.dO^T; v: Dr
      skip(U * j + ODOT);                       // dO^T
      const int pb = j % PB;
      mbar_wait(&pfull[pb], (j / PB) & 1);
#pragma unroll
      for (int m = 0; m < 8; ++m) {             // dS^T
        const float4 p = pw[pb * (PTILE / 16) + m * 128];
        s[4 * m] = p.x * (s[4 * m] - v[2 * m]) * scale;
        s[4 * m + 1] = p.y * (s[4 * m + 1] - v[2 * m + 1]) * scale;
        s[4 * m + 2] = p.z * (s[4 * m + 2] - v[2 * m]) * scale;
        s[4 * m + 3] = p.w * (s[4 * m + 3] - v[2 * m + 1]) * scale;
      }
      mbar_arrive(&pempty[pb]);
      over_q(U * j + OQT);                      // dK += dS^T.Q
    }
  }

  // ----------------------------------------------------------- epilogue
  const int64_t rs = (int64_t)H * D;
  float* out = (wg == 1 ? dk : dv) + ((int64_t)b * Sk * H + h) * D;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int r = 0; r < 32; r += 2) {
      const int j = (r % 4) >= 2 ? jb : ja;
      const int col = 64 * c + acc_col(lane, r);
      if (j < Sk && col < D) store2(out + j * rs + col, acc[c][r], acc[c][r + 1]);
    }
  }
}

// The dk/dv pass of a pair of two widths (Cfg::SPLIT_KV) as two launches,
// each one consumer warpgroup and one producer warpgroup: DV_ONLY computes
// S^T = K.Q^T, P^T and dV += P^T.dO; DK_ONLY S^T, P^T, dP^T = V.dO^T, dS^T
// and dK += dS^T.Q (S^T twice a call: the price of the split).  K and V
// are resident (V unread by DV_ONLY, for one layout), a q tile's units
// stream through a ring of KST = 2 units: Q rows (NC) and dO^T (NV) for
// dV; Q rows, dO rows (NV) and Q^T (NC) for dK.  The ring holds fewer
// units than a product over D takes, so every product runs a unit at a
// time, each waited for and its unit given back: simple, not fast.
enum Part : int { DV_ONLY, DK_ONLY };

template <int D, int DV, int PART>
__global__ void __launch_bounds__(256, 1)
flash_bwd_part_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                      const float* __restrict__ Dsum, float* __restrict__ out, int Sq, int Sk,
                      int H, float scale, int causal, int q_off) {
  using C = Cfg<D, DV>;
  constexpr int NC = C::NC, NV = C::NV, ST = C::KST;
  constexpr int U = PART == DV_ONLY ? NC + NV : 2 * NC + NV;   // units of a q tile
  constexpr int NO = PART == DV_ONLY ? NV : NC;                // chunks of the output
  constexpr int WO = PART == DV_ONLY ? DV : D;                 // its width
  constexpr int OB = PART == DV_ONLY ? NC : NC + NV;           // its product's first unit
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 + 3 * MAX_ST];
  // beside each slot: the q tile's lse * log2(e) with its first Q unit, its
  // Dr with its first dO unit (DK_ONLY), 0 past Sq
  __shared__ float rows[ST * BT];
  uint8_t* base = align1024(smem_raw);
  uint8_t* sK = base;                  // NC units, then V's NV
  uint8_t* ring = base + (NC + NV) * UNIT;
  uint64_t* res_landed = bars;
  uint64_t* res_full = bars + 1;
  uint64_t* landed = bars + 2;
  uint64_t* full = bars + 2 + MAX_ST;
  uint64_t* empty = bars + 2 + 2 * MAX_ST;

  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int k0 = (int)blockIdx.y * BT;      // the first key tiles see the most q tiles
  const int n_qt = (Sq + BT - 1) / BT;
  // the first q tile with a row that sees a key of this tile
  const int it0 = causal ? max(0, k0 - q_off) / BT : 0;
  const int ntile = max(0, n_qt - it0);
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(res_landed, 1);
    mbar_init(res_full, 128);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&landed[s], 1);
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const auto unit = [&](int n) {
    const int k = n % U, row = (it0 + n / U) * BT;
    if (k < NC) return UnitSrc{&tq, row, k, ROW};
    if (PART == DV_ONLY) return UnitSrc{&tdo, row, k - NC, COL};
    if (k < NC + NV) return UnitSrc{&tdo, row, k - NC, ROW};
    return UnitSrc{&tq, row, k - NC - NV, COL};
  };

  if (__shfl_sync(0xffffffffu, tid / 128, 0) == 1) {
    const float* lrow = lse + ((int64_t)b * H + h) * Sq;
    const float* drow = Dsum + ((int64_t)b * H + h) * Sq;
    const auto rowval = [&](int n, int t) {
      const int k = n % U, i = (it0 + n / U) * BT + t;
      if ((k != 0 && (PART == DV_ONLY || k != NC)) || i >= Sq) return 0.f;
      return k == 0 ? __ldg(lrow + i) * LOG2E : __ldg(drow + i);
    };
    produce<C, ST, 1>(&tk, &tv, k0, sK, res_landed, res_full, unit, rowval, rows, U * ntile,
                      ring, landed, full, empty, h, b, tid - 128);
    return;
  }

  // ------------------------------------------------------- consumers
  const int warp = tid / 32, lane = tid % 32;
  const int ja = k0 + acc_row(warp, lane, 0), jb = ja + 8;   // this thread's keys
  const float sl2 = scale * LOG2E;
  const Ring<ST> in{full, empty, ring};
  const uint32_t aK = smem_u32(sK), aV = aK + NC * UNIT;
  float acc[NO][32];
#pragma unroll
  for (int c = 0; c < NO; ++c) zero(acc[c]);
  float s[32], v[16];
  uint32_t ah[32], al[32];
  // v[2 (r / 4) + r % 2]: the row value staged beside unit n for column
  // acc_col(lane, r)
  const auto row_vals = [&](int n) {
#pragma unroll
    for (int m = 0; m < 16; ++m)
      v[m] = rows[(n % ST) * BT + 8 * (m / 2) + 2 * (lane % 4) + m % 2];
  };

  mbar_wait(res_full, 0);
  for (int j = 0; j < ntile; ++j) {
    const int i0 = (it0 + j) * BT, n0 = U * j;
    // S^T = K.Q^T, a Q unit at a time; v: lse * log2(e)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const uint32_t bu = in.take(n0 + c);
      if (c == 0) row_vals(n0);
      wg_fence();
      mma_ss(s, aK + c * UNIT, bu, C::ks(c), c == 0);
      wg_commit();
      wg_wait_all();
      fence_regs(s);
      in.give(n0 + c);
    }
    // P^T, masked on the tiles a mask cuts (a branch on the whole tile)
    if (i0 + BT > Sq || (causal && k0 + BT - 1 > i0 + q_off)) {
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int i = i0 + acc_col(lane, r), jk = (r % 4) >= 2 ? jb : ja;
        const bool keep = i < Sq && !(causal && jk > i + q_off);
        s[r] = keep ? exp2f(s[r] * sl2 - v[2 * (r / 4) + r % 2]) : 0.f;
      }
    } else {
#pragma unroll
      for (int r = 0; r < 32; ++r) s[r] = exp2f(s[r] * sl2 - v[2 * (r / 4) + r % 2]);
    }
    if constexpr (PART == DK_ONLY) {
      // dP^T = V.dO^T, a dO unit at a time; v: Dr; then dS^T into s
      float dp[32];
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const uint32_t bu = in.take(n0 + NC + c);
        if (c == 0) row_vals(n0 + NC);
        wg_fence();
        mma_ss(dp, aV + c * UNIT, bu, C::ksv(c), c == 0);
        wg_commit();
        wg_wait_all();
        fence_regs(dp);
        in.give(n0 + NC + c);
      }
#pragma unroll
      for (int r = 0; r < 32; ++r) s[r] = s[r] * (dp[r] - v[2 * (r / 4) + r % 2]) * scale;
    }
    // dV += P^T.dO (the dO^T units) or dK += dS^T.Q (the Q^T units)
    pack_a(s, ah, al);
#pragma unroll
    for (int c = 0; c < NO; ++c) {
      const uint32_t bu = in.take(n0 + OB + c);
      wg_fence();
      mma_rs(acc[c], ah, al, bu);
      wg_commit();
      wg_wait_all();
      fence_regs(acc[c]);
      in.give(n0 + OB + c);
    }
  }

  // ----------------------------------------------------------- epilogue
  const int64_t rs = (int64_t)H * WO;
  float* o = out + ((int64_t)b * Sk * H + h) * WO;
#pragma unroll
  for (int c = 0; c < NO; ++c) {
#pragma unroll
    for (int r = 0; r < 32; r += 2) {
      const int j = (r % 4) >= 2 ? jb : ja;
      const int col = 64 * c + acc_col(lane, r);
      if (j < Sk && col < WO) store2(o + j * rs + col, acc[c][r], acc[c][r + 1]);
    }
  }
}

template <int D, int DV>
int launch(const float* q, const float* k, const float* v, const float* dO, const float* lse,
           float* Dsum, float* dq, float* dk, float* dv, int64_t B, int64_t Sq, int64_t Sk,
           int64_t H, Strides sq, Strides sk, Strides sv, Strides sdo, float scale, int causal,
           int q_off, int device, cudaStream_t stream) {
  using C = Cfg<D, DV>;
  // 16-byte-aligned bases, strides of whole 16 bytes (the wrapper copies
  // what fails), read through float32 tensor maps
  const void* ptrs[] = {q, k, v, dO};
  const Strides strides[] = {sq, sk, sv, sdo};
  for (int i = 0; i < 4; ++i)
    if ((uintptr_t)ptrs[i] % 16 || strides[i].b % 4 || strides[i].s % 4 || strides[i].h % 4)
      return -3;
  CUtensorMap tq, tk, tv, tdo;
  int rc;
  if ((rc = cached_map(&tq, q, B, Sq, H, D, sq, 4)) != 0) return rc;
  if ((rc = cached_map(&tk, k, B, Sk, H, D, sk, 4)) != 0) return rc;
  if ((rc = cached_map(&tv, v, B, Sk, H, DV, sv, 4)) != 0) return rc;
  if ((rc = cached_map(&tdo, dO, B, Sq, H, DV, sdo, 4)) != 0) return rc;
  static bool done_dq[64] = {}, done_kv[64] = {}, done_k[64] = {};   // per device
  auto kq = flash_bwd_dq_kernel<D, DV>;
  if ((rc = set_smem(kq, C::SMEM_Q, done_dq, device)) != 0) return rc;
  constexpr int W = C::QW;
  const int64_t n_qb = (Sq + BT * W - 1) / (BT * W), n_kt = (Sk + BT - 1) / BT;
  if (B * H > 0x7fffffff || n_qb > 65535 || n_kt > 65535) return -1;
  kq<<<dim3((unsigned)(B * H), (unsigned)n_qb), 128 * (W + 1), C::SMEM_Q, stream>>>(
      tq, tk, tv, tdo, lse, Dsum, dq, (int)Sq, (int)Sk, (int)H, (int)n_qb, scale, causal, q_off);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * H), (unsigned)n_kt);
  if constexpr (C::SPLIT_KV) {
    auto kv = flash_bwd_part_kernel<D, DV, DV_ONLY>;
    auto kk = flash_bwd_part_kernel<D, DV, DK_ONLY>;
    if ((rc = set_smem(kv, C::SMEM_PART, done_kv, device)) != 0) return rc;
    if ((rc = set_smem(kk, C::SMEM_PART, done_k, device)) != 0) return rc;
    kv<<<grid, 256, C::SMEM_PART, stream>>>(tq, tk, tv, tdo, lse, Dsum, dv, (int)Sq, (int)Sk,
                                            (int)H, scale, causal, q_off);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    kk<<<grid, 256, C::SMEM_PART, stream>>>(tq, tk, tv, tdo, lse, Dsum, dk, (int)Sq, (int)Sk,
                                            (int)H, scale, causal, q_off);
  } else {
    auto kkv = flash_bwd_dkdv_kernel<D>;
    if ((rc = set_smem(kkv, C::SMEM_KV, done_kv, device)) != 0) return rc;
    kkv<<<grid, 384, C::SMEM_KV, stream>>>(tq, tk, tv, tdo, lse, Dsum, dk, dv, (int)Sq,
                                           (int)Sk, (int)H, scale, causal, q_off);
  }
  return (int)cudaGetLastError();
}

}  // namespace tf32


// ===================================================== bfloat16: bf16 wgmma

namespace bf16 {

constexpr int MAX_ST = 3;
constexpr int THREADS = 128 + 32;     // a consumer warpgroup, a producer warp

// D: the width of q and k; DV: v's (and dO's)
template <int D, int DV>
struct Cfg {
  static constexpr int DP = (D + 63) / 64 * 64;   // Q and K columns in shared memory
  static constexpr int CH = DP / 64;              // boxes of a Q or K tile
  static constexpr int OREG = DP / 2;             // floats a thread of a 64 x DP accumulator
  static constexpr int TILE = CH * BOX_BYTES;     // bytes of a 64-row Q or K tile
  static constexpr int DPV = (DV + 63) / 64 * 64; // V and dO columns in shared memory
  static constexpr int CHV = DPV / 64;            // boxes of a V or dO tile
  static constexpr int OREGV = DPV / 2;           // floats a thread of a 64 x DPV accumulator
  static constexpr int TILEV = CHV * BOX_BYTES;   // bytes of a 64-row V or dO tile
  static constexpr int ST = D <= 64 ? 3 : 2;      // ring stages of a Q/K and a V/dO tile
  static constexpr size_t SMEM = 1024 + (size_t)(TILE + TILEV) * (1 + ST);
  // blocks an SM: the dq pass, and the dk/dv pass (two accumulators of 64
  // floats above 64); at D = 192 one dq block (its dQ accumulator is 96
  // floats a thread)
  static constexpr int DQ_BLOCKS = D <= 128 ? 2 : 1;
  static constexpr int KV_BLOCKS = D <= 64 ? 2 : 1;
  // the dk/dv pass as one launch (both accumulators), or, where they do not
  // fit one warpgroup's registers together (D = 192, DV = 128: 96 + 64
  // floats a thread), as two: a dV pass and a dK pass
  static constexpr bool SPLIT_KV = D != DV;
};

// what a dk/dv launch computes
enum Part : int { BOTH, DV_ONLY, DK_ONLY };

// x and y, neighbouring columns of an accumulator row, as bf16x2 hi =
// bf16(x) and lo = bf16(x - hi)
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - f.x, y - f.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// a 64 x 64 accumulator tile as the A fragments of a product over its
// columns, hi and lo: the accumulator layout is the A-fragment layout (the
// forward's P)
__device__ __forceinline__ void pack_hl(const float (&v)[32], uint32_t (&hi)[16],
                                        uint32_t (&lo)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) split2(v[2 * i], v[2 * i + 1], hi[i], lo[i]);
}

// d (64 x 64) = A.B^T over D: two 64-row tiles in shared memory, K-major
template <int D>
__device__ __forceinline__ void mma_over_d(float (&d)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
    wgmma_ss_n64(d, desc_kmajor(a + off), desc_kmajor(b + off), kk > 0);
  }
}

// d (64 x DP) += (hi + lo fragments) . B over the 64 rows of tile b, read
// MN-major (the transpose bit): lo terms, then hi.  DP = 192 is three n64
// products, one a 64-column box (an n64 accumulator's 32 floats are the
// wider one's 32 c .. 32 c + 31)
template <int DP>
__device__ __forceinline__ void mma_over_rows(float (&d)[DP / 2], const uint32_t (&hi)[16],
                                              const uint32_t (&lo)[16], uint32_t b) {
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    const uint32_t* a = part == 0 ? lo : hi;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (DP == 192) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
          wgmma_rs_n64(*reinterpret_cast<float(*)[32]>(d + 32 * c), a + 4 * kk,
                       desc_mnmajor(b + c * BOX_BYTES + kk * 16 * 128));
      } else if constexpr (DP == 128) {
        wgmma_rs_n128(d, a + 4 * kk, desc_mnmajor(b + kk * 16 * 128));
      } else {
        wgmma_rs_n64(d, a + 4 * kk, desc_mnmajor(b + kk * 16 * 128));
      }
    }
  }
}

// the dq pass

template <int D, int DV>
__global__ void __launch_bounds__(THREADS, Cfg<D, DV>::DQ_BLOCKS)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse, float* __restrict__ Dsum,
                    __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H, int n_qt, float scale,
                    int causal, int q_off) {
  using C = Cfg<D, DV>;
  constexpr int ST = C::ST, STAGE = C::TILE + C::TILEV;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * MAX_ST];
  uint8_t* base = align1024(smem_raw);
  uint8_t* sQ = base;
  uint8_t* sdO = base + C::TILE;
  uint8_t* ring = base + STAGE;          // stage s: K at ring + s STAGE, V after it
  uint64_t* res_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + MAX_ST;

  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * BT;   // most key tiles first
  const int n_kt = key_tiles(q0, BT, Sq, Sk, causal, q_off);
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(res_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {
    // --------------------------------------------------- producer warp
    if (tid == 128) {
      mbar_expect_tx(res_full, STAGE);
      for (int c = 0; c < C::CH; ++c) {
        tma_load_4d(sQ + c * BOX_BYTES, &tq, res_full, c * 64, h, q0, b);
        if (c < C::CHV) tma_load_4d(sdO + c * BOX_BYTES, &tdo, res_full, c * 64, h, q0, b);
      }
      int n = 0;
      for (int pass = 0; pass < 2; ++pass) {
        for (int t = 0; t < n_kt; ++t, ++n) {
          const int s = n % ST;
          mbar_wait(&empty[s], ((n / ST) & 1) ^ 1);
          mbar_expect_tx(&full[s], STAGE);
          uint8_t* st = ring + s * STAGE;
          for (int c = 0; c < C::CH; ++c) {
            tma_load_4d(st + c * BOX_BYTES, &tk, &full[s], c * 64, h, t * BT, b);
            if (c < C::CHV)
              tma_load_4d(st + C::TILE + c * BOX_BYTES, &tv, &full[s], c * 64, h, t * BT, b);
          }
        }
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroup
  const int warp = tid / 32, lane = tid % 32;
  const int ia = q0 + acc_row(warp, lane, 0), ib = ia + 8;
  const float* lrow = lse + ((int64_t)b * H + h) * Sq;
  const float la = ia < Sq ? lrow[ia] * LOG2E : 0.f, lb = ib < Sq ? lrow[ib] * LOG2E : 0.f;
  const float sl2 = scale * LOG2E;
  const uint32_t aQ = smem_u32(sQ), adO = smem_u32(sdO);
  float s[32], dp[32];
  int n = 0;   // ring stages taken

  // S = Q.K^T and dP = dO.V^T of stage st, issued as two groups
  auto issue_sdp = [&](int st) {
    const uint32_t kt = smem_u32(ring + st * STAGE);
    zero(s);
    zero(dp);
    wg_fence();
    mma_over_d<D>(s, aQ, kt);
    wg_commit();
    mma_over_d<DV>(dp, adO, kt + C::TILE);
    wg_commit();
  };
  // the next stage, once it is full -> its slot
  auto take = [&]() {
    const int st = n % ST;
    mbar_wait(&full[st], (n / ST) & 1);
    ++n;
    return st;
  };
  // s becomes p for the key tile at k0, 0 where masked
  auto probs = [&](int k0) {
    const bool edge = k0 + BT > Sk || (causal && k0 + BT - 1 > q0 + q_off);
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const bool lower = (r % 4) >= 2;
      float p = exp2f(s[r] * sl2 - (lower ? lb : la));
      if (edge) {
        const int j = k0 + acc_col(lane, r), i = lower ? ib : ia;
        if (j >= Sk || (causal && j > i + q_off)) p = 0.f;
      }
      s[r] = p;
    }
  };

  mbar_wait(res_full, 0);
  // the D pass: Dr = rowsum(p * dp) / rowsum(p) over every key
  float pdp_a = 0.f, pdp_b = 0.f, ps_a = 0.f, ps_b = 0.f;
  for (int t = 0; t < n_kt; ++t) {
    const int st = take();
    issue_sdp(st);
    wg_wait_one();   // S is in; dP may still run
    fence_regs(s);
    probs(t * BT);
    wg_wait_all();
    fence_regs(dp);
    mbar_arrive(&empty[st]);
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      if ((r % 4) < 2) {
        pdp_a += s[r] * dp[r];
        ps_a += s[r];
      } else {
        pdp_b += s[r] * dp[r];
        ps_b += s[r];
      }
    }
  }
  const float Da = row_sum4(pdp_a) / row_sum4(ps_a), Db = row_sum4(pdp_b) / row_sum4(ps_b);
  if (lane % 4 == 0) {
    float* drow = Dsum + ((int64_t)b * H + h) * Sq;
    if (ia < Sq) drow[ia] = Da;
    if (ib < Sq) drow[ib] = Db;
  }

  // the dq pass: dq = sum over key tiles of dS.K; the stage of the previous
  // tile's dS.K is given back once that product is in
  float acc[C::OREG];
  zero(acc);
  uint32_t hi[16], lo[16];
  int prev = -1;
  for (int t = 0; t < n_kt; ++t) {
    const int st = take();
    issue_sdp(st);
    wg_wait_one();   // the previous dS.K and S are in
    fence_regs(s);
    if (prev >= 0) mbar_arrive(&empty[prev]);
    probs(t * BT);
    wg_wait_all();
    fence_regs(dp);
#pragma unroll
    for (int r = 0; r < 32; ++r) s[r] = s[r] * (dp[r] - ((r % 4) >= 2 ? Db : Da)) * scale;
    pack_hl(s, hi, lo);
    wg_fence();
    mma_over_rows<C::DP>(acc, hi, lo, smem_u32(ring + st * STAGE));
    wg_commit();
    prev = st;
  }
  wg_wait_all();
  fence_regs(acc);
  if (prev >= 0) mbar_arrive(&empty[prev]);

  // ----------------------------------------------------------- epilogue
  const int64_t rs = (int64_t)H * D;
  __nv_bfloat16* out = dq + ((int64_t)b * Sq * H + h) * D;
#pragma unroll
  for (int r = 0; r < C::OREG; r += 2) {
    const int i = (r % 4) >= 2 ? ib : ia;
    const int col = acc_col(lane, r);
    if (i < Sq && col < D) store2(out + i * rs + col, acc[r], acc[r + 1]);
  }
}

// the dk/dv pass

// PART: both gradients (BOTH), or dV or dK alone (Cfg::SPLIT_KV); a
// launch of one reads the tiles of both and stores its own
template <int D, int DV, int PART>
__global__ void __launch_bounds__(THREADS, Cfg<D, DV>::KV_BLOCKS)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                      const float* __restrict__ Dsum, __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H, float scale,
                      int causal, int q_off) {
  using C = Cfg<D, DV>;
  static_assert(PART != BOTH || D == DV, "one launch for both gradients at D = DV only");
  constexpr int ST = C::ST, STAGE = C::TILE + C::TILEV;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * MAX_ST];
  // each stage's q rows: lse * log2(e), then Dr (0 past Sq)
  __shared__ float rows[MAX_ST][2][BT];
  uint8_t* base = align1024(smem_raw);
  uint8_t* sK = base;
  uint8_t* sV = base + C::TILE;
  uint8_t* ring = base + STAGE;          // stage s: Q at ring + s STAGE, dO after it
  uint64_t* res_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + MAX_ST;

  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int k0 = (int)blockIdx.y * BT;      // the first key tiles see the most q tiles
  const int n_qt = (Sq + BT - 1) / BT;
  // the first q tile with a row that sees a key of this tile
  const int it0 = causal ? max(0, k0 - q_off) / BT : 0;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(res_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 32);   // the producer lanes' arrivals, the first with the bytes
      mbar_init(&empty[s], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {
    // --------------------------------------------------- producer warp
    const int lane = tid - 128;
    if (lane == 0) {
      mbar_expect_tx(res_full, STAGE);
      for (int c = 0; c < C::CH; ++c) {
        tma_load_4d(sK + c * BOX_BYTES, &tk, res_full, c * 64, h, k0, b);
        if (c < C::CHV) tma_load_4d(sV + c * BOX_BYTES, &tv, res_full, c * 64, h, k0, b);
      }
    }
    const float* lrow = lse + ((int64_t)b * H + h) * Sq;
    const float* drow = Dsum + ((int64_t)b * H + h) * Sq;
    int n = 0;
    for (int it = it0; it < n_qt; ++it, ++n) {
      const int s = n % ST;
      const int i = it * BT + 2 * lane;
      const float l0 = i < Sq ? __ldg(lrow + i) * LOG2E : 0.f;
      const float l1 = i + 1 < Sq ? __ldg(lrow + i + 1) * LOG2E : 0.f;
      const float d0 = i < Sq ? __ldg(drow + i) : 0.f, d1 = i + 1 < Sq ? __ldg(drow + i + 1) : 0.f;
      mbar_wait(&empty[s], ((n / ST) & 1) ^ 1);
      rows[s][0][2 * lane] = l0;
      rows[s][0][2 * lane + 1] = l1;
      rows[s][1][2 * lane] = d0;
      rows[s][1][2 * lane + 1] = d1;
      if (lane == 0) {
        mbar_expect_tx(&full[s], STAGE);
        uint8_t* st = ring + s * STAGE;
        for (int c = 0; c < C::CH; ++c) {
          tma_load_4d(st + c * BOX_BYTES, &tq, &full[s], c * 64, h, it * BT, b);
          if (c < C::CHV)
            tma_load_4d(st + C::TILE + c * BOX_BYTES, &tdo, &full[s], c * 64, h, it * BT, b);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroup
  const int warp = tid / 32, lane = tid % 32;
  const int ja = k0 + acc_row(warp, lane, 0), jb = ja + 8;   // this thread's keys
  const float sl2 = scale * LOG2E;
  const uint32_t aK = smem_u32(sK), aV = smem_u32(sV);
  constexpr bool WANT_DK = PART != DV_ONLY, WANT_DV = PART != DK_ONLY;
  float dka[WANT_DK ? C::OREG : 1], dva[WANT_DV ? C::OREGV : 1];
  zero(dka);
  zero(dva);
  float s[32], dp[32];
  uint32_t hi[16], lo[16];

  mbar_wait(res_full, 0);
  int n = 0, prev = -1;
  for (int it = it0; it < n_qt; ++it, ++n) {
    const int st = n % ST;
    mbar_wait(&full[st], (n / ST) & 1);
    const uint32_t aQ = smem_u32(ring + st * STAGE), adO = aQ + C::TILE;
    zero(s);
    if constexpr (WANT_DK) zero(dp);
    wg_fence();
    mma_over_d<D>(s, aK, aQ);     // S^T = K.Q^T: rows keys, columns q
    wg_commit();
    if constexpr (WANT_DK) {
      mma_over_d<DV>(dp, aV, adO);   // dP^T = V.dO^T
      wg_commit();
      wg_wait_one();              // the previous dS^T.Q and S^T are in
    } else {
      wg_wait_all();              // the previous P^T.dO and S^T are in
    }
    fence_regs(s);
    if (prev >= 0) mbar_arrive(&empty[prev]);
    const float* lr = rows[st][0];
    const float* dr = rows[st][1];
    const int i0 = it * BT;
    const bool edge = i0 + BT > Sq || (causal && k0 + BT - 1 > i0 + q_off);
#pragma unroll
    for (int r = 0; r < 32; ++r) {            // P^T
      const int col = acc_col(lane, r), i = i0 + col, j = (r % 4) >= 2 ? jb : ja;
      const bool keep = !edge || (i < Sq && !(causal && j > i + q_off));
      s[r] = keep ? exp2f(s[r] * sl2 - lr[col]) : 0.f;
    }
    if constexpr (PART == BOTH) {
      pack_hl(s, hi, lo);
      wg_fence();
      mma_over_rows<C::DPV>(dva, hi, lo, adO);  // dV += P^T.dO
      wg_commit();
      wg_wait_one();                            // dP^T is in; dV may still run
      fence_regs(dp);
#pragma unroll
      for (int r = 0; r < 32; ++r) dp[r] = s[r] * (dp[r] - dr[acc_col(lane, r)]) * scale;
      wg_wait_all();                            // dV is in: its fragments are free
      pack_hl(dp, hi, lo);
      wg_fence();
      mma_over_rows<C::DP>(dka, hi, lo, aQ);    // dK += dS^T.Q
      wg_commit();
    } else if constexpr (PART == DV_ONLY) {
      pack_hl(s, hi, lo);
      wg_fence();
      mma_over_rows<C::DPV>(dva, hi, lo, adO);  // dV += P^T.dO
      wg_commit();
    } else {
      wg_wait_all();                            // dP^T is in
      fence_regs(dp);
#pragma unroll
      for (int r = 0; r < 32; ++r) dp[r] = s[r] * (dp[r] - dr[acc_col(lane, r)]) * scale;
      pack_hl(dp, hi, lo);
      wg_fence();
      mma_over_rows<C::DP>(dka, hi, lo, aQ);    // dK += dS^T.Q
      wg_commit();
    }
    prev = st;
  }
  wg_wait_all();
  fence_regs(dka);
  fence_regs(dva);
  if (prev >= 0) mbar_arrive(&empty[prev]);

  // ----------------------------------------------------------- epilogue
  if constexpr (WANT_DK) {
    const int64_t rs = (int64_t)H * D;
    const int64_t o = ((int64_t)b * Sk * H + h) * D;
#pragma unroll
    for (int r = 0; r < C::OREG; r += 2) {
      const int j = (r % 4) >= 2 ? jb : ja;
      const int col = acc_col(lane, r);
      if (j < Sk && col < D) {
        store2(dk + o + j * rs + col, dka[r], dka[r + 1]);
        if constexpr (PART == BOTH) store2(dv + o + j * rs + col, dva[r], dva[r + 1]);
      }
    }
  } else {
    const int64_t rs = (int64_t)H * DV;
    const int64_t o = ((int64_t)b * Sk * H + h) * DV;
#pragma unroll
    for (int r = 0; r < C::OREGV; r += 2) {
      const int j = (r % 4) >= 2 ? jb : ja;
      const int col = acc_col(lane, r);
      if (j < Sk && col < DV) store2(dv + o + j * rs + col, dva[r], dva[r + 1]);
    }
  }
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, const void* dO, const float* lse,
           float* Dsum, __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv, int64_t B,
           int64_t Sq, int64_t Sk, int64_t H, Strides sq, Strides sk, Strides sv, Strides sdo,
           float scale, int causal, int q_off, int device, cudaStream_t stream) {
  using C = Cfg<D, DV>;
  CUtensorMap tq, tk, tv, tdo;
  int rc;
  if ((rc = cached_map(&tq, q, B, Sq, H, D, sq)) != 0) return rc;
  if ((rc = cached_map(&tk, k, B, Sk, H, D, sk)) != 0) return rc;
  if ((rc = cached_map(&tv, v, B, Sk, H, DV, sv)) != 0) return rc;
  if ((rc = cached_map(&tdo, dO, B, Sq, H, DV, sdo)) != 0) return rc;
  const size_t smem = C::SMEM;
  static bool done_dq[64] = {}, done_kv[64] = {}, done_k[64] = {};   // per device
  auto kq = flash_bwd_dq_kernel<D, DV>;
  auto kkv = flash_bwd_dkdv_kernel<D, DV, C::SPLIT_KV ? DV_ONLY : BOTH>;
  if ((rc = set_smem(kq, smem, done_dq, device)) != 0) return rc;
  if ((rc = set_smem(kkv, smem, done_kv, device)) != 0) return rc;
  const int64_t n_qt = (Sq + BT - 1) / BT, n_kt = (Sk + BT - 1) / BT;
  if (B * H > 0x7fffffff || n_qt > 65535 || n_kt > 65535) return -1;
  kq<<<dim3((unsigned)(B * H), (unsigned)n_qt), THREADS, smem, stream>>>(
      tq, tk, tv, tdo, lse, Dsum, dq, (int)Sq, (int)Sk, (int)H, (int)n_qt, scale, causal, q_off);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kkv<<<dim3((unsigned)(B * H), (unsigned)n_kt), THREADS, smem, stream>>>(
      tq, tk, tv, tdo, lse, Dsum, dk, dv, (int)Sq, (int)Sk, (int)H, scale, causal, q_off);
  if constexpr (C::SPLIT_KV) {
    auto kk = flash_bwd_dkdv_kernel<D, DV, DK_ONLY>;
    if ((rc = set_smem(kk, smem, done_k, device)) != 0) return rc;
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    kk<<<dim3((unsigned)(B * H), (unsigned)n_kt), THREADS, smem, stream>>>(
        tq, tk, tv, tdo, lse, Dsum, dk, dv, (int)Sq, (int)Sk, (int)H, scale, causal, q_off);
  }
  return (int)cudaGetLastError();
}

}  // namespace bf16

// ------------------------------------------------------------- the entry

// the launches of input type T at the pair (D, DV)
template <typename T, int D, int DV>
int launch_typed(const void* q, const void* k, const void* v, const void* dO, const float* lse,
                 float* Dsum, void* dq, void* dk, void* dv, int64_t B, int64_t Sq, int64_t Sk,
                 int64_t H, Strides sq, Strides sk, Strides sv, Strides sdo, float scale,
                 int causal, int q_off, int dev, cudaStream_t st) {
  if constexpr (std::is_same<T, float>::value)
    return tf32::launch<D, DV>((const float*)q, (const float*)k, (const float*)v,
                               (const float*)dO, lse, Dsum, (float*)dq, (float*)dk, (float*)dv,
                               B, Sq, Sk, H, sq, sk, sv, sdo, scale, causal, q_off, dev, st);
  else
    return bf16::launch<D, DV>(q, k, v, dO, lse, Dsum, (__nv_bfloat16*)dq, (__nv_bfloat16*)dk,
                               (__nv_bfloat16*)dv, B, Sq, Sk, H, sq, sk, sv, sdo, scale, causal,
                               q_off, dev, st);
}

// The entry of a translation unit built for input type T (its dtype code:
// 0 float32, 1 bfloat16): argument checks, then the launches of the built
// pair (D, Dv).
template <typename T>
int run(int dtype_code, const void* q, const void* k, const void* v, const void* dO,
        const void* lse, void* Dsum, void* dq, void* dk, void* dv, int64_t B, int64_t Sq,
        int64_t Sk, int64_t H, int64_t D, int64_t Dv, Strides sq, Strides sk, Strides sv,
        Strides sdo, float scale, int causal, int q_off, int dtype, int device, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || B > 65535 || H > 65535 ||
      Sq > ((int64_t)1 << 30) || Sk > ((int64_t)1 << 30) || q_off < 0 ||
      q_off > ((int64_t)1 << 30))
    return -1;
  if (dtype != dtype_code) return -2;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* l = (const float*)lse;
  float* ds = (float*)Dsum;
  cudaStream_t st = (cudaStream_t)stream;
#define PAIR(DK_, DV_)                                                                      \
  if (D == DK_ && Dv == DV_)                                                                \
    return launch_typed<T, DK_, DV_>(q, k, v, dO, l, ds, dq, dk, dv, B, Sq, Sk, H, sq, sk, sv, \
                                  sdo, scale, causal, q_off, device, st);
  PAIR(16, 16)
  PAIR(32, 32)
  PAIR(64, 64)
  PAIR(96, 96)
  PAIR(128, 128)
  PAIR(192, 128)
#undef PAIR
  return -1;
}

}  // namespace
