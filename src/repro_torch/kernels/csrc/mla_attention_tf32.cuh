// MLA's absorbed attention in float32 on tf32 wgmma fed by TMA (sm_90a,
// 3xTF32): the float32 route of mla_attention.cu, which includes this file
// and describes the function, both routes' designs and what bounds each
// launch in its header.
//
// Units.  Every operand a product reads from shared memory is a tiles.cuh
// unit: 64 rows by 64 K-major columns, its tf32 hi part, then its lo part
// (32 KiB), in a ring of slots that one thread loads in a fixed order and
// both consumer warpgroups walk, each giving every unit back, the one that
// reads it once its products are done (tiles.cuh's RingIn).  Three kinds:
// - a row unit (64 rows of q, k, v or do, 64 of their columns) arrives raw
//   by TMA through a float32 tensor map over (D, 1, rows, B), 32 columns x
//   64 rows a box, zeros past the edges, into its hi half as it lies: the
//   tensor core reads a tf32 operand's top 19 bits, so the raw value is its
//   hi, truncated.  As the A operand (Q, dO) it is read into registers by
//   ldmatrix and its lo formed there; as the B operand (K, V) the consumer
//   warpgroup that reads it writes its lo = x - trunc(x) (lo_pass) first;
// - a transposed unit that every row tile reads alike (V^T, K^T: the B
//   operand of a product over keys) is built once a call in global memory
//   (mla_tunits_tf32_kernel) and arrives whole by one bulk copy;
// - a transposed unit of a row tile's rows (Q^T, dO^T in the keys launch)
//   arrives raw into its lo half, and a producer warpgroup builds hi^T and
//   lo^T from it (transpose_unit).
// Transposed units order their K index as pack_a orders a register A
// operand.  A chunk is 64 columns of Dk or Dv (9 and 8 at full width); a
// product skips the k steps past the width, and a narrower head loads
// fewer boxes.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mla_attention_wgmma.cuh"
#include "tiles.cuh"
#include "tma.cuh"

namespace {
namespace mlatf {

constexpr int BM = 64;                   // rows of a row tile
constexpr int KT = 64;                   // keys of a key tile (the scratch's key padding)
constexpr int ROW_CHUNK = 32;            // row tiles of a dK / dV chunk
constexpr int SLAB = 4;                  // chunks of a dK / dV block's columns
constexpr int THREADS = 384;             // two consumer warpgroups + a loading warpgroup
constexpr int ROWS_THREADS = 288;        // two consumer warpgroups + a loading warp
constexpr int FWD_ST = 6, ROWS_ST = 6, KEYS_ST = 7;   // ring slots of each launch
// setmaxnreg: the registers of a loading (producer) thread and of a consumer
// thread, the forward's (mlawg's 40 and 232) and the keys launch's (whose
// producers transpose): 40 x 128 + 232 x 256 and 80 x 128 + 200 x 256 at
// most 384 x 168, what the block holds (more, and the consumers' increase
// waits forever)
constexpr int KEYS_PRODUCER_REGS = 80, KEYS_CONSUMER_REGS = 200;

using mlawg::bar_arrive;
using mlawg::bar_sync;
using mlawg::CONSUMER_REGS;
using mlawg::lmax;
using mlawg::lmin;
using mlawg::LN2;
using mlawg::LOG2E;
using mlawg::NEG_INF;
using mlawg::PRODUCER_REGS;
using mlawg::ThreadRows;

__host__ __device__ __forceinline__ int chunks(int64_t d) { return (int)((d + 63) / 64); }
// 32-column boxes of chunk c of a d-wide tensor, and its 8-wide k steps
__device__ __forceinline__ int nboxes(int d, int c) { return (min(64, d - 64 * c) + 31) / 32; }
__device__ __forceinline__ int ksteps(int d, int c) { return min(8, (d - 64 * c) / 8); }

template <int N = PRODUCER_REGS>
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N = CONSUMER_REGS>
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// the source of a ring unit: boxes [col, col + 32 nb) x rows [row, row + 64)
// of a tensor map, or (`made`) a unit built whole in global memory by
// mla_tunits_tf32_kernel
struct Src {
  const CUtensorMap* map;
  int col, row, nb;
  const float* made;
};

// The producer warpgroup of the keys launch: transposed units 0 .. total -
// 1 (`unit(n)` their sources) into ring slot n % ST, each landing raw on
// the slot's landed mbarrier, transposed by every thread and published on
// its full one.  Thread 0 issues the TMA loads: at unit n's turn, those of
// every later unit whose slot is already free (it never waits for a slot
// ahead of its turn), so that their latency overlaps the transposes.
template <int ST, typename U>
__device__ __forceinline__ void produce(U unit, int total, uint8_t* ring, uint64_t* full,
                                        uint64_t* empty, uint64_t* landed, int b, int ptid) {
  const auto issue = [&](const Src& u, int n) {
    const int s = n % ST;
    mbar_wait(&empty[s], ((n / ST) & 1) ^ 1);
    mbar_expect_tx(&landed[s], u.nb * UBOX);
    uint8_t* dst = ring + s * UNIT + UNIT_HALF;
    for (int x = 0; x < u.nb; ++x)
      tma_load_4d(dst + x * UBOX, u.map, &landed[s], u.col + 32 * x, 0, u.row, b);
  };
  int issued = 0;   // thread 0: the units whose loads it has issued
  for (int n = 0; n < total; ++n) {
    const Src u = unit(n);
    const int s = n % ST;
    if (ptid == 0) {
      if (issued == n) issue(u, n), ++issued;
      while (issued < total && issued < n + ST &&
             mbar_test(&empty[issued % ST], ((issued / ST) & 1) ^ 1))
        issue(unit(issued), issued), ++issued;
    }
    mbar_wait(&landed[s], (n / ST) & 1);
    transpose_unit(ring + s * UNIT, u.nb, ptid);
    fence_async_shared();
    asm volatile("barrier.sync 1, 128;\n" ::: "memory");   // every thread's part is in
    if (ptid == 0) mbar_arrive(&full[s]);
  }
}

// The loading thread: units 0 .. total - 1 (`unit(n)` their sources) into
// ring slot n % ST once it is free (the slot's full and empty mbarriers,
// bars[s] and bars[ST + s]), each landing on its full barrier: a row unit
// raw in its hi half, a made unit whole.
template <int ST, typename U>
__device__ __forceinline__ void load_units(U unit, int total, uint8_t* ring, uint64_t* bars,
                                           int b) {
  uint64_t* full = bars;
  uint64_t* empty = bars + ST;
  for (int n = 0; n < total; ++n) {
    const Src u = unit(n);
    const int s = n % ST;
    mbar_wait(&empty[s], ((n / ST) & 1) ^ 1);
    if (u.made != nullptr) {   // one bulk copy of the whole unit
      mbar_expect_tx(&full[s], UNIT);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(smem_u32(ring + s * UNIT)),
          "l"(u.made), "r"(UNIT), "r"(smem_u32(&full[s]))
          : "memory");
      continue;
    }
    mbar_expect_tx(&full[s], u.nb * UBOX);
    for (int x = 0; x < u.nb; ++x)
      tma_load_4d(ring + s * UNIT + x * UBOX, u.map, &full[s], u.col + 32 * x, 0, u.row, b);
  }
}

// The transposed units of a (B, S, D) float32 tensor x that every row tile
// reads alike (V^T in the forward, K^T in the rows launch), built once a
// call into global memory as the image a ring slot holds: unit (b, t, c)
// is element (r, slot of jj) = x[b, 64 t + jj, 64 c + r], jj permuted as
// pack_a orders P and dS, hi (raw) then lo, zero past S and D.  A block of
// 128 threads a unit, each thread transpose_unit's 4 x 4 blocks.
__global__ void __launch_bounds__(128)
    mla_tunits_tf32_kernel(const float* __restrict__ x, float* __restrict__ units, int S, int D) {
  const int nch = chunks(D), t = (int)blockIdx.x / nch, c = (int)blockIdx.x % nch;
  const int64_t b = blockIdx.y;
  const float* src = x + (b * S + (int64_t)t * KT) * D + 64 * c;
  const int rows = min(KT, S - t * KT), cols = min(64, D - 64 * c);
  uint8_t* out = reinterpret_cast<uint8_t*>(units) +
                 ((b * gridDim.x + blockIdx.x) * (int64_t)UNIT);
  const int ptid = threadIdx.x, cc = ptid % 16, jj0 = 8 * (cc >> 1) + (cc & 1);
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int g = ptid / 16 + 8 * m;
    float4 v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int jj = jj0 + 2 * q;
      v[q] = jj < rows && 4 * g < cols
                 ? __ldg(reinterpret_cast<const float4*>(src + (int64_t)jj * D + 4 * g))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 o = make_float4(get(v[0], i), get(v[1], i), get(v[2], i), get(v[3], i));
      const uint32_t off = sw_off(4 * g + i, 4 * cc, UROWS);
      *reinterpret_cast<float4*>(out + off) = o;
      *reinterpret_cast<float4*>(out + UNIT_HALF + off) = lo4(o);
    }
  }
}

// floats of the transposed units of a (B, S, D) tensor
__host__ __device__ __forceinline__ int64_t tunits_floats(int64_t B, int64_t S, int64_t D) {
  return B * ((S + KT - 1) / KT) * chunks(D) * (UNIT / 4);
}

// d (64 x 64) += A . B^T over `ks` k steps, 3xTF32, with A a raw row
// unit (its hi half as TMA landed it) read into registers: each k step's
// fragments by one ldmatrix (a 32-bit element is two 16-bit halves, so
// the four 8 x 8 matrices are A's rows g and g + 8 at columns t and t + 4
// as the tf32 fragment orders them), hi the raw value (the tensor core
// truncates it), lo = x - trunc(x) beside it (64 registers a thread); B a
// split unit.  The products are waited for before the registers are free.
// A needs no lo half in shared memory and is read once, not three times:
// half the bytes an SS product reads.
__device__ __forceinline__ void mma_rs_raw(float (&d)[32], uint32_t a, uint32_t b, int ks,
                                           int wtid) {
  const int lane = wtid % 32;
  const int row = (wtid / 32) * 16 + lane % 8 + 8 * ((lane / 8) & 1), col = 4 * (lane / 16);
  uint32_t ah[32], al[32];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t addr = a + sw_off(row, 8 * j + col, UROWS);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(ah[4 * j]), "=r"(ah[4 * j + 1]), "=r"(ah[4 * j + 2]), "=r"(ah[4 * j + 3])
                 : "r"(addr));
  }
#pragma unroll
  for (int i = 0; i < 32; ++i)
    al[i] = __float_as_uint(__uint_as_float(ah[i]) - __uint_as_float(ah[i] & 0xFFFFE000u));
  wg_fence();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < ks) {
      const uint64_t bh = desc_k(b, j, UROWS);
      wgmma_tf32_rs_n64(d, al + 4 * j, bh);
      wgmma_tf32_rs_n64(d, ah + 4 * j, desc_k(b + UNIT_HALF, j, UROWS));
      wgmma_tf32_rs_n64(d, ah + 4 * j, bh);
    }
  }
  wg_commit();
  wg_wait_all();
  fence_regs(d);
}

// A row unit's lo half, by the consumer warpgroup that reads it, made
// visible to its products (every thread's part: its own named barrier,
// 5 + wg)
__device__ __forceinline__ void split_row_unit(uint8_t* unit, int nb, int wg, int wtid) {
  lo_pass(unit, nb, wtid);
  fence_async_shared();
  bar_sync(5 + wg, 128);
}

// the ring's barriers: full 1 (the TMA's expect_tx), empty 256 (every
// consumer thread)
template <int ST>
__device__ __forceinline__ void init_ring(uint64_t* bars) {
  for (int s = 0; s < ST; ++s) {
    mbar_init(&bars[s], 1);
    mbar_init(&bars[ST + s], 256);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the row tile of block i: the last tiles (most keys under the causal
// mask) first, batch rows interleaved; n_kt key tiles of KT its rows see
struct Tile {
  int64_t r0, M;
  int b, n_kt;
  __device__ __forceinline__ Tile(int i, int n_rt, int B, int Sq, int Sk, int H, int causal) {
    M = (int64_t)Sq * H;
    r0 = (int64_t)(n_rt - 1 - i / B) * BM;
    b = i % B;
    const int64_t last = (lmin(r0 + BM, M) - 1) / H;
    const int kv_end = causal ? (int)lmin(Sk, last + 1) : Sk;
    n_kt = (kv_end + KT - 1) / KT;
  }
};

// ------------------------------------------------------------- forward
//
// A block per row tile.  For each key tile the loading thread streams Q's
// and K's units chunk by chunk (Q_c, K_c), then the made V^T units (a chunk
// of Dv each).  Warpgroup w computes the partial S = sum over its chunks
// c = w (mod 2) of Q_c.K_c^T (Q_c read raw into registers, K_c split in
// place); the two partials pass through shared memory and each warpgroup
// adds the other's (a + b = b + a: both hold the same S), takes the online
// softmax and O[:, 256 w ..] += P.V over its four V^T units, P split once
// in registers as the A operand.  O stays in registers, 128 accumulators a
// thread; it leaves from them.

// dynamic shared memory: the ring and the two partials, + 1 KiB of alignment
__host__ __device__ __forceinline__ size_t fwd_smem() {
  return 1024 + (size_t)FWD_ST * UNIT + (size_t)2 * BM * KT * 4;
}

__global__ void __launch_bounds__(THREADS, 1)
    mla_fwd_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const float* __restrict__ vt, float* __restrict__ o,
                        float* __restrict__ lse, int Sq, int Sk, int H, int Dk, int Dv, int n_rt,
                        int B, float scale_log2, int causal) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * FWD_ST];
  uint8_t* ring = align1024(smem_raw);
  float* xS = reinterpret_cast<float*>(ring + FWD_ST * UNIT);   // [warpgroup][32][128]

  const Tile tile((int)blockIdx.x, n_rt, B, Sq, Sk, H, causal);
  const int64_t r0 = tile.r0, M = tile.M;
  const int n_kt = tile.n_kt;
  const int nkc = chunks(Dk), nvc = chunks(Dv);
  const int nv0 = min(nvc, 4), nv1 = nvc - nv0;   // V^T units of warpgroups 0 and 1
  const int n_kt_all = (Sk + KT - 1) / KT;         // key tiles of the made V^T units
  const int per = 2 * nkc + nvc;                  // units a key tile
  const int tid = threadIdx.x;

  if (tid == 0) init_ring<FWD_ST>(bars);
  __syncthreads();

  if (tid >= 256) {
    // ---------------------------------------------- loading warpgroup
    producer_regs();
    if (tid != 256) return;
    // a key tile's units: Q_0, K_0, ..., Q_8, K_8, then V^T 0, 4, 1, 5, 2, 6, 3, 7
    const auto unit = [&](int n) {
      const int t = n / per, i = n % per;
      if (i < 2 * nkc) {
        const int c = i / 2;
        return (i & 1) ? Src{&tk, 64 * c, t * KT, nboxes(Dk, c), nullptr}
                       : Src{&tq, 64 * c, (int)r0, nboxes(Dk, c), nullptr};
      }
      const int j = i - 2 * nkc;
      const int v = j < 2 * nv1 ? ((j & 1) ? 4 + j / 2 : j / 2) : j - nv1;
      const int64_t made = ((int64_t)tile.b * n_kt_all + t) * nvc + v;
      return Src{nullptr, 0, 0, 0, vt + made * (UNIT / 4)};
    };
    load_units<FWD_ST>(unit, n_kt * per, ring, bars, tile.b);
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  // Named barriers (0 is __syncthreads): 2 both partials are in, 3 + w
  // warpgroup w's partial buffer has been read, 5 + w warpgroup w's own.
  consumer_regs();
  const int wg = tid / 128, wtid = tid % 128, lane = tid % 32;
  const ThreadRows rows(wtid, r0, M, H);
  const int64_t first = r0 / H;   // the tile's first position
  RingIn<FWD_ST> in{bars, bars + FWD_ST, ring, 0};
  float* mine = xS + wg * 4096;
  const float* other = xS + (1 - wg) * 4096;
  float oa[4][32];
#pragma unroll
  for (int i = 0; i < 4; ++i) zero(oa[i]);
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * KT;
    // this warpgroup's partial S; a slot is given back as soon as the
    // products that read it are done (holding one for longer, to split the
    // next chunk's units under the products, measured slower: the ring is
    // what the loads wait for)
    float sc[32];
    zero(sc);
    for (int c = 0; c < nkc; ++c) {
      const int sq = in.take(), sk = in.take();
      if ((c & 1) == wg) {
        split_row_unit(ring + sk * UNIT, nboxes(Dk, c), wg, wtid);
        mma_rs_raw(sc, in.addr(sq), in.addr(sk), ksteps(Dk, c), wtid);
      }
      in.give(sq);
      in.give(sk);
    }
    // S = both partials
    if (t > 0) bar_sync(3 + wg, 256);
#pragma unroll
    for (int r = 0; r < 32; ++r) mine[r * 128 + wtid] = sc[r];
    bar_sync(2, 256);
#pragma unroll
    for (int r = 0; r < 32; ++r) sc[r] += other[r * 128 + wtid];
    if (t < n_kt - 1) bar_arrive(4 - wg, 256);

    // the online softmax (log2 units), as the bf16 kernel takes it
    const bool edge = k0 + KT > Sk || r0 + BM > M || (causal && k0 + KT - 1 > first);
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      float x = sc[r] * scale_log2;
      if (edge && rows.masked(r, k0, Sk, causal)) x = NEG_INF;
      sc[r] = x;
      if ((r % 4) < 2) mx0 = fmaxf(mx0, x);
      else mx1 = fmaxf(mx1, x);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      if ((r % 4) < 2) {
        sc[r] = exp2f(sc[r] - mn0);
        rs0 += sc[r];
      } else {
        sc[r] = exp2f(sc[r] - mn1);
        rs1 += sc[r];
      }
    }
    l0 = l0 * a0 + rs0;   // this thread's columns; the row's four join at the end
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 32; ++r) oa[i][r] *= (r % 4) < 2 ? a0 : a1;

    // O += P.V over this warpgroup's V^T units (the stream's order), P split
    // into A fragments once
    uint32_t ah[32], al[32];
    pack_a(sc, ah, al);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        if (i < (side ? nv1 : nv0)) {
          const int s = in.take();
          if (side == wg) {
            wg_fence();
            mma_rs(oa[i], ah, al, in.addr(s));
            wg_commit();
            wg_wait_all();
            fence_regs(oa[i]);
          }
          in.give(s);
        }
      }
    }
  }

  // ----------------------------------------------------------- epilogue
  l0 = row_sum4(l0);
  l1 = row_sum4(l1);
  const int b = tile.b;
  if (lse != nullptr && wg == 0 && lane % 4 == 0) {
    const float ls[2] = {(m0 + log2f(fmaxf(l0, 1e-30f))) * LN2,
                         (m1 + log2f(fmaxf(l1, 1e-30f))) * LN2};
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (rows.ok[i]) lse[((int64_t)b * H + rows.R[i] % H) * Sq + rows.pos[i]] = ls[i];
  }
  const float inv[2] = {1.f / fmaxf(l0, 1e-30f), 1.f / fmaxf(l1, 1e-30f)};
  float* ob = o + (int64_t)b * M * Dv;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int r = 0; r < 32; r += 2) {
      const int h = (r % 4) >= 2;
      const int col = 256 * wg + 64 * i + (r / 4) * 8 + rows.cq;
      if (rows.ok[h] && col < Dv)
        *reinterpret_cast<float2*>(ob + rows.R[h] * Dv + col) =
            make_float2(oa[i][r] * inv[h], oa[i][r + 1] * inv[h]);
    }
}

// ------------------------------------------------------------ backward
//
// 1. rows (mla_bwd_rows_tf32_kernel), a block per row tile.  Pass 1, for
//    each key tile: warpgroup 0 computes S = Q.K^T over Dk's chunks and
//    warpgroup 1 dP = dO.V^T over Dv's (Q_c, K_c, dO_c, V_c in the stream,
//    Q and dO read raw into registers); warpgroup 0 forms P = exp(scale S -
//    lse), writes it to the scratch and hands it to warpgroup 1 through
//    shared memory, which sums p * dp a row and writes dP to the dS
//    scratch.  Pass 2: the port's D = rowsum(p dp) / rowsum(p), and dS =
//    P (dP - D) scale over dP, each warpgroup every other key tile.  Pass
//    3: dQ = dS.K a chunk of Dk at a time (warpgroup w the chunks c = w mod
//    2): dS read back from the scratch into registers, split as the A
//    operand, K^T a made unit a (key tile, chunk).  S and dP are computed
//    once: 1.0x the least products (the bf16 route recomputes them).  The
//    scratch is key-major, (B, keys_pad, rows_pad), so that the keys launch
//    reads a dS^T (P^T) tile in the accumulator layout with 8-byte loads.
// 2. keys (mla_bwd_keys_tf32_kernel): a block per (128 keys, slab of four
//    chunks of dK or dV, batch row x chunk of 32 row tiles), two consumer
//    warpgroups (64 keys each) and a producer warpgroup.  For each row tile
//    that sees its keys the producers transpose the slab's Q^T (dO^T)
//    units, which both consumers read; each consumer reads its dS^T (P^T)
//    tile from the scratch into registers (while the row tile before runs
//    its products), splits it as the A operand and issues dK += dS^T.Q (dV
//    += P^T.dO), 128 accumulators a thread, into the chunk's float32
//    partial.  Each scratch tile is read once a slab: dS three times, P
//    twice.
// 3. finish (mla_attention.cu): the chunks' partials summed in order.

__host__ __device__ __forceinline__ size_t rows_smem() {
  return 1024 + (size_t)ROWS_ST * UNIT + (size_t)BM * KT * 4;
}

__host__ __device__ __forceinline__ size_t keys_smem() { return 1024 + (size_t)KEYS_ST * UNIT; }

// element r of a thread's accumulator tile at key tile k0: its offset in a
// batch row's transposed scratch (key-major, rows_pad rows a key)
__device__ __forceinline__ int64_t tpos(const ThreadRows& rows, int r, int64_t r0, int k0,
                                        int64_t rows_pad) {
  const int key = k0 + (r / 4) * 8 + rows.cq + (r % 2);
  return (int64_t)key * rows_pad + r0 + rows.row0 + ((r % 4) >= 2 ? 8 : 0);
}

__global__ void __launch_bounds__(ROWS_THREADS, 1)
    mla_bwd_rows_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo,
                             const float* __restrict__ kt, const float* __restrict__ lse,
                             float* __restrict__ P,
                             float* __restrict__ dS, float* __restrict__ dq, int Sq, int Sk, int H,
                             int Dk, int Dv, int n_rt, int B, int64_t rows_pad, int64_t keys_pad,
                             float scale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * ROWS_ST];
  __shared__ float rsum[2][BM];   // a row's sum of p (warpgroup 0) and of p dp (1)
  uint8_t* ring = align1024(smem_raw);
  float* xP = reinterpret_cast<float*>(ring + ROWS_ST * UNIT);   // [32][128] a thread's P

  const Tile tile((int)blockIdx.x, n_rt, B, Sq, Sk, H, causal);
  const int64_t r0 = tile.r0, M = tile.M;
  const int b = tile.b, n_kt = tile.n_kt;
  const int nkc = chunks(Dk), nvc = chunks(Dv), nmin = min(nkc, nvc);
  const int per1 = 2 * (nkc + nvc);      // pass 1's units a key tile
  const int fp = nkc / 2;                // pass 3's chunk pairs with two chunks
  const int tid = threadIdx.x;

  if (tid == 0) init_ring<ROWS_ST>(bars);
  __syncthreads();

  if (tid >= 256) {
    // --------------------------------------------------- loading warp
    if (tid != 256) return;
    // pass 1, a key tile: Q_c, K_c, dO_c, V_c for each chunk c (the wider
    // head's last chunks alone); pass 3: for each pair of Dk's chunks, for
    // each key tile, K^T of both
    const auto unit = [&](int n) {
      if (n < n_kt * per1) {
        const int t = n / per1, i = n % per1;
        int c, kind;
        if (i < 4 * nmin) {
          c = i / 4;
          kind = i % 4;
        } else {
          c = nmin + (i - 4 * nmin) / 2;
          kind = (nkc > nvc ? 0 : 2) + (i - 4 * nmin) % 2;
        }
        const int d = kind < 2 ? Dk : Dv;
        const CUtensorMap* map = kind == 0 ? &tq : kind == 1 ? &tk : kind == 2 ? &tdo : &tv;
        return Src{map, 64 * c, (kind & 1) ? t * KT : (int)r0, nboxes(d, c), nullptr};
      }
      const int j = n - n_kt * per1;
      int t, c;
      if (j < fp * 2 * n_kt) {
        const int r = j % (2 * n_kt);
        c = 2 * (j / (2 * n_kt)) + r % 2;
        t = r / 2;
      } else {
        c = nkc - 1;
        t = j - fp * 2 * n_kt;
      }
      const int64_t made = ((int64_t)b * ((Sk + KT - 1) / KT) + t) * nkc + c;
      return Src{nullptr, 0, 0, 0, kt + made * (UNIT / 4)};
    };
    load_units<ROWS_ST>(unit, n_kt * (per1 + nkc), ring, bars, b);
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  // Named barriers: 2 P is in xP, 3 xP has been read, 4 the row sums are
  // in, 5 + w warpgroup w's own, 7 dS is in the scratch.
  const int wg = tid / 128, wtid = tid % 128, lane = tid % 32;
  const ThreadRows rows(wtid, r0, M, H);
  const int64_t first = r0 / H;
  RingIn<ROWS_ST> in{bars, bars + ROWS_ST, ring, 0};
  float* Pb = P + (int64_t)b * keys_pad * rows_pad;
  float* dSb = dS + (int64_t)b * keys_pad * rows_pad;
  const auto edge_of = [&](int k0) {
    return k0 + KT > Sk || r0 + BM > M || (causal && k0 + KT - 1 > first);
  };
  float lse2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    lse2[i] = rows.ok[i] ? lse[((int64_t)b * H + rows.R[i] % H) * Sq + rows.pos[i]] * LOG2E : 0.f;
  const float scale_log2 = scale * LOG2E;
  float sums[2] = {0.f, 0.f};   // warpgroup 0: sum of p; 1: sum of p dp

  // ------------------------------------------------------------ pass 1
  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * KT;
    float acc[32];   // warpgroup 0: S, warpgroup 1: dP
    zero(acc);
    for (int c = 0; c < max(nkc, nvc); ++c) {
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        if (c < (side ? nvc : nkc)) {
          const int sa = in.take(), sb = in.take();
          if (side == wg) {
            const int d = side ? Dv : Dk;
            split_row_unit(ring + sb * UNIT, nboxes(d, c), wg, wtid);
            mma_rs_raw(acc, in.addr(sa), in.addr(sb), ksteps(d, c), wtid);
          }
          in.give(sa);
          in.give(sb);
        }
      }
    }
    if (wg == 0) {
      const bool edge = edge_of(k0);
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const float p = edge && rows.masked(r, k0, Sk, causal)
                            ? 0.f
                            : exp2f(acc[r] * scale_log2 - lse2[(r % 4) >= 2]);
        acc[r] = p;
        sums[(r % 4) >= 2] += p;
        Pb[tpos(rows, r, r0, k0, rows_pad)] = p;
      }
      if (t > 0) bar_sync(3, 256);
#pragma unroll
      for (int r = 0; r < 32; ++r) xP[r * 128 + wtid] = acc[r];
      bar_arrive(2, 256);
    } else {
      bar_sync(2, 256);
#pragma unroll
      for (int r = 0; r < 32; ++r) sums[(r % 4) >= 2] += xP[r * 128 + wtid] * acc[r];
      if (t < n_kt - 1) bar_arrive(3, 256);
#pragma unroll
      for (int r = 0; r < 32; ++r) dSb[tpos(rows, r, r0, k0, rows_pad)] = acc[r];
    }
  }

  // ------------------------------------------------------------ pass 2
  sums[0] = row_sum4(sums[0]);
  sums[1] = row_sum4(sums[1]);
  if (lane % 4 == 0) {
    rsum[wg][rows.row0] = sums[0];
    rsum[wg][rows.row0 + 8] = sums[1];
  }
  bar_sync(4, 256);
  const float D[2] = {rsum[1][rows.row0] / rsum[0][rows.row0],
                      rsum[1][rows.row0 + 8] / rsum[0][rows.row0 + 8]};
  for (int t = wg; t < n_kt; t += 2) {
    const int k0 = t * KT;
    const bool edge = edge_of(k0);
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int64_t x = tpos(rows, r, r0, k0, rows_pad);
      const float p = Pb[x], dp = dSb[x];
      dSb[x] = edge && rows.masked(r, k0, Sk, causal) ? 0.f : p * (dp - D[(r % 4) >= 2]) * scale;
    }
  }
  bar_sync(7, 256);   // every dS of the tile is in (bar.sync orders global memory too)

  // ------------------------------------------------------------ pass 3
  float* dqb = dq + (int64_t)b * M * Dk;
  for (int cp = 0; cp < (nkc + 1) / 2; ++cp) {
    const bool two = 2 * cp + 1 < nkc;
    const int c = 2 * cp + wg;   // this warpgroup's chunk (if c < nkc)
    float dqa[32];
    zero(dqa);
    for (int t = 0; t < n_kt; ++t) {
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        if (side == 0 || two) {
          if (side == wg) {
            const int s = in.take();
            float v[32];
#pragma unroll
            for (int r = 0; r < 32; ++r) v[r] = dSb[tpos(rows, r, r0, t * KT, rows_pad)];
            uint32_t ah[32], al[32];
            pack_a(v, ah, al);
            wg_fence();
            mma_rs(dqa, ah, al, in.addr(s));
            wg_commit();
            wg_wait_all();
            fence_regs(dqa);
            in.give(s);
          } else {
            in.skip();
          }
        }
      }
    }
    if (c < nkc) {
#pragma unroll
      for (int r = 0; r < 32; r += 2) {
        const int h = (r % 4) >= 2;
        const int col = 64 * c + (r / 4) * 8 + rows.cq;
        if (rows.ok[h] && col < Dk)
          *reinterpret_cast<float2*>(dqb + rows.R[h] * Dk + col) = make_float2(dqa[r], dqa[r + 1]);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    mla_bwd_keys_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tdo,
                             const float* __restrict__ P, const float* __restrict__ dS,
                             float* __restrict__ part, int Sq, int Sk, int H, int Dk, int Dv,
                             int n_kb, int B, int64_t rows_pad, int64_t keys_pad, int causal) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[3 * KEYS_ST];   // full, empty, landed
  uint8_t* ring = align1024(smem_raw);

  const int nkc = chunks(Dk), nvc = chunks(Dv), nks = (nkc + SLAB - 1) / SLAB;
  const int kb = (int)(blockIdx.x % n_kb), sl = (int)(blockIdx.x / n_kb);
  const bool is_k = sl < nks;                        // a slab of dK, or of dV
  const int width = is_k ? Dk : Dv;
  const int ch0 = (is_k ? sl : sl - nks) * SLAB;     // the slab's first chunk
  const int nch = min(SLAB, chunks(width) - ch0);
  const int b = (int)(blockIdx.y % B), chunk = (int)(blockIdx.y / B);
  const int64_t M = (int64_t)Sq * H, n_rt = (M + BM - 1) / BM;
  const int k0 = kb * 2 * KT;                        // the block's first key
  const bool two = k0 + KT < keys_pad;               // its second key tile exists
  // the chunk's row tiles that see the block's first key (row k0 H is the
  // first at position k0)
  int64_t rt_lo = (int64_t)chunk * ROW_CHUNK;
  const int64_t rt_hi = lmin(n_rt, rt_lo + ROW_CHUNK);
  if (causal) rt_lo = lmax(rt_lo, (int64_t)k0 * H / BM);
  const int n = (int)lmax(0, rt_hi - rt_lo);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < KEYS_ST; ++s) mbar_init(&bars[2 * KEYS_ST + s], 1);
    init_ring<KEYS_ST>(bars);
  }
  __syncthreads();

  if (tid >= 256) {
    // ---------------------------------------------- producer warpgroup
    // a row tile's units: the slab's Q^T (dO^T) chunks, rows in pack_a's order
    producer_regs<KEYS_PRODUCER_REGS>();
    const CUtensorMap* mrow = is_k ? &tq : &tdo;
    const auto unit = [&](int u) {
      const int c = ch0 + u % nch;
      return Src{mrow, 64 * c, (int)((rt_lo + u / nch) * BM), nboxes(width, c), nullptr};
    };
    produce<KEYS_ST>(unit, n * nch, ring, bars, bars + KEYS_ST, bars + 2 * KEYS_ST, b,
                     tid - 256);
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  // warpgroup w: keys k0 + 64 w .., the slab's chunks.  Its dS^T (P^T)
  // tile of a row tile is read from the key-major scratch in the
  // accumulator layout, split in registers as the A operand (its rows in
  // pack_a's order, as the units' are), while the products of the row tile
  // before run; a row tile whose rows see none of its keys is skipped (the
  // rows launch wrote no dS there).
  consumer_regs<KEYS_CONSUMER_REGS>();
  const int wg = tid / 128, wtid = tid % 128;
  const int kw = k0 + wg * KT;
  RingIn<KEYS_ST> in{bars, bars + KEYS_ST, ring, 0};
  const ThreadRows rows(wtid, 0, KT, 1);   // rows of the accumulator: keys
  const float* src = (is_k ? dS : P) + (int64_t)b * keys_pad * rows_pad +
                     (int64_t)(kw + rows.row0) * rows_pad + rows.cq;
  float acc[SLAB][32];
#pragma unroll
  for (int j = 0; j < SLAB; ++j) zero(acc[j]);
  uint32_t ah[32], al[32];
  int h0 = 0, nh = 0;   // units h0 .. h0 + nh - 1 (slots h0 % KEYS_ST ..): their products run
  for (int i = 0; i < n; ++i) {
    const int64_t r0 = (rt_lo + i) * BM;
    const int64_t kv_end = causal ? lmin(Sk, (lmin(r0 + BM, M) - 1) / H + 1) : Sk;
    const bool go = (wg == 0 || two) && kw < kv_end;
    float v[32];
    if (go) {
#pragma unroll
      for (int r = 0; r < 32; r += 2) {
        const float2 x = *reinterpret_cast<const float2*>(
            src + ((r % 4) >= 2 ? 8 * rows_pad : 0) + r0 + (r / 4) * 8);
        v[r] = x.x;
        v[r + 1] = x.y;
      }
    }
    if (nh > 0) {
      wg_wait_all();
#pragma unroll
      for (int j = 0; j < SLAB; ++j) fence_regs(acc[j]);
      for (int j = 0; j < nh; ++j) in.give((h0 + j) % KEYS_ST);
      nh = 0;
    }
    if (go) pack_a(v, ah, al);
    h0 = in.n;
#pragma unroll
    for (int j = 0; j < SLAB; ++j) {
      if (j < nch) {
        const int sb = in.take();
        if (go) {
          wg_fence();
          mma_rs(acc[j], ah, al, in.addr(sb));
          wg_commit();
        } else {
          in.give(sb);
        }
      }
    }
    nh = go ? nch : 0;
  }
  wg_wait_all();
#pragma unroll
  for (int j = 0; j < SLAB; ++j) fence_regs(acc[j]);
  for (int j = 0; j < nh; ++j) in.give((h0 + j) % KEYS_ST);
  const int W = Dk + Dv;
  float* pb = part + ((int64_t)chunk * B + b) * Sk * W + (is_k ? 0 : Dk);
#pragma unroll
  for (int j = 0; j < SLAB; ++j)
#pragma unroll
    for (int r = 0; r < 32; r += 2) {
      const int key = kw + rows.row0 + ((r % 4) >= 2 ? 8 : 0);
      const int col = 64 * (ch0 + j) + (r / 4) * 8 + rows.cq;
      if (j < nch && key < Sk && col < width)
        *reinterpret_cast<float2*>(pb + (int64_t)key * W + col) =
            make_float2(acc[j][r], acc[j][r + 1]);
    }
}

// ------------------------------------------------------------ launches

// a (B, rows, D) float32 matrix as TMA reads it: 32-column x 64-row boxes
inline int matrix_map(CUtensorMap* map, const void* ptr, int64_t B, int64_t rows, int64_t D) {
  return cached_map(map, ptr, B, rows, 1, D, Strides{rows * D, D, D}, 4, BM);
}

// the transposed units of x (B, S, D) into `units` (tunits_floats floats)
inline int make_tunits(const void* x, float* units, int64_t B, int64_t S, int D, cudaStream_t st) {
  const int64_t n = (S + KT - 1) / KT * chunks(D);
  if (n > 0x7fffffff) return -1;
  mla_tunits_tf32_kernel<<<dim3((unsigned)n, (unsigned)B), 128, 0, st>>>((const float*)x, units,
                                                                         (int)S, D);
  return (int)cudaGetLastError();
}

// the forward: V^T's units, then the forward launch
inline int fwd(const void* q, const void* k, const void* v, void* o, float* lse, float* units,
               int64_t B, int64_t Sq, int64_t Sk, int64_t H, int Dk, int Dv, float scale,
               int causal, cudaStream_t st) {
  const int64_t M = Sq * H, n_rt = (M + BM - 1) / BM;
  if (n_rt * B > 0x7fffffff) return -1;
  CUtensorMap tq, tk;
  int rc;
  if ((rc = matrix_map(&tq, q, B, M, Dk)) != 0) return rc;
  if ((rc = matrix_map(&tk, k, B, Sk, Dk)) != 0) return rc;
  const size_t smem = fwd_smem();
  if ((rc = mlawg::set_smem((const void*)mla_fwd_tf32_kernel, smem)) != 0) return rc;
  if ((rc = make_tunits(v, units, B, Sk, Dv, st)) != 0) return rc;
  mla_fwd_tf32_kernel<<<(unsigned)(n_rt * B), THREADS, smem, st>>>(
      tq, tk, units, (float*)o, lse, (int)Sq, (int)Sk, (int)H, Dk, Dv, (int)n_rt, (int)B,
      scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

// K^T's units, the rows and keys launches; the caller runs the finishing one
inline int bwd(const void* q, const void* k, const void* v, const float* lse, const void* dout,
               void* P, void* dS, float* part, float* units, void* dq, int64_t B, int64_t Sq,
               int64_t Sk, int64_t H, int Dk, int Dv, float scale, int causal, cudaStream_t st) {
  const int64_t M = Sq * H, n_rt = (M + BM - 1) / BM, rows_pad = n_rt * BM;
  const int64_t keys_pad = (Sk + KT - 1) / KT * KT;
  const int64_t n_kb = (Sk + 2 * KT - 1) / (2 * KT);
  const int64_t chunks_ = (n_rt + ROW_CHUNK - 1) / ROW_CHUNK;
  const int64_t slabs = (chunks(Dk) + SLAB - 1) / SLAB + (chunks(Dv) + SLAB - 1) / SLAB;
  if (n_rt * B > 0x7fffffff || n_kb * slabs > 0x7fffffff || B * chunks_ > 65535) return -1;
  CUtensorMap tq, tk, tv, tdo;
  int rc;
  if ((rc = matrix_map(&tq, q, B, M, Dk)) != 0) return rc;
  if ((rc = matrix_map(&tk, k, B, Sk, Dk)) != 0) return rc;
  if ((rc = matrix_map(&tv, v, B, Sk, Dv)) != 0) return rc;
  if ((rc = matrix_map(&tdo, dout, B, M, Dv)) != 0) return rc;
  const size_t smem_rows = rows_smem(), smem_keys = keys_smem();
  if ((rc = mlawg::set_smem((const void*)mla_bwd_rows_tf32_kernel, smem_rows)) != 0) return rc;
  if ((rc = mlawg::set_smem((const void*)mla_bwd_keys_tf32_kernel, smem_keys)) != 0) return rc;
  if ((rc = make_tunits(k, units, B, Sk, Dk, st)) != 0) return rc;
  mla_bwd_rows_tf32_kernel<<<(unsigned)(n_rt * B), ROWS_THREADS, smem_rows, st>>>(
      tq, tk, tv, tdo, units, lse, (float*)P, (float*)dS, (float*)dq, (int)Sq, (int)Sk,
      (int)H, Dk, Dv, (int)n_rt, (int)B, rows_pad, keys_pad, scale, causal);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mla_bwd_keys_tf32_kernel<<<dim3((unsigned)(n_kb * slabs), (unsigned)(B * chunks_)), THREADS,
                             smem_keys, st>>>(tq, tdo, (const float*)P, (const float*)dS, part,
                                              (int)Sq, (int)Sk, (int)H, Dk, Dv, (int)n_kb, (int)B,
                                              rows_pad, keys_pad, causal);
  return (int)cudaGetLastError();
}

}  // namespace mlatf
}  // namespace
