// The flash-attention backward for Hopper (sm_90a), on the tensor cores.
//
// Replaces no Pallas kernel: the JAX package's backward is XLA code
// (src/repro/models/attention.py:_flash_bwd_rule under flash_attention_vjp),
// and the port ran its plain version (ref.flash_attention_bwd) on the card
// in every training step.  It computes what that plain version computes:
//
//   q, do (B,Sq,H,D), k, v (B,Sk,H,D) (GQA callers expand K/V first), lse
//   (B,H,Sq) float32 as the forward stores it  ->  dq, dk, dv in q's type,
//   p  = exp(scale q.k^T - lse), masked as the forward masks (causal with
//        the query offset q_off, ragged Sq and Sk), 0 where masked
//   dp = do.v^T,  Dr = rowsum(p * dp) / rowsum(p) over all keys (the port's
//        D, from the recomputed p; not sum(do * o), see ref.py)
//   ds = p * (dp - Dr) * scale,  dq = ds.k,  dk = ds^T.q,  dv = p^T.do
//
// for D in {16, 32, 64, 96, 128}.  Both routes take two launches on the
// same stream and are deterministic (no atomics; each output element is
// written by one thread of one block): a dq pass, one block per (64-row q
// tile, head, batch), that first walks the key tiles for Dr (stored for
// the second launch) and then walks them again for dq; and a dk/dv pass,
// one block per (64-key tile, head, batch), over the q tiles whose rows
// see the key tile.  The grids walk the tiles with the most work first.
//
// What bounds it (flash_attention_cuda.flash_bwd_cost): the five products
// over the causal pairs.  At zamba2-1.2b's training shape (B=2, S=512,
// H=32, D=64, causal) they are 5.38 GFLOP: 5.4 us at bf16's tensor-core
// rate, 32.6 us at the 3xTF32 rate, against 8.8 us (bf16) of bytes; at
// pixtral-12b's (B=2, S=1280, H=32, D=128) 67.9 us of bf16 operations.
// Both routes recompute S and dP in the dq pass (Dr needs every key before
// any dS), so each does seven products' work where the function needs five.
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
//   Shared memory (Cfg<D>::SMEM, 1 KiB of alignment): two resident tiles
//   and ST stages of two, a tile 8 KiB at D <= 64 (ST 3: 65 KiB) and 16
//   KiB above (two 64-column boxes, ST 2: 97 KiB); two blocks an SM, but
//   one at D > 64 in the dk/dv pass (two accumulators of 64 floats).
//
// float32 (namespace tf32): 3xTF32 on tf32 wgmma.  A float32 operand is
//   split into hi = x truncated to tf32 and lo = x - hi (hopper.cuh's
//   Round::trunc, tiles.cuh) and a product is lo.hi + hi.lo + hi.hi; tf32
//   wgmma reads shared memory K-major
//   only, so the products over the sequence read transposed copies (K^T,
//   Q^T, dO^T) that the producers stage (tiles.cuh).  One consumer
//   warpgroup and one producer warpgroup in the dq pass; two consumer
//   warpgroups in the dk/dv pass (warpgroup 0 S^T, P^T and dv, warpgroup 1
//   S^T again, dP^T, dS^T and dk: one accumulator each keeps D = 128 inside
//   168 registers).  Units of 32 KiB (64 x 64 float32 as tf32 hi and lo);
//   2 NC resident (NC = 64-column chunks of D: 1 at D <= 64, 2 above) and
//   a ring of 4 (3 at NC = 2), + 1 KiB of alignment: 193 KiB at D <= 64,
//   225 KiB above.  One block a SM.
//
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

template <int D>
struct Cfg {
  static constexpr int NC = (D + 63) / 64;             // 64-column chunks of D
  static constexpr int ST = NC == 1 ? 4 : 3;           // ring slots
  static constexpr size_t SMEM = 1024 + (size_t)UNIT * (2 * NC + ST);
  // k steps of chunk c of a product over D
  static __device__ __forceinline__ int ks(int c) { return min(8, (D - 64 * c) / 8); }
};

// the dq pass

template <int D>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dO,
                    const float* __restrict__ lse, float* __restrict__ Dsum, float* __restrict__ dq, int Sq, int Sk, int H,
                    int n_qt, Strides sq, Strides sk, Strides sv, Strides sdo, float scale,
                    int causal, int q_off) {
  using C = Cfg<D>;
  constexpr int NC = C::NC, ST = C::ST;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * MAX_ST];
  uint8_t* base = align1024(smem_raw);
  uint8_t* sQ = base;                  // NC units
  uint8_t* sdO = base + NC * UNIT;     // NC units
  uint8_t* ring = base + 2 * NC * UNIT;
  uint64_t* res_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + MAX_ST;

  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * BT;   // most key tiles first
  const int n_kt = key_tiles(q0, BT, Sq, Sk, causal, q_off);
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(res_full, 128);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {
    // ------------------------------------------------------ producers
    const int ptid = tid - 128;
    const int rq = min(BT, Sq - q0);
    RowTile<128> rt;
    ColTile<128> ct;
    const float* qb = q + b * sq.b + h * sq.h + (int64_t)q0 * sq.s;
    const float* db = dO + b * sdo.b + h * sdo.h + (int64_t)q0 * sdo.s;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      rt.load(qb + 64 * c, sq.s, rq, D - 64 * c, true, NoScale{}, ptid);
      rt.store(sQ + c * UNIT, ptid);
      rt.load(db + 64 * c, sdo.s, rq, D - 64 * c, true, NoScale{}, ptid);
      rt.store(sdO + c * UNIT, ptid);
    }
    fence_async_shared();
    mbar_arrive(res_full);
    RingOut<ST> out{full, empty, ring, 0};
    const float* kb = k + b * sk.b + h * sk.h;
    const float* vb = v + b * sv.b + h * sv.h;
    for (int pass = 0; pass < 2; ++pass) {
      for (int t = 0; t < n_kt; ++t) {
        const int rk = min(BT, Sk - t * BT);
        const float* kt = kb + (int64_t)t * BT * sk.s;
        const float* vt = vb + (int64_t)t * BT * sv.s;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          rt.load(kt + 64 * c, sk.s, rk, D - 64 * c, true, NoScale{}, ptid);
          rt.store(out.acquire(), ptid);
          out.publish();
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          rt.load(vt + 64 * c, sv.s, rk, D - 64 * c, true, NoScale{}, ptid);
          rt.store(out.acquire(), ptid);
          out.publish();
        }
        if (pass == 1) {
#pragma unroll
          for (int c = 0; c < NC; ++c) {   // K^T: rows d, K the key index
            ct.load(kt + 64 * c, sk.s, rk, D - 64 * c, true, NoScale{}, ptid);
            ct.store(out.acquire(), ptid);
            out.publish();
          }
        }
      }
    }
    return;
  }

  // ------------------------------------------------------- consumers
  const int warp = tid / 32, lane = tid % 32;
  const int ia = q0 + acc_row(warp, lane, 0), ib = ia + 8;
  const float* lrow = lse + ((int64_t)b * H + h) * Sq;
  const float la = ia < Sq ? lrow[ia] * LOG2E : 0.f, lb = ib < Sq ? lrow[ib] * LOG2E : 0.f;
  const float sl2 = scale * LOG2E;
  RingIn<ST> in{full, empty, ring, 0};
  float s[32], dp[32];

  // S = Q.K^T into s and dP = dO.V^T into dp for the next key tile
  auto products = [&]() {
    int slot[NC];
    zero(s);
#pragma unroll
    for (int c = 0; c < NC; ++c) slot[c] = in.take();
    wg_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
      mma_ss(s, smem_u32(sQ + c * UNIT), in.addr(slot[c]), C::ks(c));
    wg_commit();
    wg_wait_all();
    fence_regs(s);
#pragma unroll
    for (int c = 0; c < NC; ++c) in.give(slot[c]);
    zero(dp);
#pragma unroll
    for (int c = 0; c < NC; ++c) slot[c] = in.take();
    wg_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
      mma_ss(dp, smem_u32(sdO + c * UNIT), in.addr(slot[c]), C::ks(c));
    wg_commit();
    wg_wait_all();
    fence_regs(dp);
#pragma unroll
    for (int c = 0; c < NC; ++c) in.give(slot[c]);
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
    products();
    probs(t * BT);
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

  // the dq pass: dq = sum over key tiles of dS.K
  float acc[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c) zero(acc[c]);
  uint32_t ah[32], al[32];
  for (int t = 0; t < n_kt; ++t) {
    products();
    probs(t * BT);
#pragma unroll
    for (int r = 0; r < 32; ++r) s[r] = s[r] * (dp[r] - ((r % 4) >= 2 ? Db : Da)) * scale;
    pack_a(s, ah, al);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int sl = in.take();
      wg_fence();
      mma_rs(acc[c], ah, al, in.addr(sl));
      wg_commit();
      wg_wait_all();
      fence_regs(acc[c]);
      in.give(sl);
    }
  }

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

template <int D>
__global__ void __launch_bounds__(384, 1)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dO,
                      const float* __restrict__ lse, const float* __restrict__ Dsum,
                      float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int H,
                      Strides sq, Strides sk, Strides sv, Strides sdo, float scale, int causal,
                      int q_off) {
  using C = Cfg<D>;
  constexpr int NC = C::NC, ST = C::ST;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * MAX_ST];
  uint8_t* base = align1024(smem_raw);
  uint8_t* sK = base;                  // NC units
  uint8_t* sV = base + NC * UNIT;      // NC units
  uint8_t* ring = base + 2 * NC * UNIT;
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
    mbar_init(res_full, 128);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ------------------------------------------------------ producers
    const int ptid = tid - 256;
    const int rk = min(BT, Sk - k0);
    RowTile<128> rt;
    ColTile<128> ct;
    const float* kt = k + b * sk.b + h * sk.h + (int64_t)k0 * sk.s;
    const float* vt = v + b * sv.b + h * sv.h + (int64_t)k0 * sv.s;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      rt.load(kt + 64 * c, sk.s, rk, D - 64 * c, true, NoScale{}, ptid);
      rt.store(sK + c * UNIT, ptid);
      rt.load(vt + 64 * c, sv.s, rk, D - 64 * c, true, NoScale{}, ptid);
      rt.store(sV + c * UNIT, ptid);
    }
    fence_async_shared();
    mbar_arrive(res_full);
    RingOut<ST> out{full, empty, ring, 0};
    const float* qb = q + b * sq.b + h * sq.h;
    const float* db = dO + b * sdo.b + h * sdo.h;
    for (int it = it0; it < n_qt; ++it) {
      const int rq = min(BT, Sq - it * BT);
      const float* qt = qb + (int64_t)it * BT * sq.s;
      const float* dt = db + (int64_t)it * BT * sdo.s;
#pragma unroll
      for (int c = 0; c < NC; ++c) {   // Q rows (S^T)
        rt.load(qt + 64 * c, sq.s, rq, D - 64 * c, true, NoScale{}, ptid);
        rt.store(out.acquire(), ptid);
        out.publish();
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {   // dO rows (dP^T)
        rt.load(dt + 64 * c, sdo.s, rq, D - 64 * c, true, NoScale{}, ptid);
        rt.store(out.acquire(), ptid);
        out.publish();
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {   // dO^T (dv)
        ct.load(dt + 64 * c, sdo.s, rq, D - 64 * c, true, NoScale{}, ptid);
        ct.store(out.acquire(), ptid);
        out.publish();
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {   // Q^T (dk)
        ct.load(qt + 64 * c, sq.s, rq, D - 64 * c, true, NoScale{}, ptid);
        ct.store(out.acquire(), ptid);
        out.publish();
      }
    }
    return;
  }

  // ------------------------------------------------------- consumers
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const bool is_dk = wg == 1;
  const int ja = k0 + acc_row(warp, lane, 0), jb = ja + 8;   // this thread's keys
  const float* lrow = lse + ((int64_t)b * H + h) * Sq;
  const float* drow = Dsum + ((int64_t)b * H + h) * Sq;
  const float sl2 = scale * LOG2E;
  RingIn<ST> in{full, empty, ring, 0};
  float acc[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c) zero(acc[c]);
  float s[32], dp[32];
  uint32_t ah[32], al[32];

  // d = A (resident) . B^T (the next NC units), both over D
  auto over_d = [&](float (&d)[32], uint8_t* a) {
    int slot[NC];
    zero(d);
#pragma unroll
    for (int c = 0; c < NC; ++c) slot[c] = in.take();
    wg_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
      mma_ss(d, smem_u32(a + c * UNIT), in.addr(slot[c]), C::ks(c));
    wg_commit();
    wg_wait_all();
    fence_regs(d);
#pragma unroll
    for (int c = 0; c < NC; ++c) in.give(slot[c]);
  };
  // acc += (A fragments) . (the next NC units), over the q tile's 64 rows
  auto over_q = [&]() {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int sl = in.take();
      wg_fence();
      mma_rs(acc[c], ah, al, in.addr(sl));
      wg_commit();
      wg_wait_all();
      fence_regs(acc[c]);
      in.give(sl);
    }
  };
  auto skip = [&]() {
#pragma unroll
    for (int c = 0; c < NC; ++c) in.skip();
  };

  mbar_wait(res_full, 0);
  for (int it = it0; it < n_qt; ++it) {
    const int i0 = it * BT;
    over_d(s, sK);                            // S^T = K.Q^T: rows keys, columns q
    const bool edge = i0 + BT > Sq || (causal && k0 + BT - 1 > i0 + q_off);
#pragma unroll
    for (int r = 0; r < 32; ++r) {            // P^T
      const int i = i0 + acc_col(lane, r), j = (r % 4) >= 2 ? jb : ja;
      const bool keep = !edge || (i < Sq && !(causal && j > i + q_off));
      s[r] = keep ? exp2f(s[r] * sl2 - __ldg(lrow + i) * LOG2E) : 0.f;
    }
    if (!is_dk) {
      skip();                                 // dO rows
      pack_a(s, ah, al);
      over_q();                               // dv += P^T.dO
      skip();                                 // Q^T
    } else {
      over_d(dp, sV);                         // dP^T = V.dO^T
#pragma unroll
      for (int r = 0; r < 32; ++r) {          // dS^T
        const int i = i0 + acc_col(lane, r);
        const float Dr = i < Sq ? __ldg(drow + i) : 0.f;
        dp[r] = s[r] * (dp[r] - Dr) * scale;
      }
      pack_a(dp, ah, al);
      skip();                                 // dO^T
      over_q();                               // dk += dS^T.Q
    }
  }

  // ----------------------------------------------------------- epilogue
  const int64_t rs = (int64_t)H * D;
  float* out = (is_dk ? dk : dv) + ((int64_t)b * Sk * H + h) * D;
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


template <int D>
int launch(const float* q, const float* k, const float* v, const float* dO, const float* lse,
           float* Dsum, float* dq, float* dk, float* dv, int64_t B, int64_t Sq, int64_t Sk,
           int64_t H, Strides sq, Strides sk, Strides sv, Strides sdo, float scale, int causal,
           int q_off, int device, cudaStream_t stream) {
  // 16-byte-aligned bases, strides of whole 16 bytes (the wrapper copies
  // what fails)
  const void* ptrs[] = {q, k, v, dO};
  const Strides strides[] = {sq, sk, sv, sdo};
  for (int i = 0; i < 4; ++i)
    if ((uintptr_t)ptrs[i] % 16 || strides[i].b % 4 || strides[i].s % 4 || strides[i].h % 4)
      return -3;
  const size_t smem = Cfg<D>::SMEM;
  static bool done_dq[64] = {}, done_kv[64] = {};   // per device
  auto kq = flash_bwd_dq_kernel<D>;
  auto kkv = flash_bwd_dkdv_kernel<D>;
  int rc;
  if ((rc = set_smem(kq, smem, done_dq, device)) != 0) return rc;
  if ((rc = set_smem(kkv, smem, done_kv, device)) != 0) return rc;
  const int64_t n_qt = (Sq + BT - 1) / BT, n_kt = (Sk + BT - 1) / BT;
  if (B * H > 0x7fffffff || n_qt > 65535 || n_kt > 65535) return -1;
  kq<<<dim3((unsigned)(B * H), (unsigned)n_qt), 256, smem, stream>>>(
      q, k, v, dO, lse, Dsum, dq, (int)Sq, (int)Sk, (int)H, (int)n_qt, sq, sk, sv, sdo, scale,
      causal, q_off);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kkv<<<dim3((unsigned)(B * H), (unsigned)n_kt), 384, smem, stream>>>(
      q, k, v, dO, lse, Dsum, dk, dv, (int)Sq, (int)Sk, (int)H, sq, sk, sv, sdo, scale, causal,
      q_off);
  return (int)cudaGetLastError();
}

}  // namespace tf32


// ===================================================== bfloat16: bf16 wgmma

namespace bf16 {

constexpr int MAX_ST = 3;
constexpr int THREADS = 128 + 32;     // a consumer warpgroup, a producer warp

template <int D>
struct Cfg {
  static constexpr int DP = (D + 63) / 64 * 64;   // columns in shared memory
  static constexpr int CH = DP / 64;              // boxes of a tile
  static constexpr int KS = D / 16;               // k steps of a product over D
  static constexpr int OREG = DP / 2;             // floats a thread of a 64 x DP accumulator
  static constexpr int TILE = CH * BOX_BYTES;     // bytes of a 64-row tile
  static constexpr int ST = D <= 64 ? 3 : 2;      // ring stages of two tiles
  static constexpr size_t SMEM = 1024 + (size_t)TILE * (2 + 2 * ST);
  static constexpr int KV_BLOCKS = D <= 64 ? 2 : 1;   // dk/dv blocks an SM
};

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
// MN-major (the transpose bit): lo terms, then hi
template <int DP>
__device__ __forceinline__ void mma_over_rows(float (&d)[DP / 2], const uint32_t (&hi)[16],
                                              const uint32_t (&lo)[16], uint32_t b) {
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    const uint32_t* a = part == 0 ? lo : hi;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = desc_mnmajor(b + kk * 16 * 128);
      if constexpr (DP == 128)
        wgmma_rs_n128(d, a + 4 * kk, db);
      else
        wgmma_rs_n64(d, a + 4 * kk, db);
    }
  }
}

// the dq pass

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse, float* __restrict__ Dsum,
                    __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H, int n_qt, float scale,
                    int causal, int q_off) {
  using C = Cfg<D>;
  constexpr int ST = C::ST;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * MAX_ST];
  uint8_t* base = align1024(smem_raw);
  uint8_t* sQ = base;
  uint8_t* sdO = base + C::TILE;
  uint8_t* ring = base + 2 * C::TILE;    // stage s: K at ring + 2 s TILE, V after it
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
      mbar_expect_tx(res_full, 2 * C::TILE);
      for (int c = 0; c < C::CH; ++c) {
        tma_load_4d(sQ + c * BOX_BYTES, &tq, res_full, c * 64, h, q0, b);
        tma_load_4d(sdO + c * BOX_BYTES, &tdo, res_full, c * 64, h, q0, b);
      }
      int n = 0;
      for (int pass = 0; pass < 2; ++pass) {
        for (int t = 0; t < n_kt; ++t, ++n) {
          const int s = n % ST;
          mbar_wait(&empty[s], ((n / ST) & 1) ^ 1);
          mbar_expect_tx(&full[s], 2 * C::TILE);
          uint8_t* st = ring + s * 2 * C::TILE;
          for (int c = 0; c < C::CH; ++c) {
            tma_load_4d(st + c * BOX_BYTES, &tk, &full[s], c * 64, h, t * BT, b);
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
    const uint32_t kt = smem_u32(ring + st * 2 * C::TILE);
    zero(s);
    zero(dp);
    wg_fence();
    mma_over_d<D>(s, aQ, kt);
    wg_commit();
    mma_over_d<D>(dp, adO, kt + C::TILE);
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
    mma_over_rows<C::DP>(acc, hi, lo, smem_u32(ring + st * 2 * C::TILE));
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

template <int D>
__global__ void __launch_bounds__(THREADS, Cfg<D>::KV_BLOCKS)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                      const float* __restrict__ Dsum, __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H, float scale,
                      int causal, int q_off) {
  using C = Cfg<D>;
  constexpr int ST = C::ST;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * MAX_ST];
  // each stage's q rows: lse * log2(e), then Dr (0 past Sq)
  __shared__ float rows[MAX_ST][2][BT];
  uint8_t* base = align1024(smem_raw);
  uint8_t* sK = base;
  uint8_t* sV = base + C::TILE;
  uint8_t* ring = base + 2 * C::TILE;    // stage s: Q at ring + 2 s TILE, dO after it
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
      mbar_expect_tx(res_full, 2 * C::TILE);
      for (int c = 0; c < C::CH; ++c) {
        tma_load_4d(sK + c * BOX_BYTES, &tk, res_full, c * 64, h, k0, b);
        tma_load_4d(sV + c * BOX_BYTES, &tv, res_full, c * 64, h, k0, b);
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
        mbar_expect_tx(&full[s], 2 * C::TILE);
        uint8_t* st = ring + s * 2 * C::TILE;
        for (int c = 0; c < C::CH; ++c) {
          tma_load_4d(st + c * BOX_BYTES, &tq, &full[s], c * 64, h, it * BT, b);
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
  float dka[C::OREG], dva[C::OREG];
  zero(dka);
  zero(dva);
  float s[32], dp[32];
  uint32_t hi[16], lo[16];

  mbar_wait(res_full, 0);
  int n = 0, prev = -1;
  for (int it = it0; it < n_qt; ++it, ++n) {
    const int st = n % ST;
    mbar_wait(&full[st], (n / ST) & 1);
    const uint32_t aQ = smem_u32(ring + st * 2 * C::TILE), adO = aQ + C::TILE;
    zero(s);
    zero(dp);
    wg_fence();
    mma_over_d<D>(s, aK, aQ);     // S^T = K.Q^T: rows keys, columns q
    wg_commit();
    mma_over_d<D>(dp, aV, adO);   // dP^T = V.dO^T
    wg_commit();
    wg_wait_one();                // the previous dS^T.Q and S^T are in
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
    pack_hl(s, hi, lo);
    wg_fence();
    mma_over_rows<C::DP>(dva, hi, lo, adO);   // dV += P^T.dO
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
    prev = st;
  }
  wg_wait_all();
  fence_regs(dka);
  fence_regs(dva);
  if (prev >= 0) mbar_arrive(&empty[prev]);

  // ----------------------------------------------------------- epilogue
  const int64_t rs = (int64_t)H * D;
  const int64_t o = ((int64_t)b * Sk * H + h) * D;
#pragma unroll
  for (int r = 0; r < C::OREG; r += 2) {
    const int j = (r % 4) >= 2 ? jb : ja;
    const int col = acc_col(lane, r);
    if (j < Sk && col < D) {
      store2(dk + o + j * rs + col, dka[r], dka[r + 1]);
      store2(dv + o + j * rs + col, dva[r], dva[r + 1]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dO, const float* lse,
           float* Dsum, __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv, int64_t B,
           int64_t Sq, int64_t Sk, int64_t H, Strides sq, Strides sk, Strides sv, Strides sdo,
           float scale, int causal, int q_off, int device, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int rc;
  if ((rc = cached_map(&tq, q, B, Sq, H, D, sq)) != 0) return rc;
  if ((rc = cached_map(&tk, k, B, Sk, H, D, sk)) != 0) return rc;
  if ((rc = cached_map(&tv, v, B, Sk, H, D, sv)) != 0) return rc;
  if ((rc = cached_map(&tdo, dO, B, Sq, H, D, sdo)) != 0) return rc;
  const size_t smem = Cfg<D>::SMEM;
  static bool done_dq[64] = {}, done_kv[64] = {};   // per device
  auto kq = flash_bwd_dq_kernel<D>;
  auto kkv = flash_bwd_dkdv_kernel<D>;
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
  return (int)cudaGetLastError();
}

}  // namespace bf16

// ------------------------------------------------------------- the entry

// the launches of input type T at head dim D
template <typename T, int D>
int launch_typed(const void* q, const void* k, const void* v, const void* dO, const float* lse,
                 float* Dsum, void* dq, void* dk, void* dv, int64_t B, int64_t Sq, int64_t Sk,
                 int64_t H, Strides sq, Strides sk, Strides sv, Strides sdo, float scale,
                 int causal, int q_off, int dev, cudaStream_t st) {
  if constexpr (std::is_same<T, float>::value)
    return tf32::launch<D>((const float*)q, (const float*)k, (const float*)v, (const float*)dO,
                           lse, Dsum, (float*)dq, (float*)dk, (float*)dv, B, Sq, Sk, H, sq, sk,
                           sv, sdo, scale, causal, q_off, dev, st);
  else
    return bf16::launch<D>(q, k, v, dO, lse, Dsum, (__nv_bfloat16*)dq, (__nv_bfloat16*)dk,
                           (__nv_bfloat16*)dv, B, Sq, Sk, H, sq, sk, sv, sdo, scale, causal,
                           q_off, dev, st);
}

// The entry of a translation unit built for input type T (its dtype code:
// 0 float32, 1 bfloat16): argument checks, then the two launches.
template <typename T>
int run(int dtype_code, const void* q, const void* k, const void* v, const void* dO,
        const void* lse, void* Dsum, void* dq, void* dk, void* dv, int64_t B, int64_t Sq,
        int64_t Sk, int64_t H, int64_t D, Strides sq, Strides sk, Strides sv, Strides sdo,
        float scale, int causal, int q_off, int dtype, int device, void* stream) {
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
  switch (D) {
    case 16:
      return launch_typed<T, 16>(q, k, v, dO, l, ds, dq, dk, dv, B, Sq, Sk, H, sq, sk, sv, sdo,
                                 scale, causal, q_off, device, st);
    case 32:
      return launch_typed<T, 32>(q, k, v, dO, l, ds, dq, dk, dv, B, Sq, Sk, H, sq, sk, sv, sdo,
                                 scale, causal, q_off, device, st);
    case 64:
      return launch_typed<T, 64>(q, k, v, dO, l, ds, dq, dk, dv, B, Sq, Sk, H, sq, sk, sv, sdo,
                                 scale, causal, q_off, device, st);
    case 96:
      return launch_typed<T, 96>(q, k, v, dO, l, ds, dq, dk, dv, B, Sq, Sk, H, sq, sk, sv, sdo,
                                 scale, causal, q_off, device, st);
    case 128:
      return launch_typed<T, 128>(q, k, v, dO, l, ds, dq, dk, dv, B, Sq, Sk, H, sq, sk, sv, sdo,
                                  scale, causal, q_off, device, st);
    default: return -1;
  }
}

}  // namespace
