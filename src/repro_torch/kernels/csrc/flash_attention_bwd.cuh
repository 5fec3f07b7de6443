// The flash-attention backward for Hopper (sm_90a), on the tensor cores
// at float32 accuracy (3xTF32).
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
// for D in {16, 32, 64, 96, 128}, float32 or bfloat16, q, k, v and do read
// through their (batch, sequence, head) strides (the last dimension
// contiguous; the wrapper copies what 16-byte-aligned loads cannot read).
//
// Precision.  Every product runs on tf32 wgmma with float32 accumulation.
// A float32 operand is split into hi = tf32(x) and lo = tf32(x - hi) and a
// product is lo.hi + hi.lo + hi.hi (hopper.cuh).  A bf16 input is exact in
// TF32, so a product of two bf16 operands (q.k^T, do.v^T) is one TF32
// product, exact as bf16 wgmma's, and a product of a bf16 operand with a
// float32 p or ds splits only the latter (2xTF32): p and ds keep float32
// accuracy, as in the plain version.  tests/test_torch_bwd_kernels.py
// repeats this arithmetic on the CPU.
//
// What bounds it: at zamba2-1.2b's training shape (B=2, S=512, H=32, D=64,
// causal) the five products over the causal pairs are 2.7 GFLOP, 5.4 us at
// bf16's tensor-core rate and 16.3 us at the 3xTF32 rate, against 10.1 us
// (bf16) and 20.1 us (float32) of bytes.  This first kernel computes more
// than the five: S and dP twice (the D pass and the dq pass; the dk/dv
// pass's two warpgroups each recompute S).
//
// Design: two launches, deterministic (no atomics; each output element is
// written by one thread of one block).
//   dq pass, flash_bwd_dq_kernel: one block per (64-row q tile, head,
//   batch), of one consumer warpgroup and one producer warpgroup.  The
//   producers stage the Q and dO tiles once (resident units) and stream the
//   key tiles the causal rows need twice through a ring: first K and V as
//   they lie (S = Q.K^T and dP = dO.V^T, for the row sums of p * dp and p:
//   Dr, stored for the second launch), then K, V and K^T (dS.K, the key
//   index permuted as pack_a stages dS).  dq stays in registers.
//   dk/dv pass, flash_bwd_dkdv_kernel: one block per (64-key tile, head,
//   batch), of two consumer warpgroups and one producer warpgroup.  K and V
//   are resident; for each q tile whose rows see the key tile the producers
//   stream Q, dO, dO^T and Q^T.  Warpgroup 0 computes S^T = K.Q^T, P^T and
//   dv += P^T.dO; warpgroup 1 computes S^T, dP^T = V.dO^T, dS^T and dk +=
//   dS^T.Q.  Each holds one accumulator (D / 2 floats a thread at most 64),
//   which is what keeps D = 128 inside the 168 registers of 384 threads.
// Shared memory: units of 32 KiB (64 x 64 float32 as tf32 hi and lo); 2 NC
// resident (NC = 64-column chunks of D: 1 at D <= 64, 2 above) and a ring
// of 4 (3 at NC = 2) units, + 1 KiB of alignment: 193 KiB at D <= 64, 225
// KiB above.  One block a SM.

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

namespace {

constexpr int BT = 64;                        // rows of a q tile and a key tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_ST = 4;

struct Strides {
  int64_t b, s, h;
};

template <int D>
struct Cfg {
  static constexpr int NC = (D + 63) / 64;             // 64-column chunks of D
  static constexpr int ST = NC == 1 ? 4 : 3;           // ring slots
  static constexpr size_t SMEM = 1024 + (size_t)UNIT * (2 * NC + ST);
  // k steps of chunk c of a product over D
  static __device__ __forceinline__ int ks(int c) { return min(8, (D - 64 * c) / 8); }
};

// key tiles the causal rows [q0, q0 + rows) need (the forward's tiles_for)
__device__ __forceinline__ int key_tiles(int q0, int rows, int Sq, int Sk, int causal, int q_off) {
  const int n = (Sk + BT - 1) / BT;
  return causal ? min(n, (min(q0 + rows, Sq) - 1 + q_off) / BT + 1) : n;
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b) {
  if constexpr (std::is_same<T, float>::value)
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  else
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ------------------------------------------------------------ the dq pass

template <int D, typename T>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dO, const float* __restrict__ lse,
                    float* __restrict__ Dsum, T* __restrict__ dq, int Sq, int Sk, int H,
                    int n_qt, Strides sq, Strides sk, Strides sv, Strides sdo, float scale,
                    int causal, int q_off) {
  using C = Cfg<D>;
  constexpr int NC = C::NC, ST = C::ST;
  constexpr bool LO = std::is_same<T, float>::value;
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
    RowTile<128, LO> rt;
    ColTile<128, LO> ct;
    const T* qb = q + b * sq.b + h * sq.h + (int64_t)q0 * sq.s;
    const T* db = dO + b * sdo.b + h * sdo.h + (int64_t)q0 * sdo.s;
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
    const T* kb = k + b * sk.b + h * sk.h;
    const T* vb = v + b * sv.b + h * sv.h;
    for (int pass = 0; pass < 2; ++pass) {
      for (int t = 0; t < n_kt; ++t) {
        const int rk = min(BT, Sk - t * BT);
        const T* kt = kb + (int64_t)t * BT * sk.s;
        const T* vt = vb + (int64_t)t * BT * sv.s;
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
      mma_ss<LO, LO>(s, smem_u32(sQ + c * UNIT), in.addr(slot[c]), C::ks(c));
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
      mma_ss<LO, LO>(dp, smem_u32(sdO + c * UNIT), in.addr(slot[c]), C::ks(c));
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
      mma_rs<LO>(acc[c], ah, al, in.addr(sl));
      wg_commit();
      wg_wait_all();
      fence_regs(acc[c]);
      in.give(sl);
    }
  }

  // ----------------------------------------------------------- epilogue
  const int64_t rs = (int64_t)H * D;
  T* out = dq + ((int64_t)b * Sq * H + h) * D;
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

// --------------------------------------------------------- the dk/dv pass

template <int D, typename T>
__global__ void __launch_bounds__(384, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dO,
                      const float* __restrict__ lse, const float* __restrict__ Dsum,
                      T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H,
                      Strides sq, Strides sk, Strides sv, Strides sdo, float scale, int causal,
                      int q_off) {
  using C = Cfg<D>;
  constexpr int NC = C::NC, ST = C::ST;
  constexpr bool LO = std::is_same<T, float>::value;
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
    RowTile<128, LO> rt;
    ColTile<128, LO> ct;
    const T* kt = k + b * sk.b + h * sk.h + (int64_t)k0 * sk.s;
    const T* vt = v + b * sv.b + h * sv.h + (int64_t)k0 * sv.s;
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
    const T* qb = q + b * sq.b + h * sq.h;
    const T* db = dO + b * sdo.b + h * sdo.h;
    for (int it = it0; it < n_qt; ++it) {
      const int rq = min(BT, Sq - it * BT);
      const T* qt = qb + (int64_t)it * BT * sq.s;
      const T* dt = db + (int64_t)it * BT * sdo.s;
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
      mma_ss<LO, LO>(d, smem_u32(a + c * UNIT), in.addr(slot[c]), C::ks(c));
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
      mma_rs<LO>(acc[c], ah, al, in.addr(sl));
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
  T* out = (is_dk ? dk : dv) + ((int64_t)b * Sk * H + h) * D;
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

// ------------------------------------------------------------- launches

template <typename K>
int set_smem(K kern, size_t smem, bool* done, int device) {
  if (device >= 0 && device < 64 && done[device]) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (device >= 0 && device < 64) done[device] = true;
  return 0;
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, const void* dO, const float* lse,
           float* Dsum, void* dq, void* dk, void* dv, int64_t B, int64_t Sq, int64_t Sk,
           int64_t H, Strides sq, Strides sk, Strides sv, Strides sdo, float scale, int causal,
           int q_off, int device, cudaStream_t stream) {
  // 16-byte-aligned bases, strides of whole 16 bytes (8-byte loads of bf16
  // need half of it; the wrapper copies what fails)
  const void* ptrs[] = {q, k, v, dO};
  const Strides strides[] = {sq, sk, sv, sdo};
  constexpr int64_t per16 = 16 / sizeof(T);
  for (int i = 0; i < 4; ++i)
    if ((uintptr_t)ptrs[i] % 16 || strides[i].b % per16 || strides[i].s % per16 ||
        strides[i].h % per16)
      return -3;
  const size_t smem = Cfg<D>::SMEM;
  static bool done_dq[64] = {}, done_kv[64] = {};   // per device
  auto kq = flash_bwd_dq_kernel<D, T>;
  auto kkv = flash_bwd_dkdv_kernel<D, T>;
  int rc;
  if ((rc = set_smem(kq, smem, done_dq, device)) != 0) return rc;
  if ((rc = set_smem(kkv, smem, done_kv, device)) != 0) return rc;
  const int64_t n_qt = (Sq + BT - 1) / BT, n_kt = (Sk + BT - 1) / BT;
  if (B * H > 0x7fffffff || n_qt > 65535 || n_kt > 65535) return -1;
  kq<<<dim3((unsigned)(B * H), (unsigned)n_qt), 256, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dO, lse, Dsum, (T*)dq, (int)Sq, (int)Sk,
      (int)H, (int)n_qt, sq, sk, sv, sdo, scale, causal, q_off);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kkv<<<dim3((unsigned)(B * H), (unsigned)n_kt), 384, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dO, lse, Dsum, (T*)dk, (T*)dv, (int)Sq,
      (int)Sk, (int)H, sq, sk, sv, sdo, scale, causal, q_off);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int64_t D, const void* q, const void* k, const void* v, const void* dO,
             const float* lse, float* Dsum, void* dq, void* dk, void* dv, int64_t B, int64_t Sq,
             int64_t Sk, int64_t H, Strides sq, Strides sk, Strides sv, Strides sdo,
             float scale, int causal, int q_off, int dev, cudaStream_t st) {
  switch (D) {
    case 16:
      return launch<16, T>(q, k, v, dO, lse, Dsum, dq, dk, dv, B, Sq, Sk, H, sq, sk, sv, sdo,
                           scale, causal, q_off, dev, st);
    case 32:
      return launch<32, T>(q, k, v, dO, lse, Dsum, dq, dk, dv, B, Sq, Sk, H, sq, sk, sv, sdo,
                           scale, causal, q_off, dev, st);
    case 64:
      return launch<64, T>(q, k, v, dO, lse, Dsum, dq, dk, dv, B, Sq, Sk, H, sq, sk, sv, sdo,
                           scale, causal, q_off, dev, st);
    case 96:
      return launch<96, T>(q, k, v, dO, lse, Dsum, dq, dk, dv, B, Sq, Sk, H, sq, sk, sv, sdo,
                           scale, causal, q_off, dev, st);
    case 128:
      return launch<128, T>(q, k, v, dO, lse, Dsum, dq, dk, dv, B, Sq, Sk, H, sq, sk, sv, sdo,
                            scale, causal, q_off, dev, st);
    default: return -1;
  }
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
  return dispatch<T>(D, q, k, v, dO, (const float*)lse, (float*)Dsum, dq, dk, dv, B, Sq, Sk, H,
                     sq, sk, sv, sdo, scale, causal, q_off, device, (cudaStream_t)stream);
}

}  // namespace
