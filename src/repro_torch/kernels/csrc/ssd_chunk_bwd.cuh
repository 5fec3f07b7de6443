// The backward of one Mamba2 SSD chunk for Hopper (sm_90a), its products
// on the tensor cores at float32 accuracy (3xTF32).
//
// Replaces no Pallas kernel: the JAX package trains through autodiff of
// jax.checkpoint(_chunk_scan_step) (src/repro/models/ssd.py:136-139), XLA
// code, and the port ran its plain version (ref.ssd_chunk_bwd: the plain
// chunk recomputed and differentiated by autograd) on the card in every
// training step.  It gives what that plain version gives: the gradients of
// (y, state') of ssd_chunk.cu's forward with respect to x, dt, A, B, C and
// state, from the inputs and (dy, dstate) alone.  Per (batch b, head h),
// with a = dt A, cum its inclusive prefix sum, L_ij = exp(cum_i - cum_j) for
// j <= i (0 above the diagonal, masked before the exp), w_j = exp(cum_L -
// cum_j) (L the last row), xbar_j = dt_j x_j, G_ij = C_i.B_j and M_ij =
// dy_i.xbar_j:
//
//   dxbar_j = sum_{i>=j} L_ij G_ij dy_i + w_j dstate.B_j,   dx = dxbar dt
//   dB_j    = sum_{i>=j} L_ij M_ij C_i  + w_j dstate^T.xbar_j
//   dC_i    = sum_{j<=i} L_ij M_ij B_j  + exp(cum_i) state^T.dy_i
//   dstate_in = exp(cum_L) dstate + sum_i exp(cum_i) dy_i (x) C_i
//   dcum_k  = sum_{j<k} E_kj - sum_{i>k} E_ik + exp(cum_k) dy_k.(state.C_k)
//             - w_k xbar_k.(dstate.B_k)
//             + [k = L] (sum_j w_j xbar_j.(dstate.B_j) + exp(cum_L) <dstate, state>)
//   with E_ij = L_ij G_ij M_ij off the diagonal (the diagonal's terms cancel
//   exactly and are left out of both sums, so no rounding of them is left:
//   at dt |A| ~ 100 they are ~100x the rest);
//   da = the reverse prefix sum of dcum,  d dt = da A + sum_p dxbar x,
//   dA partial (b, h) = sum_k da_k dt_k (summed over b by the wrapper).
//
//   x (B,Q,H,P), dt (B,Q,H), A (H,), B and C (B,Q,H,N), dy (B,Q,H,P), read
//   through their (batch, row, head) strides (B and C of head stride 0
//   included); state and dstate (B,H,P,N) contiguous  ->  dx (B,Q,H,P), ddt
//   (B,Q,H), dB and dC (B,Q,H,N) (per head: the expand's autograd sums
//   them), dstate_in (B,H,P,N), dA partials (B,H), all float32, contiguous.
//   P <= 64, N <= 128, Q while the shared memory fits (smem_bytes below,
//   ssd_chunk_cuda.ssd_chunk_bwd_smem_bytes).
//
// Precision: every product is hi.hi + hi.lo + lo.hi of tf32 halves
// accumulated in float32 (hopper.cuh), as in the forward;
// tests/test_torch_bwd_kernels.py repeats the arithmetic on the CPU (3xTF32
// holds 1e-4 of the plain backward, 1xTF32 does not).
//
// What bounds it: at zamba2-1.2b's chunk (B=2, Q=256, H=64, P=N=64, B and
// C once per group) ~1.8 GFLOP of products at the 3xTF32 rate (~11 us)
// against ~17 MB of bytes (~5 us): operations.  This kernel computes the
// score products per head and more of them (M and L in both orientations):
// ~4x the forward's work.
//
// Design: one block per (h, b), deterministic (no atomics): a consumer
// warpgroup (warps 0-3) and a producer warpgroup (warps 4-7).  All threads
// first take cum by a block scan.  Then three phases over 64-row tiles, the
// producers staging every operand as a 64 x 64 unit (tiles.cuh) through a
// ring of three, or into the "outer" units a phase holds for a whole tile:
//   1. for each j tile (outer: B_j and xbar_j as they lie): dxbar_j and dB_j
//      in registers, from their state terms and, for every i tile i >= j,
//      G^T = B_j.C_i^T and M^T = xbar_j.dy_i^T (rows j, columns i), masked
//      and decayed, then (L G)^T.dy_i and (L M)^T.C_i; E's row sums (over
//      i, for -sum E_ik) in registers and its column sums (for sum E_kj)
//      across the warps into shared memory;
//   2. for each i tile (outer: dy_i): dC_i from its state term (and its dot
//      with C_i, the state part of dcum) and, for every j <= i, M =
//      dy_i.xbar_j^T, (L M).B_j;
//   3. dstate_in = sum over i tiles of dy_i^T.(exp(cum) C_i), both staged
//      transposed;
// then the consumers take da by a reverse block scan, d dt and the dA
// partial.  Shared memory: 1 KiB of alignment, (N/64 + 1) outer units and 3
// ring units of 32 KiB, and 4 Q floats of per-row sums: 165 KiB at N <= 64,
// Q = 256; one block a SM.

// Each state width is its own translation unit, so nvcc builds the two in
// parallel: ssd_chunk_bwd.cu (N <= 64) and ssd_chunk_bwd_n128.cu (64 < N <=
// 128), each a library with the entry ssd_chunk_bwd.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tiles.cuh"

namespace {

constexpr int T = 64;                 // rows of a tile
constexpr int THREADS = 256;          // consumer warpgroup, producer warpgroup
constexpr int ST = 3;                 // ring slots

struct Str3 {
  int64_t b, q, h;
};

__host__ __device__ __forceinline__ int q_pad(int Q) { return (Q + 3) & ~3; }

size_t smem_bytes(int Q, int N) {
  const int ncn = N <= 64 ? 1 : 2;
  // alignment; outer and ring units; cum, rowE, dc1, xdx (Q each); the
  // column partials (4 warps x 64), the scan's 128 segments, 16 sums
  return 1024 + (size_t)UNIT * (ncn + 1 + ST) + 4 * (4 * (size_t)q_pad(Q) + 256 + 128 + 16);
}

template <int NCN>
__global__ void __launch_bounds__(THREADS, 1)
ssd_chunk_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const float* __restrict__ Bm,
                     const float* __restrict__ Cm, const float* __restrict__ state,
                     const float* __restrict__ dy, const float* __restrict__ dstate,
                     float* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dB,
                     float* __restrict__ dC, float* __restrict__ dstate_in,
                     float* __restrict__ dA_part, int Q, int H, int P, int N, Str3 sx,
                     Str3 sdt, Str3 sB, Str3 sC, Str3 sdy, int vec) {
  extern __shared__ uint8_t smem_raw[];
  // ring full[ST], empty[ST]; outer full, outer empty
  __shared__ __align__(8) uint64_t bars[2 * ST + 2];
  uint8_t* base = align1024(smem_raw);
  uint8_t* outer = base;                        // NCN + 1 units
  uint8_t* ring = base + (NCN + 1) * UNIT;      // ST units
  float* cum = reinterpret_cast<float*>(ring + ST * UNIT);
  const int Qp = q_pad(Q);
  float* rowE = cum + Qp;    // sum_{j<k} E_kj, then + the state part of dcum
  float* dc1 = rowE + Qp;    // -sum_{i>k} E_ik - w_k xbar_k.(dstate.B_k)
  float* xdx = dc1 + Qp;     // sum_p dxbar_k x_k
  float* colred = xdx + Qp;  // [4][64]
  float* seg = colred + 256; // [128]
  float* red = seg + 128;    // [16]
  uint64_t* full = bars;
  uint64_t* empty = bars + ST;
  uint64_t* o_full = bars + 2 * ST;
  uint64_t* o_empty = bars + 2 * ST + 1;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y;
  const float Ah = A[h];
  const float* xb = x + b * sx.b + h * sx.h;
  const float* dtb = dt + b * sdt.b + h * sdt.h;
  const float* Bb = Bm + b * sB.b + h * sB.h;
  const float* Cb = Cm + b * sC.b + h * sC.h;
  const float* dyb = dy + b * sdy.b + h * sdy.h;
  const int64_t sbh = ((int64_t)b * H + h) * P * N;
  const float* st = state + sbh;
  const float* dst = dstate + sbh;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], 128);
    }
    mbar_init(o_full, 128);
    mbar_init(o_empty, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // cum: inclusive prefix sum of dt * A, THREADS rows at a time; rowE = 0
  for (int k = tid; k < Q; k += THREADS) rowE[k] = 0.f;
  float carry = 0.f;
  for (int q0 = 0; q0 < Q; q0 += THREADS) {
    const int qi = q0 + tid;
    float val = qi < Q ? dtb[(int64_t)qi * sdt.q] * Ah : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, val, off);
      if (lane >= off) val += t;
    }
    if (lane == 31) red[warp] = val;
    __syncthreads();
    float before = carry, total = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) {
      if (w < warp) before += red[w];
      total += red[w];
    }
    if (qi < Q) cum[qi] = before + val;
    __syncthreads();
    carry += total;
  }
  __syncthreads();   // the barriers are initialised, cum is complete

  const int nt = (Q + T - 1) / T;
  const float cL = cum[Q - 1];
  const int ksP = min(8, (P + 7) / 8);
  auto ksN = [&](int c) { return min(8, (N - 64 * c + 7) / 8); };

  if (tid >= 128) {
    // -------------------------------------------------------- producers
    const int ptid = tid - 128;
    const bool vx = vec & 1, vb = vec & 2, vc = vec & 4, vs = vec & 8, vy = vec & 16;
    RowTile<128, true> rt;
    ColTile<128, true> ct;
    ColTile<128, true, false> cs;   // a state transposed, beside a RowTile A
    RingOut<ST> out{full, empty, ring, 0};
    int of = 0;   // outer fills
    auto o_acquire = [&]() { mbar_wait(o_empty, (of & 1) ^ 1); };
    auto o_publish = [&]() {
      fence_async_shared();
      mbar_arrive(o_full);
      ++of;
    };
    auto put_rows = [&](const float* src, int64_t ld, int rows, int cols, bool v, auto scale) {
      rt.load(src, ld, rows, cols, v, scale, ptid);
      rt.store(out.acquire(), ptid);
      out.publish();
    };
    auto put_cols = [&](const float* src, int64_t ld, int rows, int cols, bool v, auto scale) {
      ct.load(src, ld, rows, cols, v, scale, ptid);
      ct.store(out.acquire(), ptid);
      out.publish();
    };
    auto put_state_t = [&](const float* src, int c) {   // chunk c of state^T (n, p)
      cs.load(src + 64 * c, N, P, N - 64 * c, vs, NoScale{}, ptid);
      cs.store(out.acquire(), ptid);
      out.publish();
    };
    auto by_dt = [=](int r0) {   // xbar = x dt, row by row
      return [=](int r) { return __ldg(dtb + (int64_t)(r0 + r) * sdt.q); };
    };
    auto by_ecum = [=](int r0) {   // exp(cum_i) C_i
      return [=](int r) { return expf(cum[r0 + r]); };
    };
    // 1. the j tiles
    for (int jt = 0; jt < nt; ++jt) {
      const int j0 = jt * T, nj = min(T, Q - j0);
      o_acquire();
      for (int c = 0; c < NCN; ++c) {
        rt.load(Bb + (int64_t)j0 * sB.q + 64 * c, sB.q, nj, N - 64 * c, vb, NoScale{}, ptid);
        rt.store(outer + c * UNIT, ptid);
      }
      rt.load(xb + (int64_t)j0 * sx.q, sx.q, nj, P, vx, by_dt(j0), ptid);
      rt.store(outer + NCN * UNIT, ptid);
      o_publish();
      for (int c = 0; c < NCN; ++c) put_rows(dst + 64 * c, N, P, N - 64 * c, vs, NoScale{});
      for (int c = 0; c < NCN; ++c) put_state_t(dst, c);
      for (int it = jt; it < nt; ++it) {
        const int i0 = it * T, ni = min(T, Q - i0);
        const float* ci = Cb + (int64_t)i0 * sC.q;
        const float* yi = dyb + (int64_t)i0 * sdy.q;
        for (int c = 0; c < NCN; ++c) put_rows(ci + 64 * c, sC.q, ni, N - 64 * c, vc, NoScale{});
        put_rows(yi, sdy.q, ni, P, vy, NoScale{});
        put_cols(yi, sdy.q, ni, P, vy, NoScale{});
        for (int c = 0; c < NCN; ++c) put_cols(ci + 64 * c, sC.q, ni, N - 64 * c, vc, NoScale{});
      }
    }
    // 2. the i tiles
    for (int it = 0; it < nt; ++it) {
      const int i0 = it * T, ni = min(T, Q - i0);
      o_acquire();
      rt.load(dyb + (int64_t)i0 * sdy.q, sdy.q, ni, P, vy, NoScale{}, ptid);
      rt.store(outer, ptid);
      o_publish();
      for (int c = 0; c < NCN; ++c) put_state_t(st, c);
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * T, nj = min(T, Q - j0);
        put_rows(xb + (int64_t)j0 * sx.q, sx.q, nj, P, vx, by_dt(j0));
        for (int c = 0; c < NCN; ++c)
          put_cols(Bb + (int64_t)j0 * sB.q + 64 * c, sB.q, nj, N - 64 * c, vb, NoScale{});
      }
    }
    // 3. dstate_in's product
    for (int it = 0; it < nt; ++it) {
      const int i0 = it * T, ni = min(T, Q - i0);
      put_cols(dyb + (int64_t)i0 * sdy.q, sdy.q, ni, P, vy, NoScale{});
      for (int c = 0; c < NCN; ++c)
        put_cols(Cb + (int64_t)i0 * sC.q + 64 * c, sC.q, ni, N - 64 * c, vc, by_ecum(i0));
    }
    return;
  }

  // --------------------------------------------------------- consumers
  RingIn<ST> in{full, empty, ring, 0};
  int of = 0;
  const int r0 = warp * 16 + lane / 4;        // this thread's tile rows r0, r0 + 8
  const int64_t qs = (int64_t)H * P, ns = (int64_t)H * N;   // row strides of the outputs
  float* dxo = dx + ((int64_t)b * Q * H + h) * P;
  float* dBo = dB + ((int64_t)b * Q * H + h) * N;
  float* dCo = dC + ((int64_t)b * Q * H + h) * N;
  float g[32], m[32];
  uint32_t ah[32], al[32];
  float wsum = 0.f;   // this thread's rows' w_k xbar_k.(dstate.B_k)

  // d = A (a unit) . B^T over the next `nu` units' chunks
  auto prod_ss = [&](float (&d)[32], uint32_t a, int ks) {
    const int sl = in.take();
    wg_fence();
    mma_ss<true, true>(d, a, in.addr(sl), ks);
    wg_commit();
    wg_wait_all();
    fence_regs(d);
    in.give(sl);
  };
  auto prod_rs = [&](float (&d)[32]) {
    const int sl = in.take();
    wg_fence();
    mma_rs<true>(d, ah, al, in.addr(sl));
    wg_commit();
    wg_wait_all();
    fence_regs(d);
    in.give(sl);
  };
  // a row dot with a global row tile: sum over this thread's columns c0 +
  // acc_col of d[r] * src[row * ld + col] (row r0 or r0 + 8, col < cols),
  // joined over the row's four threads -> (row r0, row r0 + 8)
  auto row_dot = [&](const float (&d)[32], const float* src, int64_t ld, int row_a, int cols,
                     int c0, float& ra, float& rb) {
    float a = 0.f, bsum = 0.f;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const bool lower = (r % 4) >= 2;
      const int row = row_a + (lower ? 8 : 0), col = c0 + acc_col(lane, r);
      if (row < Q && col < cols) {
        const float t = d[r] * __ldg(src + (int64_t)row * ld + col);
        if (lower) bsum += t;
        else a += t;
      }
    }
    ra += row_sum4(a);
    rb += row_sum4(bsum);
  };

  // ------------------------------------------------ 1. the j tiles
  {
    float dxb[32], dBa[NCN][32];
    for (int jt = 0; jt < nt; ++jt) {
      const int j0 = jt * T, ja = j0 + r0, jb = ja + 8;
      const float cja = ja < Q ? cum[ja] : 0.f, cjb = jb < Q ? cum[jb] : 0.f;
      const float wa = ja < Q ? expf(cL - cja) : 0.f, wb = jb < Q ? expf(cL - cjb) : 0.f;
      mbar_wait(o_full, of & 1);
      ++of;
      const uint32_t oB = smem_u32(outer), oX = smem_u32(outer + NCN * UNIT);
      // the state terms: dxbar2 = w (B_j.dstate^T), dB2 = w (xbar_j.dstate)
      zero(dxb);
#pragma unroll
      for (int c = 0; c < NCN; ++c) prod_ss(dxb, oB + c * UNIT, ksN(c));
#pragma unroll
      for (int r = 0; r < 32; ++r) dxb[r] *= (r % 4) >= 2 ? wb : wa;
      float wd_a = 0.f, wd_b = 0.f;           // xbar_j.dxbar2_j
      row_dot(dxb, xb, sx.q, ja, P, 0, wd_a, wd_b);
      wd_a *= ja < Q ? __ldg(dtb + (int64_t)ja * sdt.q) : 0.f;
      wd_b *= jb < Q ? __ldg(dtb + (int64_t)jb * sdt.q) : 0.f;
#pragma unroll
      for (int c = 0; c < NCN; ++c) {
        zero(dBa[c]);
        prod_ss(dBa[c], oX, ksP);
#pragma unroll
        for (int r = 0; r < 32; ++r) dBa[c][r] *= (r % 4) >= 2 ? wb : wa;
      }
      float ce_a = 0.f, ce_b = 0.f;           // sum_{i>j} E_ij of rows ja, jb
      for (int it = jt; it < nt; ++it) {
        const int i0 = it * T;
        zero(g);
        for (int c = 0; c < NCN; ++c) prod_ss(g, oB + c * UNIT, ksN(c));   // G^T
        zero(m);
        prod_ss(m, oX, ksP);                                               // M^T
        float cs[16];                          // column partials of E
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          const bool lower = (r % 4) >= 2;
          const int i = i0 + acc_col(lane, r), j = lower ? jb : ja;
          const bool in_tri = i >= j && i < Q && j < Q;
          const float L = in_tri ? expf(cum[i] - (lower ? cjb : cja)) : 0.f;
          g[r] *= L;
          const float e = i > j ? g[r] * m[r] : 0.f;
          m[r] *= L;
          if (lower) ce_b += e;
          else ce_a += e;
          if (lower) cs[(r / 4) * 2 + (r % 2)] += e;
          else cs[(r / 4) * 2 + (r % 2)] = e;
        }
        // E's column sums over the tile's 64 rows: the warp's eight row
        // groups by shuffles, the four warps through shared memory
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          cs[u] += __shfl_xor_sync(0xffffffffu, cs[u], 4);
          cs[u] += __shfl_xor_sync(0xffffffffu, cs[u], 8);
          cs[u] += __shfl_xor_sync(0xffffffffu, cs[u], 16);
        }
        if (lane < 4) {
#pragma unroll
          for (int u = 0; u < 16; ++u) colred[warp * 64 + (u / 2) * 8 + lane * 2 + (u % 2)] = cs[u];
        }
        wg_sync(1);
        if (tid < 64 && i0 + tid < Q)
          rowE[i0 + tid] += colred[tid] + colred[64 + tid] + colred[128 + tid] + colred[192 + tid];
        wg_sync(1);
        pack_a(g, ah, al);
        prod_rs(dxb);                                                      // (L G)^T.dy_i
        pack_a(m, ah, al);
#pragma unroll
        for (int c = 0; c < NCN; ++c) prod_rs(dBa[c]);                    // (L M)^T.C_i
      }
      mbar_arrive(o_empty);
      // epilogue of the j tile
      float xd_a = 0.f, xd_b = 0.f;
      row_dot(dxb, xb, sx.q, ja, P, 0, xd_a, xd_b);
      const float dta = ja < Q ? __ldg(dtb + (int64_t)ja * sdt.q) : 0.f;
      const float dtb_ = jb < Q ? __ldg(dtb + (int64_t)jb * sdt.q) : 0.f;
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const bool lower = (r % 4) >= 2;
        const int j = lower ? jb : ja, p = acc_col(lane, r);
        if (j < Q && p < P) dxo[j * qs + p] = dxb[r] * (lower ? dtb_ : dta);
      }
#pragma unroll
      for (int c = 0; c < NCN; ++c) {
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          const int j = (r % 4) >= 2 ? jb : ja, n = 64 * c + acc_col(lane, r);
          if (j < Q && n < N) dBo[j * ns + n] = dBa[c][r];
        }
      }
      ce_a = row_sum4(ce_a);
      ce_b = row_sum4(ce_b);
      if (lane % 4 == 0) {
        if (ja < Q) {
          dc1[ja] = -ce_a - wd_a;
          xdx[ja] = xd_a;
          wsum += wd_a;
        }
        if (jb < Q) {
          dc1[jb] = -ce_b - wd_b;
          xdx[jb] = xd_b;
          wsum += wd_b;
        }
      }
    }
  }
  wg_sync(1);   // rowE's column sums are in

  // ------------------------------------------------ 2. the i tiles
  {
    float dCa[NCN][32];
    for (int it = 0; it < nt; ++it) {
      const int i0 = it * T, ia = i0 + r0, ib = ia + 8;
      const float cia = ia < Q ? cum[ia] : 0.f, cib = ib < Q ? cum[ib] : 0.f;
      const float ea = ia < Q ? expf(cia) : 0.f, eb = ib < Q ? expf(cib) : 0.f;
      mbar_wait(o_full, of & 1);
      ++of;
      const uint32_t oY = smem_u32(outer);
      float sa = 0.f, sb = 0.f;              // C_i.dC2_i, the state part of dcum
#pragma unroll
      for (int c = 0; c < NCN; ++c) {
        zero(dCa[c]);
        prod_ss(dCa[c], oY, ksP);                                          // dy_i.state
#pragma unroll
        for (int r = 0; r < 32; ++r) dCa[c][r] *= (r % 4) >= 2 ? eb : ea;
        row_dot(dCa[c], Cb, sC.q, ia, N, 64 * c, sa, sb);
      }
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * T;
        zero(m);
        prod_ss(m, oY, ksP);                                               // M = dy_i.xbar_j^T
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          const bool lower = (r % 4) >= 2;
          const int j = j0 + acc_col(lane, r), i = lower ? ib : ia;
          m[r] *= (j <= i && i < Q) ? expf((lower ? cib : cia) - cum[j]) : 0.f;
        }
        pack_a(m, ah, al);
#pragma unroll
        for (int c = 0; c < NCN; ++c) prod_rs(dCa[c]);                    // (L M).B_j
      }
      mbar_arrive(o_empty);
#pragma unroll
      for (int c = 0; c < NCN; ++c) {
#pragma unroll
        for (int r = 0; r < 32; ++r) {
          const int i = (r % 4) >= 2 ? ib : ia, n = 64 * c + acc_col(lane, r);
          if (i < Q && n < N) dCo[i * ns + n] = dCa[c][r];
        }
      }
      if (lane % 4 == 0) {
        if (ia < Q) rowE[ia] += sa;
        if (ib < Q) rowE[ib] += sb;
      }
    }
  }

  // ------------------------------------------------ 3. dstate_in
  float sd = 0.f;   // this thread's part of <dstate, state>
  {
    float S[NCN][32];
#pragma unroll
    for (int c = 0; c < NCN; ++c) zero(S[c]);
    for (int it = 0; it < nt; ++it) {
      const int sa = in.take();                                            // dy_i^T
#pragma unroll
      for (int c = 0; c < NCN; ++c) {
        const int sb = in.take();                                          // (exp(cum) C_i)^T
        wg_fence();
        mma_ss<true, true>(S[c], in.addr(sa), in.addr(sb), 8);
        wg_commit();
        wg_wait_all();
        fence_regs(S[c]);
        in.give(sb);
      }
      in.give(sa);
    }
    const float eL = expf(cL);
    float* so = dstate_in + sbh;
#pragma unroll
    for (int c = 0; c < NCN; ++c) {
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int p = r0 + ((r % 4) >= 2 ? 8 : 0), n = 64 * c + acc_col(lane, r);
        if (p < P && n < N) {
          const float ds = dst[(int64_t)p * N + n];
          so[(int64_t)p * N + n] = S[c][r] + eL * ds;
          sd += ds * st[(int64_t)p * N + n];
        }
      }
    }
  }

  // ------------------------------------ da, d dt, the dA partial
  // the two block sums (the warps' shuffles, then the four warps in order)
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    wsum += __shfl_xor_sync(0xffffffffu, wsum, off);
    sd += __shfl_xor_sync(0xffffffffu, sd, off);
  }
  if (lane == 0) {
    red[warp] = wsum;
    red[4 + warp] = sd;
  }
  wg_sync(1);   // also: every row's rowE, dc1 and xdx are in
  const float extra = (red[0] + red[1] + red[2] + red[3]) +
                      expf(cL) * (red[4] + red[5] + red[6] + red[7]);
  // da_k = extra + sum_{i>=k} dcum_i: each thread a segment of rows, the
  // segments' sums joined from the last
  const int per = (Q + 127) / 128, lo = min(Q, tid * per), hi = min(Q, lo + per);
  float part = 0.f;
  for (int k = lo; k < hi; ++k) part += rowE[k] + dc1[k];
  seg[tid] = part;
  wg_sync(1);
  float run = extra;
  for (int t = 127; t > tid; --t) run += seg[t];
  float dAp = 0.f;
  float* ddto = ddt + (int64_t)b * Q * H + h;
  for (int k = hi - 1; k >= lo; --k) {
    run += rowE[k] + dc1[k];
    const float dtk = __ldg(dtb + (int64_t)k * sdt.q);
    ddto[(int64_t)k * H] = run * Ah + xdx[k];
    dAp += run * dtk;
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) dAp += __shfl_xor_sync(0xffffffffu, dAp, off);
  if (lane == 0) red[8 + warp] = dAp;
  wg_sync(1);
  if (tid == 0) dA_part[(int64_t)b * H + h] = red[8] + red[9] + red[10] + red[11];
}

template <int NCN>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* state, const void* dy, const void* dstate, void* dx, void* ddt, void* dB,
           void* dC, void* dstate_in, void* dA_part, int64_t B, int64_t Q, int64_t H, int64_t P,
           int64_t N, Str3 sx, Str3 sdt, Str3 sB, Str3 sC, Str3 sdy, cudaStream_t stream) {
  auto kern = ssd_chunk_bwd_kernel<NCN>;
  // which of x, B, C, the states and dy take 16-byte loads (bits 0-4)
  auto v16 = [](const void* p, int64_t cols, Str3 s) {
    return ((uintptr_t)p % 16 == 0) && cols % 4 == 0 && s.b % 4 == 0 && s.q % 4 == 0 &&
           s.h % 4 == 0;
  };
  const Str3 sst{P * N, N, 0};
  const int vec = (v16(x, P, sx) ? 1 : 0) | (v16(Bm, N, sB) ? 2 : 0) | (v16(Cm, N, sC) ? 4 : 0) |
                  (v16(state, N, sst) && v16(dstate, N, sst) ? 8 : 0) |
                  (v16(dy, P, sdy) ? 16 : 0);
  const size_t smem = smem_bytes((int)Q, (int)N);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)H, (unsigned)B);
  kern<<<grid, THREADS, smem, stream>>>(
      (const float*)x, (const float*)dt, (const float*)A, (const float*)Bm, (const float*)Cm,
      (const float*)state, (const float*)dy, (const float*)dstate, (float*)dx, (float*)ddt,
      (float*)dB, (float*)dC, (float*)dstate_in, (float*)dA_part, (int)Q, (int)H, (int)P, (int)N,
      sx, sdt, sB, sC, sdy, vec);
  return (int)cudaGetLastError();
}

// The entry of a translation unit built for NCN 64-column chunks of N:
// argument checks, then the launch.
template <int NCN>
int run(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
        const void* state, const void* dy, const void* dstate, void* dx, void* ddt, void* dB,
        void* dC, void* dstate_in, void* dA_part, int64_t B, int64_t Q, int64_t H, int64_t P,
        int64_t N, Str3 sx, Str3 sdt, Str3 sB, Str3 sC, Str3 sdy, int device, void* stream) {
  if (B <= 0 || Q <= 0 || H <= 0 || P <= 0 || N <= 0 || P > 64 || N > 64 * NCN ||
      N <= 64 * (NCN - 1) || B > 65535 || H > ((int64_t)1 << 30) || Q > ((int64_t)1 << 20))
    return -1;
  if (smem_bytes((int)Q, (int)N) > 232448) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch<NCN>(x, dt, A, Bm, Cm, state, dy, dstate, dx, ddt, dB, dC, dstate_in, dA_part, B,
                     Q, H, P, N, sx, sdt, sB, sC, sdy, (cudaStream_t)stream);
}

}  // namespace
