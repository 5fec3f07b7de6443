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
//   exported as ssd_chunk_bwd_smem_bytes).
//
// Precision: every product is hi.hi + hi.lo + lo.hi of tf32 halves
// (hopper.cuh's Round::trunc: hi = x truncated, lo = x - hi) accumulated
// in float32;
// tests/test_torch_bwd_kernels.py repeats the arithmetic, the tile pairs and
// the cross-tile sums in their order on the CPU (3xTF32 holds 1e-4 of the
// plain backward, 1xTF32 does not).
//
// What bounds it (ssd_chunk_cuda.ssd_chunk_bwd_cost): at zamba2-1.2b's chunk
// (B=2, Q=256, H=64, P=N=64, B and C once per group) 3.25 GFLOP of products
// at the 3xTF32 rate (19.7 us) against ~17 MB of bytes (~5 us): operations.
// This kernel computes the score products per head and M and L in both
// orientations: 76 products of 64 x 64 x 64 a (b, h), ~1.7x that count.
//
// Design: two launches, deterministic (no atomics; every value is written
// by one thread, and every sum across blocks is taken in a fixed order).
//   ssd_bwd_tile_kernel: one block per (64-row tile t, h, b), nt = Q / 64
//   of them a (b, h) (512 at zamba2's chunk), each taking cum by a block
//   scan of its own.  Block t does, for j tile t, phase 1 (the nt - t pairs
//   i >= j: dxbar_j and dB_j, with their state terms), for i tile t, phase 2
//   (the t + 1 pairs j <= i: dC_i with its state term) and phase 3 (its
//   tile's dy_i^T.(exp(cum) C_i)): nt + 1 pairs a block, 4 and 2 products a
//   pair.  A consumer warpgroup (warps 0-3) computes; a producer warpgroup
//   (warps 4-7) stages every operand as a 64 x 64 unit of tf32 hi and lo
//   (tiles.cuh: rows as they lie, or transposed for the B operand of a
//   product over rows; a full tile loaded with no predicates; the split by
//   truncation, two instructions a value) through a ring of three.  B_j
//   and xbar_j (phase 1) and dy_i (phase 2) are "outer" units held for a
//   phase; at N <= 64 dy_i has a unit of its own, so phase 2's
//   staging runs ahead while phase 1 computes.  Every product runs all
//   eight k steps of its unit (units are zero-padded past P and N): one
//   unrolled run of wgmma.  A product whose A is an accumulator tile (L G,
//   L M) takes its tf32 fragments half of K at a time, which keeps the
//   consumer inside 255 registers with no spill at N <= 64.  Below the
//   diagonal and inside the chunk the elementwise work masks nothing, and
//   L's exponentials are the fast ones (__expf: ex2.approx of x log2(e),
//   relative error below 1e-5 where L does not underflow).
//   What crosses tiles goes to scratch: E's column sums (each warp's 64 a
//   pair), the tile's dcum pieces (-sum_{i>k} E_ik - w_k xbar_k.dxbar2_k
//   and C_k.dC2_k) and sum_p dxbar_k x_k per row, the tile's sum of w_k
//   xbar_k.dxbar2_k, and its dstate_in part.  dx, dB and dC are written
//   directly.
//   ssd_bwd_finish_kernel: one block per (h, b): dstate_in (exp(cum_L)
//   dstate plus the tiles' parts in tile order), dcum (the E partials in
//   tile and warp order), da by a reverse scan (the warps' shuffles, then
//   the warps in order), d dt and the dA partial.
// The trace of PR 28's kernel (one block per (h, b)) and of this one:
// PERF.md.  Staging, not the products, sets the pace, and within staging
// the producers' instructions a value, not the loads' latency: fewer
// instructions in the split (truncation) and in the loads (no predicates
// on a full tile) made the kernel 31 % faster, while staging raw float32
// tiles by cp.async through a deeper ring and splitting them in a second
// pass (the A operands in the consumers' registers, or once into shared
// memory), three units' loads in flight in registers, and products issued
// back to back (ptxas spilled) were each measured slower: PERF.md.
// Shared memory of the tile kernel: 1 KiB of alignment, three outer and
// three ring units of 32 KiB, cum (Q floats) and 16 floats: 193 KiB at
// Q = 256; one block an SM.  Scratch (the wrapper's torch.empty):
// scratch_floats(Q, P, N) floats a (b, h).  The library exports both sizes
// (ssd_chunk_bwd.cu), which the wrapper reads.

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

// three outer units: B_j (NCN chunks) and xbar_j for phase 1, and dy_i for
// phase 2 in a unit of its own at NCN = 1 (so the producers stage phase 2
// while phase 1 runs), in B_j's first at NCN = 2 (once phase 1 is done)
template <int NCN>
struct Outer {
  static constexpr int DY = NCN == 1 ? 2 : 0;   // dy_i's unit
};

struct Str3 {
  int64_t b, q, h;
};

__host__ __device__ __forceinline__ int q_pad(int Q) { return (Q + 3) & ~3; }
__host__ __device__ __forceinline__ int n_tiles(int Q) { return (Q + T - 1) / T; }

// The scratch of one (b, h), in floats: colE [nt][4 warps][Qp] (E's column
// sums over a warp's 16 rows of j tile jt, for the i >= 64 jt the tile's
// pairs reach), part [nt][P * N] (each tile's dy^T.(exp(cum) C)), wsum [nt]
// (each tile's sum of w_k xbar_k.dxbar2_k), then three rows of Qp: dc1
// (-sum_{i>k} E_ik - w_k xbar_k.dxbar2_k), xdx (sum_p dxbar_k x_k), cdc
// (C_k.dC2_k).
__host__ __device__ __forceinline__ int64_t scratch_floats(int Q, int P, int N) {
  const int64_t nt = n_tiles(Q), Qp = q_pad(Q);
  return nt * (4 * Qp + (int64_t)P * N + 1) + 3 * Qp;
}

// one (b, h)'s scratch (F: float, or const float where it is only read),
// its regions found where they are used
template <typename F>
struct Scratch {
  F* base;
  int nt, Qp, PN;
  __device__ __forceinline__ Scratch(F* scratch, int bh, int Q, int P, int N)
      : base(scratch + (int64_t)bh * scratch_floats(Q, P, N)), nt(n_tiles(Q)), Qp(q_pad(Q)),
        PN(P * N) {}
  // E's column sums of j tile jt, warp w
  __device__ __forceinline__ F* colE(int jt, int w) const {
    return base + ((int64_t)jt * 4 + w) * Qp;
  }
  // tile t's part of dstate_in
  __device__ __forceinline__ F* part(int t) const {
    return base + (int64_t)nt * 4 * Qp + (int64_t)t * PN;
  }
  __device__ __forceinline__ F* wsum() const { return base + (int64_t)nt * (4 * Qp + PN); }
  // the rows dc1 (0), xdx (1), cdc (2)
  __device__ __forceinline__ F* row(int k) const { return wsum() + nt + (int64_t)k * Qp; }
};

// alignment; outer and ring units (three each at N <= 64 and at N = 128);
// cum (Q floats); 16 sums
size_t smem_bytes(int Q) { return 1024 + (size_t)UNIT * (3 + ST) + 4 * ((size_t)q_pad(Q) + 16); }

// cum = the inclusive prefix sum of dt * A over the chunk, by all THREADS
// threads of the block (red: 8 floats)
__device__ __forceinline__ void block_cum(const float* dtb, int64_t sdq, float Ah, int Q,
                                          float* cum, float* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float carry = 0.f;
  for (int q0 = 0; q0 < Q; q0 += THREADS) {
    const int qi = q0 + tid;
    float val = qi < Q ? dtb[(int64_t)qi * sdq] * Ah : 0.f;
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
}

// d (64 x 64) = A . B^T over a unit's eight k steps, both units split
__device__ __forceinline__ void mma3(float (&d)[32], uint32_t a, uint32_t b) {
  mma_ss(d, a, b, 8);
}

// the producers' next unit: loaded, split, stored into the next ring slot
// and published
template <typename Tile, typename S>
__device__ __forceinline__ void put(RingOut<ST>& out, int ptid, const float* src, int64_t ld,
                                    int rows, int cols, bool v, S scale) {
  Tile tile;
  tile.load(src, ld, rows, cols, v, scale, ptid);
  tile.store(out.acquire(), ptid);
  out.publish();
}

// the ring slots of a product that was in flight, once it is in
template <int NCN>
__device__ __forceinline__ void give_back(RingIn<ST>& in, const int (&pend)[NCN], bool& pending) {
  if (pending) {
#pragma unroll
    for (int c = 0; c < NCN; ++c) in.give(pend[c]);
  }
  pending = false;
}

// d[c] += A . unit b[c] for each of the NC units, A the accumulator tile v
// split into tf32 A fragments half of K at a time (pack_a_half): the second
// half is packed once the first half's products are in.  Issued and
// committed; the caller waits.
template <int NC>
__device__ __forceinline__ void mma_rs_halves(float (&d)[NC][32], const float (&v)[32],
                                              const int (&b)[NC], const RingIn<ST>& in) {
  uint32_t ah[16], al[16];
  pack_a_half<0>(v, ah, al);
  wg_fence();
#pragma unroll
  for (int c = 0; c < NC; ++c) mma_rs_half<0>(d[c], ah, al, in.addr(b[c]));
  wg_commit();
  wg_wait_all();
  pack_a_half<1>(v, ah, al);
  wg_fence();
#pragma unroll
  for (int c = 0; c < NC; ++c) mma_rs_half<1>(d[c], ah, al, in.addr(b[c]));
  wg_commit();
}

struct ByDt {   // xbar = x dt, row by row
  const float* dt;
  int64_t ld;
  int r0;
  __device__ __forceinline__ float operator()(int r) const {
    return __ldg(dt + (int64_t)(r0 + r) * ld);
  }
};

struct ByEcum {   // exp(cum_i) C_i
  const float* cum;
  int r0;
  __device__ __forceinline__ float operator()(int r) const { return expf(cum[r0 + r]); }
};

// a row dot with a global row tile: the sum over a thread's columns c0 +
// acc_col of d[r] * src[row * ld + col] (row row_a or row_a + 8, row < Q,
// col < cols), joined over the row's four threads, added to (ra, rb)
__device__ __forceinline__ void row_dot(const float (&d)[32], const float* src, int64_t ld,
                                        int row_a, int Q, int cols, int c0, int lane, float& ra,
                                        float& rb) {
  float a = 0.f, bsum = 0.f;
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const bool lower = (r % 4) >= 2;
    const int row = row_a + (lower ? 8 : 0), col = c0 + acc_col(lane, r);
    if (row < Q && col < cols) {
      const float v = d[r] * __ldg(src + (int64_t)row * ld + col);
      if (lower) bsum += v;
      else a += v;
    }
  }
  ra += row_sum4(a);
  rb += row_sum4(bsum);
}

template <int NCN>
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_tile_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ state,
                    const float* __restrict__ dy, const float* __restrict__ dstate,
                    float* __restrict__ dx, float* __restrict__ dB, float* __restrict__ dC,
                    float* __restrict__ scratch, int Q, int H, int P, int N, Str3 sx, Str3 sdt,
                    Str3 sB, Str3 sC, Str3 sdy, int vec) {
  extern __shared__ uint8_t smem_raw[];
  // ring full[ST], empty[ST]; the outer units' full barriers of phases 1
  // and 2, phase 1's outer empty barrier
  __shared__ __align__(8) uint64_t bars[2 * ST + 3];
  uint8_t* base = align1024(smem_raw);
  uint8_t* outer = base;                        // 3 units
  uint8_t* ring = base + 3 * UNIT;              // ST units
  float* cum = reinterpret_cast<float*>(ring + ST * UNIT);
  float* red = cum + q_pad(Q);                  // [16]
  uint64_t* full = bars;
  uint64_t* empty = bars + ST;
  uint64_t* o_full = bars + 2 * ST;        // [2]
  uint64_t* o_empty = bars + 2 * ST + 2;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const float Ah = A[h];
  const float* xb = x + b * sx.b + h * sx.h;
  const float* dtb = dt + b * sdt.b + h * sdt.h;
  const float* Bb = Bm + b * sB.b + h * sB.h;
  const float* Cb = Cm + b * sC.b + h * sC.h;
  const float* dyb = dy + b * sdy.b + h * sdy.h;
  const int64_t sbh = ((int64_t)b * H + h) * P * N;
  const float* st = state + sbh;
  const float* dst = dstate + sbh;
  const int nt = n_tiles(Q);
  const Scratch<float> scr(scratch, b * H + h, Q, P, N);

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], 128);
    }
    mbar_init(&o_full[0], 128);
    mbar_init(&o_full[1], 128);
    mbar_init(o_empty, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  block_cum(dtb, sdt.q, Ah, Q, cum, red);
  __syncthreads();   // the barriers are initialised, cum is complete

  const float cL = cum[Q - 1];
  const int i0 = t * T, j0 = i0, rows_t = min(T, Q - i0);   // this block's tile

  if (tid >= 128) {
    // -------------------------------------------------------- producers
    const int ptid = tid - 128;
    const bool vx = vec & 1, vb = vec & 2, vc = vec & 4, vs = vec & 8, vy = vec & 16;
    RingOut<ST> out{full, empty, ring, 0};
    using Rows = RowTile<128>;
    using Cols = ColTile<128>;
    using StateT = ColTile<128, false>;   // a state transposed, beside a RowTile A
    Rows ro;                              // the outer units
    // 1. j tile t: B_j and xbar_j outer; dstate and dstate^T; the i >= j pairs
    for (int c = 0; c < NCN; ++c) {
      ro.load(Bb + (int64_t)j0 * sB.q + 64 * c, sB.q, rows_t, N - 64 * c, vb, NoScale{}, ptid);
      ro.store(outer + c * UNIT, ptid);
    }
    ro.load(xb + (int64_t)j0 * sx.q, sx.q, rows_t, P, vx, ByDt{dtb, sdt.q, j0}, ptid);
    ro.store(outer + NCN * UNIT, ptid);
    fence_async_shared();
    mbar_arrive(&o_full[0]);
    for (int c = 0; c < NCN; ++c)
      put<Rows>(out, ptid, dst + 64 * c, N, P, N - 64 * c, vs, NoScale{});
    for (int c = 0; c < NCN; ++c)
      put<StateT>(out, ptid, dst + 64 * c, N, P, N - 64 * c, vs, NoScale{});
    for (int it = t; it < nt; ++it) {
      const int ii = it * T, ni = min(T, Q - ii);
      const float* ci = Cb + (int64_t)ii * sC.q;
      const float* yi = dyb + (int64_t)ii * sdy.q;
      for (int c = 0; c < NCN; ++c)
        put<Rows>(out, ptid, ci + 64 * c, sC.q, ni, N - 64 * c, vc, NoScale{});
      put<Rows>(out, ptid, yi, sdy.q, ni, P, vy, NoScale{});
      put<Cols>(out, ptid, yi, sdy.q, ni, P, vy, NoScale{});
      for (int c = 0; c < NCN; ++c)
        put<Cols>(out, ptid, ci + 64 * c, sC.q, ni, N - 64 * c, vc, NoScale{});
    }
    // 2. i tile t: dy_i outer (once phase 1 is done with B_j at NCN = 2);
    // state^T; the j <= i pairs
    if (NCN != 1) mbar_wait(o_empty, 0);
    ro.load(dyb + (int64_t)i0 * sdy.q, sdy.q, rows_t, P, vy, NoScale{}, ptid);
    ro.store(outer + Outer<NCN>::DY * UNIT, ptid);
    fence_async_shared();
    mbar_arrive(&o_full[1]);
    for (int c = 0; c < NCN; ++c)
      put<StateT>(out, ptid, st + 64 * c, N, P, N - 64 * c, vs, NoScale{});
    for (int jt = 0; jt <= t; ++jt) {
      const int jj = jt * T, nj = min(T, Q - jj);
      put<Rows>(out, ptid, xb + (int64_t)jj * sx.q, sx.q, nj, P, vx, ByDt{dtb, sdt.q, jj});
      for (int c = 0; c < NCN; ++c)
        put<Cols>(out, ptid, Bb + (int64_t)jj * sB.q + 64 * c, sB.q, nj, N - 64 * c, vb,
                  NoScale{});
    }
    // 3. the tile's part of dstate_in
    put<Cols>(out, ptid, dyb + (int64_t)i0 * sdy.q, sdy.q, rows_t, P, vy, NoScale{});
    for (int c = 0; c < NCN; ++c)
      put<Cols>(out, ptid, Cb + (int64_t)i0 * sC.q + 64 * c, sC.q, rows_t, N - 64 * c, vc,
                ByEcum{cum, i0});
    return;
  }

  // --------------------------------------------------------- consumers
  RingIn<ST> in{full, empty, ring, 0};
  const int r0 = warp * 16 + lane / 4;        // this thread's tile rows r0, r0 + 8
  float g[32], m[32];
  int pend[NCN];       // ring slots a product in flight reads, given back once it is in
  bool pending = false;
  // ------------------------------------------------ 1. j tile t
  {
    const int ja = j0 + r0, jb = ja + 8;
    const float cja = ja < Q ? cum[ja] : 0.f, cjb = jb < Q ? cum[jb] : 0.f;
    const float wa = ja < Q ? expf(cL - cja) : 0.f, wb = jb < Q ? expf(cL - cjb) : 0.f;
    const uint32_t oB = smem_u32(outer), oX = smem_u32(outer + NCN * UNIT);
    float dxbs[1][32], dBa[NCN][32];   // dxbar_j (one accumulator) and dB_j
    float(&dxb)[32] = dxbs[0];
    mbar_wait(&o_full[0], 0);
    // the state terms: dxbar2 = w (B_j.dstate^T), dB2 = w (xbar_j.dstate)
    {
      int sa[NCN], sb[NCN];
#pragma unroll
      for (int c = 0; c < NCN; ++c) sa[c] = in.take();
      zero(dxb);
      wg_fence();
#pragma unroll
      for (int c = 0; c < NCN; ++c) mma3(dxb, oB + c * UNIT, in.addr(sa[c]));
      wg_commit();
      if (2 * NCN > ST) {   // the ring cannot hold both operands' chunks
        wg_wait_all();
#pragma unroll
        for (int c = 0; c < NCN; ++c) in.give(sa[c]);
      }
#pragma unroll
      for (int c = 0; c < NCN; ++c) {
        sb[c] = in.take();
        zero(dBa[c]);
      }
      wg_fence();
#pragma unroll
      for (int c = 0; c < NCN; ++c) mma3(dBa[c], oX, in.addr(sb[c]));
      wg_commit();
      wg_wait_all();
      fence_regs(dxb);
#pragma unroll
      for (int c = 0; c < NCN; ++c) {
        fence_regs(dBa[c]);
        if (2 * NCN <= ST) in.give(sa[c]);
        in.give(sb[c]);
      }
    }
#pragma unroll
    for (int r = 0; r < 32; ++r) dxb[r] *= (r % 4) >= 2 ? wb : wa;
#pragma unroll
    for (int c = 0; c < NCN; ++c) {
#pragma unroll
      for (int r = 0; r < 32; ++r) dBa[c][r] *= (r % 4) >= 2 ? wb : wa;
    }
    float wd_a = 0.f, wd_b = 0.f;           // xbar_j.dxbar2_j
    row_dot(dxb, xb, sx.q, ja, Q, P, 0, lane, wd_a, wd_b);
    wd_a *= ja < Q ? __ldg(dtb + (int64_t)ja * sdt.q) : 0.f;
    wd_b *= jb < Q ? __ldg(dtb + (int64_t)jb * sdt.q) : 0.f;
    float ce_a = 0.f, ce_b = 0.f;           // sum_{i>j} E_ij of rows ja, jb
    for (int it = t; it < nt; ++it) {
      const int ii = it * T;
      wg_wait_all();   // the previous pair's (L M)^T.C_i: its fragments and units are free
#pragma unroll
      for (int c = 0; c < NCN; ++c) fence_regs(dBa[c]);
      give_back(in, pend, pending);
      int sc[NCN], sy;
#pragma unroll
      for (int c = 0; c < NCN; ++c) sc[c] = in.take();
      sy = in.take();
      zero(g);
      zero(m);
      wg_fence();
#pragma unroll
      for (int c = 0; c < NCN; ++c) mma3(g, oB + c * UNIT, in.addr(sc[c]));   // G^T
      mma3(m, oX, in.addr(sy));                                               // M^T
      wg_commit();
      wg_wait_all();
      fence_regs(g);
      fence_regs(m);
#pragma unroll
      for (int c = 0; c < NCN; ++c) in.give(sc[c]);
      in.give(sy);
      // L, E, and E's column sums over the warp's 16 rows, a column (rows
      // r0 and r0 + 8, accumulator elements r and r + 2) at a time; below
      // the diagonal and inside the chunk nothing is masked
      float* ce = scr.colE(t, warp) + ii;
      const bool plain = it > t && ii + T <= Q;
      // this thread's first column, opaque to the compiler, so that nothing
      // per column is computed once for all pairs and kept (or spilled)
      int c2 = (lane % 4) * 2;
      asm volatile("" : "+r"(c2));
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int r = (u / 2) * 4 + u % 2, col = (r / 4) * 8 + c2 + r % 2, i = ii + col;
        float e2[2];
#pragma unroll
        for (int lower = 0; lower < 2; ++lower) {
          const int k = r + 2 * lower, j = lower ? jb : ja;
          const float cj = lower ? cjb : cja;
          float L;
          if (plain) {
            L = __expf(cum[i] - cj);
          } else {
            const bool in_tri = i >= j && i < Q && j < Q;
            L = in_tri ? __expf(cum[i] - cj) : 0.f;
          }
          g[k] *= L;
          e2[lower] = (plain || i > j) ? g[k] * m[k] : 0.f;
          m[k] *= L;
        }
        ce_a += e2[0];
        ce_b += e2[1];
        float sum = e2[0] + e2[1];
        sum += __shfl_xor_sync(0xffffffffu, sum, 4);
        sum += __shfl_xor_sync(0xffffffffu, sum, 8);
        sum += __shfl_xor_sync(0xffffffffu, sum, 16);
        if (lane < 4 && i < Q) ce[col] = sum;
      }
      {
        const int syc[1] = {in.take()};
        mma_rs_halves<1>(dxbs, g, syc, in);                                  // (L G)^T.dy_i
        wg_wait_all();
        fence_regs(dxb);
        in.give(syc[0]);
      }
#pragma unroll
      for (int c = 0; c < NCN; ++c) pend[c] = in.take();
      pending = true;
      mma_rs_halves<NCN>(dBa, m, pend, in);                                   // (L M)^T.C_i
    }
    wg_wait_all();
#pragma unroll
    for (int c = 0; c < NCN; ++c) fence_regs(dBa[c]);
    give_back(in, pend, pending);
    mbar_arrive(o_empty);
    // the j tile's outputs
    const int64_t qs = (int64_t)H * P, ns = (int64_t)H * N;   // row strides of the outputs
    float* dxo = dx + ((int64_t)b * Q * H + h) * P;
    float* dBo = dB + ((int64_t)b * Q * H + h) * N;
    const float dta = ja < Q ? __ldg(dtb + (int64_t)ja * sdt.q) : 0.f;
    const float dtbj = jb < Q ? __ldg(dtb + (int64_t)jb * sdt.q) : 0.f;
    float xd_a = 0.f, xd_b = 0.f;
    row_dot(dxb, xb, sx.q, ja, Q, P, 0, lane, xd_a, xd_b);
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const bool lower = (r % 4) >= 2;
      const int j = lower ? jb : ja, p = acc_col(lane, r);
      if (j < Q && p < P) dxo[j * qs + p] = dxb[r] * (lower ? dtbj : dta);
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
        scr.row(0)[ja] = -ce_a - wd_a;
        scr.row(1)[ja] = xd_a;
      }
      if (jb < Q) {
        scr.row(0)[jb] = -ce_b - wd_b;
        scr.row(1)[jb] = xd_b;
      }
    }
    // the tile's sum of w_k xbar_k.dxbar2_k (each row once: lanes 0 mod 4)
    float ws = lane % 4 == 0 ? (ja < Q ? wd_a : 0.f) + (jb < Q ? wd_b : 0.f) : 0.f;
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) ws += __shfl_xor_sync(0xffffffffu, ws, off);
    if (lane == 0) red[8 + warp] = ws;
    wg_sync(1);
    if (tid == 0) scr.wsum()[t] = red[8] + red[9] + red[10] + red[11];
  }

  // ------------------------------------------------ 2. i tile t
  {
    const int ia = i0 + r0, ib = ia + 8;
    const float cia = ia < Q ? cum[ia] : 0.f, cib = ib < Q ? cum[ib] : 0.f;
    const float ea = ia < Q ? expf(cia) : 0.f, eb = ib < Q ? expf(cib) : 0.f;
    const uint32_t oY = smem_u32(outer + Outer<NCN>::DY * UNIT);
    float dCa[NCN][32];
    mbar_wait(&o_full[1], 0);
    {
      int ss[NCN];
#pragma unroll
      for (int c = 0; c < NCN; ++c) {
        ss[c] = in.take();
        zero(dCa[c]);
      }
      wg_fence();
#pragma unroll
      for (int c = 0; c < NCN; ++c) mma3(dCa[c], oY, in.addr(ss[c]));       // dy_i.state
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int c = 0; c < NCN; ++c) {
        fence_regs(dCa[c]);
        in.give(ss[c]);
      }
    }
    float sa = 0.f, sb = 0.f;              // C_i.dC2_i, the state part of dcum
#pragma unroll
    for (int c = 0; c < NCN; ++c) {
#pragma unroll
      for (int r = 0; r < 32; ++r) dCa[c][r] *= (r % 4) >= 2 ? eb : ea;
      row_dot(dCa[c], Cb, sC.q, ia, Q, N, 64 * c, lane, sa, sb);
    }
    for (int jt = 0; jt <= t; ++jt) {
      const int jj = jt * T;
      const int sx_ = in.take();
      zero(m);
      wg_fence();
      mma3(m, oY, in.addr(sx_));                                             // M = dy_i.xbar_j^T
      wg_commit();
      wg_wait_all();   // also the previous pair's (L M).B_j
      fence_regs(m);
#pragma unroll
      for (int c = 0; c < NCN; ++c) fence_regs(dCa[c]);
      in.give(sx_);
      give_back(in, pend, pending);
      const bool plain = jt < t && i0 + T <= Q;   // below the diagonal, inside the chunk
      int c2 = (lane % 4) * 2;                     // opaque, as in phase 1
      asm volatile("" : "+r"(c2));
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const bool lower = (r % 4) >= 2;
        const int j = jj + (r / 4) * 8 + c2 + r % 2, i = lower ? ib : ia;
        const float L = __expf((lower ? cib : cia) - cum[min(j, Q - 1)]);
        m[r] *= plain ? L : (j <= i && i < Q) ? L : 0.f;
      }
#pragma unroll
      for (int c = 0; c < NCN; ++c) pend[c] = in.take();
      pending = true;
      mma_rs_halves<NCN>(dCa, m, pend, in);                                   // (L M).B_j
    }
    wg_wait_all();
#pragma unroll
    for (int c = 0; c < NCN; ++c) fence_regs(dCa[c]);
    give_back(in, pend, pending);
    const int64_t ns = (int64_t)H * N;
    float* dCo = dC + ((int64_t)b * Q * H + h) * N;
#pragma unroll
    for (int c = 0; c < NCN; ++c) {
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int i = (r % 4) >= 2 ? ib : ia, n = 64 * c + acc_col(lane, r);
        if (i < Q && n < N) dCo[i * ns + n] = dCa[c][r];
      }
    }
    if (lane % 4 == 0) {
      if (ia < Q) scr.row(2)[ia] = sa;
      if (ib < Q) scr.row(2)[ib] = sb;
    }
  }

  // ------------------------------------------------ 3. dstate_in's part
  {
    float S[NCN][32];
    int se[NCN];
    const int sy = in.take();                                              // dy_i^T
#pragma unroll
    for (int c = 0; c < NCN; ++c) {
      se[c] = in.take();                                                   // (exp(cum) C_i)^T
      zero(S[c]);
    }
    wg_fence();
#pragma unroll
    for (int c = 0; c < NCN; ++c) mma3(S[c], in.addr(sy), in.addr(se[c]));
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int c = 0; c < NCN; ++c) {
      fence_regs(S[c]);
      in.give(se[c]);
    }
    in.give(sy);
    float* po = scr.part(t);
#pragma unroll
    for (int c = 0; c < NCN; ++c) {
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int p = r0 + ((r % 4) >= 2 ? 8 : 0), n = 64 * c + acc_col(lane, r);
        if (p < P && n < N) po[(int64_t)p * N + n] = S[c][r];
      }
    }
  }
}

// dstate_in, dcum, da, d dt and the dA partial of one (b, h) from the
// tiles' scratch, every sum in a fixed order
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_finish_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                      const float* __restrict__ state, const float* __restrict__ dstate,
                      const float* __restrict__ scratch, float* __restrict__ ddt,
                      float* __restrict__ dstate_in, float* __restrict__ dA_part, int Q, int H,
                      int P, int N, Str3 sdt) {
  extern __shared__ float fsm[];
  float* cum = fsm;                         // [Qp], then dcum over it
  float* red = fsm + q_pad(Q);              // [16]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y;
  const float Ah = A[h];
  const float* dtb = dt + b * sdt.b + h * sdt.h;
  const int nt = n_tiles(Q), Qp = q_pad(Q);
  const Scratch<const float> scr(scratch, b * H + h, Q, P, N);
  const float *dc1 = scr.row(0), *xdx = scr.row(1), *cdc = scr.row(2);
  const int64_t sbh = ((int64_t)b * H + h) * P * N;
  // the sum over the block of each thread's v, the warps in order; red[8..15]
  auto block_sum = [&](float v) {
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[8 + warp] = v;
    __syncthreads();
    float total = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) total += red[8 + w];
    __syncthreads();
    return total;
  };

  block_cum(dtb, sdt.q, Ah, Q, cum, red);
  const float eL = expf(cum[Q - 1]);
  // dstate_in and this thread's part of <dstate, state>
  float sd = 0.f;
  for (int e0 = tid; e0 < P * N; e0 += 4 * THREADS) {   // four elements' loads in flight
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * THREADS;
      v[u] = 0.f;
      if (e < P * N) {
        const float ds = dstate[sbh + e];
        v[u] = eL * ds;
        sd += ds * state[sbh + e];
      }
    }
    for (int tt = 0; tt < nt; ++tt) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * THREADS;
        if (e < P * N) v[u] += scr.part(tt)[e];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * THREADS;
      if (e < P * N) dstate_in[sbh + e] = v[u];
    }
  }
  float ws = 0.f;
  for (int tt = 0; tt < nt; ++tt) ws += scr.wsum()[tt];
  // extra = the tiles' sums of w_k xbar_k.dxbar2_k + exp(cum_L) <dstate, state>
  const float extra = ws + eL * block_sum(sd);   // also: every thread has read cum[Q - 1]
  // dcum over cum's place: E's column partials in tile and warp order
  for (int k = tid; k < Q; k += THREADS) {
    float rowE = 0.f;
    for (int jt = 0; jt <= k / T; ++jt) {
      const float* ce = scr.colE(jt, 0) + k;
      rowE += ((ce[0] + ce[Qp]) + ce[2 * Qp]) + ce[3 * Qp];
    }
    cum[k] = rowE + cdc[k] + dc1[k];
  }
  __syncthreads();
  // da_k = extra + sum_{i>=k} dcum_i: each thread a segment of rows; the
  // sums of the segments after it by a suffix scan (the warp's lanes by
  // shuffles, then the later warps' totals in order)
  const int per = (Q + THREADS - 1) / THREADS, lo = min(Q, tid * per), hi = min(Q, lo + per);
  float acc = 0.f;
  for (int k = lo; k < hi; ++k) acc += cum[k];
  float incl = acc;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_down_sync(0xffffffffu, incl, off);
    if (lane + off < 32) incl += v;
  }
  if (lane == 0) red[warp] = incl;
  __syncthreads();
  float run = extra + (incl - acc);
  for (int w = THREADS / 32 - 1; w > warp; --w) run += red[w];
  float dAp = 0.f;
  float* ddto = ddt + (int64_t)b * Q * H + h;
  for (int k = hi - 1; k >= lo; --k) {
    run += cum[k];
    ddto[(int64_t)k * H] = run * Ah + xdx[k];
    dAp += run * __ldg(dtb + (int64_t)k * sdt.q);
  }
  const float dA = block_sum(dAp);
  if (tid == 0) dA_part[(int64_t)b * H + h] = dA;
}

template <int NCN>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* state, const void* dy, const void* dstate, void* dx, void* ddt, void* dB,
           void* dC, void* dstate_in, void* dA_part, void* scratch, int64_t B, int64_t Q,
           int64_t H, int64_t P, int64_t N, Str3 sx, Str3 sdt, Str3 sB, Str3 sC, Str3 sdy,
           cudaStream_t stream) {
  auto kern = ssd_bwd_tile_kernel<NCN>;
  // which of x, B, C, the states and dy take 16-byte loads (bits 0-4)
  auto v16 = [](const void* p, int64_t cols, Str3 s) {
    return ((uintptr_t)p % 16 == 0) && cols % 4 == 0 && s.b % 4 == 0 && s.q % 4 == 0 &&
           s.h % 4 == 0;
  };
  const Str3 sst{P * N, N, 0};
  const int vec = (v16(x, P, sx) ? 1 : 0) | (v16(Bm, N, sB) ? 2 : 0) | (v16(Cm, N, sC) ? 4 : 0) |
                  (v16(state, N, sst) && v16(dstate, N, sst) ? 8 : 0) |
                  (v16(dy, P, sdy) ? 16 : 0);
  const size_t smem = smem_bytes((int)Q);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((unsigned)n_tiles((int)Q), (unsigned)H, (unsigned)B), THREADS, smem, stream>>>(
      (const float*)x, (const float*)dt, (const float*)A, (const float*)Bm, (const float*)Cm,
      (const float*)state, (const float*)dy, (const float*)dstate, (float*)dx, (float*)dB,
      (float*)dC, (float*)scratch, (int)Q, (int)H, (int)P, (int)N, sx, sdt, sB, sC, sdy, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t fsmem = 4 * ((size_t)q_pad((int)Q) + 16);
  err = cudaFuncSetAttribute(ssd_bwd_finish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)fsmem);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_finish_kernel<<<dim3((unsigned)H, (unsigned)B), THREADS, fsmem, stream>>>(
      (const float*)dt, (const float*)A, (const float*)state, (const float*)dstate,
      (const float*)scratch, (float*)ddt, (float*)dstate_in, (float*)dA_part, (int)Q, (int)H,
      (int)P, (int)N, sdt);
  return (int)cudaGetLastError();
}

// The entry of a translation unit built for NCN 64-column chunks of N:
// argument checks, then the launches.
template <int NCN>
int run(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
        const void* state, const void* dy, const void* dstate, void* dx, void* ddt, void* dB,
        void* dC, void* dstate_in, void* dA_part, void* scratch, int64_t scratch_len,
        int64_t B, int64_t Q, int64_t H, int64_t P, int64_t N, Str3 sx, Str3 sdt, Str3 sB,
        Str3 sC, Str3 sdy, int device, void* stream) {
  if (B <= 0 || Q <= 0 || H <= 0 || P <= 0 || N <= 0 || P > 64 || N > 64 * NCN ||
      N <= 64 * (NCN - 1) || B > 65535 || H > 65535 || Q > ((int64_t)1 << 20))
    return -1;
  if (smem_bytes((int)Q) > 232448) return -1;
  if (scratch_len < B * H * scratch_floats((int)Q, (int)P, (int)N)) return -1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return launch<NCN>(x, dt, A, Bm, Cm, state, dy, dstate, dx, ddt, dB, dC, dstate_in, dA_part,
                     scratch, B, Q, H, P, N, sx, sdt, sB, sC, sdy, (cudaStream_t)stream);
}

}  // namespace
