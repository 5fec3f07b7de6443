// MLA's absorbed attention on bf16 wgmma fed by TMA (sm_90a): the bf16
// route of mla_attention.cu, which includes this file and describes the
// function, the design and what bounds each launch in its header.
//
// Tiles.  A row is a (position, head) pair as q lies in memory, so q and o
// are (B, M = Sq * H, D) matrices and k and v (B, Sk, D) ones; every tile
// is read through a TMA tensor map over (D, 1, rows, B) in boxes of 64
// columns (128 bytes, 128-byte swizzle) x 64 rows, or 32 rows for the key
// and value stages, with zeros past the edges.  A row tile is 64 rows: 64
// heads of one position at H = 128.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tma.cuh"

namespace {
namespace mlawg {

typedef __nv_bfloat16 bf16;

constexpr int BM = 64;                 // rows of a row tile (a TMA box of rows)
constexpr int BN = 32;                 // keys of a K / V stage (32-row boxes)
constexpr int KB_BOX = BN * 128;       // bytes of a 32-row box
constexpr int FWD_STAGES = 2;          // depth of the forward's K / V ring
constexpr int KEY_TILE = 64;           // keys of a dS (P) tile: the scratch's key padding
constexpr int BLOCK_KEYS = 128;        // keys of a dK / dV block: two tiles
constexpr int KEY_STAGES = 4;          // depth of the dK / dV launch's ring
constexpr int SLAB = 4;                // 64-column boxes of a dK / dV slab
constexpr int ROW_CHUNK = 32;          // row tiles of a dK / dV chunk
constexpr int MAX_KB = 9, MAX_VB = 8;  // 64-column boxes of Dk <= 576, Dv <= 512
constexpr int KEYS_THREADS = 288;      // two consumer warpgroups + a producer warp
constexpr int ROWS_THREADS = 384;      // two consumer warpgroups + a producer warpgroup
constexpr int PRODUCER_REGS = 40;      // setmaxnreg: a producer warpgroup's registers,
constexpr int CONSUMER_REGS = 232;     // and a consumer's (40 x 128 + 232 x 256 <= 65,536)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_INF = -1e30f;

// d (m64 x n32, f32) (+)= A (smem, K-major) . B (smem, K-major), bf16;
// with scale_d 0, d = A . B
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (m64 x n256, f32) += A (registers, bf16x2) . B (smem, MN-major), bf16
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n256, f32) (+)= A (smem, MN-major) . B (smem, MN-major), bf16
__device__ __forceinline__ void wgmma_ss_tt_n256(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}


__host__ __device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int64_t lmax(int64_t a, int64_t b) { return a > b ? a : b; }
__host__ __device__ __forceinline__ int boxes(int64_t d) { return (int)((d + 63) / 64); }

// A block of three warpgroups runs at 65,536 / 384 = 168 registers a thread
// unless it moves them: the producer warpgroup gives its own back and the
// consumers take them (ptxas budgets the code after each for its count).
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
}

// Zeros in boxes [from, to) of `box`-byte boxes at `base`, by the block's
// threads below `n`, made visible to the TMA and wgmma (async proxy).  The
// products run over every box of the widest head, so the boxes a narrower
// head does not load hold zeros and add nothing.
__device__ __forceinline__ void zero_boxes(uint8_t* base, int box, int from, int to, int n) {
  uint4* w = reinterpret_cast<uint4*>(base + (size_t)from * box);
  const int words = (to - from) * box / 16;
  for (int i = threadIdx.x; i < words; i += n) w[i] = make_uint4(0u, 0u, 0u, 0u);
  fence_async_shared();
}

// named barriers among the consumer warpgroups (id 0 is __syncthreads)
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// the MN-major descriptor of a tile whose 64-column boxes are `box` bytes
// apart (8-row groups 1024 bytes apart)
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t box) {
  return desc_sw128(addr, box, 1024);
}

// byte offset of element (row, col) of a 64-row tile of 64-column boxes in
// the 128-byte swizzle the TMA reads and writes
__device__ __forceinline__ uint32_t sw_box(int row, int col) {
  const int cc = col % 64;
  return (uint32_t)((col / 64) * BOX_BYTES + row * 128 + (((cc / 8) ^ (row % 8)) * 16) +
                    (cc % 8) * 2);
}

// the row tile of block i: the last tiles (most keys under the causal
// mask) first, batch rows interleaved
struct RowTile {
  int64_t r0, M;
  int b, n_kt;   // n_kt: key stages of BN the tile's rows see
  __device__ __forceinline__ RowTile(int i, int n_rt, int B, int Sq, int Sk, int H, int causal) {
    M = (int64_t)Sq * H;
    r0 = (int64_t)(n_rt - 1 - i / B) * BM;
    b = i % B;
    const int64_t last = (lmin(r0 + BM, M) - 1) / H;
    const int kv_end = causal ? (int)lmin(Sk, last + 1) : Sk;
    n_kt = (kv_end + BN - 1) / BN;
  }
};

// a consumer thread's two rows of the m64 accumulator layout: row0 and
// row0 + 8 of the tile, (position, head) of each, and whether each is a row
// of q; element r of an n-wide accumulator is at row (r % 4 < 2 ? row0 :
// row0 + 8) and column (r / 4) * 8 + cq + r % 2
struct ThreadRows {
  int row0, cq;
  int64_t R[2], pos[2];
  bool ok[2];
  __device__ __forceinline__ ThreadRows(int wtid, int64_t r0, int64_t M, int H) {
    row0 = (wtid / 32) * 16 + (wtid % 32) / 4;
    cq = (wtid % 4) * 2;
    for (int i = 0; i < 2; ++i) {
      R[i] = r0 + row0 + 8 * i;
      pos[i] = R[i] / H;
      ok[i] = R[i] < M;
    }
  }
  // element r of key stage k0 is masked: past the keys, past q's rows, or
  // above the causal diagonal of its row's position
  __device__ __forceinline__ bool masked(int r, int k0, int Sk, int causal) const {
    const int i = (r % 4) >= 2;
    const int j = k0 + (r / 4) * 8 + cq + (r % 2);
    return j >= Sk || !ok[i] || (causal && j > pos[i]);
  }
};

// ------------------------------------------------------------- forward
//
// A block per row tile: NWG consumer warpgroups (one per 256 columns of
// O: NWG = 2 at Dv > 256) and a producer warp (a producer warpgroup at NWG
// = 2, whose registers go to the consumers).  The producer loads the Q tile
// once (the boxes of Dk) and streams 32-key stages of K and V into a
// two-stage ring.  Every warpgroup computes S = Q.K^T of a stage whole
// (wgmma m64n32k16 over Dk, both operands K-major in shared memory) and
// its softmax in registers, and O[:, 256 w ...] += P.V (m64n256k16, P in
// registers, V MN-major); S of stage t is issued with P.V of stage t - 1.

__host__ __device__ __forceinline__ int fwd_groups(int nvb) { return nvb > 4 ? 2 : 1; }

// dynamic shared memory of the forward: the Q tile and two stages of K
// (9 boxes each) and V (every box the products read: 4 a warpgroup), or
// the O tile it stages its output in, if larger; + 1 KiB of alignment
__host__ __device__ __forceinline__ size_t fwd_smem(int nvb) {
  const int nwg = fwd_groups(nvb);
  const size_t main =
      (size_t)MAX_KB * BOX_BYTES + (size_t)FWD_STAGES * (MAX_KB + 4 * nwg) * KB_BOX;
  const size_t out = (size_t)4 * nwg * BOX_BYTES;
  return 1024 + (main > out ? main : out);
}

// threads of the forward: NWG consumer warpgroups and a producer warp, or
// at NWG = 2 a producer warpgroup (its registers go to the consumers)
template <int NWG>
constexpr int fwd_threads() {
  return NWG * 128 + (NWG == 2 ? 128 : 32);
}

template <int NWG>
__global__ void __launch_bounds__(fwd_threads<NWG>(), 1)
    mla_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap to, float* __restrict__ lse,
                         int Sq, int Sk, int H, int nkb, int nvb, int n_rt, int B,
                         float scale_log2, int causal) {
  constexpr int CONSUMERS = NWG * 128;
  constexpr int VST = 4 * NWG * KB_BOX;   // bytes of a V stage
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * FWD_STAGES];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  constexpr int kst = MAX_KB * KB_BOX;    // bytes of a K stage
  uint8_t* sQ = base;
  uint8_t* sK = sQ + MAX_KB * BOX_BYTES;
  uint8_t* sV = sK + FWD_STAGES * kst;
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + FWD_STAGES;
  uint64_t* empty = bars + 1 + 2 * FWD_STAGES;

  const RowTile tile((int)blockIdx.x, n_rt, B, Sq, Sk, H, causal);
  const int64_t r0 = tile.r0, M = tile.M;
  const int b = tile.b, n_kt = tile.n_kt;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < FWD_STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (nkb < MAX_KB && tid < CONSUMERS) {
    zero_boxes(sQ, BOX_BYTES, nkb, MAX_KB, CONSUMERS);
    for (int s = 0; s < FWD_STAGES; ++s) zero_boxes(sK + s * kst, KB_BOX, nkb, MAX_KB, CONSUMERS);
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ------------------------------------------------- producer warp(s)
    if constexpr (NWG == 2) producer_regs();
    if (tid == CONSUMERS) {
      mbar_expect_tx(q_full, nkb * BOX_BYTES);
      for (int c = 0; c < nkb; ++c)
        tma_load_4d(sQ + c * BOX_BYTES, &tq, q_full, c * 64, 0, (int)r0, b);
      for (int t = 0; t < n_kt; ++t) {
        const int s = t % FWD_STAGES;
        mbar_wait(&empty[s], ((t / FWD_STAGES) & 1) ^ 1);
        mbar_expect_tx(&k_full[s], nkb * KB_BOX);
        for (int c = 0; c < nkb; ++c)
          tma_load_4d(sK + s * kst + c * KB_BOX, &tk, &k_full[s], c * 64, 0, t * BN, b);
        mbar_expect_tx(&v_full[s], nvb * KB_BOX);
        for (int c = 0; c < nvb; ++c)
          tma_load_4d(sV + s * VST + c * KB_BOX, &tv, &v_full[s], c * 64, 0, t * BN, b);
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  if constexpr (NWG == 2) consumer_regs();
  const int wg = tid / 128, wtid = tid % 128, lane = tid % 32;
  const ThreadRows rows(wtid, r0, M, H);
  const int64_t first = r0 / H;   // the tile's first position
  float o[128];
  zero(o);
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float sc[16];
  uint32_t pa[8];
  const uint32_t q_addr = smem_u32(sQ);

  // S = Q.K^T of stage t into sc, issued and committed
  auto issue_qk = [&](int t) {
    const int s = t % FWD_STAGES;
    mbar_wait(&k_full[s], (t / FWD_STAGES) & 1);
    const uint32_t k_addr = smem_u32(sK + s * kst);
    wg_fence();
#pragma unroll
    for (int c = 0; c < MAX_KB; ++c) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n32(sc, desc_kmajor(q_addr + c * BOX_BYTES + kk * 32),
                     desc_kmajor(k_addr + c * KB_BOX + kk * 32), (c | kk) != 0);
    }
    wg_commit();
  };
  // O[:, this warpgroup's 256 columns] += P.V of stage t, issued and committed
  auto issue_pv = [&](int t) {
    const int s = t % FWD_STAGES;
    mbar_wait(&v_full[s], (t / FWD_STAGES) & 1);
    const uint32_t v_addr = smem_u32(sV + s * VST + wg * 4 * KB_BOX);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs_n256(o, pa + 4 * kk, desc_mn(v_addr + kk * 16 * 128, KB_BOX));
    wg_commit();
  };
  // the online softmax of stage t (log2 units), as flash_attention.cu's bf16
  // kernel: sc becomes P, the factors O is rescaled by come back in a0, a1
  float a0 = 1.f, a1 = 1.f;
  auto softmax = [&](int t) {
    const int k0 = t * BN;
    const bool edge = k0 + BN > Sk || r0 + BM > M || (causal && k0 + BN - 1 > first);
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      float v = sc[r] * scale_log2;
      if (edge && rows.masked(r, k0, Sk, causal)) v = NEG_INF;
      sc[r] = v;
      if ((r % 4) < 2) mx0 = fmaxf(mx0, v);
      else mx1 = fmaxf(mx1, v);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    a0 = exp2f(m0 - mn0);
    a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      if ((r % 4) < 2) {
        sc[r] = exp2f(sc[r] - mn0);
        rs0 += sc[r];
      } else {
        sc[r] = exp2f(sc[r] - mn1);
        rs1 += sc[r];
      }
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
  };
  auto pack_p = [&]() {
#pragma unroll
    for (int i = 0; i < 8; ++i) pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
  };

  mbar_wait(q_full, 0);
  issue_qk(0);
  wg_wait_all();
  fence_regs(sc);
  softmax(0);
  pack_p();
  for (int t = 1; t < n_kt; ++t) {
    issue_qk(t);
    issue_pv(t - 1);
    wg_wait_one();   // S of stage t is in; P.V of stage t - 1 may still run
    fence_regs(sc);
    softmax(t);
    wg_wait_all();
    fence_regs(o);
    mbar_arrive(&empty[(t - 1) % FWD_STAGES]);
#pragma unroll
    for (int r = 0; r < 128; ++r) o[r] *= (r % 4) < 2 ? a0 : a1;
    pack_p();
  }
  issue_pv(n_kt - 1);
  wg_wait_all();
  fence_regs(o);
  mbar_arrive(&empty[(n_kt - 1) % FWD_STAGES]);

  // ----------------------------------------------------------- epilogue
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if (lse != nullptr && wg == 0 && lane % 4 == 0) {
    const float ls[2] = {(m0 + log2f(fmaxf(l0, 1e-30f))) * LN2,
                         (m1 + log2f(fmaxf(l1, 1e-30f))) * LN2};
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (rows.ok[i]) lse[((int64_t)b * H + rows.R[i] % H) * Sq + rows.pos[i]] = ls[i];
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  bar_sync(1, CONSUMERS);   // every product that reads the Q tile or the ring is done
  uint8_t* so = base + wg * 4 * BOX_BYTES;
#pragma unroll
  for (int r = 0; r < 128; r += 2) {
    const int row = rows.row0 + ((r % 4) >= 2 ? 8 : 0);
    const float inv = (r % 4) >= 2 ? inv1 : inv0;
    *reinterpret_cast<uint32_t*>(so + sw_box(row, (r / 4) * 8 + rows.cq)) =
        pack_bf16(o[r] * inv, o[r + 1] * inv);
  }
  fence_async_shared();
  bar_sync(1, CONSUMERS);
  if (tid == 0) {
    for (int c = 0; c < nvb; ++c) tma_store_4d(&to, base + c * BOX_BYTES, c * 64, 0, (int)r0, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ------------------------------------------------------------ backward
//
// 1. rows (mla_bwd_rows_wgmma_kernel): a block per row tile, two consumer
//    warpgroups and a producer warpgroup (its registers go to the
//    consumers: dQ alone is 160 accumulators a thread in warpgroup 1).  The
//    producer loads the tile's Q and dO once (136 KB at full width) and
//    streams 32-key stages of K and V (one stage each: what shared memory
//    leaves) over the keys the tile's rows see, twice.  Warpgroup 0 computes S = Q.K^T and P = exp(scale S
//    - lse), warpgroup 1 dP = dO.V^T (both m64n32k16 from shared memory, at
//    once); P passes to warpgroup 1 through shared memory.  The first pass
//    sums p * dp and p a row (the port's D), and warpgroup 1 releases each
//    K stage before its own products; the second writes P and dS =
//    P (dP - D) scale (bf16) to the scratch, hands dS back to warpgroup 0,
//    and both accumulate dQ = dS.K in registers (m64n256k16 with dS in
//    registers, K MN-major; warpgroup 0 Dk's columns 0-255, warpgroup 1
//    256-575).  dQ leaves through shared memory by TMA.
// 2. keys (mla_bwd_keys_wgmma_kernel): a block per (128 keys, slab of 256
//    columns of dK or dV, batch row x chunk of 32 row tiles), two consumer
//    warpgroups of 64 keys each and a producer warp that streams each row
//    tile's two dS (P) tiles and its Q (dO) slab, which both warpgroups
//    read, into a four-stage ring; dK = dS^T.Q (dV = P^T.dO) is m64n256k16
//    with both operands MN-major in shared memory, summed into the chunk's
//    float32 partial.  The launch reads the row tiles' slabs from L2 once
//    for every 128 keys that they see.
// 3. finish (mla_bwd_finish_kernel): the chunks' partials summed in order.

// dynamic shared memory of the rows launch: Q and dO tiles, a K and a V
// stage (9 and 8 boxes), P (float32) and dS (bf16) of a stage; + 1 KiB of
// alignment
__host__ __device__ __forceinline__ size_t rows_smem() {
  return 1024 + (size_t)(MAX_KB + MAX_VB) * BOX_BYTES + (size_t)(MAX_KB + MAX_VB) * KB_BOX +
         (size_t)BM * BN * 4 + (size_t)BM * BN * 2;
}

// of the keys launch: four stages of two dS (P) tiles and a slab
__host__ __device__ __forceinline__ size_t keys_smem() {
  return 1024 + (size_t)KEY_STAGES * (2 + SLAB) * BOX_BYTES;
}

__global__ void __launch_bounds__(ROWS_THREADS, 1)
    mla_bwd_rows_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tdo,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdq,
                              const float* __restrict__ lse, bf16* __restrict__ P,
                              bf16* __restrict__ dS, int Sq, int Sk, int H, int nkb, int nvb,
                              int n_rt, int B, int64_t rows_pad, int64_t keys_pad, float scale,
                              int causal) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[5];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = base;
  uint8_t* sdO = sQ + MAX_KB * BOX_BYTES;
  uint8_t* sK = sdO + MAX_VB * BOX_BYTES;
  uint8_t* sV = sK + MAX_KB * KB_BOX;
  float* xP = reinterpret_cast<float*>(sV + MAX_VB * KB_BOX);  // [16][128] a thread's P
  uint32_t* xdS = reinterpret_cast<uint32_t*>(xP + BM * BN);  // [8][128] its dS, bf16 pairs
  uint64_t* qd_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 2;
  uint64_t* k_empty = bars + 3;
  uint64_t* v_empty = bars + 4;

  const RowTile tile((int)blockIdx.x, n_rt, B, Sq, Sk, H, causal);
  const int64_t r0 = tile.r0, M = tile.M;
  const int b = tile.b, n_kt = tile.n_kt, U = 2 * n_kt;   // stages: two passes
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(qd_full, 1);
    mbar_init(k_full, 1);
    mbar_init(v_full, 1);
    mbar_init(k_empty, 256);
    mbar_init(v_empty, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < 256) {
    zero_boxes(sQ, BOX_BYTES, nkb, MAX_KB, 256);
    zero_boxes(sdO, BOX_BYTES, nvb, MAX_VB, 256);
    zero_boxes(sK, KB_BOX, nkb, MAX_KB, 256);
    zero_boxes(sV, KB_BOX, nvb, MAX_VB, 256);
  }
  __syncthreads();

  if (tid >= 256) {
    // ------------------------------------------------ producer warpgroup
    producer_regs();
    if (tid == 256) {
      mbar_expect_tx(qd_full, (nkb + nvb) * BOX_BYTES);
      for (int c = 0; c < nkb; ++c)
        tma_load_4d(sQ + c * BOX_BYTES, &tq, qd_full, c * 64, 0, (int)r0, b);
      for (int c = 0; c < nvb; ++c)
        tma_load_4d(sdO + c * BOX_BYTES, &tdo, qd_full, c * 64, 0, (int)r0, b);
      for (int u = 0; u < U; ++u) {
        const int t = u < n_kt ? u : u - n_kt, par = (u & 1) ^ 1;
        mbar_wait(v_empty, par);
        mbar_expect_tx(v_full, nvb * KB_BOX);
        for (int c = 0; c < nvb; ++c)
          tma_load_4d(sV + c * KB_BOX, &tv, v_full, c * 64, 0, t * BN, b);
        mbar_wait(k_empty, par);
        mbar_expect_tx(k_full, nkb * KB_BOX);
        for (int c = 0; c < nkb; ++c)
          tma_load_4d(sK + c * KB_BOX, &tk, k_full, c * 64, 0, t * BN, b);
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  // Named barriers between the two (256 threads each): 1 P is in xP,
  // 2 xP has been read, 3 dS is in xdS, 4 xdS has been read.
  consumer_regs();
  const int wg = tid / 128, wtid = tid % 128;
  const ThreadRows rows(wtid, r0, M, H);
  const int64_t first = r0 / H;
  bf16* Pb = P + (int64_t)b * rows_pad * keys_pad;
  bf16* dSb = dS + (int64_t)b * rows_pad * keys_pad;
  const uint32_t k_addr = smem_u32(sK);
  float dq[128];   // dQ, Dk columns 256 wg .. 256 wg + 255
  zero(dq);
  float dq8[32];   // warpgroup 1: columns 512-575
  zero(dq8);
  auto edge_of = [&](int k0) {
    return k0 + BN > Sk || r0 + BM > M || (causal && k0 + BN - 1 > first);
  };
  // a stage's 16 values of this thread, bf16 pairs, to the scratch
  auto store_pairs = [&](bf16* dst, int k0, const uint32_t* pairs) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = 2 * i;
      const int64_t row = r0 + rows.row0 + ((r % 4) >= 2 ? 8 : 0);
      const int key = k0 + (r / 4) * 8 + rows.cq;
      *reinterpret_cast<uint32_t*>(dst + row * keys_pad + key) = pairs[i];
    }
  };
  mbar_wait(qd_full, 0);

  if (wg == 0) {
    // ------------------------------------- warpgroup 0: S, P, dQ[:, 0:256]
    float lse2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      lse2[i] = rows.ok[i] ? lse[((int64_t)b * H + rows.R[i] % H) * Sq + rows.pos[i]] * LOG2E
                           : 0.f;
    const float scale_log2 = scale * LOG2E;
    const uint32_t q_addr = smem_u32(sQ);
    float p[16];
    for (int u = 0; u < U; ++u) {
      const bool pass2 = u >= n_kt;
      const int t = pass2 ? u - n_kt : u, k0 = t * BN;
      mbar_wait(k_full, u & 1);
      wg_fence();
#pragma unroll
      for (int c = 0; c < MAX_KB; ++c) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n32(p, desc_kmajor(q_addr + c * BOX_BYTES + kk * 32),
                       desc_kmajor(k_addr + c * KB_BOX + kk * 32), (c | kk) != 0);
      }
      wg_commit();
      wg_wait_all();
      fence_regs(p);
      if (!pass2) mbar_arrive(k_empty);
      const bool edge = edge_of(k0);
#pragma unroll
      for (int r = 0; r < 16; ++r)
        p[r] = edge && rows.masked(r, k0, Sk, causal)
                   ? 0.f
                   : exp2f(p[r] * scale_log2 - lse2[(r % 4) >= 2]);
      if (u > 0) bar_sync(2, 256);
#pragma unroll
      for (int r = 0; r < 16; ++r) xP[r * 128 + wtid] = p[r];
      bar_arrive(1, 256);
      if (pass2) {
        uint32_t pp[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) pp[i] = pack_bf16(p[2 * i], p[2 * i + 1]);
        store_pairs(Pb, k0, pp);
        bar_sync(3, 256);
        uint32_t ds[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) ds[i] = xdS[i * 128 + wtid];
        if (t < n_kt - 1) bar_arrive(4, 256);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_rs_n256(dq, ds + 4 * kk, desc_mn(k_addr + kk * 16 * 128, KB_BOX));
        wg_commit();
        wg_wait_all();
        fence_regs(dq);
        mbar_arrive(k_empty);
      }
    }
    if (n_kt % 2) {   // the dK / dV launch reads whole 64-key tiles
      const uint32_t zeros[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      store_pairs(Pb, n_kt * BN, zeros);
    }
  } else {
    // ---------------------------------- warpgroup 1: dP, dS, dQ[:, 256:576]
    const uint32_t do_addr = smem_u32(sdO), v_addr = smem_u32(sV);
    float dp[16];
    float pdp[2] = {0.f, 0.f}, ps[2] = {0.f, 0.f}, D[2] = {0.f, 0.f};
    for (int u = 0; u < U; ++u) {
      const bool pass2 = u >= n_kt;
      const int t = pass2 ? u - n_kt : u, k0 = t * BN;
      // the first pass reads no K here: release it at once, so that the
      // next stage's K loads while warpgroup 0 takes its exponentials
      if (!pass2) mbar_arrive(k_empty);
      mbar_wait(v_full, u & 1);
      wg_fence();
#pragma unroll
      for (int c = 0; c < MAX_VB; ++c) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n32(dp, desc_kmajor(do_addr + c * BOX_BYTES + kk * 32),
                       desc_kmajor(v_addr + c * KB_BOX + kk * 32), (c | kk) != 0);
      }
      wg_commit();
      wg_wait_all();
      fence_regs(dp);
      mbar_arrive(v_empty);
      bar_sync(1, 256);   // P of this stage is in xP, read in place
      if (!pass2) {
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          const float pr = xP[r * 128 + wtid];
          pdp[(r % 4) >= 2] += pr * dp[r];
          ps[(r % 4) >= 2] += pr;
        }
        if (u < U - 1) bar_arrive(2, 256);
        if (t == n_kt - 1) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
#pragma unroll
            for (int off = 1; off <= 2; off <<= 1) {
              pdp[i] += __shfl_xor_sync(0xffffffffu, pdp[i], off);
              ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], off);
            }
            D[i] = pdp[i] / ps[i];
          }
        }
      } else {
        const bool edge = edge_of(k0);
        uint32_t ds[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float d2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = 2 * i + e;
            d2[e] = edge && rows.masked(r, k0, Sk, causal)
                        ? 0.f
                        : xP[r * 128 + wtid] * (dp[r] - D[(r % 4) >= 2]) * scale;
          }
          ds[i] = pack_bf16(d2[0], d2[1]);
        }
        if (u < U - 1) bar_arrive(2, 256);
        if (t > 0) bar_sync(4, 256);
#pragma unroll
        for (int i = 0; i < 8; ++i) xdS[i * 128 + wtid] = ds[i];
        bar_arrive(3, 256);
        store_pairs(dSb, k0, ds);
        mbar_wait(k_full, u & 1);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_rs_n256(dq, ds + 4 * kk, desc_mn(k_addr + 4 * KB_BOX + kk * 16 * 128, KB_BOX));
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_rs_n64(dq8, ds + 4 * kk, desc_mn(k_addr + 8 * KB_BOX + kk * 16 * 128, KB_BOX));
        wg_commit();
        wg_wait_all();
        fence_regs(dq);
        fence_regs(dq8);
        mbar_arrive(k_empty);
      }
    }
    if (n_kt % 2) {
      const uint32_t zeros[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      store_pairs(dSb, n_kt * BN, zeros);
    }
  }

  // dQ through the Q tile's shared memory (every S product is done: the
  // last P passed barrier 1 after it) and out by TMA, a warpgroup its boxes
  const int box0 = wg * 4;
#pragma unroll
  for (int r = 0; r < 128; r += 2) {
    const int row = rows.row0 + ((r % 4) >= 2 ? 8 : 0);
    const int col = box0 * 64 + (r / 4) * 8 + rows.cq;
    if (col / 64 < nkb)
      *reinterpret_cast<uint32_t*>(sQ + sw_box(row, col)) = pack_bf16(dq[r], dq[r + 1]);
  }
  if (wg == 1 && nkb > 8) {
#pragma unroll
    for (int r = 0; r < 32; r += 2) {
      const int row = rows.row0 + ((r % 4) >= 2 ? 8 : 0);
      *reinterpret_cast<uint32_t*>(sQ + sw_box(row, 512 + (r / 4) * 8 + rows.cq)) =
          pack_bf16(dq8[r], dq8[r + 1]);
    }
  }
  fence_async_shared();
  bar_sync(5 + wg, 128);
  if (wtid == 0) {
    const int box_end = wg == 0 ? (nkb < 4 ? nkb : 4) : nkb;
    for (int c = box0; c < box_end; ++c)
      tma_store_4d(&tdq, sQ + c * BOX_BYTES, c * 64, 0, (int)r0, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

__global__ void __launch_bounds__(KEYS_THREADS, 1)
    mla_bwd_keys_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tdo,
                              const __grid_constant__ CUtensorMap tp,
                              const __grid_constant__ CUtensorMap tds, float* __restrict__ part,
                              int Sq, int Sk, int H, int Dk, int Dv, int n_kb, int B,
                              int causal) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * KEY_STAGES];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  constexpr int STAGE = (2 + SLAB) * BOX_BYTES;   // two dS (P) tiles, then the slab
  uint64_t* full = bars;
  uint64_t* empty = bars + KEY_STAGES;

  const int nkb = boxes(Dk), nvb = boxes(Dv), nks = (nkb + SLAB - 1) / SLAB;
  const int kb = (int)(blockIdx.x % n_kb), sl = (int)(blockIdx.x / n_kb);
  const bool is_k = sl < nks;                      // a slab of dK, or of dV
  const int nb = is_k ? nkb : nvb;
  const int box0 = (is_k ? sl : sl - nks) * SLAB;  // the slab's first box
  const int nload = nb - box0 < SLAB ? nb - box0 : SLAB;
  const int b = (int)(blockIdx.y % B), chunk = (int)(blockIdx.y / B);
  const int64_t M = (int64_t)Sq * H, n_rt = (M + BM - 1) / BM;
  const int64_t keys_pad = (Sk + KEY_TILE - 1) / KEY_TILE * KEY_TILE;
  const int k0 = kb * BLOCK_KEYS;                   // the block's first key
  const bool two = k0 + KEY_TILE < keys_pad;        // its second 64-key tile exists
  // the chunk's row tiles that see the block's first key (row k0 H is the
  // first at position k0)
  int64_t rt_lo = (int64_t)chunk * ROW_CHUNK;
  const int64_t rt_hi = lmin(n_rt, rt_lo + ROW_CHUNK);
  if (causal) rt_lo = lmax(rt_lo, (int64_t)k0 * H / BM);
  const int n = (int)lmax(0, rt_hi - rt_lo);
  const CUtensorMap* msrc = is_k ? &tds : &tp;
  const CUtensorMap* mrow = is_k ? &tq : &tdo;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < KEY_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ---------------------------------------------------- producer warp
    if (tid == 256) {
      for (int i = 0; i < n; ++i) {
        const int s = i % KEY_STAGES;
        const int r0 = (int)((rt_lo + i) * BM);
        uint8_t* st = base + s * STAGE;
        mbar_wait(&empty[s], ((i / KEY_STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], (1 + two + nload) * BOX_BYTES);
        tma_load_4d(st, msrc, &full[s], k0, 0, r0, b);
        if (two) tma_load_4d(st + BOX_BYTES, msrc, &full[s], k0 + KEY_TILE, 0, r0, b);
        for (int c = 0; c < nload; ++c)
          tma_load_4d(st + (2 + c) * BOX_BYTES, mrow, &full[s], (box0 + c) * 64, 0, r0, b);
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroups
  // warpgroup w: keys k0 + 64 w .., the slab's 256 columns, one m64n256k16
  // a 16-row step: A = its tile's dS^T (keys x rows), B = the rows' columns;
  // a row tile whose rows see none of its keys is skipped (the rows launch
  // wrote no dS there)
  const int wg = tid / 128, wtid = tid % 128;
  const int kw = k0 + wg * KEY_TILE;
  float acc[128];
  zero(acc);
  for (int i = 0; i < n; ++i) {
    const int s = i % KEY_STAGES;
    const int64_t r0 = (rt_lo + i) * BM;
    const int64_t kv_end = causal ? lmin(Sk, (lmin(r0 + BM, M) - 1) / H + 1) : Sk;
    mbar_wait(&full[s], (i / KEY_STAGES) & 1);
    if (kw < kv_end) {
      const uint32_t a = smem_u32(base + s * STAGE);
      const uint32_t x = a + 2 * BOX_BYTES;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
        wgmma_ss_tt_n256(acc, desc_mn(a + wg * BOX_BYTES + kk * 16 * 128, BOX_BYTES),
                         desc_mn(x + kk * 16 * 128, BOX_BYTES), 1);
    }
    wg_commit();   // a group every stage, empty or not
    if (i > 0) {
      wg_wait_one();   // the products of stage i - 1 are done
      mbar_arrive(&empty[(i - 1) % KEY_STAGES]);
    }
  }
  wg_wait_all();
  fence_regs(acc);
  const int W = Dk + Dv, width = is_k ? Dk : Dv;
  float* pb = part + ((int64_t)chunk * B + b) * Sk * W + (is_k ? 0 : Dk);
  const ThreadRows rows(wtid, 0, KEY_TILE, 1);   // rows of the accumulator: keys
#pragma unroll
  for (int r = 0; r < 128; r += 2) {
    const int key = kw + rows.row0 + ((r % 4) >= 2 ? 8 : 0);
    const int col = box0 * 64 + (r / 4) * 8 + rows.cq;
    if (key < Sk && col < width)
      *reinterpret_cast<float2*>(pb + (int64_t)key * W + col) = make_float2(acc[r], acc[r + 1]);
  }
}

// ------------------------------------------------------------ launches

// a (B, rows, D) bf16 matrix as TMA reads it: rows of D elements, boxes of
// `box_rows` rows
inline int matrix_map(CUtensorMap* map, const void* ptr, int64_t B, int64_t rows, int64_t D,
                      int box_rows) {
  return cached_map(map, ptr, B, rows, 1, D, Strides{rows * D, D, D}, 2, box_rows);
}

inline int set_smem(const void* kern, size_t bytes) {
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

inline int fwd(const void* q, const void* k, const void* v, void* o, float* lse, int64_t B,
               int64_t Sq, int64_t Sk, int64_t H, int Dk, int Dv, float scale, int causal,
               cudaStream_t st) {
  const int64_t M = Sq * H, n_rt = (M + BM - 1) / BM;
  if (n_rt * B > 0x7fffffff) return -1;
  const int nkb = boxes(Dk), nvb = boxes(Dv), nwg = fwd_groups(nvb);
  CUtensorMap tq, tk, tv, to;
  int rc;
  if ((rc = matrix_map(&tq, q, B, M, Dk, BM)) != 0) return rc;
  if ((rc = matrix_map(&tk, k, B, Sk, Dk, BN)) != 0) return rc;
  if ((rc = matrix_map(&tv, v, B, Sk, Dv, BN)) != 0) return rc;
  if ((rc = matrix_map(&to, o, B, M, Dv, BM)) != 0) return rc;
  const size_t smem = fwd_smem(nvb);
  const float sl2 = scale * LOG2E;
  if (nwg == 2) {
    if ((rc = set_smem((const void*)mla_fwd_wgmma_kernel<2>, smem)) != 0) return rc;
    mla_fwd_wgmma_kernel<2><<<(unsigned)(n_rt * B), fwd_threads<2>(), smem, st>>>(
        tq, tk, tv, to, lse, (int)Sq, (int)Sk, (int)H, nkb, nvb, (int)n_rt, (int)B, sl2, causal);
  } else {
    if ((rc = set_smem((const void*)mla_fwd_wgmma_kernel<1>, smem)) != 0) return rc;
    mla_fwd_wgmma_kernel<1><<<(unsigned)(n_rt * B), fwd_threads<1>(), smem, st>>>(
        tq, tk, tv, to, lse, (int)Sq, (int)Sk, (int)H, nkb, nvb, (int)n_rt, (int)B, sl2, causal);
  }
  return (int)cudaGetLastError();
}

// the rows and keys launches; the caller runs the finishing one
inline int bwd(const void* q, const void* k, const void* v, const float* lse, const void* dout,
               void* P, void* dS, float* part, void* dq, int64_t B, int64_t Sq, int64_t Sk,
               int64_t H, int Dk, int Dv, float scale, int causal, cudaStream_t st) {
  const int64_t M = Sq * H, n_rt = (M + BM - 1) / BM, rows_pad = n_rt * BM;
  const int64_t keys_pad = (Sk + KEY_TILE - 1) / KEY_TILE * KEY_TILE;
  const int64_t n_kb = (Sk + BLOCK_KEYS - 1) / BLOCK_KEYS;
  const int64_t chunks = (n_rt + ROW_CHUNK - 1) / ROW_CHUNK;
  const int nkb = boxes(Dk), nvb = boxes(Dv);
  const int64_t slabs = (nkb + SLAB - 1) / SLAB + (nvb + SLAB - 1) / SLAB;
  if (n_rt * B > 0x7fffffff || n_kb * slabs > 0x7fffffff || B * chunks > 65535) return -1;
  CUtensorMap tq, tdo, tk, tv, tdq, tp, tds;
  int rc;
  if ((rc = matrix_map(&tq, q, B, M, Dk, BM)) != 0) return rc;
  if ((rc = matrix_map(&tdo, dout, B, M, Dv, BM)) != 0) return rc;
  if ((rc = matrix_map(&tk, k, B, Sk, Dk, BN)) != 0) return rc;
  if ((rc = matrix_map(&tv, v, B, Sk, Dv, BN)) != 0) return rc;
  if ((rc = matrix_map(&tdq, dq, B, M, Dk, BM)) != 0) return rc;
  if ((rc = matrix_map(&tp, P, B, rows_pad, keys_pad, BM)) != 0) return rc;
  if ((rc = matrix_map(&tds, dS, B, rows_pad, keys_pad, BM)) != 0) return rc;
  const size_t smem_rows = rows_smem(), smem_keys = keys_smem();
  if ((rc = set_smem((const void*)mla_bwd_rows_wgmma_kernel, smem_rows)) != 0) return rc;
  if ((rc = set_smem((const void*)mla_bwd_keys_wgmma_kernel, smem_keys)) != 0) return rc;
  mla_bwd_rows_wgmma_kernel<<<(unsigned)(n_rt * B), ROWS_THREADS, smem_rows, st>>>(
      tq, tdo, tk, tv, tdq, lse, (bf16*)P, (bf16*)dS, (int)Sq, (int)Sk, (int)H, nkb, nvb,
      (int)n_rt, (int)B, rows_pad, keys_pad, scale, causal);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mla_bwd_keys_wgmma_kernel<<<dim3((unsigned)(n_kb * slabs), (unsigned)(B * chunks)),
                              KEYS_THREADS, smem_keys, st>>>(tq, tdo, tp, tds, part, (int)Sq,
                                                            (int)Sk, (int)H, Dk, Dv, (int)n_kb,
                                                            (int)B, causal);
  return (int)cudaGetLastError();
}

}  // namespace mlawg
}  // namespace
