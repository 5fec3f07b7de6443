// Building blocks of the port's Hopper (sm_90a) tensor-core kernels
// (flash_attention.cu, ssd_chunk.cu): shared-memory addresses, mbarriers,
// the wgmma fence, commit and wait, the 128-byte-swizzle descriptor, and
// the float32-on-TF32 (3xTF32) kit both kernels' float32 routes share: the
// hi/lo split, the K-major swizzled tile layout, the tf32 wgmma wrappers,
// and the producers' global -> split -> shared tile stages.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// wait until at most the newest group is pending
__device__ __forceinline__ void wg_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// keep the compiler from moving reads of accumulators across the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; byte offsets
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// ------------------------------------------------- float32 on TF32 (3xTF32)
//
// A TF32 product keeps 10 mantissa bits of each operand.  Each float32
// operand x is split into hi = tf32(x) and lo = tf32(x - hi),
// and a product is hi.hi + hi.lo + lo.hi accumulated in float32 by wgmma
// (tf32, k = 8).  tf32 wgmma reads shared-memory operands only K-major.

constexpr int WG_ROWS = 64;   // rows of a warpgroup's m64 tile

// the producer's generic stores, made visible to wgmma's async proxy
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// tf32(x), three ways.  cvt and bits round to nearest with ties away from
// zero, to the same bits: the conversion instruction (cvt.rna.tf32.f32), or
// two integer operations (half a tf32 ulp added to the magnitude, the 13 low
// bits cleared).  trunc clears the 13 low bits (toward zero).  Which is
// faster depends on the kernel's mix of instructions (PERF.md: the integer
// forms for flash attention and the backward kernels, the instruction for
// the SSD chunk's forward), so the kernel chooses.
enum class Round { cvt, bits, trunc };

template <Round RND = Round::cvt>
__device__ __forceinline__ uint32_t to_tf32(float x) {
  if constexpr (RND == Round::bits) {
    return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  } else if constexpr (RND == Round::trunc) {
    return __float_as_uint(x) & 0xFFFFE000u;
  } else {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r;
  }
}

// x = hi + lo + e, hi = tf32(x): |e| ~2^-22 |x| (cvt), 2^-21 (bits), 2^-20
// (trunc).  The tensor core reads a tf32 operand's top 19 bits and drops
// the 13 low ones (truncation), so the integer forms hand it lo = x - hi
// unconverted, at no cost.  A NaN x gives a NaN hi: the rounding's carry
// would take CUDA's canonical NaN (0x7fffffff) into the sign and make it a
// zero, so bits keeps it apart; trunc cannot carry.
template <Round RND = Round::cvt>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32<RND>(x);
  if constexpr (RND == Round::bits) {
    if (x != x) hi = __float_as_uint(x) | 0x00400000u;
  }
  if constexpr (RND == Round::cvt)
    lo = to_tf32<RND>(x - __uint_as_float(hi));
  else
    lo = __float_as_uint(x - __uint_as_float(hi));
}

// Byte offset of element (r, k) of an R-row tile stored K-major for wgmma:
// 32-float (128-byte) column blocks of R rows each, 128-byte swizzle (the
// 16-byte chunk index XOR the row within its 8-row group).
__device__ __forceinline__ uint32_t sw_off(int r, int k, int R) {
  return (uint32_t)((k >> 5) * (R * 128) + r * 128 + ((((k & 31) >> 2) ^ (r & 7)) << 4) +
                    (k & 3) * 4);
}

// the K-major descriptor of the k-th 8-wide k step of an R-row tile: rows
// of 128 bytes, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_k(uint32_t base, int kk, int R) {
  return desc_sw128(base + (kk >> 2) * (R * 128) + (kk & 3) * 32, 16, 1024);
}

// d (m64 x n64, f32) += A (smem, K-major) . B (smem, K-major), tf32; with
// scale_d 0, d = A . B (d's old values not read)
__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                                  int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (m64 x n128, f32) += A (smem, K-major) . B (smem, K-major), tf32
__device__ __forceinline__ void wgmma_tf32_ss_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d (m64 x n64, f32) += A (registers, tf32) . B (smem, K-major), tf32
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n96, f32) += A (registers, tf32) . B (smem, K-major), tf32
__device__ __forceinline__ void wgmma_tf32_rs_n96(float (&d)[48], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (m64 x n128, f32) += A (registers, tf32) . B (smem, K-major), tf32
__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// acc (64 x n64) += A . B over K = 8 * ksteps with both operands split:
// lo.hi, hi.lo, then hi.hi for each k step (smallest terms first)
__device__ __forceinline__ void mma3_ss_n64(float (&d)[32], uint32_t a_hi, uint32_t a_lo,
                                            uint32_t b_hi, uint32_t b_lo, int ksteps, int rb) {
  for (int kk = 0; kk < ksteps; ++kk) {
    wgmma_tf32_ss_n64(d, desc_k(a_lo, kk, WG_ROWS), desc_k(b_hi, kk, rb));
    wgmma_tf32_ss_n64(d, desc_k(a_hi, kk, WG_ROWS), desc_k(b_lo, kk, rb));
    wgmma_tf32_ss_n64(d, desc_k(a_hi, kk, WG_ROWS), desc_k(b_hi, kk, rb));
  }
}

__device__ __forceinline__ void mma3_ss_n128(float (&d)[64], uint32_t a_hi, uint32_t a_lo,
                                             uint32_t b_hi, uint32_t b_lo, int ksteps) {
  for (int kk = 0; kk < ksteps; ++kk) {
    wgmma_tf32_ss_n128(d, desc_k(a_lo, kk, WG_ROWS), desc_k(b_hi, kk, 128));
    wgmma_tf32_ss_n128(d, desc_k(a_hi, kk, WG_ROWS), desc_k(b_lo, kk, 128));
    wgmma_tf32_ss_n128(d, desc_k(a_hi, kk, WG_ROWS), desc_k(b_hi, kk, 128));
  }
}

// ------------------------------------------------------- producer stages
//
// Each stage is two phases: every global load of the tile is issued first
// (into registers, before the producer waits for a free slot, so their
// latency overlaps the wait), then the values are split and stored.  Loads
// are 16 bytes where the tensor allows (a 16-byte-aligned base, strides
// and the row length multiples of 4 floats: flag `vec`), else 4.

__device__ __forceinline__ float4 load4(const float* row, int k, int cols, bool vec) {
  if (vec) return k < cols ? __ldg(reinterpret_cast<const float4*>(row + k)) : make_float4(0.f, 0.f, 0.f, 0.f);
  float4 v;
  v.x = k < cols ? __ldg(row + k) : 0.f;
  v.y = k + 1 < cols ? __ldg(row + k + 1) : 0.f;
  v.z = k + 2 < cols ? __ldg(row + k + 2) : 0.f;
  v.w = k + 3 < cols ? __ldg(row + k + 3) : 0.f;
  return v;
}

__device__ __forceinline__ float get(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

template <Round RND>
__device__ __forceinline__ void store_split(uint8_t* hi, uint8_t* lo, uint32_t off, float4 v) {
  uint4 h, l;
  split<RND>(v.x, h.x, l.x);
  split<RND>(v.y, h.y, l.y);
  split<RND>(v.z, h.z, l.z);
  split<RND>(v.w, h.w, l.w);
  *reinterpret_cast<uint4*>(hi + off) = h;
  *reinterpret_cast<uint4*>(lo + off) = l;
}

// A (64, NT) tile of rows: element (r, k) = src[r * ld + k] where r < rows
// and k < cols, else 0, filled by NP threads.  A thread takes 4 consecutive
// k of a row; eight neighbouring threads fill one 128-byte row,
// conflict-free.
template <int NT, int NP, Round RND = Round::cvt>
struct Rows {
  static constexpr int KC = NT / 4;
  static constexpr int U = WG_ROWS * KC / NP;
  float4 v[U];

  __device__ __forceinline__ void load(const float* src, int64_t ld, int rows, int cols,
                                       bool vec, int ptid) {
#pragma unroll
    for (int m = 0; m < U; ++m) {
      const int u = ptid + m * NP, r = u / KC, k = (u % KC) * 4;
      v[m] = r < rows ? load4(src + (int64_t)r * ld, k, cols, vec)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ __forceinline__ void store(uint8_t* hi, uint8_t* lo, int ptid) const {
#pragma unroll
    for (int m = 0; m < U; ++m) {
      const int u = ptid + m * NP;
      store_split<RND>(hi, lo, sw_off(u / KC, (u % KC) * 4, WG_ROWS), v[m]);
    }
  }
};

// An (R, 64) tile whose K index is column jj of a 64-row j-tile, in the
// permuted order (inside each 8-wide k step even jj in slots 0-3, odd jj in
// slots 4-7): element (r, slot of jj) = src[jj * ld + r] * s1[jj] * s2[jj]
// for jj < rows and r < cols, else 0, filled by NP threads.  A thread
// takes a 4 x 4 block: rows 4g..4g+3 (one 16-byte load along r per column)
// and the 16-byte chunk c, slots 4c..4c+3, which hold the columns
// jj = 8 (c / 2) + 2 q + (c % 2), q = 0..3.  Neighbouring threads take
// neighbouring row groups, so the loads are coalesced; each thread starts
// its four row stores at another row of the group, so a store phase of
// eight threads meets at most two of them in one bank.
template <int R, int NP, Round RND = Round::cvt>
struct Cols {
  static constexpr int G = R / 4;
  static constexpr int U = G * 16 / NP;
  float4 v[U][4];
  float sc[U][4][2];

  template <typename S>
  __device__ __forceinline__ void load(const float* src, int64_t ld, int rows, int cols,
                                       bool vec, S scale, int ptid) {
#pragma unroll
    for (int m = 0; m < U; ++m) {
      const int u = ptid + m * NP, g = u % G, c = u / G;
      const int jj0 = 8 * (c >> 1) + (c & 1);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int jj = jj0 + 2 * q;
        const bool ok = jj < rows;
        v[m][q] = ok ? load4(src + (int64_t)jj * ld, 4 * g, cols, vec)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
        scale(jj, ok, sc[m][q][0], sc[m][q][1]);
      }
    }
  }
  __device__ __forceinline__ void store(uint8_t* hi, uint8_t* lo, int ptid) const {
#pragma unroll
    for (int m = 0; m < U; ++m) {
      const int u = ptid + m * NP, g = u % G, c = u / G;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = (i + g) & 3;   // this thread's i-th row of its group
        float4 o;
        o.x = get(v[m][0], q) * sc[m][0][0] * sc[m][0][1];
        o.y = get(v[m][1], q) * sc[m][1][0] * sc[m][1][1];
        o.z = get(v[m][2], q) * sc[m][2][0] * sc[m][2][1];
        o.w = get(v[m][3], q) * sc[m][3][0] * sc[m][3][1];
        store_split<RND>(hi, lo, sw_off(4 * g + q, 4 * c, R), o);
      }
    }
  }
};

}  // namespace
