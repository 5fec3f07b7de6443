// The 64 x 64 tiles of the port's float32 kernels on 3xTF32 wgmma
// (flash_attention_bwd.cuh, ssd_chunk_bwd.cuh, mla_attention_tf32.cuh), on
// hopper.cuh's kit.
//
// Every operand a backward product reads from shared memory is a "unit":
// 64 rows by 64 K-major columns in the 128-byte-swizzled layout tf32 wgmma
// reads (hopper.cuh's sw_off with R = 64), its tf32 hi part at +0 and its
// lo part at +UNIT_HALF.  A tensor wider than 64 columns is cut into
// 64-column chunks, a unit each, and a product over it runs one chunk at a
// time; a narrower one is padded with zero columns (a product may skip the
// k steps past its width).  A unit is filled from global memory by
//   RowTile: element (r, k) = src[r * ld + k] * scale(r), 64 rows as they
//            lie (the A or B operand of a product over the columns);
//   ColTile: element (r, slot of jj) = src[jj * ld + r] * scale(jj), the
//            transpose, with the K index jj permuted inside each 8-wide k
//            step (even jj in slots 0-3, odd jj in 4-7): the B operand of a
//            product whose A is a register tile in the accumulator layout
//            (pack_a applies the same permutation), or both operands of a
//            product over rows; with PERM = false in its natural order, the
//            B operand of a product whose A is a RowTile.
// Sources are float32, read with 16-byte loads where their alignment allows
// (a tile's loads issued together, not one behind each branch).  Products
// run on both halves of each operand (3xTF32), every operand split by
// truncation (put4, pack_a).  Outputs of every product are m64n64 float32
// accumulators: a thread holds rows g and g + 8 of its warp's 16 (g =
// lane / 4) and, in each 8-column group, the columns 2 (lane % 4) and
// 2 (lane % 4) + 1.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int UROWS = 64;                      // rows of a unit
constexpr int UNIT_HALF = UROWS * 64 * 4;      // bytes of a unit's hi (or lo) part
constexpr int UNIT = 2 * UNIT_HALF;            // bytes of a unit

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// four floats of a row from column k, 0 past `cols` or where the row is not
// `ok`; with VEC one 16-byte load, issued whatever the predicates from an
// address that is valid (the tile's first element, `safe`).  VEC is a
// template argument and no load sits behind a branch, so a thread's loads
// of a tile issue together (a runtime choice a load serialised them)
template <bool VEC>
__device__ __forceinline__ float4 load4_or0(const float* row, const float* safe, bool ok, int k,
                                            int cols) {
  ok = ok && k < cols;
  if constexpr (VEC) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(ok ? row + k : safe));
    return ok ? x : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    return ok ? load4(row, k, cols, false) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// the values stored, split into tf32 hi and lo by truncation (hopper.cuh's
// Round::trunc, two instructions a value).  The producers' instructions set
// the backward kernels' pace: the conversion instruction took 4x the time
// of the rest of a unit's staging, and rounding by integer operations made
// the whole SSD backward 10 % slower than truncating (PERF.md)
__device__ __forceinline__ void put4(uint8_t* unit, uint32_t off, float4 v) {
  store_split<Round::trunc>(unit, unit + UNIT_HALF, off, v);
}

__device__ __forceinline__ float4 scale4(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

struct NoScale {
  __device__ __forceinline__ float operator()(int) const { return 1.f; }
};

// A RowTile filled by NP threads; a thread takes 4 consecutive columns of a
// row, eight neighbouring threads one 128-byte row (hopper.cuh's Rows).
template <int NP>
struct RowTile {
  static constexpr int U = UROWS * 16 / NP;
  float4 v[U];

  // rows < `rows` and columns < `cols` of src, else 0, row r scaled by
  // scale(r) (called for rows < `rows` only, else for row 0); 16-byte
  // loads where `vec`, with no predicates where the tile is full
  template <typename S>
  __device__ __forceinline__ void load(const float* src, int64_t ld, int rows, int cols, bool vec,
                                       S scale, int ptid) {
    if (vec && rows >= UROWS && cols >= 64)
      load_as<true, true>(src, ld, rows, cols, scale, ptid);
    else if (vec)
      load_as<true, false>(src, ld, rows, cols, scale, ptid);
    else
      load_as<false, false>(src, ld, rows, cols, scale, ptid);
  }
  template <bool VEC, bool FULL, typename S>
  __device__ __forceinline__ void load_as(const float* src, int64_t ld, int rows, int cols,
                                          S scale, int ptid) {
#pragma unroll
    for (int m = 0; m < U; ++m) {
      const int u = ptid + m * NP, r = u / 16, k = (u % 16) * 4;
      if constexpr (FULL) {
        v[m] = scale4(__ldg(reinterpret_cast<const float4*>(src + (int64_t)r * ld + k)), scale(r));
      } else {
        const bool ok = r < rows;
        const int rr = ok ? r : 0;
        v[m] = scale4(load4_or0<VEC>(src + (int64_t)rr * ld, src, ok, k, cols), scale(rr));
      }
    }
  }
  __device__ __forceinline__ void store(uint8_t* unit, int ptid) const {
#pragma unroll
    for (int m = 0; m < U; ++m) {
      const int u = ptid + m * NP;
      put4(unit, sw_off(u / 16, (u % 16) * 4, UROWS), v[m]);
    }
  }
};

// A ColTile filled by NP threads: a thread takes a 4 x 4 block, rows
// 4g..4g+3 of the unit (one load along r per source row jj) and the
// 16-byte chunk c of slots 4c..4c+3, which hold jj = 8 (c / 2) + 2 q +
// (c % 2), q = 0..3 (hopper.cuh's Cols), or jj = 4c + q without PERM.
// Neighbouring threads take neighbouring chunks c of one row group: a
// warp's load reads 32 bytes of each of 16 source rows, and the eight
// threads of a store phase write one unit row's eight 16-byte chunks, free
// of bank conflicts, each element in its place with no selection at run
// time.
template <int NP, bool PERM = true>
struct ColTile {
  static constexpr int G = UROWS / 4;
  static constexpr int U = G * 16 / NP;
  float4 v[U][4];

  // source rows jj < `rows` and columns r < `cols`, else 0, row jj scaled
  // by scale(jj) (called for rows < `rows` only, else for row 0); 16-byte
  // loads where `vec`, with no predicates where the tile is full
  template <typename S>
  __device__ __forceinline__ void load(const float* src, int64_t ld, int rows, int cols, bool vec,
                                       S scale, int ptid) {
    if (vec && rows >= UROWS && cols >= 64)
      load_as<true, true>(src, ld, rows, cols, scale, ptid);
    else if (vec)
      load_as<true, false>(src, ld, rows, cols, scale, ptid);
    else
      load_as<false, false>(src, ld, rows, cols, scale, ptid);
  }
  template <bool VEC, bool FULL, typename S>
  __device__ __forceinline__ void load_as(const float* src, int64_t ld, int rows, int cols,
                                          S scale, int ptid) {
#pragma unroll
    for (int m = 0; m < U; ++m) {
      const int u = ptid + m * NP, c = u % 16, g = u / 16;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int jj = PERM ? 8 * (c >> 1) + (c & 1) + 2 * q : 4 * c + q;
        if constexpr (FULL) {
          v[m][q] = scale4(__ldg(reinterpret_cast<const float4*>(src + (int64_t)jj * ld + 4 * g)),
                           scale(jj));
        } else {
          const bool ok = jj < rows;
          const int rr = ok ? jj : 0;
          v[m][q] = scale4(load4_or0<VEC>(src + (int64_t)rr * ld, src, ok, 4 * g, cols),
                           scale(rr));
        }
      }
    }
  }
  __device__ __forceinline__ void store(uint8_t* unit, int ptid) const {
#pragma unroll
    for (int m = 0; m < U; ++m) {
      const int u = ptid + m * NP, c = u % 16, g = u / 16;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float4 o;
        o.x = get(v[m][0], i);
        o.y = get(v[m][1], i);
        o.z = get(v[m][2], i);
        o.w = get(v[m][3], i);
        put4(unit, sw_off(4 * g + i, 4 * c, UROWS), o);
      }
    }
  }
};

// ------------------------------------------------------------- products

// d (64 x 64) += A . B^T over `ks` 8-wide k steps, both units in shared
// memory (addresses a, b): lo.hi, hi.lo, hi.hi a k step; with `set`, d =
// A . B^T (the first product does not read d, so d needs no zeroing)
__device__ __forceinline__ void mma_ss(float (&d)[32], uint32_t a, uint32_t b, int ks,
                                       bool set = false) {
#pragma unroll
  for (int kk = 0; kk < ks; ++kk) {
    const uint64_t ah = desc_k(a, kk, UROWS), bh = desc_k(b, kk, UROWS);
    wgmma_tf32_ss_n64(d, desc_k(a + UNIT_HALF, kk, UROWS), bh, !(set && kk == 0));
    wgmma_tf32_ss_n64(d, ah, desc_k(b + UNIT_HALF, kk, UROWS));
    wgmma_tf32_ss_n64(d, ah, bh);
  }
}

// d (64 x 64) += A . B^T over 64 K, A split in registers (pack_a), B a unit
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&ah)[32],
                                       const uint32_t (&al)[32], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t bh = desc_k(b, kk, UROWS);
    wgmma_tf32_rs_n64(d, al + 4 * kk, bh);
    wgmma_tf32_rs_n64(d, ah + 4 * kk, desc_k(b + UNIT_HALF, kk, UROWS));
    wgmma_tf32_rs_n64(d, ah + 4 * kk, bh);
  }
}

// an accumulator tile split into tf32 A fragments, the K index permuted
// inside each 8-wide k step as ColTile stages it: a thread holds columns
// 2t, 2t+1 of each 8 and A slot t takes column 2t, slot t + 4 column
// 2t + 1.  Fragment order: (row, t), (row + 8, t), (row, t + 4),
// (row + 8, t + 4).
__device__ __forceinline__ void pack_a(const float (&v)[32], uint32_t (&ah)[32],
                                       uint32_t (&al)[32]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    split<Round::trunc>(v[4 * kk + 0], ah[4 * kk + 0], al[4 * kk + 0]);
    split<Round::trunc>(v[4 * kk + 2], ah[4 * kk + 1], al[4 * kk + 1]);
    split<Round::trunc>(v[4 * kk + 1], ah[4 * kk + 2], al[4 * kk + 2]);
    split<Round::trunc>(v[4 * kk + 3], ah[4 * kk + 3], al[4 * kk + 3]);
  }
}

// half HF of pack_a: the fragments of k steps 4 HF .. 4 HF + 3 only, for
// kernels that cannot hold all 64 registers of a split tile
template <int HF>
__device__ __forceinline__ void pack_a_half(const float (&v)[32], uint32_t (&ah)[16],
                                            uint32_t (&al)[16]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int K = 4 * HF + kk;
    split<Round::trunc>(v[4 * K + 0], ah[4 * kk + 0], al[4 * kk + 0]);
    split<Round::trunc>(v[4 * K + 2], ah[4 * kk + 1], al[4 * kk + 1]);
    split<Round::trunc>(v[4 * K + 1], ah[4 * kk + 2], al[4 * kk + 2]);
    split<Round::trunc>(v[4 * K + 3], ah[4 * kk + 3], al[4 * kk + 3]);
  }
}

// d += (A's half HF, pack_a_half) . B over that half's 32 K, B a unit
template <int HF>
__device__ __forceinline__ void mma_rs_half(float (&d)[32], const uint32_t (&ah)[16],
                                            const uint32_t (&al)[16], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int K = 4 * HF + kk;
    const uint64_t bh = desc_k(b, K, UROWS);
    wgmma_tf32_rs_n64(d, al + 4 * kk, bh);
    wgmma_tf32_rs_n64(d, ah + 4 * kk, desc_k(b + UNIT_HALF, K, UROWS));
    wgmma_tf32_rs_n64(d, ah + 4 * kk, bh);
  }
}

// accumulator element r's row (0..63) and column (0..63) in its tile
__device__ __forceinline__ int acc_row(int warp, int lane, int r) {
  return warp * 16 + lane / 4 + ((r % 4) >= 2 ? 8 : 0);
}
__device__ __forceinline__ int acc_col(int lane, int r) {
  return (r / 4) * 8 + (lane % 4) * 2 + (r % 2);
}

// the sum over the four threads of an accumulator row
__device__ __forceinline__ float row_sum4(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// ------------------------------------------------ units landed by TMA
//
// A unit's 64 rows arrive raw by TMA (tma.cuh's float32 maps), 32 columns
// a box, each box one 32-column block of sw_off's layout (UBOX bytes): in
// its hi half, where the raw value is hi as it lies (the tensor core reads
// a tf32 operand's top 19 bits) and lo_pass writes lo, or in its lo half,
// from which transpose_unit builds the transposed unit.

constexpr int UBOX = UNIT_HALF / 2;           // bytes of a unit's 32-column block

__device__ __forceinline__ float4 lo4(float4 v) {
  const auto lo = [](float x) { return x - __uint_as_float(to_tf32<Round::trunc>(x)); };
  return make_float4(lo(v.x), lo(v.y), lo(v.z), lo(v.w));
}

// whether the barrier's phase of this parity has completed (no waiting)
__device__ __forceinline__ bool mbar_test(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// A row unit whose raw rows landed in its hi half: the tensor core reads a
// tf32 operand's top 19 bits, so the raw value is hi as it lies; the lo
// half gets x - trunc(x).  A thread takes 16-byte chunks, neighbours
// neighbouring chunks (the layout does not matter to an elementwise pass).
__device__ __forceinline__ void lo_pass(uint8_t* unit, int nb, int ptid) {
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    if (x < nb) {
      float4 v[4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        v[m] = *reinterpret_cast<const float4*>(unit + x * UBOX + (ptid + 128 * m) * 16);
#pragma unroll
      for (int m = 0; m < 4; ++m)
        *reinterpret_cast<float4*>(unit + UNIT_HALF + x * UBOX + (ptid + 128 * m) * 16) =
            lo4(v[m]);
    }
  }
}

// A transposed unit (ColTile's layout: element (r, slot of jj) = raw (jj,
// r), jj permuted inside each 8-wide k step as pack_a orders the A
// fragments) from the raw rows landed in its lo half: hi^T into the hi
// half, then, once every producer thread has read its raw values, lo^T
// over them.  A thread takes the 4 x 4 blocks of row group g (rows 4g ..
// 4g + 3) and 16-byte chunk c (slots 4c .. 4c + 3, jj = jj0 + 2q):
// c = ptid % 16, so the eight threads of a store phase write one row's
// eight chunks (no bank conflict), and each reads its four source rows
// starting at another q (rot), so the eight reads of a load phase fall in
// eight bank groups too; the values are rotated back in registers.
__device__ __forceinline__ void transpose_unit(uint8_t* unit, int nb, int ptid) {
  const int c = ptid % 16, rot = (c >> 1) & 3;
  const int jj0 = 8 * (c >> 1) + (c & 1);
  uint8_t* raw = unit + UNIT_HALF;
  float4 w[2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    if (m < nb) {
      const int g = ptid / 16 + 8 * m;
      float4 v[4];
#pragma unroll
      for (int s = 0; s < 4; ++s)
        v[s] = *reinterpret_cast<const float4*>(raw + sw_off(jj0 + 2 * ((s + rot) & 3), 4 * g,
                                                             UROWS));
      // w[q] = v[(q - rot) & 3]: by 2, then by 1
      const float4 t0 = rot & 2 ? v[2] : v[0], t1 = rot & 2 ? v[3] : v[1];
      const float4 t2 = rot & 2 ? v[0] : v[2], t3 = rot & 2 ? v[1] : v[3];
      w[m][0] = rot & 1 ? t3 : t0;
      w[m][1] = rot & 1 ? t0 : t1;
      w[m][2] = rot & 1 ? t1 : t2;
      w[m][3] = rot & 1 ? t2 : t3;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(unit + sw_off(4 * g + i, 4 * c, UROWS)) =
            make_float4(get(w[m][0], i), get(w[m][1], i), get(w[m][2], i), get(w[m][3], i));
    }
  }
  // every producer thread has read its raw values (barrier.sync, not
  // bar.sync: thread 0 may arrive apart from its warp, from a TMA issue)
  asm volatile("barrier.sync 1, 128;\n" ::: "memory");
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    if (m < nb) {
      const int g = ptid / 16 + 8 * m;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(raw + sw_off(4 * g + i, 4 * c, UROWS)) = lo4(
            make_float4(get(w[m][0], i), get(w[m][1], i), get(w[m][2], i), get(w[m][3], i)));
    }
  }
}

// ----------------------------------------------------------------- rings
//
// Units stream from the producer warpgroup to the consumers through a ring
// of ST slots in shared memory, in one fixed order both sides walk: a full
// barrier a slot (the producers' arrivals) and an empty barrier a slot
// (every consumer thread's arrival, whether or not its warpgroup reads the
// unit: a warpgroup that skips a unit still waits for it to be full before
// it gives it back, so no arrival lands on a later fill of the slot).

template <int ST>
struct RingOut {   // the producers' side
  uint64_t* full;
  uint64_t* empty;
  uint8_t* slots;
  int n;
  __device__ __forceinline__ uint8_t* acquire() {
    const int s = n % ST;
    mbar_wait(&empty[s], ((n / ST) & 1) ^ 1);
    return slots + s * UNIT;
  }
  __device__ __forceinline__ void publish() {
    fence_async_shared();
    mbar_arrive(&full[n % ST]);
    ++n;
  }
};

template <int ST>
struct RingIn {    // a consumer's side
  uint64_t* full;
  uint64_t* empty;
  uint8_t* slots;
  int n;
  // the slot of the next unit, once it is full
  __device__ __forceinline__ int take() {
    const int s = n % ST;
    mbar_wait(&full[s], (n / ST) & 1);
    ++n;
    return s;
  }
  __device__ __forceinline__ uint32_t addr(int s) const { return smem_u32(slots + s * UNIT); }
  __device__ __forceinline__ void give(int s) { mbar_arrive(&empty[s]); }
  __device__ __forceinline__ void skip() { give(take()); }
};

// the consumer warpgroup's own barrier (0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

}  // namespace
