// The flash-attention backward on bfloat16 inputs: the kernels of
// flash_attention_bwd.cuh (see its header for the design) instantiated for
// __nv_bfloat16.

#include "flash_attention_bwd.cuh"

// Returns the CUDA error of the launches (0 on success; two, three at (192,
// 128)); -1 for a shape the kernels do not take ((D, Dv) not a built pair:
// (16, 16), (32, 32), (64, 64), (96, 96), (128, 128) or (192, 128); an empty
// or oversized grid), -2 for a dtype code other than 1 (bfloat16; the other
// type is the other library's), -3 when q, k, v or dO cannot be read as they
// are (a base not 16-byte aligned, a stride not a multiple of 16
// bytes).  Strides are in elements, (batch, sequence, head) for each of q, k,
// v and dO (D the width of q and k, Dv that of v and dO).  lse is the
// forward's contiguous float32 (B, H, Sq); Dsum a contiguous float32 (B, H,
// Sq) scratch the first launch writes and the second reads; dq (B,Sq,H,D),
// dk (B,Sk,H,D) and dv (B,Sk,H,Dv) are new contiguous tensors of q's type.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* dO,
                                   const void* lse, void* Dsum, void* dq, void* dk, void* dv,
                                   int64_t B, int64_t Sq, int64_t Sk, int64_t H, int64_t D,
                                   int64_t Dv, int64_t qb, int64_t qs, int64_t qh, int64_t kb,
                                   int64_t ks, int64_t kh, int64_t vb, int64_t vs, int64_t vh,
                                   int64_t ob, int64_t os, int64_t oh, float scale, int causal,
                                   int q_off, int dtype, int device, void* stream) {
  return run<__nv_bfloat16>(1, q, k, v, dO, lse, Dsum, dq, dk, dv, B, Sq, Sk, H, D, Dv,
                  Strides{qb, qs, qh}, Strides{kb, ks, kh}, Strides{vb, vs, vh},
                  Strides{ob, os, oh}, scale, causal, q_off, dtype, device, stream);
}
