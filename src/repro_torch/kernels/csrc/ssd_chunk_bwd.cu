// The SSD chunk's backward for state widths N <= 64: the kernel of
// ssd_chunk_bwd.cuh (see its header for the design) instantiated for 1
// 64-column chunk of N.

#include "ssd_chunk_bwd.cuh"

// Returns the CUDA error of the two launches (0 on success), or -1 for a
// shape the kernels do not take (P > 64, N above 64, an empty chunk, more
// shared memory than a block may have, or a scratch shorter than B * H *
// scratch_floats(Q, P, N) floats).  Strides are in elements: (batch, row,
// head) for each of x, dt, B, C and dy; B's and C's head stride may be
// 0.  state and dstate are contiguous (B, H, P, N); the outputs are new
// contiguous tensors: dx (B,Q,H,P), ddt (B,Q,H), dB and dC (B,Q,H,N),
// dstate_in (B,H,P,N), dA_part (B,H); scratch is float32 of scratch_len
// elements, written and read by the launches.
extern "C" int ssd_chunk_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                             const void* Cm, const void* state, const void* dy,
                             const void* dstate, void* dx, void* ddt, void* dB, void* dC,
                             void* dstate_in, void* dA_part, void* scratch,
                             int64_t scratch_len, int64_t B, int64_t Q, int64_t H,
                             int64_t P, int64_t N, int64_t xb, int64_t xq, int64_t xh,
                             int64_t db, int64_t dq, int64_t dh, int64_t bb, int64_t bq,
                             int64_t bh, int64_t cb, int64_t cq, int64_t ch, int64_t yb,
                             int64_t yq, int64_t yh, int device, void* stream) {
  return run<1>(x, dt, A, Bm, Cm, state, dy, dstate, dx, ddt, dB, dC, dstate_in, dA_part,
                scratch, scratch_len, B, Q, H, P, N, Str3{xb, xq, xh}, Str3{db, dq, dh},
                Str3{bb, bq, bh}, Str3{cb, cq, ch}, Str3{yb, yq, yh}, device, stream);
}

// The tile launch's shared memory at chunk length Q and the scratch a
// (batch, head) needs, in floats: the wrapper's sizes (ssd_chunk_cuda.py).
extern "C" int64_t ssd_chunk_bwd_smem_bytes(int64_t Q) { return (int64_t)smem_bytes((int)Q); }

extern "C" int64_t ssd_chunk_bwd_scratch_floats(int64_t Q, int64_t P, int64_t N) {
  return scratch_floats((int)Q, (int)P, (int)N);
}
