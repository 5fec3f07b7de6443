"""The card's rates and the least time of a piece of work on it.

The port runs on an NVIDIA H100 SXM (80 GB HBM3).  The rates are the
data sheet's, dense (no sparsity); a card run below its 700 W limit is
slower, so every time measured beside a bound names the card's power
limit.  ``bound_ms`` is the roofline of one call: the larger of its bytes
over the memory rate and its operations over the peak of their type.
"""

from __future__ import annotations

#: bf16 multiply-adds on the tensor cores, FLOP/s (H100 SXM data sheet)
BF16_FLOPS = 989e12
#: TF32 on the tensor cores, FLOP/s (H100 SXM data sheet); a float32
#: product by 3xTF32 takes three of them
TF32_FLOPS = 495e12
#: float32 outside the tensor cores, FLOP/s (H100 SXM data sheet)
F32_FLOPS = 67e12
#: HBM3 bytes/s (H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
#: NVLink 4 bytes/s one way per card (H100 SXM data sheet: 900 GB/s both
#: ways together)
NVLINK_BYTES_PER_S = 450e9
#: shared memory a block may take (227 KB of the SM's 256 KB), bytes
SMEM_PER_BLOCK = 232_448


def bound_ms(flops: float, n_bytes: float, peak: float):
    """(least ms, "bytes" or "operations"): ``n_bytes`` over the HBM rate
    against ``flops`` over ``peak``."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
