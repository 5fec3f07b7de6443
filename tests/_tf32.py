"""TF32 arithmetic emulated in plain torch on the CPU, for the tests that
hold the precision argument of the port's 3xTF32 kernels (``ssd_chunk``,
float32 ``flash_attention``).  No path of the port runs it.

TF32 rounding is the kernels' ``to_tf32``: round to nearest with ties away
from zero onto 10 mantissa bits (half a TF32 ulp added to the magnitude,
the 13 low bits cleared), which is what ``cvt.rna.tf32.f32`` computes."""

import torch


def tf32(t):
    u = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0x1000) & 0xFFFFE000               # the magnitude, half up
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)
    return u.view(torch.float32)


def mm(eq, a, b, terms):
    """``torch.einsum(eq, a, b)`` as the kernels compute it: one TF32
    product (``terms=1``), or each operand split into hi = tf32(x) and
    lo = tf32(x - hi) and lo.hi + hi.lo + hi.hi summed in float32
    (``terms=3``)."""
    ah, bh = tf32(a), tf32(b)
    out = torch.einsum(eq, ah, bh)
    if terms == 3:
        al, bl = tf32(a - ah), tf32(b - bh)
        out = torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + out
    return out
