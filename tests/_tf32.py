"""TF32 arithmetic emulated in plain torch on the CPU, for the tests that
hold the precision argument of the port's 3xTF32 kernels (``ssd_chunk``,
float32 ``flash_attention``, their backwards).  No path of the port runs it.

TF32 rounding is the kernels' ``to_tf32`` (``csrc/hopper.cuh``): round to
nearest with ties away from zero onto 10 mantissa bits (half a TF32 ulp
added to the magnitude, the 13 low bits cleared), which is what
``cvt.rna.tf32.f32`` computes, or truncation (the 13 low bits cleared),
which is also what the tensor core does to the 13 low bits of an operand
it is handed.  A 3xTF32 product splits each operand into hi and lo as its
kernel does (``split``):

* ``"rna"``   hi = tf32(x), lo = tf32(x - hi)   (``Round::cvt``: the SSD chunk's forward)
* ``"bits"``  hi = tf32(x), lo = trunc(x - hi)  (``Round::bits``: the flash forward)
* ``"trunc"`` hi = trunc(x), lo = trunc(x - hi) (``Round::trunc``: the backward kernels)
"""

import torch


def tf32(t):
    u = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0x1000) & 0xFFFFE000               # the magnitude, half up
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)
    return u.view(torch.float32)


def trunc(t):
    return (t.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(t, mode="rna"):
    """(hi, lo) of ``t`` as a kernel of ``mode`` splits it."""
    hi = trunc(t) if mode == "trunc" else tf32(t)
    lo = tf32(t - hi) if mode == "rna" else trunc(t - hi)
    return hi, lo


def mm(eq, a, b, terms, mode="rna"):
    """``torch.einsum(eq, a, b)`` as the kernels compute it: one TF32
    product (``terms=1``, of the hi parts), or each operand split (``mode``)
    and lo.hi + hi.lo + hi.hi summed in float32 (``terms=3``)."""
    (ah, al), (bh, bl) = split(a, mode), split(b, mode)
    out = torch.einsum(eq, ah, bh)
    if terms == 3:
        out = torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + out
    return out
