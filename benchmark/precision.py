"""The arithmetic the references compute in.

The reference runs in float64.  Its control (the check that a lower
precision than the configuration states fails the comparison) runs the
same code in TF32: float32 throughout, with every operand of a matrix
product rounded to TF32's 10 explicit mantissa bits (to nearest, ties
away from zero) and the products summed in float32, as a TF32 tensor core
does.  The rounding is written out, so the control reads the same on the
CPU and on a GPU.
"""
from __future__ import annotations

import torch


def tf32_round(t):
    """``t`` (float32) rounded to TF32's precision."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Arith:
    """``mm(a, b)``: the matrix product of the reference's precision."""

    def __init__(self, tf32=False):
        self.tf32 = tf32
        self.dtype = torch.float32 if tf32 else torch.float64

    def mm(self, a, b):
        if self.tf32:
            return tf32_round(a) @ tf32_round(b)
        return a @ b

    def mv(self, M, v):
        return self.mm(M, v.unsqueeze(-1)).squeeze(-1)


FLOAT64 = Arith()
TF32 = Arith(tf32=True)
