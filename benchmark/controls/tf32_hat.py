"""The control for HAT in float32 with TF32 off: the plain reference with
both operands of every product (each Linear, both attentions' two products,
each conv, the CAB's 1x1s included) rounded to TF32's 10-bit mantissa and
float32 accumulation, which is what TF32 tensor cores compute; the same
arithmetic on any device."""

from __future__ import annotations

from benchmark.controls.tf32 import round_tf32
from benchmark.reference.hat import Ops


class Tf32Ops(Ops):
    def linear(self, x, w, b):
        return super().linear(round_tf32(x), round_tf32(w), b)

    def matmul(self, a, b):
        return super().matmul(round_tf32(a), round_tf32(b))

    def conv(self, x, w, b):
        return super().conv(round_tf32(x), round_tf32(w), b)

    def conv1(self, x, w, b):
        return super().conv1(round_tf32(x), round_tf32(w), b)


def training_ops() -> Ops:
    return Tf32Ops()
