"""The arithmetic every reference model goes through, in one precision.

``Ops("float32")`` is the plain reference: float32 products with TF32 off.
The lower precisions are the controls of ``portbench/control.py``, the
reference computed one step below what a configuration states:

* ``"tf32"`` (for a float32 configuration): on the card cuBLAS and cuDNN
  run their products in TF32; on the CPU, which has no TF32, the operands
  of each product are rounded to TF32's 10-bit mantissa first;
* ``"fp8"`` (for a bfloat16 configuration): the operands of each product
  are rounded to float8 e4m3 with a per-tensor scale (the largest
  magnitude at 448, e4m3's largest value), as an fp8 recipe feeds them,
  and the product runs in float32.

Only the products (convolutions, matmuls) change precision; every other
operation stays float32, as in the program's mixed-precision paths.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

PRECISIONS = ("float32", "tf32", "fp8")
E4M3_MAX = 448.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to 10 mantissa bits, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in float32."""
    amax = x.detach().abs().max().clamp(min=1e-30)
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class Ops:
    """Convolutions and matmuls in ``precision`` (see the module doc)."""

    def __init__(self, precision: str = "float32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
        self.precision = precision

    def _operands(self, *xs: torch.Tensor):
        """The operands as the product reads them; gradients pass the
        rounding as if it were not there (the training control)."""
        if self.precision == "fp8":
            return tuple(x + (round_fp8(x) - x).detach() for x in xs)
        if self.precision == "tf32" and xs[0].device.type != "cuda":
            return tuple(x + (round_tf32(x.detach()) - x).detach() for x in xs)
        return xs

    @contextlib.contextmanager
    def numerics(self):
        """TF32 on in cuBLAS and cuDNN for ``"tf32"`` on the card, off
        otherwise; the previous settings come back on leaving."""
        cuda_m, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        on = self.precision == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield self
        finally:
            torch.backends.cuda.matmul.allow_tf32 = cuda_m
            torch.backends.cudnn.allow_tf32 = cudnn

    def conv1d(self, x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
        x, w = self._operands(x.float(), w.float())
        return F.conv1d(x, w, b, stride, padding, dilation, groups)

    def conv2d(self, x, w, b=None, stride=1, padding=0):
        x, w = self._operands(x.float(), w.float())
        return F.conv2d(x, w, b, stride, padding)

    def conv_transpose1d(self, x, w, b=None, stride=1, padding=0):
        x, w = self._operands(x.float(), w.float())
        return F.conv_transpose1d(x, w, b, stride, padding)

    def matmul(self, a, b):
        a, b = self._operands(a.float(), b.float())
        return torch.matmul(a, b)

    def linear(self, x, w, b=None):
        x, w = self._operands(x.float(), w.float())
        return F.linear(x, w, b)
