"""The arithmetic of the reference's products.

``FP32`` computes every product in float32 with TF32 off. ``FP8`` is the
control: each operand of a product is rounded to float8 e4m3 with one scale
per tensor (its largest magnitude maps to 448, the format's largest), then
multiplied in float32 - the precision below the configurations' bfloat16.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp32_exact() -> None:
    """No TF32 in float32 products on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Precision:
    name = "fp32"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b, each operand through ``q``."""
        return self.q(a) @ self.q(b)


class _RoundFP8(torch.autograd.Function):
    """Rounding to e4m3 on the way in; the gradient passes straight through
    (and is itself rounded where it meets the next product)."""

    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


class FP8(Precision):
    name = "fp8"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return _RoundFP8.apply(x)


PRECISIONS = {"fp32": Precision(), "fp8": FP8()}
