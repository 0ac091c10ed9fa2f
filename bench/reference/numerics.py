"""The reference's arithmetic: plain float32 with TF32 off, or, for the
control, every product's operands rounded to fp8 (e4m3, one scale per
tensor, fp32 accumulation), the precision below the bfloat16 the
configurations compute in. In the control the backward's products take
rounded operands too: the incoming gradient of each product and the
gradients it hands back are rounded as well."""
from __future__ import annotations

import torch

FP8_MAX = 448.0  # largest finite e4m3 value


def fp32_only() -> None:
    """TF32 off: a float32 product on the card is float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 under one scale (its largest magnitude to 448),
    returned in float32."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (x.float() / scale).to(torch.float8_e4m3fn).float() * scale


class _Round(torch.autograd.Function):
    """fp8 rounding forward; the gradient passes straight through."""

    @staticmethod
    def forward(ctx, x):
        return round_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGrad(torch.autograd.Function):
    """Identity forward; the gradient is rounded to fp8."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g)


class Numerics:
    """``ein``: a two-operand einsum in the chosen precision."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision is fp32 or fp8, not {precision}")
        self.precision = precision

    def ein(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp32":
            return torch.einsum(eq, a.float(), b.float())
        a = _RoundGrad.apply(_Round.apply(a))
        b = _RoundGrad.apply(_Round.apply(b))
        return _RoundGrad.apply(torch.einsum(eq, a, b))

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a (..., K) @ b (K, N)."""
        return self.ein("...k,kn->...n", a, b)
