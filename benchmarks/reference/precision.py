"""The products of the reference, at a chosen precision.

``"float32"``: plain f32 products, TF32 off (the training cells'
reference).
``"bfloat16"``: both operands of every product rounded to bfloat16 and
summed in f32, as the configurations' bf16 compute states it; the
recurrent layers' inputs (xp) rounded alike (``recurrent_input``), as that
compute reads them (the search cell's reference).
``"fp8"``: both operands of every product, and in the backward its
incoming gradient, rounded to float8 e4m3 with one scale per tensor (the
largest magnitude maps to 448), products summed in f32: the training
cells' control, one step below the bfloat16 compute the configurations
state.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0
PRECISION_OF_SEARCH = "bfloat16"


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


ROUNDING = {"bfloat16": round_bf16, "fp8": round_fp8}


def recurrent_input(x: torch.Tensor, precision: str) -> torch.Tensor:
    """What a recurrent layer reads of its input projection."""
    return round_bf16(x) if precision == "bfloat16" else x


class _RoundedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, rnd):
        ar, br = rnd(a), rnd(b)
        ctx.save_for_backward(ar, br)
        ctx.rnd = rnd
        return torch.matmul(ar, br)

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        g = ctx.rnd(g)
        if br.dim() == 2:  # [..., K] @ [K, N]: the weight's gradient sums the leading dims
            ga = torch.matmul(g, br.t())
            gb = ar.reshape(-1, ar.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
            return ga, gb, None
        return torch.matmul(g, br.transpose(-1, -2)), torch.matmul(ar.transpose(-1, -2), g), None


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float32":
        return torch.matmul(a.float(), b.float())
    if precision in ROUNDING:
        return _RoundedMatmul.apply(a.float(), b.float(), ROUNDING[precision])
    raise ValueError(f"unknown reference precision {precision!r}")
