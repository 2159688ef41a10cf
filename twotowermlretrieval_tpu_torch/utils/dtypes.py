"""dtype, precision and device policy.

- bf16 compute means bf16 operands with f32 accumulation. ``torch.matmul``
  on bf16 tensors returns bf16, which JAX's ``preferred_element_type=f32``
  does not: plain products therefore go through :func:`matmul_f32`, which
  rounds the operands to the compute dtype, upcasts them (exactly) to f32
  and multiplies in f32.
- f32 compute means true f32 products: TF32 is switched off for both
  cuBLAS and cuDNN (:func:`set_matmul_precision`), the counterpart of
  JAX's ``Precision.HIGHEST``. The kernels' f32 routes (the scans over an
  f32 corpus, attention at f32 compute, both recurrent kernels at f32
  compute) compute such products on the bf16 tensor cores as split
  products: each f32 operand as three bf16 pieces (:func:`split_bf16x3`),
  the six leading products of the pieces (:data:`SPLIT_PRODUCTS`) summed
  in f32. :func:`matmul_split` is that arithmetic on the CPU.
- Entry points run on ``cuda`` unless the caller asks for the CPU
  (:func:`resolve_device`); a CUDA request without a card raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported compute/storage dtype {name!r}") from None


def set_matmul_precision() -> None:
    """Full-f32 products on the card: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def matmul_f32(a: torch.Tensor, b: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """``a @ b`` with operands rounded to ``cdt`` and an f32 result.

    The upcast of a bf16-rounded operand to f32 is exact, so this equals a
    bf16 x bf16 product with f32 accumulation, up to summation order."""
    return torch.matmul(a.to(cdt).float(), b.to(cdt).float())


# The products of bf16 pieces a split product takes, (left piece, right
# piece) with 0 = hi, 1 = mid, 2 = lo, smallest first: XLA's six-pass
# HIGHEST. mid.lo, lo.mid and lo.lo are dropped.
SPLIT_PRODUCTS = ((1, 1), (2, 0), (0, 2), (1, 0), (0, 1), (0, 0))
# What the dropped products may cost a product's entry, relative to
# sum_k |a_k b_k|: |mid| <= 2^-8 (1 + 2^-8) |x| and |lo| <= 2^-16 |x|
# (csrc/doc_mma.cuh, "The f32 path").
SPLIT_DROPPED_REL = 2.0 ** -23 * (1 + 2.0 ** -7)


def split_bf16x3(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The split of ``x`` (f32) into three bf16 pieces (hi, mid, lo): each
    rounds to nearest even what the pieces before it leave (the remainders
    are exact in f32), so hi + mid + lo is ``x`` exactly (8 significant
    bits each and the remainders' signs cover f32's 24). A bf16 value's mid
    and lo are zero."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    rest = x - hi.float()
    mid = rest.to(torch.bfloat16)
    return hi, mid, (rest - mid.float()).to(torch.bfloat16)


def matmul_split(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernels' f32 routes form it: the
    :data:`SPLIT_PRODUCTS` of the operands' bf16 pieces, each product of
    bf16 values exact in f32, summed in f32 in that order (the kernels sum
    in another order). Within ``SPLIT_DROPPED_REL * sum_k |a_k b_k|`` of
    the exact product, besides the f32 sums' rounding."""
    ap, bp = split_bf16x3(a), split_bf16x3(b)
    out = None
    for i, j in SPLIT_PRODUCTS:
        term = torch.matmul(ap[i].float(), bp[j].float())
        out = term if out is None else out + term
    return out


def bernoulli_mask(generator: torch.Generator, p: float, shape, device) -> torch.Tensor:
    """Bernoulli(p) bool mask drawn from ``generator``, which lives on
    ``device`` (a CUDA generator for CUDA tensors).

    The counterpart of the JAX package's ``fast_bernoulli``. The streams
    differ (torch's Philox or CPU generator against JAX's rbg bits), so
    masks agree with JAX's in law, not bit for bit; given the generator's
    state they are reproducible."""
    return torch.rand(shape, generator=generator, device=device) < p


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. Raises when CUDA is asked for
    and there is none: the port never carries on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch versions"
            )
        set_matmul_precision()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
