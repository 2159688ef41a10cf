"""dtype, precision and device policy.

- bf16 compute means bf16 operands with f32 accumulation. ``torch.matmul``
  on bf16 tensors returns bf16, which JAX's ``preferred_element_type=f32``
  does not: plain products therefore go through :func:`matmul_f32`, which
  rounds the operands to the compute dtype, upcasts them (exactly) to f32
  and multiplies in f32.
- f32 compute means true f32 products: TF32 is switched off for both
  cuBLAS and cuDNN (:func:`set_matmul_precision`), the counterpart of
  JAX's ``Precision.HIGHEST``.
- Entry points run on ``cuda`` unless the caller asks for the CPU
  (:func:`resolve_device`); a CUDA request without a card raises.
"""

from __future__ import annotations

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
