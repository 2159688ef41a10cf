"""Fused softmax attention, forward and backward: CUDA kernels + plain versions.

The port of the JAX package's ``ops/attention.py``. :func:`fused_attention`
keeps its public layout: q, k, v [R, T, hd] with R = batch * heads (f32, or
bf16 under a bf16 residual stream), an additive [R, T] bias over the key
positions (0 valid, -1e9 masked) and an f32 [R, T, hd] result equal to
``softmax(q k^T * scale + bias[:, None, :]) v``. Every product takes its
operands rounded to ``compute_dtype`` and sums in f32, as the TPU kernel's
``_bdot`` does: q and k for the scores, p and v for the output, p and do
for dv, do and v for dp, ds and k for dq, ds and q for dk. The scores stay
f32, the scale multiplies them after the product and the softmax divides
by the row sum.

The backward recomputes p from q, k and v, as the TPU kernel does, and its
row term is ``rowsum(dp * p)`` with the f32 p (not FlashAttention's
``rowsum(do * o)``, which differs by the rounding of p in o).

Two wrappers, each with a launch count and a plain PyTorch version beside
it: :func:`attention_fwd` (``csrc/attention.cu``, forward) and
:func:`attention_bwd` (the same source, backward: a launch per query row for
dq and the row statistics, then one per key row for dk and dv, so every sum
runs in a fixed order without atomics). A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises. The kernels hold one
row's keys and values (or queries and output cotangents) for the whole T in
shared memory as f32: they take head widths 8, 16, 32 and 64 and T up to
512 (at hd = 64 the shared memory caps T at 440); the wrappers raise beyond.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from twotowermlretrieval_tpu_torch.ops import _build
from twotowermlretrieval_tpu_torch.utils.dtypes import matmul_f32, torch_dtype

HEAD_DIMS = (8, 16, 32, 64)  # head widths the kernels are built for
MAX_T = 512  # the whole-T range of the TPU kernel's design

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
_COMMON = [_INT, _INT, _INT, _INT, _INT, _INT, ctypes.c_float]  # device, in_bf16, cdt_bf16, R, T, hd, scale


def _lib():
    lib = _build.load("attention")
    if not getattr(lib, "_ttr_bound", False):
        lib.attention_fwd_launch.restype = _INT
        lib.attention_fwd_launch.argtypes = _COMMON + [_VOIDP] * 6  # q, k, v, bias, out, stream
        lib.attention_bwd_launch.restype = _INT
        # q, k, v, bias, dout, dq, dk, dv, stats, stream
        lib.attention_bwd_launch.argtypes = _COMMON + [_VOIDP] * 10
        lib.attention_error_string.restype = ctypes.c_char_p
        lib.attention_error_string.argtypes = [_INT]
        lib._ttr_bound = True
    return lib


def _check_args(q, k, v, bias, *more):
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must all be [R, T, hd]: {[tuple(t.shape) for t in (q, k, v)]}")
    R, T, hd = q.shape
    if tuple(bias.shape) != (R, T):
        raise ValueError(f"bias must be [R, T] = {(R, T)}, got {tuple(bias.shape)}")
    for t in more:
        if t.shape != q.shape:
            raise ValueError(f"the output cotangent must be {tuple(q.shape)}, got {tuple(t.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q, k, v must share float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    dev = q.device
    for t in (k, v, bias, *more):
        if t.device != dev:
            raise ValueError(f"every tensor must be on {dev}; one is on {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fused attention runs on cpu or cuda tensors, not {dev}")
    return R, T, hd


def _kernel_args(fn, q, k, v, bias, compute_dtype):
    """The arguments the C launchers take after the device: contiguous
    inputs and the dtype flags. Raises on a shape the kernels do not take."""
    R, T, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"{fn}: the kernel takes head widths {HEAD_DIMS}, got {hd}")
    if not 1 <= T <= MAX_T:
        raise ValueError(f"{fn}: the kernel takes 1 <= T <= {MAX_T}, got {T}")
    cdt = torch_dtype(compute_dtype)
    ins = [t.contiguous() for t in (q, k, v)] + [bias.float().contiguous()]
    return ins, int(q.dtype == torch.bfloat16), int(cdt == torch.bfloat16)


def _launch(fn: str, device: torch.device, *args) -> None:
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        # the tensors' device (inside the with): the library carries its own runtime
        err = getattr(lib, fn)(torch.cuda.current_device(), *args, stream)
    if err:
        raise RuntimeError(f"{fn} failed: {lib.attention_error_string(err).decode()}")


def attention_fwd(q, k, v, bias, scale: float, compute_dtype="bfloat16") -> torch.Tensor:
    """``softmax(q k^T * scale + bias[:, None, :]) v`` as f32 [R, T, hd]."""
    R, T, hd = _check_args(q, k, v, bias)
    if q.device.type == "cpu":
        return attention_fwd_reference(q, k, v, bias, scale, compute_dtype)
    ins, in_bf16, cdt_bf16 = _kernel_args("attention_fwd", q, k, v, bias, compute_dtype)
    out = torch.empty((R, T, hd), dtype=torch.float32, device=q.device)
    if R == 0:
        return out
    _launch("attention_fwd_launch", q.device, in_bf16, cdt_bf16, R, T, hd, float(scale),
            *[t.data_ptr() for t in ins], out.data_ptr())
    attention_fwd.launches += 1
    return out


attention_fwd.launches = 0  # kernel launches, counted where the kernel is launched


def attention_bwd(
    q, k, v, bias, dout, scale: float, compute_dtype="bfloat16"
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv), each f32 [R, T, hd], for the output cotangent ``dout``."""
    R, T, hd = _check_args(q, k, v, bias, dout)
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, bias, dout, scale, compute_dtype)
    ins, in_bf16, cdt_bf16 = _kernel_args("attention_bwd", q, k, v, bias, compute_dtype)
    do = dout.float().contiguous()
    grads = [torch.empty((R, T, hd), dtype=torch.float32, device=q.device) for _ in range(3)]
    if R == 0:
        return tuple(grads)
    # per query row: the softmax maximum, the row sum and rowsum(dp * p)
    stats = torch.empty((3, R, T), dtype=torch.float32, device=q.device)
    _launch("attention_bwd_launch", q.device, in_bf16, cdt_bf16, R, T, hd, float(scale),
            *[t.data_ptr() for t in (*ins, do, *grads, stats)])
    attention_bwd.launches += 1
    return tuple(grads)


attention_bwd.launches = 0


# ---------------------------------------------------------------------------
# plain versions: the TPU kernels' steps, one product at a time
# ---------------------------------------------------------------------------


def _probs(q, k, bias, scale, cdt):
    s = matmul_f32(q, k.transpose(-1, -2), cdt) * scale  # [R, T, T] f32
    s = s + bias.float()[:, None, :]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def attention_fwd_reference(q, k, v, bias, scale: float, compute_dtype="bfloat16"):
    """Plain PyTorch version of the forward kernel."""
    _check_args(q, k, v, bias)
    cdt = torch_dtype(compute_dtype)
    return matmul_f32(_probs(q, k, bias, scale, cdt), v, cdt)


def attention_bwd_reference(q, k, v, bias, dout, scale: float, compute_dtype="bfloat16"):
    """Plain PyTorch version of the backward kernel."""
    _check_args(q, k, v, bias, dout)
    cdt = torch_dtype(compute_dtype)
    p = _probs(q, k, bias, scale, cdt)
    do = dout.float()
    dv = matmul_f32(p.transpose(-1, -2), do, cdt)
    dp = matmul_f32(do, v.transpose(-1, -2), cdt)
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True)) * scale
    dq = matmul_f32(ds, k, cdt)
    dk = matmul_f32(ds.transpose(-1, -2), q, cdt)
    return dq, dk, dv


class _FusedAttention(torch.autograd.Function):
    """The counterpart of the JAX ``fused_attention`` custom VJP: saves
    (q, k, v, bias) and recomputes p in the backward; the bias gets no
    gradient (a length-derived mask)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, compute_dtype, input_dtype):
        if input_dtype is not None:
            q, k, v = (t.to(input_dtype) for t in (q, k, v))
        ctx.scale, ctx.compute_dtype = scale, compute_dtype
        ctx.save_for_backward(q, k, v, bias)
        return attention_fwd(q, k, v, bias, scale, compute_dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, bias, dout, ctx.scale, ctx.compute_dtype)
        return dq, dk, dv, None, None, None, None


def fused_attention(q, k, v, bias, scale: float, compute_dtype="bfloat16",
                    input_dtype=None) -> torch.Tensor:
    """Softmax attention over flattened heads (see the module docstring);
    differentiable in q, k and v. ``input_dtype`` rounds q, k and v to that
    dtype before the kernel reads them, while their gradients stay f32: the
    JAX custom VJP returns f32 cotangents for bf16 inputs, which a bf16
    residual stream (the caller's cast) then passes on unrounded. Without
    it, the gradients take the inputs' dtype."""
    return _FusedAttention.apply(q, k, v, bias, scale, compute_dtype, input_dtype)


def use_fused_attention(T: int, hd: int, force: Optional[bool] = None) -> bool:
    """The JAX package's policy: off unless forced (``FUSED_ATTENTION``);
    ``None`` means off."""
    if force is not None:
        return force
    return False


def attention_bound(R: int, T: int, hd: int, in_bytes: int, backward: bool = False):
    """Least work of one call: each input read once, each output written
    once, and the products' operations (2 for the forward, 5 for the
    backward, each 2*R*T*T*hd); the output cotangent is f32. Returns
    (bytes, flops)."""
    n = R * T * hd
    if backward:
        return 3 * n * in_bytes + n * 4 + R * T * 4 + 3 * n * 4, 10 * R * T * T * hd
    return 3 * n * in_bytes + R * T * 4 + n * 4, 4 * R * T * T * hd
