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
:func:`attention_bwd` (the same source, backward: a launch per query tile
for dq and the row statistics, then one per key tile for dk and dv, so every
sum runs in a fixed order without atomics). A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises. Both compute dtypes
run every product on the tensor cores (mma.sync), each score computed once
and kept in shared memory as f32 for its query tile; :func:`attention_plan`
picks the tiles. Under bf16 compute the operands are staged in bf16 (route
"mma"). Under f32 compute (route "split") every product is a split product,
the six leading products of the operands' three bf16 pieces summed in f32
(:func:`~twotowermlretrieval_tpu_torch.utils.dtypes.matmul_split` is its
arithmetic on the CPU), with a row's keys and values streamed through
shared memory in chunks of up to 64 keys. Both take head widths 8, 16, 32
and 64 and every T up to 512.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from twotowermlretrieval_tpu_torch.ops import _build
from twotowermlretrieval_tpu_torch.utils.dtypes import SPLIT_PRODUCTS, matmul_f32, torch_dtype

HEAD_DIMS = (8, 16, 32, 64)  # head widths the kernels are built for
MAX_T = 512  # the whole-T range of the TPU kernel's design

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
# device, in_bf16, cdt_bf16, R, T, hd, scale, and the tile's rows, kv_shared, ks
_COMMON = [_INT, _INT, _INT, _INT, _INT, _INT, ctypes.c_float, _INT, _INT, _INT]
_SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper
_TILE, _KEY_TILE = 128, 64  # query rows (keys) a block at most, 16 a warp
_KC = 64  # f32 compute: keys a chunk of the key ring, KC in the .cu
_PIECES = 3  # bf16 pieces of an f32 value


def _lib():
    lib = _build.load("attention")
    if not getattr(lib, "_ttr_bound", False):
        lib.attention_fwd_launch.restype = _INT
        # q, k, v, bias, out, stream
        lib.attention_fwd_launch.argtypes = _COMMON + [_VOIDP] * 6
        lib.attention_bwd_launch.restype = _INT
        # kt, then q, k, v, bias, dout, dq, dk, dv, stats, stream
        lib.attention_bwd_launch.argtypes = _COMMON + [_INT] + [_VOIDP] * 10
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


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def attention_plan(T: int, hd: int, compute_dtype="bfloat16"):
    """The kernels' tiles and shared memory at (T, hd), or None where a
    layout does not fit the SM. ``fwd`` and ``dq`` (the backward's first
    launch) take ``rows`` query rows a block, 16 a warp, the largest of
    min(128, T rounded up to 16), 64, 32 and 16 that fits the block's scores
    [rows, T] f32 beside its staged operands; ``dkv`` (the second launch)
    takes ``rows`` keys a block (at most 64) and query tiles of as many
    rows. bf16 compute (``route`` "mma"): ``fwd`` and ``dq`` stage the whole
    K and V in bf16, V over K (``kv_shared``; the backward then K over V
    again for dq) where both do not fit, and split each tile's keys over
    two warps (``ks`` 2) where one block fills the SM's shared memory, so
    that a SM runs twice the warps. f32 compute (``route`` "split"): ``fwd``
    and ``dq`` stream K and V in chunks of ``kc`` keys (at most 64), each
    copied as f32 and split into three bf16 planes; ``dkv`` keeps its key
    tile's K and V as three planes, and a query tile's Q and dO, and P then
    dS in one region.
    ``smem``: bytes a block (``fwd_layout``, ``dq_layout``, ``dkv_layout``,
    ``split_layout`` and ``dkv_split_layout`` in csrc/attention.cu, region
    by region)."""
    Tp = _up(T, 16)
    row = (max(hd, 16) + 8) * 2  # a staged bf16 row, 16 bytes of pad
    top = min(_TILE, Tp)
    cands = [top] + [r for r in (64, 32, 16) if r < top]
    kt = min(_KEY_TILE, Tp)
    if torch_dtype(compute_dtype) != torch.bfloat16:
        kc = min(_KC, Tp)

        # one chunk as copied (f32), its three planes, the f32 scores, the bias
        def split_smem(rows):
            return kc * hd * 4 + _PIECES * kc * row + rows * Tp * 4 + Tp * 4

        rows = next((r for r in cands if split_smem(r) <= _SMEM_LIMIT), None)
        # K, V, Q and dO planes, the query tile's Q and dO as copied, two
        # buffers of statistics, one region of P (then dS) planes, the bias
        dkv = {"rows": kt, "smem": 4 * _PIECES * kt * row + 2 * kt * hd * 4
               + 2 * _up(12 * kt, 16) + _PIECES * kt * (kt + 8) * 2 + _up(4 * kt, 16)}
        if rows is None or dkv["smem"] > _SMEM_LIMIT:
            return None
        tile = {"rows": rows, "kc": kc, "smem": split_smem(rows)}
        return {"route": "split", "fwd": tile, "dq": dict(tile), "dkv": dkv}

    # the tile's query rows, its K and V (one of them where V goes over K),
    # its f32 scores, the bias and where two key halves meet (rows * 32)
    def fwd_smem(rows, shared):
        return rows * row + Tp * row * (1 if shared else 2) + rows * Tp * 4 + Tp * 4 + rows * 32

    def dq_smem(rows, shared):  # dO's rows too
        return fwd_smem(rows, shared) + rows * row

    def pick(smem):  # the largest tile that fits, V apart from K before V over K
        r, sh = next(((r, sh) for r in cands for sh in (False, True)
                      if smem(r, sh) <= _SMEM_LIMIT), (None, None))
        if r is None:
            return None
        split = r <= 64 and smem(r, sh) > _SMEM_LIMIT // 2 and Tp >= max(32, hd)
        return {"rows": r, "kv_shared": sh, "ks": 2 if split else 1, "smem": smem(r, sh)}

    fwd, dq = pick(fwd_smem), pick(dq_smem)
    dkv = {"rows": kt, "smem": 2 * kt * row + 2 * (2 * kt * row + _up(3 * kt * 4, 16))
           + 2 * _up(kt * (kt + 8) * 2, 16) + _up(kt * 4, 16)}
    if fwd is None or dq is None or dkv["smem"] > _SMEM_LIMIT:
        return None
    return {"route": "mma", "fwd": fwd, "dq": dq, "dkv": dkv}


def _kernel_args(fn, q, k, v, bias, compute_dtype):
    """The arguments the C launchers take after the device: contiguous,
    16-byte aligned inputs, the dtype flags and the plan. Raises on a shape
    the kernels do not take."""
    R, T, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"{fn}: the kernel takes head widths {HEAD_DIMS}, got {hd}")
    if not 1 <= T <= MAX_T:
        raise ValueError(f"{fn}: the kernel takes 1 <= T <= {MAX_T}, got {T}")
    cdt = torch_dtype(compute_dtype)
    plan = attention_plan(T, hd, cdt)
    if plan is None:
        widest = max(t for t in range(1, MAX_T + 1) if attention_plan(t, hd, cdt) is not None)
        raise ValueError(f"{fn}: no layout of the kernel fits shared memory at T={T} hd={hd} "
                         f"{cdt}; it takes T up to {widest}")
    ins = [_aligned(t) for t in (q, k, v)] + [bias.float().contiguous()]
    return ins, int(q.dtype == torch.bfloat16), int(cdt == torch.bfloat16), plan


def _tile_args(tile: dict):
    """(rows, kv_shared, ks) of a plan's tile; the split route takes rows only."""
    return tile["rows"], int(tile.get("kv_shared", False)), tile.get("ks", 1)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and on the 16-byte alignment of the kernels' vector copies."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


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
    ins, in_bf16, cdt_bf16, plan = _kernel_args("attention_fwd", q, k, v, bias, compute_dtype)
    out = torch.empty((R, T, hd), dtype=torch.float32, device=q.device)
    if R == 0:
        return out
    _launch("attention_fwd_launch", q.device, in_bf16, cdt_bf16, R, T, hd, float(scale),
            *_tile_args(plan["fwd"]), *[t.data_ptr() for t in ins], out.data_ptr())
    attention_fwd.launches += 1
    attention_fwd.by_route[plan["route"]] += 1
    return out


attention_fwd.launches = 0  # kernel launches, counted where the kernel is launched
attention_fwd.by_route = {"mma": 0, "split": 0}  # the same launches by the plan's route


def attention_bwd(
    q, k, v, bias, dout, scale: float, compute_dtype="bfloat16"
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv), each f32 [R, T, hd], for the output cotangent ``dout``."""
    R, T, hd = _check_args(q, k, v, bias, dout)
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, bias, dout, scale, compute_dtype)
    ins, in_bf16, cdt_bf16, plan = _kernel_args("attention_bwd", q, k, v, bias, compute_dtype)
    do = _aligned(dout.float())
    grads = [torch.empty((R, T, hd), dtype=torch.float32, device=q.device) for _ in range(3)]
    if R == 0:
        return tuple(grads)
    # per query row: the softmax maximum, the row sum and rowsum(dp * p)
    stats = torch.empty((3, R, T), dtype=torch.float32, device=q.device)
    _launch("attention_bwd_launch", q.device, in_bf16, cdt_bf16, R, T, hd, float(scale),
            *_tile_args(plan["dq"]), plan["dkv"]["rows"],
            *[t.data_ptr() for t in (*ins, do, *grads, stats)])
    attention_bwd.launches += 1
    attention_bwd.by_route[plan["route"]] += 1
    return tuple(grads)


attention_bwd.launches = 0
attention_bwd.by_route = {"mma": 0, "split": 0}


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


def _bf16_products(a_bf16: bool, b_bf16: bool) -> int:
    """The bf16 products one f32-compute product takes: SPLIT_PRODUCTS
    less those of a bf16 operand's pieces past hi, which are zero."""
    return sum(1 for i, j in SPLIT_PRODUCTS if (i == 0 or not a_bf16) and (j == 0 or not b_bf16))


def attention_bound(R: int, T: int, hd: int, in_bytes: int, backward: bool = False,
                    compute_dtype="bfloat16"):
    """Least work of one call: each input read once, each output written
    once (the output cotangent is f32), and the products on the bf16 tensor
    cores, each 2*R*T*T*hd operations: S = Q K^T and O = P V forward; S,
    dP = dO V^T, dQ = dS K, dV = P^T dO and dK = dS^T Q backward. At f32
    compute a product counts once for each bf16 product of its split, by
    its operands' dtypes (P, dS and dO are f32). Returns (bytes, operations),
    the operations at the bf16 rate."""
    n, one = R * T * hd, 2 * R * T * T * hd
    x = in_bytes == 2
    mul = _bf16_products if torch_dtype(compute_dtype) == torch.float32 else (lambda a, b: 1)
    if backward:
        ops = one * (mul(x, x) + 3 * mul(False, x) + mul(False, False))
        return 3 * n * in_bytes + n * 4 + R * T * 4 + 3 * n * 4, ops
    return 3 * n * in_bytes + R * T * 4 + n * 4, one * (mul(x, x) + mul(False, x))
