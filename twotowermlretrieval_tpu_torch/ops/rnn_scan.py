"""Recurrent time loop (GRU / LSTM / RNN), forward: CUDA kernel + plain version.

:func:`rnn_layer_fwd` keeps the JAX package's signature (``ops/rnn_scan.py``
``rnn_layer_fwd``): per-direction ``xps`` [T, B, G*H] in original time
order, a [T, B] f32 mask, ``w_hh`` [D, H, G*H], ``b_hh`` [D, G*H]. It
returns ``(outs, c_hist, h_final)``: per-direction state histories
[T, B, H] (f32, or the compute dtype under ``history_in_cdt``), the LSTM
cell histories (else ``()``), and ``h_final`` [D, B, H] f32.

On a CUDA tensor it launches ``csrc/rnn_fwd.cu`` (one block per direction
and 16 batch rows, the whole time loop inside the kernel); on a CPU tensor
it runs :func:`rnn_layer_fwd_reference`, the plain PyTorch version of the
same arithmetic. Both read xp rounded to the compute dtype, as the TPU
kernel does (its caller casts xp before the call), and round h to the
compute dtype before every step's product.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from twotowermlretrieval_tpu_torch.ops import _build
from twotowermlretrieval_tpu_torch.utils.dtypes import torch_dtype

_GATES = {"GRU": 3, "LSTM": 4, "RNN": 1}
_CELL_CODE = {"RNN": 0, "GRU": 1, "LSTM": 2}

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int


def _lib():
    lib = _build.load("rnn_fwd")
    if not getattr(lib, "_ttr_bound", False):
        lib.rnn_fwd_launch.restype = _INT
        lib.rnn_fwd_launch.argtypes = [
            _INT, _INT, _INT, _INT,  # device, cell, cdt_bf16, hist_bf16
            _INT, _INT, _INT, _INT,  # T, B, H, D
            _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP,  # xp0, xp1, mask, w_hh, b_hh
            _VOIDP, _VOIDP, _VOIDP, _VOIDP, _VOIDP,  # out0, out1, c0, c1, h_final
            _VOIDP,  # stream
        ]
        lib.rnn_fwd_error_string.restype = ctypes.c_char_p
        lib.rnn_fwd_error_string.argtypes = [_INT]
        lib._ttr_bound = True
    return lib


def _check_args(cell, xps, mask, w_hh, b_hh):
    if cell not in _GATES:
        raise ValueError(f"cell must be one of {list(_GATES)}, got {cell!r}")
    D = len(xps)
    if D not in (1, 2):
        raise ValueError(f"one or two directions expected, got {D}")
    T, B, GH = xps[0].shape
    H = GH // _GATES[cell]
    if GH != H * _GATES[cell] or any(x.shape != (T, B, GH) for x in xps):
        raise ValueError(f"xps must all be [T, B, {_GATES[cell]}*H]: {[tuple(x.shape) for x in xps]}")
    if tuple(mask.shape) != (T, B):
        raise ValueError(f"mask must be [T, B] = {(T, B)}, got {tuple(mask.shape)}")
    if tuple(w_hh.shape) != (D, H, GH) or tuple(b_hh.shape) != (D, GH):
        raise ValueError(
            f"w_hh must be {(D, H, GH)} and b_hh {(D, GH)}: "
            f"{tuple(w_hh.shape)}, {tuple(b_hh.shape)}"
        )
    return D, T, B, H, GH


def rnn_layer_fwd(
    cell: str,
    xps: Sequence[torch.Tensor],
    mask: torch.Tensor,
    w_hh: torch.Tensor,
    b_hh: torch.Tensor,
    compute_dtype="bfloat16",
    history_in_cdt: bool = False,
) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...], torch.Tensor]:
    """One recurrent layer over all directions (see the module docstring)."""
    D, T, B, H, GH = _check_args(cell, xps, mask, w_hh, b_hh)
    dev = xps[0].device
    for name, t in (("xps", xps[-1]), ("mask", mask), ("w_hh", w_hh), ("b_hh", b_hh)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, xps[0] on {dev}")
    if dev.type == "cpu":
        return rnn_layer_fwd_reference(
            cell, xps, mask, w_hh, b_hh, compute_dtype, history_in_cdt
        )
    if dev.type != "cuda":
        raise ValueError(f"rnn_layer_fwd runs on cpu or cuda tensors, not {dev}")

    cdt = torch_dtype(compute_dtype)
    hist = cdt if history_in_cdt else torch.float32
    # the kernel reads xp in the compute dtype, as the TPU kernel does
    xs = [x.to(cdt).contiguous() for x in xps]
    m = mask.to(torch.float32).contiguous()
    w = w_hh.to(cdt).contiguous()
    b = b_hh.to(torch.float32).contiguous()
    outs = [torch.empty((T, B, H), dtype=hist, device=dev) for _ in range(D)]
    c_hist = (
        [torch.empty((T, B, H), dtype=hist, device=dev) for _ in range(D)]
        if cell == "LSTM" else []
    )
    h_final = torch.empty((D, B, H), dtype=torch.float32, device=dev)

    def ptr(ts, i):
        return ts[i].data_ptr() if i < len(ts) else None

    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rnn_fwd_launch(
            torch.cuda.current_device(),  # the tensors' device (inside the with)
            _CELL_CODE[cell], int(cdt == torch.bfloat16), int(hist == torch.bfloat16),
            T, B, H, D,
            ptr(xs, 0), ptr(xs, 1), m.data_ptr(), w.data_ptr(), b.data_ptr(),
            ptr(outs, 0), ptr(outs, 1), ptr(c_hist, 0), ptr(c_hist, 1),
            h_final.data_ptr(), stream,
        )
    if err:
        raise RuntimeError(f"rnn_fwd kernel launch failed: {lib.rnn_fwd_error_string(err).decode()}")
    rnn_layer_fwd.launches += 1
    return tuple(outs), tuple(c_hist), h_final


rnn_layer_fwd.launches = 0  # kernel launches, counted where the kernel is launched


def rnn_layer_fwd_reference(
    cell: str,
    xps: Sequence[torch.Tensor],
    mask: torch.Tensor,
    w_hh: torch.Tensor,
    b_hh: torch.Tensor,
    compute_dtype="bfloat16",
    history_in_cdt: bool = False,
):
    """Plain PyTorch version of the kernel: a Python loop over time, the
    directions' products in f32 on operands rounded to the compute dtype."""
    D, T, B, H, GH = _check_args(cell, xps, mask, w_hh, b_hh)
    cdt = torch_dtype(compute_dtype)
    hist = cdt if history_in_cdt else torch.float32
    xs = [x.to(cdt).float() for x in xps]
    w = w_hh.to(cdt).float()
    b = b_hh.float()
    m_all = mask.float()
    dev = xs[0].device
    h = [torch.zeros((B, H), dtype=torch.float32, device=dev) for _ in range(D)]
    c = [torch.zeros((B, H), dtype=torch.float32, device=dev) for _ in range(D)]
    outs = [[None] * T for _ in range(D)]
    cs = [[None] * T for _ in range(D)]
    for i in range(T):
        for d in range(D):
            t = i if d == 0 else T - 1 - i
            xp = xs[d][t]
            m = m_all[t][:, None]
            h_prev = h[d]
            hp = torch.matmul(h_prev.to(cdt).float(), w[d]) + b[d]
            if cell == "GRU":
                r = torch.sigmoid(xp[:, :H] + hp[:, :H])
                z = torch.sigmoid(xp[:, H : 2 * H] + hp[:, H : 2 * H])
                n = torch.tanh(xp[:, 2 * H :] + r * hp[:, 2 * H :])
                h_new = (1.0 - z) * n + z * h_prev
            elif cell == "LSTM":
                g_all = xp + hp
                i_g = torch.sigmoid(g_all[:, :H])
                f_g = torch.sigmoid(g_all[:, H : 2 * H])
                g_g = torch.tanh(g_all[:, 2 * H : 3 * H])
                o_g = torch.sigmoid(g_all[:, 3 * H :])
                c_new = f_g * c[d] + i_g * g_g
                h_new = o_g * torch.tanh(c_new)
                c[d] = m * c_new + (1.0 - m) * c[d]
                cs[d][t] = c[d].to(hist)
            else:
                h_new = torch.tanh(xp + hp)
            h[d] = m * h_new + (1.0 - m) * h_prev
            outs[d][t] = h[d].to(hist)
    out_t = tuple(torch.stack(o) for o in outs)
    c_t = tuple(torch.stack(o) for o in cs) if cell == "LSTM" else ()
    return out_t, c_t, torch.stack(h)


def rnn_fwd_bound(T: int, B: int, H: int, D: int, G: int, cdt_bytes: int, hist_bytes: int):
    """Least time the card could take for one call, from its bytes (each
    input read once, each output written once) and its operations.
    Returns (bytes, flops)."""
    nbytes = (
        D * T * B * G * H * cdt_bytes  # xp
        + T * B * 4  # mask
        + D * H * G * H * cdt_bytes + D * G * H * 4  # w_hh, b_hh
        + D * T * B * H * hist_bytes * (2 if G == 4 else 1)  # outs (+ c history)
        + D * B * H * 4  # h_final
    )
    flops = 2 * T * D * B * H * G * H
    return nbytes, flops
