"""The port's recurrent time loop against the JAX package's.

On the CPU the port's ``rnn_layer_fwd`` runs its plain PyTorch version;
it is held against the JAX Pallas kernel in interpret mode and against the
XLA masked scan, at f32 compute, on the same numpy inputs. Tolerance rtol
1e-5, atol 1e-6: the same f32 arithmetic with sums taken in another order.
The CUDA kernel itself is held against the plain version on the card by
chip_smoke.py and tests/test_torch_cuda.py.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from twotowermlretrieval_tpu.models.rnn import _scan_layer_fwd_impl
from twotowermlretrieval_tpu.ops.rnn_scan import rnn_layer_fwd as jax_rnn_layer_fwd
from twotowermlretrieval_tpu_torch.ops.rnn_scan import (
    rnn_layer_fwd,
    rnn_layer_fwd_reference,
)

RTOL, ATOL = 1e-5, 1e-6


def _case(D, cell, T=12, B=16, H=128, seed=0):
    G = {"GRU": 3, "LSTM": 4, "RNN": 1}[cell]
    # The tanh RNN at w_hh scale 0.2 (spectral radius ~2) is chaotic: over
    # 12 steps it amplifies the last-bit difference between torch's and
    # XLA's summation orders past 1e-5. At 0.05 it contracts, as trained
    # recurrences do, and the comparison sees the arithmetic alone.
    w_scale = 0.05 if cell == "RNN" else 0.2
    rng = np.random.default_rng(seed)
    xps = tuple(rng.normal(size=(T, B, G * H)).astype(np.float32) for _ in range(D))
    # full-length, empty, length-1 and random rows
    lengths = np.r_[T, 0, 1, rng.integers(1, T + 1, B - 3)].astype(np.int32)
    mask = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
    w_hh = (rng.normal(size=(D, H, G * H)) * w_scale).astype(np.float32)
    b_hh = (rng.normal(size=(D, G * H)) * 0.1).astype(np.float32)
    return cell, xps, mask, w_hh, b_hh


CASES = [(1, "GRU"), (2, "GRU"), (2, "LSTM"), (2, "RNN")]
IDS = ["unidir-GRU", "bidir-GRU", "bidir-LSTM", "bidir-RNN"]


def _port(cell, xps, mask, w_hh, b_hh):
    outs, c_hist, fin = rnn_layer_fwd(
        cell, [torch.from_numpy(x) for x in xps], torch.from_numpy(mask),
        torch.from_numpy(w_hh), torch.from_numpy(b_hh), compute_dtype="float32",
    )
    return [o.numpy() for o in outs], [c.numpy() for c in c_hist], fin.numpy()


@pytest.mark.parametrize("D,cell", CASES, ids=IDS)
def test_port_fwd_matches_jax_pallas_interpret(D, cell):
    cell, xps, mask, w_hh, b_hh = _case(D, cell)
    outs, c_hist, fin = _port(cell, xps, mask, w_hh, b_hh)
    j_outs, j_c, j_fin = jax_rnn_layer_fwd(
        cell, tuple(jnp.asarray(x) for x in xps), jnp.asarray(mask),
        jnp.asarray(w_hh), jnp.asarray(b_hh), compute_dtype="float32", interpret=True,
    )
    for a, b in zip(outs, j_outs):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL)
    for a, b in zip(c_hist, j_c):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(fin, np.asarray(j_fin), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("D,cell", CASES, ids=IDS)
def test_port_fwd_matches_jax_xla_scan(D, cell):
    cell, xps, mask, w_hh, b_hh = _case(D, cell, seed=1)
    outs, _, fin = _port(cell, xps, mask, w_hh, b_hh)
    os.environ["TTMR_DISABLE_FUSED_RNN"] = "1"
    try:
        j_outs, _, j_fin = _scan_layer_fwd_impl(
            cell, "float32", tuple(jnp.asarray(x) for x in xps), jnp.asarray(mask),
            jnp.asarray(w_hh), jnp.asarray(b_hh),
        )
    finally:
        del os.environ["TTMR_DISABLE_FUSED_RNN"]
    for a, b in zip(outs, j_outs):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(fin, np.asarray(j_fin), rtol=RTOL, atol=ATOL)


def test_zero_length_rows_keep_zero_state():
    """Padded steps are identity updates: a row of length 0 stays exactly
    zero through every step, in every direction."""
    cell, xps, mask, w_hh, b_hh = _case(2, "GRU", T=6, B=4, H=16)
    outs, _, fin = _port(cell, xps, mask, w_hh, b_hh)
    assert (fin[:, 1] == 0).all()
    assert all((o[:, 1] == 0).all() for o in outs)


def test_bf16_history_is_rounded_state():
    """Under history_in_cdt the history is the f32 state rounded to bf16;
    h_final stays f32."""
    cell, xps, mask, w_hh, b_hh = _case(2, "GRU", T=5, B=4, H=16)
    args = ([torch.from_numpy(x) for x in xps], torch.from_numpy(mask),
            torch.from_numpy(w_hh), torch.from_numpy(b_hh))
    outs32, _, fin32 = rnn_layer_fwd_reference(cell, *args, compute_dtype="bfloat16")
    outs16, _, fin16 = rnn_layer_fwd_reference(
        cell, *args, compute_dtype="bfloat16", history_in_cdt=True
    )
    assert outs16[0].dtype == torch.bfloat16 and fin16.dtype == torch.float32
    torch.testing.assert_close(outs16[0], outs32[0].to(torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(fin16, fin32, rtol=0, atol=0)
