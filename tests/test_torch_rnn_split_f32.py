"""The recurrent kernels' f32-compute arithmetic, on the CPU.

At f32 compute ``csrc/rnn_fwd.cu`` and ``csrc/rnn_bwd.cu`` form every
product (the step's h . W, the gate recompute, the dh chain, the weight
gradient) as a split product: each f32 operand in three bf16 pieces and the
six leading products of the pieces (``csrc/recur_chain.cuh``), which is
``utils/dtypes.py`` ``matmul_split``. Here the plain versions run with
their products (``ops/rnn_scan.py`` ``_mm``) replaced by ``matmul_split``
and are held against the JAX Pallas kernels in interpret mode at f32
compute, which ask for Precision.HIGHEST, on the same numpy inputs: GRU and
LSTM, both directions, a ragged batch with a zero-length row. Tolerances
are those of tests/test_torch_rnn_scan.py (rtol 1e-5, atol 1e-6) and
tests/test_torch_rnn_bwd.py (rtol 1e-4, atol 1e-5 on dxp and 1e-4 on dW and
db): the split's dropped products cost at most 2^-23 (1 + 2^-7) of each
entry's sum of |a_k b_k|, the size of an f32 sum's own rounding. The
kernels' row blocks and the chain's W stay f32 in shared memory and are
split in registers; the forward's W (but at its widest layers) and the
GEMMs' operands are held as planes of ``split_bf16x3``'s pieces
(tests/test_torch_split_f32.py), written once a call on the card, which
form the same products: no packing of pieces has a CPU twin.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from twotowermlretrieval_tpu.ops.rnn_scan import rnn_layer_bwd as jax_rnn_layer_bwd
from twotowermlretrieval_tpu.ops.rnn_scan import rnn_layer_fwd as jax_rnn_layer_fwd
from twotowermlretrieval_tpu_torch.ops import rnn_scan
from twotowermlretrieval_tpu_torch.utils.dtypes import matmul_split

FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
BWD_RTOL, BWD_ATOL_DX, BWD_ATOL_W = 1e-4, 1e-5, 1e-4
CELLS = ["GRU", "LSTM"]


def _case(cell, T=12, B=16, H=128, seed=0):
    """Both directions' inputs, full-length, empty, length-1 and random
    rows, the cotangents, and the forward's history from JAX's kernel."""
    G = {"GRU": 3, "LSTM": 4}[cell]
    rng = np.random.default_rng(seed)
    xps = tuple(rng.normal(size=(T, B, G * H)).astype(np.float32) for _ in range(2))
    lengths = np.r_[T, 0, 1, rng.integers(1, T + 1, B - 3)].astype(np.int32)
    mask = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
    w_hh = (rng.normal(size=(2, H, G * H)) * 0.2).astype(np.float32)
    b_hh = (rng.normal(size=(2, G * H)) * 0.1).astype(np.float32)
    douts = tuple(rng.normal(size=(T, B, H)).astype(np.float32) for _ in range(2))
    d_hfinal = rng.normal(size=(2, B, H)).astype(np.float32)
    return xps, mask, w_hh, b_hh, douts, d_hfinal


@pytest.fixture
def split_products(monkeypatch):
    """The plain versions' products as the kernels form them at f32
    compute; counts the products taken."""
    calls = []

    def mm(a, b):
        calls.append(a.shape)
        return matmul_split(a, b)

    monkeypatch.setattr(rnn_scan, "_mm", mm)
    return calls


@pytest.mark.parametrize("cell", CELLS)
def test_split_forward_matches_jax_pallas_interpret(cell, split_products):
    xps, mask, w_hh, b_hh, _, _ = _case(cell)
    T = mask.shape[0]
    outs, c_hist, fin = rnn_scan.rnn_layer_fwd(
        cell, [torch.from_numpy(x) for x in xps], torch.from_numpy(mask),
        torch.from_numpy(w_hh), torch.from_numpy(b_hh), compute_dtype="float32")
    assert len(split_products) == 2 * T  # every step's product, both directions
    j_outs, j_c, j_fin = jax_rnn_layer_fwd(
        cell, tuple(jnp.asarray(x) for x in xps), jnp.asarray(mask), jnp.asarray(w_hh),
        jnp.asarray(b_hh), compute_dtype="float32", interpret=True)
    for a, b in zip((*outs, *c_hist, fin), (*j_outs, *j_c, j_fin)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=FWD_RTOL, atol=FWD_ATOL)
    # the zero-length row stays exactly zero
    assert (fin[:, 1] == 0).all() and all((o[:, 1] == 0).all() for o in outs)


@pytest.mark.parametrize("cell", CELLS)
def test_split_backward_matches_jax_pallas_interpret(cell, split_products):
    xps, mask, w_hh, b_hh, douts, d_hfinal = _case(cell, seed=1)
    T = mask.shape[0]
    outs, c_hist, _ = jax_rnn_layer_fwd(
        cell, tuple(jnp.asarray(x) for x in xps), jnp.asarray(mask), jnp.asarray(w_hh),
        jnp.asarray(b_hh), compute_dtype="float32", interpret=True)
    args = (xps, mask, w_hh, b_hh, tuple(np.asarray(o) for o in outs),
            tuple(np.asarray(c) for c in c_hist), douts, d_hfinal)

    def t(a):
        return tuple(torch.from_numpy(np.array(x)) for x in a) if isinstance(a, tuple) \
            else torch.from_numpy(np.array(a))

    dxps, dw, db = rnn_scan.rnn_layer_bwd(cell, *map(t, args), compute_dtype="float32")
    # the gate recompute and the weight gradient a direction, the chain a step
    assert len(split_products) == 2 * (T + 2)
    j_dxps, j_dw, j_db = jax_rnn_layer_bwd(
        cell, *[tuple(map(jnp.asarray, a)) if isinstance(a, tuple) else jnp.asarray(a)
                for a in args], compute_dtype="float32", interpret=True)
    for a, b in zip(dxps, j_dxps):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=BWD_RTOL, atol=BWD_ATOL_DX)
    np.testing.assert_allclose(dw.numpy(), np.asarray(j_dw), rtol=BWD_RTOL, atol=BWD_ATOL_W)
    np.testing.assert_allclose(db.numpy(), np.asarray(j_db), rtol=BWD_RTOL, atol=BWD_ATOL_W)
    # the zero-length row gets no gate cotangent
    assert all((d[:, 1] == 0).all() for d in dxps)
