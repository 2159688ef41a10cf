"""``TTMR_RNN_HISTORY``: the saved state history's dtype, as the JAX
package reads the variable, and the f32 history under bf16 compute
against the JAX Pallas kernels.

The port reads the variable at every call (``models/rnn.py``
``history_in_cdt``); the JAX package reads it when it traces a step, so
the JAX side of the kernel comparison never depends on it: it passes
``history_in_cdt`` (forward) or the history's dtype (backward) directly.

Tolerances of the kernel comparison are those of the bf16 kernel-parity
tests (tests/test_torch_cuda.py, chip_smoke.py): the forward 2e-3 on
h_final and 1e-2 on the history (relative 2^-6 on the LSTM cell
history), the backward one bf16 ulp of the dxp scale (2^-7 max |dxp|) and
2e-3 norm-relative on dW and db. The inputs are bf16-representable, so
both sides start from the same operands; they round h to bf16 before
each step's product and differ in the order of the f32 sums.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from twotowermlretrieval_tpu.ops.rnn_scan import rnn_layer_bwd as jax_rnn_layer_bwd
from twotowermlretrieval_tpu.ops.rnn_scan import rnn_layer_fwd as jax_rnn_layer_fwd
from twotowermlretrieval_tpu_torch.models import rnn as port_rnn
from twotowermlretrieval_tpu_torch.models.rnn import RNNSpec, init_rnn_encoder, rnn_encode
from twotowermlretrieval_tpu_torch.ops.rnn_scan import rnn_layer_bwd, rnn_layer_fwd

# JAX models/rnn.py: unset (or empty) -> compact history iff compute is
# 16-bit; "cdt" -> compact; anything else -> f32
JAX_TABLE = [
    (None, "bfloat16", True), (None, "float32", False),
    ("", "bfloat16", True), ("", "float32", False),
    ("cdt", "bfloat16", True), ("cdt", "float32", True),
    ("f32", "bfloat16", False), ("f32", "float32", False),
    ("bogus", "bfloat16", False), ("bogus", "float32", False),
]


def _spy(monkeypatch, calls):
    """Record each layer's history_in_cdt and the history's dtype the
    backward receives (outs) and its cotangents' (douts)."""
    def fwd(*args, **kwargs):
        calls["fwd"].append(kwargs["history_in_cdt"])
        return rnn_layer_fwd(*args, **kwargs)

    def bwd(cell, xps, mask, w_hh, b_hh, outs, c_hist, douts, *rest, **kwargs):
        calls["bwd"].append((outs[0].dtype, douts[0].dtype))
        return rnn_layer_bwd(cell, xps, mask, w_hh, b_hh, outs, c_hist, douts, *rest, **kwargs)

    monkeypatch.setattr(port_rnn, "rnn_layer_fwd", fwd)
    monkeypatch.setattr(port_rnn, "rnn_layer_bwd", bwd)


def _encode_and_grad(compute_dtype):
    spec = RNNSpec(vocab_size=40, embed_dim=8, hidden_dim=8, num_layers=2,
                   bidirectional=True, compute_dtype=compute_dtype)
    params = init_rnn_encoder(torch.Generator().manual_seed(0), spec)
    w = params["layers"][0]["fwd"]["w_hh"].requires_grad_(True)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, 40, (4, 6)).astype(np.int64))
    lengths = torch.tensor([6, 3, 0, 1])
    rnn_encode(params, tokens, lengths, spec).sum().backward()
    return w.grad


@pytest.mark.parametrize("env,compute_dtype,compact", JAX_TABLE,
                         ids=[f"{e}-{c}" for e, c, _ in JAX_TABLE])
def test_history_env_matches_jax_table(monkeypatch, env, compute_dtype, compact):
    if env is None:
        monkeypatch.delenv("TTMR_RNN_HISTORY", raising=False)
    else:
        monkeypatch.setenv("TTMR_RNN_HISTORY", env)
    calls = {"fwd": [], "bwd": []}
    _spy(monkeypatch, calls)
    grad = _encode_and_grad(compute_dtype)
    assert calls["fwd"] == [compact, compact]  # both layers
    hist = torch.bfloat16 if compact and compute_dtype == "bfloat16" else torch.float32
    # the backward reads the history and its cotangents in one dtype
    assert calls["bwd"] == [(hist, hist), (hist, hist)]
    assert torch.isfinite(grad).all() and grad.abs().sum() > 0


def test_history_env_is_read_at_every_call(monkeypatch):
    """A change of the variable takes effect on the next encode, in the
    same process (the JAX package would keep its traced choice)."""
    calls = {"fwd": [], "bwd": []}
    _spy(monkeypatch, calls)
    for env in ("f32", "cdt", "f32"):
        monkeypatch.setenv("TTMR_RNN_HISTORY", env)
        _encode_and_grad("bfloat16")
    assert calls["fwd"] == [False, False, True, True, False, False]


def _bf16(x):
    """x rounded to bf16 and back: an operand both sides read exactly."""
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy()


@pytest.mark.parametrize("cell", ["GRU", "LSTM"])
def test_f32_history_under_bf16_matches_jax(cell):
    """The plain forward and backward with history_in_cdt=False at bf16
    compute against JAX's kernels in interpret mode (T=8, B=8, H=16, both
    directions; the JAX kernels as one block of the 8 rows)."""
    T, B, H, D = 8, 8, 16, 2
    G = {"GRU": 3, "LSTM": 4}[cell]
    rng = np.random.default_rng(11)
    xps = tuple(_bf16(rng.normal(size=(T, B, G * H))) for _ in range(D))
    lengths = np.r_[T, 0, 1, rng.integers(1, T + 1, B - 3)]
    mask = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
    w_hh = _bf16(rng.normal(size=(D, H, G * H)) * 0.2)
    b_hh = (rng.normal(size=(D, G * H)) * 0.1).astype(np.float32)
    douts = tuple(rng.normal(size=(T, B, H)).astype(np.float32) for _ in range(D))
    d_hfinal = rng.normal(size=(D, B, H)).astype(np.float32)

    t = torch.from_numpy
    outs, c_hist, fin = rnn_layer_fwd(cell, [t(x) for x in xps], t(mask), t(w_hh), t(b_hh),
                                      compute_dtype="bfloat16", history_in_cdt=False)
    j_outs, j_c, j_fin = jax_rnn_layer_fwd(
        cell, tuple(jnp.asarray(x) for x in xps), jnp.asarray(mask), jnp.asarray(w_hh),
        jnp.asarray(b_hh), compute_dtype="bfloat16", history_in_cdt=False, interpret=True,
        b_block=B)
    assert outs[0].dtype == torch.float32 and j_outs[0].dtype == jnp.float32
    np.testing.assert_allclose(fin.numpy(), np.asarray(j_fin), rtol=0, atol=2e-3)
    for a, b in zip(outs, j_outs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-2)
    for a, b in zip(c_hist, j_c):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2 ** -6, atol=1e-2)

    # the backward from the same (JAX's) f32 history
    hist = tuple(np.array(o) for o in j_outs)
    cells = tuple(np.array(c) for c in j_c)
    dxps, dw, db = rnn_layer_bwd(
        cell, [t(x) for x in xps], t(mask), t(w_hh), t(b_hh), [t(h) for h in hist],
        [t(c) for c in cells], [t(d) for d in douts], t(d_hfinal), compute_dtype="bfloat16")
    j_dxps, j_dw, j_db = jax_rnn_layer_bwd(
        cell, tuple(jnp.asarray(x) for x in xps), jnp.asarray(mask), jnp.asarray(w_hh),
        jnp.asarray(b_hh), tuple(jnp.asarray(h) for h in hist),
        tuple(jnp.asarray(c) for c in cells), tuple(jnp.asarray(d) for d in douts),
        jnp.asarray(d_hfinal), compute_dtype="bfloat16", interpret=True, b_block=B)
    for a, b in zip(dxps, j_dxps):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 2 ** -7 * np.abs(b).max()
    for a, b in ((dw, j_dw), (db, j_db)):
        b = np.asarray(b)
        assert np.linalg.norm(a.numpy() - b) <= 2e-3 * np.linalg.norm(b)
