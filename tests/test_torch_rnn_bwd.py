"""The port's recurrent backward and encoder gradients against the JAX
package's.

On the CPU the port's ``rnn_layer_bwd`` (and its split-mode variants) run
the plain PyTorch version of ``csrc/rnn_bwd.cu``; they are held against
the JAX Pallas kernels in interpret mode at f32 compute, on the same numpy
inputs. Tolerances are those of the JAX package's own kernel tests
(tests/test_rnn_kernel.py): rtol 1e-4 with atol 1e-5 on dxp and 1e-4 on
dW/db, for the same f32 arithmetic summed in another order. The encoder's
gradients go through the port's autograd Function and are held against
``jax.grad`` of the JAX encoder per leaf. The CUDA kernel itself is held
against the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from twotowermlretrieval_tpu.models.rnn import RNNSpec as JaxRNNSpec
from twotowermlretrieval_tpu.models.rnn import init_rnn_encoder as jax_init_rnn_encoder
from twotowermlretrieval_tpu.models.rnn import rnn_encode as jax_rnn_encode
from twotowermlretrieval_tpu.ops.rnn_scan import rnn_layer_bwd as jax_rnn_layer_bwd
from twotowermlretrieval_tpu.ops.rnn_scan import rnn_layer_bwd_hoisted as jax_bwd_hoisted
from twotowermlretrieval_tpu.ops.rnn_scan import rnn_layer_bwd_split as jax_rnn_layer_bwd_split
from twotowermlretrieval_tpu.ops.rnn_scan import rnn_layer_bwd_split_full as jax_bwd_split_full
from twotowermlretrieval_tpu.ops.rnn_scan import rnn_layer_fwd as jax_rnn_layer_fwd
from twotowermlretrieval_tpu_torch.models.rnn import RNNSpec, dropout_parts, rnn_encode
from twotowermlretrieval_tpu_torch.models.two_tower import to_device
from twotowermlretrieval_tpu_torch.ops.rnn_scan import (
    _bwd_reference,
    rnn_bwd_bound,
    rnn_fwd_bound,
    rnn_layer_bwd,
    rnn_layer_bwd_hoisted,
    rnn_layer_bwd_reference,
    rnn_layer_bwd_split,
    rnn_layer_bwd_split_full,
)
from twotowermlretrieval_tpu_torch.utils.dtypes import bernoulli_mask

RTOL, ATOL_DX, ATOL_W = 1e-4, 1e-5, 1e-4

CASES = [(1, "GRU"), (2, "GRU"), (1, "LSTM"), (2, "LSTM"), (1, "RNN"), (2, "RNN")]
IDS = [f"{'bidir' if d == 2 else 'unidir'}-{c}" for d, c in CASES]


def _case(D, cell, T=12, B=16, H=128, seed=0, b_block=0):
    """Inputs, the forward's saved history (JAX's kernel, interpret mode)
    and random cotangents, all numpy."""
    G = {"GRU": 3, "LSTM": 4, "RNN": 1}[cell]
    # a contracting recurrence (see tests/test_torch_rnn_scan.py): the tanh
    # RNN is chaotic at 0.2
    w_scale = 0.05 if cell == "RNN" else 0.2
    rng = np.random.default_rng(seed)
    xps = tuple(rng.normal(size=(T, B, G * H)).astype(np.float32) for _ in range(D))
    lengths = np.r_[T, 0, 1, rng.integers(1, T + 1, B - 3)].astype(np.int32)
    mask = (np.arange(T)[:, None] < lengths[None, :]).astype(np.float32)
    w_hh = (rng.normal(size=(D, H, G * H)) * w_scale).astype(np.float32)
    b_hh = (rng.normal(size=(D, G * H)) * 0.1).astype(np.float32)
    douts = tuple(rng.normal(size=(T, B, H)).astype(np.float32) for _ in range(D))
    d_hfinal = rng.normal(size=(D, B, H)).astype(np.float32)
    outs, c_hist, _ = jax_rnn_layer_fwd(
        cell, tuple(jnp.asarray(x) for x in xps), jnp.asarray(mask), jnp.asarray(w_hh),
        jnp.asarray(b_hh), compute_dtype="float32", interpret=True, b_block=b_block,
    )
    outs = tuple(np.asarray(o) for o in outs)
    c_hist = tuple(np.asarray(c) for c in c_hist)
    return cell, xps, mask, w_hh, b_hh, outs, c_hist, douts, d_hfinal


def _t(arrs):
    if isinstance(arrs, tuple):
        return tuple(torch.from_numpy(np.array(a)) for a in arrs)
    return torch.from_numpy(np.array(arrs))


def _j(arrs):
    if isinstance(arrs, tuple):
        return tuple(jnp.asarray(a) for a in arrs)
    return jnp.asarray(arrs)


def _check(port, ref):
    dx, dw, db = port
    j_dx, j_dw, j_db = ref
    for a, b in zip(dx, j_dx):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL_DX)
    np.testing.assert_allclose(dw.numpy(), np.asarray(j_dw), rtol=RTOL, atol=ATOL_W)
    np.testing.assert_allclose(db.numpy(), np.asarray(j_db), rtol=RTOL, atol=ATOL_W)


@pytest.mark.parametrize("D,cell", CASES, ids=IDS)
def test_bwd_matches_jax_pallas_interpret(D, cell):
    cell, *args = _case(D, cell)
    port = rnn_layer_bwd(cell, *[_t(a) for a in args], compute_dtype="float32")
    assert all(d.dtype == torch.float32 for d in port[0])
    ref = jax_rnn_layer_bwd(cell, *[_j(a) for a in args], compute_dtype="float32",
                            interpret=True)
    _check(port, ref)


@pytest.mark.parametrize("D,cell", [(2, "GRU"), (2, "LSTM")], ids=["bidir-GRU", "bidir-LSTM"])
def test_bwd_matches_jax_multi_block(D, cell):
    """B=48 is three of the kernel's 16-row blocks; the JAX kernel runs
    blocks of 16 too (b_block), accumulating dW across them."""
    cell, *args = _case(D, cell, B=48, seed=3)
    port = rnn_layer_bwd(cell, *[_t(a) for a in args], compute_dtype="float32")
    ref = jax_rnn_layer_bwd(cell, *[_j(a) for a in args], compute_dtype="float32",
                            interpret=True, b_block=16)
    _check(port, ref)


@pytest.mark.parametrize("cell", ["GRU", "LSTM", "RNN"])
@pytest.mark.parametrize("B,T", [(37, 12), (16, 1)], ids=["B37", "T1"])
def test_bwd_matches_jax_ragged_batch_and_one_step(B, T, cell):
    """B=37 is no multiple of a row block (the JAX kernel runs it as one
    block of 37 rows); at T=1 every row is at its first position, where
    h_prev is 0 and so is dW."""
    cell, *args = _case(2, cell, T=T, B=B, seed=6, b_block=B)
    port = rnn_layer_bwd(cell, *[_t(a) for a in args], compute_dtype="float32")
    ref = jax_rnn_layer_bwd(cell, *[_j(a) for a in args], compute_dtype="float32",
                            interpret=True, b_block=B)
    _check(port, ref)


@pytest.mark.parametrize("cell", ["GRU", "LSTM", "RNN"])
def test_split_lone_direction_1_matches_jax(cell):
    """The backward tower direction alone (direction=1: it walks t = 0..T-1
    and reads h_prev at t+1), in split mode: dxp and dhp."""
    cell, xps, mask, w_hh, b_hh, outs, c_hist, douts, d_hfinal = _case(2, cell, seed=7)
    one = (xps[1], mask, w_hh[1:], b_hh[1:], outs[1])
    rest = (douts[1], d_hfinal[1:])
    port = rnn_layer_bwd_split(cell, *map(_t, one), _t(c_hist[1]) if c_hist else None,
                               *map(_t, rest), direction=1, compute_dtype="float32")
    ref = jax_rnn_layer_bwd_split(cell, *map(_j, one), _j(c_hist[1]) if c_hist else None,
                                  *map(_j, rest), direction=1, compute_dtype="float32",
                                  interpret=True)
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL_DX)


@pytest.mark.parametrize("D,cell", CASES, ids=IDS)
def test_hoisted_and_split_plans_match_jax(D, cell):
    cell, *args = _case(D, cell, seed=1)
    targs, jargs = [_t(a) for a in args], [_j(a) for a in args]
    _check(rnn_layer_bwd_hoisted(cell, *targs, compute_dtype="float32"),
           jax_bwd_hoisted(cell, *jargs, compute_dtype="float32", interpret=True))
    _check(rnn_layer_bwd_split_full(cell, *targs, compute_dtype="float32"),
           jax_bwd_split_full(cell, *jargs, compute_dtype="float32", interpret=True))


def test_cpu_wrapper_is_the_plain_version_in_both_modes():
    cell, *args = _case(2, "GRU", T=6, B=16, H=16, seed=2)
    targs = [_t(a) for a in args]
    a = rnn_layer_bwd(cell, *targs, compute_dtype="bfloat16")
    b = rnn_layer_bwd_reference(cell, *targs, compute_dtype="bfloat16")
    for x, y in zip((*a[0], a[1], a[2]), (*b[0], b[1], b[2])):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    # split mode: dxp equals the combined mode's; GRU's dhp differs from it
    # only in the candidate third
    dxps, dhps, dw, db = _bwd_reference(cell, *targs, "bfloat16", split=True)
    assert dw is None and db is None and dxps[0].dtype == torch.bfloat16
    torch.testing.assert_close(dxps[0].float(), a[0][0], rtol=0, atol=0)
    H = 16
    torch.testing.assert_close(dhps[0][..., : 2 * H], dxps[0][..., : 2 * H], rtol=0, atol=0)


def test_bwd_bound_counts():
    nbytes, flops = rnn_bwd_bound(T=128, B=128, H=256, D=2, G=3, cdt_bytes=2, hist_bytes=2)
    assert flops == 6 * 128 * 2 * 128 * 256 * 768
    stream = 2 * 128 * 128 * 768 * 2
    assert nbytes > 2 * stream and nbytes < 2.8 * stream
    _, flops_split = rnn_bwd_bound(128, 128, 256, 2, 3, 2, 2, split=True)
    _, flops_rnn = rnn_bwd_bound(128, 128, 256, 2, 1, 2, 2)
    assert flops_split == 4 * 128 * 2 * 128 * 256 * 768 and flops_rnn == 4 * 128 * 2 * 128 * 256 * 256


# (pass, T, B, H) -> (bound ms, by, bytes ms) at f32 compute, GRU D=2: an
# f32-precision product counts as the six bf16 products of its split,
# priced at the bf16 rate (164.8 TFLOP/s in all)
_F32_BOUNDS = {("fwd", 32, 64, 1024): (0.156339, "operations", 0.027711),
               ("bwd", 32, 64, 1024): (0.469016, "operations", 0.055263),
               ("fwd", 32, 64, 256): (0.009771, "operations", 0.005521),
               ("bwd", 32, 64, 256): (0.029313, "operations", 0.011001),
               ("fwd", 128, 128, 256): (0.078169, "operations", 0.040634),
               ("bwd", 128, 128, 256): (0.234508, "operations", 0.081170)}


@pytest.mark.parametrize("which,T,B,H", list(_F32_BOUNDS),
                         ids=[f"{w}-T{t}-B{b}-H{h}" for w, t, b, h in _F32_BOUNDS])
def test_f32_bound_prices_split_products(which, T, B, H):
    """The bench tool's bound at f32 compute (chip_smoke.py prices it the
    same way): the operations of rnn_fwd_bound / rnn_bwd_bound at a sixth of
    the bf16 rate, beside their bytes at 3.35 TB/s; at bf16 compute the
    same counts at the bf16 rate."""
    from twotowermlretrieval_tpu_torch.tools.bench_rnn_stream import _bound

    fn = rnn_fwd_bound if which == "fwd" else rnn_bwd_bound
    nbytes, flops = fn(T, B, H, 2, 3, 4, 4)
    ms, by, bytes_ms = _F32_BOUNDS[which, T, B, H]
    got_ms, got_by = _bound(nbytes, flops, split=True)
    assert (round(got_ms, 6), got_by) == (ms, by)
    assert round(nbytes / 3.35e12 * 1e3, 6) == bytes_ms
    assert _bound(nbytes, flops)[0] == max(nbytes / 3.35e12, flops / 989e12) * 1e3


# ---------------------------------------------------------------------------
# the encoder's gradients, through the autograd Function
# ---------------------------------------------------------------------------


def _encoder_case(rnn_type, bidirectional, seed=0):
    V, E, H, B, T = 50, 12, 16, 6, 9
    jspec = JaxRNNSpec(vocab_size=V, embed_dim=E, hidden_dim=H, rnn_type=rnn_type,
                       num_layers=2, bidirectional=bidirectional, compute_dtype="float32")
    spec = RNNSpec(vocab_size=V, embed_dim=E, hidden_dim=H, rnn_type=rnn_type, num_layers=2,
                   bidirectional=bidirectional, compute_dtype="float32")
    params = jax.tree.map(np.asarray, jax_init_rnn_encoder(jax.random.key(seed), jspec))
    rng = np.random.default_rng(seed)
    # no zero-length row: JAX's gradient of the clamped norm is NaN there
    # (0 * d|x|/dx at x = 0), the port's is 0
    lengths = np.r_[T, 1, rng.integers(1, T + 1, B - 2)].astype(np.int32)
    tokens = rng.integers(0, V, (B, T)).astype(np.int32)
    ct = rng.normal(size=(B, H)).astype(np.float32)
    return jspec, spec, params, tokens, lengths, ct


@pytest.mark.parametrize("rnn_type", ["GRU", "LSTM", "RNN"])
@pytest.mark.parametrize("bidirectional", [False, True], ids=["unidir", "bidir"])
def test_encoder_grads_match_jax_grad(rnn_type, bidirectional):
    jspec, spec, params, tokens, lengths, ct = _encoder_case(rnn_type, bidirectional)

    def jax_loss(p):
        return jnp.sum(jax_rnn_encode(p, jnp.asarray(tokens), jnp.asarray(lengths), jspec)
                       * ct)

    j_grads = jax.grad(jax_loss)(jax.tree.map(jnp.asarray, params))

    tparams = to_device(params, "cpu")
    leaves = []

    def mark(tree):
        if isinstance(tree, dict):
            return {k: mark(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(mark(v) for v in tree)
        leaves.append(tree.requires_grad_(True))
        return tree

    tparams = mark(tparams)
    out = rnn_encode(tparams, torch.from_numpy(tokens), torch.from_numpy(lengths), spec)
    (out * torch.from_numpy(ct)).sum().backward()

    flat_j = jax.tree_util.tree_flatten_with_path(j_grads)[0]
    flat_t = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda x: x, tparams, is_leaf=lambda x: isinstance(x, torch.Tensor)),
        is_leaf=lambda x: isinstance(x, torch.Tensor),
    )[0]
    assert len(flat_j) == len(flat_t) == len(leaves)
    for (path, g), (_, p) in zip(flat_j, flat_t):
        np.testing.assert_allclose(
            p.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-5,
            err_msg=jax.tree_util.keystr(path),
        )


def test_hoisted_plan_knob_gives_the_same_encoder_grads(monkeypatch):
    """TTMR_RNN_BWD_PLAN=hoisted swaps the backward for the split-mode
    kernel plus the hoisted weight gradient: same gradients."""
    _, spec, params, tokens, lengths, ct = _encoder_case("GRU", True, seed=4)

    def grads():
        p = to_device(params, "cpu")
        w = p["layers"][0]["bwd"]["w_hh"].requires_grad_(True)
        out = rnn_encode(p, torch.from_numpy(tokens), torch.from_numpy(lengths), spec)
        (out * torch.from_numpy(ct)).sum().backward()
        return w.grad

    fused = grads()
    monkeypatch.setenv("TTMR_RNN_BWD_PLAN", "hoisted")
    torch.testing.assert_close(grads(), fused, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------


def test_bernoulli_mask_rate():
    gen = torch.Generator().manual_seed(0)
    m = bernoulli_mask(gen, 0.8, (400, 500), "cpu")
    assert m.dtype == torch.bool and m.shape == (400, 500)
    # 200,000 draws: the rate's standard error is 9e-4
    assert abs(m.float().mean().item() - 0.8) < 5e-3
    again = bernoulli_mask(torch.Generator().manual_seed(0), 0.8, (400, 500), "cpu")
    assert torch.equal(m, again)  # determined by the generator


def test_dropout_between_layers_scales_kept_units():
    """Inter-layer dropout as torch's: the first layer's outputs are kept
    with probability 1 - p and scaled by 1 / (1 - p). With H=1 and
    all-zero recurrent and second-layer weights except one input weight,
    the second layer's input projection exposes the dropped first-layer
    output directly."""
    _, spec, params, tokens, lengths, _ = _encoder_case("GRU", False, seed=5)
    spec = RNNSpec(**{**spec.__dict__, "dropout": 0.5})
    p = to_device(params, "cpu")
    gen = torch.Generator().manual_seed(1)
    eval_out = rnn_encode(p, torch.from_numpy(tokens), torch.from_numpy(lengths), spec)
    a = rnn_encode(p, torch.from_numpy(tokens), torch.from_numpy(lengths), spec, train=True,
                   generator=gen)
    b = rnn_encode(p, torch.from_numpy(tokens), torch.from_numpy(lengths), spec, train=True,
                   generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, eval_out)
    with pytest.raises(ValueError, match="generator"):
        rnn_encode(p, torch.from_numpy(tokens), torch.from_numpy(lengths), spec, train=True)
    one_layer = RNNSpec(**{**spec.__dict__, "num_layers": 1})
    p1 = {**p, "layers": p["layers"][:1]}
    torch.testing.assert_close(
        rnn_encode(p1, torch.from_numpy(tokens), torch.from_numpy(lengths), one_layer,
                   train=True, generator=gen),
        rnn_encode(p1, torch.from_numpy(tokens), torch.from_numpy(lengths), one_layer),
        rtol=0, atol=0,
    )


def test_dropout_parts_zero_or_scale_by_keep():
    """Each part is multiplied by its own Bernoulli(keep) draw, in order,
    and divided by keep: every value is 0 or x / keep."""
    gen = torch.Generator().manual_seed(2)
    parts = (torch.rand((30, 20, 16)) + 0.5, torch.rand((30, 20, 16)) + 0.5)
    keep = 0.75
    out = dropout_parts(parts, keep, gen)
    replay = torch.Generator().manual_seed(2)
    for x, y in zip(parts, out):
        m = bernoulli_mask(replay, keep, x.shape, "cpu")
        torch.testing.assert_close(y, torch.where(m, x / keep, torch.zeros_like(x)),
                                   rtol=0, atol=0)
        assert abs(m.float().mean().item() - keep) < 0.02
    # bf16 parts (the bf16 history) stay bf16, as in the JAX package
    assert dropout_parts((parts[0].bfloat16(),), keep, gen)[0].dtype == torch.bfloat16
