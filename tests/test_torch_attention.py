"""The port's fused attention (plain versions, on the CPU) against the JAX
package's kernel run in interpret mode and its ``jax.grad``.

Tolerances:

- f32 compute: rtol 1e-5 / atol 1e-6 forward and 1e-4 / 1e-5 gradients,
  the bounds tests/test_models.py holds the JAX kernel to against its XLA
  path (the same arithmetic, sums in another order);
- bf16 compute: one bf16 ulp of the result's scale, 2^-8 * max|JAX|. Both
  round the same operands to bf16, but a last-bit difference of an f32 sum
  can move p or ds across a bf16 rounding boundary (measured at these
  shapes: 4.5e-8 of the scale; the plain version against itself with
  float64 sums at R=512, T=128: 6.1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twotowermlretrieval_tpu.ops.attention import fused_attention as jax_fused_attention
from twotowermlretrieval_tpu.ops.attention import use_fused_attention as jax_use_fused_attention
from twotowermlretrieval_tpu_torch.ops import attention as port_attention
from twotowermlretrieval_tpu_torch.ops.attention import (
    HEAD_DIMS,
    MAX_T,
    attention_bwd,
    attention_plan,
    attention_bwd_reference,
    attention_fwd,
    fused_attention,
    use_fused_attention,
)
from twotowermlretrieval_tpu_torch.utils.dtypes import SPLIT_PRODUCTS, matmul_split, split_bf16x3

_TOL = {"float32": dict(fwd=(1e-5, 1e-6), grad=(1e-4, 1e-5)), "bfloat16": 2 ** -8}


def _case(R, T, hd, seed):
    rng = np.random.default_rng(seed)
    q, k, v, ct = (rng.standard_normal((R, T, hd)).astype(np.float32) for _ in range(4))
    lens = rng.integers(1, T + 1, R)
    lens[:3] = [0, 1, T]  # a fully masked row, a single key, every key
    bias = np.where(np.arange(T)[None, :] < lens[:, None], 0.0, -1e9).astype(np.float32)
    return q, k, v, bias, ct, float(1.0 / np.sqrt(hd))


def _jax(q, k, v, bias, ct, scale, cdt, in_dtype):
    args = [jnp.asarray(x).astype(in_dtype) for x in (q, k, v)]

    def f(*a):
        return jax_fused_attention(*a, jnp.asarray(bias), scale, cdt, True)

    out, vjp = jax.vjp(f, *args)
    return [np.asarray(x, np.float32) for x in (out, *vjp(jnp.asarray(ct)))]


def _port(q, k, v, bias, ct, scale, cdt, in_dtype):
    """Through the autograd Function; bf16 inputs round inside it, so the
    gradients stay f32 as the JAX custom VJP returns them."""
    ts = [torch.from_numpy(x.copy()).requires_grad_(True) for x in (q, k, v)]
    out = fused_attention(*ts, torch.from_numpy(bias), scale, cdt,
                          input_dtype=None if in_dtype == np.float32 else torch.bfloat16)
    out.backward(torch.from_numpy(ct))
    return [out.detach().numpy()] + [t.grad.numpy() for t in ts]


def _assert_close(got, want, cdt):
    names = ("out", "dq", "dk", "dv")
    for name, a, b in zip(names, got, want):
        if cdt == "float32":
            rtol, atol = _TOL[cdt]["fwd" if name == "out" else "grad"]
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)
        else:
            assert np.abs(a - b).max() <= _TOL[cdt] * np.abs(b).max(), name


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("in_dtype", [np.float32, jnp.bfloat16], ids=["f32-in", "bf16-in"])
@pytest.mark.parametrize("R,T,hd", [(8, 16, 8), (6, 21, 16)])
def test_plain_attention_matches_jax_kernel(cdt, in_dtype, R, T, hd):
    case = _case(R, T, hd, seed=R * T)
    before = attention_fwd.launches, attention_bwd.launches
    got = _port(*case, cdt, in_dtype)
    _assert_close(got, _jax(*case, cdt, in_dtype), cdt)
    # CPU tensors take the plain versions: no kernel was launched
    assert (attention_fwd.launches, attention_bwd.launches) == before
    assert all(np.isfinite(x).all() for x in got)
    # the fully masked row attends uniformly (the -1e9 bias absorbs every score)
    v = case[2] if in_dtype == np.float32 else np.asarray(jnp.asarray(case[2]).astype(in_dtype),
                                                          np.float32)
    np.testing.assert_allclose(got[0][0], np.broadcast_to(v[0].mean(0), (T, hd)),
                               atol=1e-5 if cdt == "float32" else 2e-2)


@pytest.mark.parametrize("R,T,hd", [(3, 512, 64), (3, 1, 8), (4, 33, 16), (3, 130, 32)])
def test_plain_attention_matches_jax_kernel_long_and_ragged(R, T, hd):
    """bf16 compute, f32 inputs: hd = 64 at T = 512 (the card's kernels take
    it under bf16 compute) and ragged T (a lone key; partial 16-key blocks
    and query tiles on the card)."""
    case = _case(R, T, hd, seed=T + hd)
    got = _port(*case, "bfloat16", np.float32)
    _assert_close(got, _jax(*case, "bfloat16", np.float32), "bfloat16")
    assert all(np.isfinite(x).all() for x in got)


@pytest.mark.parametrize("R,T,hd", [(4, 33, 16), (3, 130, 64)])
def test_split_products_match_jax_kernel_at_f32_compute(monkeypatch, R, T, hd):
    """The f32-compute kernels' arithmetic on the CPU: the plain forward and
    backward with every product a split product (``matmul_split``, the six
    leading products of three bf16 pieces, in place of ``matmul_f32``)
    against the JAX kernel at f32 compute, within the f32 tolerance."""
    monkeypatch.setattr(port_attention, "matmul_f32", lambda a, b, cdt: matmul_split(a, b))
    case = _case(R, T, hd, seed=R + T + hd)
    got = _port(*case, "float32", np.float32)
    _assert_close(got, _jax(*case, "float32", np.float32), "float32")
    assert all(np.isfinite(x).all() for x in got)


@pytest.mark.parametrize("which", ["left", "right", "both"])
def test_split_products_of_zero_pieces_can_be_skipped(which):
    """A bf16 operand's mid and lo pieces are zero, so the kernels skip the
    products that take them (a bf16 input at f32 compute): summing only the
    others, in the same order, gives ``matmul_split``'s result bit for bit."""
    rng = np.random.default_rng(len(which))
    a = torch.from_numpy(rng.standard_normal((24, 40)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((40, 17)).astype(np.float32))
    if which in ("left", "both"):
        a = a.bfloat16().float()
    if which in ("right", "both"):
        b = b.bfloat16().float()
    ap, bp = split_bf16x3(a), split_bf16x3(b)
    pieces_a = 1 if which in ("left", "both") else 3
    pieces_b = 1 if which in ("right", "both") else 3
    assert all(not p.float().any() for p in ap[pieces_a:] + bp[pieces_b:])
    kept = [(i, j) for i, j in SPLIT_PRODUCTS if i < pieces_a and j < pieces_b]
    assert len(kept) == {"left": 3, "right": 3, "both": 1}[which]
    out = None
    for i, j in kept:
        term = torch.matmul(ap[i].float(), bp[j].float())
        out = term if out is None else out + term
    full = matmul_split(a, b)
    assert (out != 0).all()
    assert torch.equal(out.view(torch.int32), full.view(torch.int32))


@pytest.mark.parametrize("R,T,hd,in_bytes,backward,cdt,ms,by", [
    (32, 512, 64, 4, False, "float32", 0.013028, "operations"),
    (32, 512, 64, 4, True, "float32", 0.032571, "operations"),
    (4096, 128, 32, 4, False, "float32", 0.080756, "bytes"),
    (4096, 128, 32, 4, True, "float32", 0.140853, "bytes"),
    (4096, 128, 32, 2, False, "float32", 0.050707, "bytes"),
    (4096, 128, 32, 2, True, "float32", 0.110805, "bytes"),
    (32, 512, 64, 2, True, "bfloat16", 0.006906, "bytes"),
])
def test_attention_bound_counts_split_products(R, T, hd, in_bytes, backward, cdt, ms, by):
    """The least time of a call on an H100 SXM (3.35 TB/s, 989 TFLOP/s of
    bf16 products): at f32 compute each product counts its split's bf16
    products, six for two f32 operands, three with one bf16 input, one
    with two (S at bf16 inputs: forward 1 + 3, backward 1 + 3 + 3 + 6 + 3);
    at bf16 compute one each."""
    nbytes, ops = port_attention.attention_bound(R, T, hd, in_bytes, backward, cdt)
    one = 2 * R * T * T * hd
    products = {(4, False): 12, (4, True): 30, (2, False): 4, (2, True): 16}[in_bytes, backward]
    assert ops == one * (products if cdt == "float32" else 2 + 3 * backward)
    t_bytes, t_ops = nbytes / 3.35e12 * 1e3, ops / 989e12 * 1e3
    assert max(t_bytes, t_ops) == pytest.approx(ms, rel=1e-4)
    assert (t_bytes >= t_ops) == (by == "bytes")


def _staged_row(hd):  # a bf16 row in shared memory: the hd depth padded to 16, 16 bytes more
    return (max(hd, 16) + 8) * 2


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_attention_plan_every_length(hd):
    """Every T up to 512 has a tensor-core layout (bf16 compute) within the
    SM's shared memory, region by region as csrc/attention.cu lays it out:
    query tiles of 16 to 128 rows (a warp a 16), as large as fit beside the
    tile's f32 scores [rows, T], and key tiles of up to 64; the forward and
    the backward's first launch stage V over K only where both do not fit,
    and split a tile's keys over two warps only where one block fills the
    SM.
    f32 compute (split products) streams K and V in chunks of up to 64
    keys, each copied as f32 and split into three bf16 planes, beside query
    tiles as large as fit with their f32 scores; its second launch keeps
    three planes of each of K, V, Q and dO, and of P, then dS, in one
    region. It too has a layout at
    every T up to 512 and every head width."""
    limit = 232_448
    row = _staged_row(hd)
    for T in range(1, MAX_T + 1):
        Tp = -(-T // 16) * 16
        plan = attention_plan(T, hd, "bfloat16")
        assert plan is not None and plan["route"] == "mma", T
        f, q, kv = plan["fwd"], plan["dq"], plan["dkv"]
        for rows in (f["rows"], q["rows"], kv["rows"]):
            assert rows % 16 == 0 and 16 <= rows <= min(128, Tp)
        assert kv["rows"] == min(64, Tp)
        for p_, staged in ((f, 1), (q, 2)):  # Q (and dO) rows, K and V, scores, bias, halves
            assert p_["smem"] == staged * p_["rows"] * row \
                + Tp * row * (1 if p_["kv_shared"] else 2) + p_["rows"] * Tp * 4 + Tp * 4 \
                + p_["rows"] * 32 <= limit
            # V over K only where K and V apart do not fit
            assert not p_["kv_shared"] or p_["smem"] + Tp * row > limit
            # two key halves only where one block fills the SM, in at most 8 warps
            assert p_["ks"] == 1 or (p_["smem"] > limit // 2 and p_["rows"] <= 64
                                     and Tp >= max(32, hd))
        kt = kv["rows"]
        assert kv["smem"] == 2 * kt * row + 2 * (2 * kt * row + -(-12 * kt // 16) * 16) \
            + 2 * -(-kt * (kt + 8) * 2 // 16) * 16 + -(-kt * 4 // 16) * 16 <= limit
        f32 = attention_plan(T, hd, "float32")
        assert f32 is not None and f32["route"] == "split", T
        kc = min(64, Tp)
        tops = [min(128, Tp)] + [r for r in (64, 32, 16) if r < min(128, Tp)]

        def split_smem(rows):  # a chunk as copied (f32), its three planes, scores, bias
            return kc * hd * 4 + 3 * kc * row + rows * Tp * 4 + Tp * 4

        for p_ in (f32["fwd"], f32["dq"]):
            assert p_["kc"] == kc and p_["rows"] in tops
            assert p_["smem"] == split_smem(p_["rows"]) <= limit
            # the largest query tile that fits
            assert all(split_smem(r) > limit for r in tops if r > p_["rows"])
        kt = f32["dkv"]["rows"]
        assert kt == min(64, Tp)
        # K, V, Q and dO planes, Q and dO as copied, two buffers of
        # statistics, one region of P (then dS) planes, the bias
        assert f32["dkv"]["smem"] == 4 * 3 * kt * row + 2 * kt * hd * 4 + 2 * 12 * kt \
            + 3 * kt * (kt + 8) * 2 + 4 * kt <= limit
    wide = attention_plan(512, 64, "bfloat16")  # V over K keeps 64-row tiles
    assert wide["fwd"]["rows"] == wide["dq"]["rows"] == 64 and wide["dq"]["kv_shared"]
    assert wide["fwd"]["ks"] == wide["dq"]["ks"] == 2
    f32 = attention_plan(512, 64, "float32")  # eight chunks of 64 keys, 64-row tiles
    assert (f32["fwd"]["rows"], f32["fwd"]["kc"], f32["fwd"]["smem"]) == (64, 64, 177_152)
    assert f32["dkv"]["smem"] == 172_800
    assert attention_plan(128, 32, "float32")["fwd"]["rows"] == 128  # config 5's doc tower


def test_bf16_inputs_without_input_dtype_give_bf16_gradients():
    """Handing the Function bf16 tensors gives the JAX forward exactly as
    with input_dtype, and gradients rounded to bf16 (torch keeps a gradient
    in its input's dtype)."""
    q, k, v, bias, ct, scale = _case(8, 16, 8, seed=5)
    ts = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True) for x in (q, k, v)]
    out = fused_attention(*ts, torch.from_numpy(bias), scale, "bfloat16")
    out.backward(torch.from_numpy(ct))
    want = _jax(q, k, v, bias, ct, scale, "bfloat16", jnp.bfloat16)
    np.testing.assert_allclose(out.detach().numpy(), want[0], rtol=1e-5, atol=1e-6)
    for t, w in zip(ts, want[1:]):
        assert t.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(t.grad.float().numpy(), w, rtol=2 ** -8, atol=1e-6)


def test_backward_wrapper_is_the_plain_backward_on_the_cpu():
    q, k, v, bias, ct, scale = _case(6, 12, 8, seed=9)
    args = [torch.from_numpy(x) for x in (q, k, v, bias, ct)]
    for a, b in zip(attention_bwd(*args, scale, "float32"),
                    attention_bwd_reference(*args, scale, "float32")):
        assert torch.equal(a, b)


def test_policy_matches_jax():
    for force in (None, True, False):
        for T, hd in ((32, 32), (128, 32), (512, 64)):
            assert use_fused_attention(T, hd, force) == jax_use_fused_attention(T, hd, force)


def test_wrappers_reject_bad_shapes():
    x = torch.zeros((2, 4, 8))
    with pytest.raises(ValueError):
        attention_fwd(x, x, x[:, :3], torch.zeros((2, 4)), 0.3)
    with pytest.raises(ValueError):
        attention_fwd(x, x, x, torch.zeros((2, 5)), 0.3)
    with pytest.raises(ValueError):
        attention_fwd(x, x, x.double(), torch.zeros((2, 4)), 0.3)
    with pytest.raises(ValueError):
        attention_bwd(x, x, x, torch.zeros((2, 4)), x[:1], 0.3)
