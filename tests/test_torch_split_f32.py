"""The f32 route's arithmetic, on the CPU.

``csrc/doc_mma.cuh`` scores an f32 corpus on the tensor cores: each f32 value
splits into three bf16 pieces (hi, mid, lo) and a score takes the six leading
products of the pieces, as XLA's HIGHEST precision does on the TPU's bf16
units; ``csrc/attention.cu`` forms every product at f32 compute the same
way. ``utils/dtypes.py`` ``split_bf16x3`` and ``matmul_split`` and
``ops/topk.py`` ``split_scores`` are that arithmetic in plain PyTorch. Here
they are held against what the header
states: the pieces sum back to the input exactly, and a six-product score is
within ``SPLIT_DROPPED_REL * sum_k |q_k d_k|`` (2^-23 (1 + 2^-7)) of the exact
product, besides the rounding of an f32 sum, which at most ``n 2^-24 sum_k
|q_k d_k|`` for n terms. The exact product is taken in f64, and JAX's f32
``jnp.dot`` at ``Precision.HIGHEST`` on the CPU is held to the same bound plus
its own f32 sum's. Inputs are seeded numpy arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twotowermlretrieval_tpu.ops.topk import fused_topk_segmax as jax_fused_topk_segmax
from twotowermlretrieval_tpu_torch.ops.topk import fused_topk_segmax, split_scores
from twotowermlretrieval_tpu_torch.utils.dtypes import (
    SPLIT_DROPPED_REL,
    SPLIT_PRODUCTS,
    matmul_split,
    split_bf16x3,
)

U = 2.0 ** -24  # f32's unit roundoff


def _unit_rows(rng, n, h):
    x = rng.standard_normal((n, h)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _values(kind, rng):
    """f32 values: unit rows, a wide range of magnitudes, and bf16 rounding
    ties (a bf16 value plus half its last place, where the split rounds to
    even)."""
    if kind == "unit":
        return _unit_rows(rng, 64, 256)
    if kind == "wide":
        mag = np.exp2(rng.uniform(-60, 60, size=(64, 64)))
        return (rng.choice([-1.0, 1.0], size=(64, 64)) * mag).astype(np.float32)
    base = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32)).bfloat16()
    bits = base.view(torch.int16).int() & 0xFFFF
    half_ulp = (bits << 16 | 0x8000).int().view(torch.float32) - (bits << 16).int().view(
        torch.float32)
    return (base.float() + half_ulp).numpy()


@pytest.mark.parametrize("kind", ["unit", "wide", "ties"])
def test_split_pieces_sum_back_exactly(kind):
    """hi + mid + lo is the f32 input to the bit (summed in f64, where the
    sum of three bf16 values is exact); each piece is the round to nearest
    even of what the pieces before it leave, so |mid| <= 2^-8 (1 + 2^-8)
    |x| and |lo| <= 2^-16 |x|."""
    x = torch.from_numpy(_values(kind, np.random.default_rng(3)))
    hi, mid, lo = split_bf16x3(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = hi.double() + mid.double() + lo.double()
    assert torch.equal(total, x.double())
    assert torch.equal(hi, x.bfloat16())
    assert torch.equal(mid, (x - hi.float()).bfloat16())
    ax = x.double().abs()
    assert (mid.double().abs() <= 2.0 ** -8 * (1 + 2.0 ** -8) * ax).all()
    assert (lo.double().abs() <= 2.0 ** -16 * ax).all()


@pytest.mark.parametrize("H", [8, 24, 256, 1024, 3200])
def test_six_products_within_the_stated_bound(H):
    """The six leading products of the pieces, summed exactly (f64), are
    within SPLIT_DROPPED_REL * sum_k |q_k d_k| of the exact product; the
    f32 twin within that plus an f32 sum's rounding (6H terms); JAX's f32
    HIGHEST dot within the same plus its own (H terms). Taking only hi.hi
    (one bf16 pass) is far outside the bound: the bound is not vacuous."""
    rng = np.random.default_rng(H)
    q, d = _unit_rows(rng, 8, H), _unit_rows(rng, 300, H)
    exact = q.astype(np.float64) @ d.astype(np.float64).T
    mass = np.abs(q).astype(np.float64) @ np.abs(d).astype(np.float64).T  # sum_k |q_k d_k|
    qp = [t.double().numpy() for t in split_bf16x3(torch.from_numpy(q))]
    dp = [t.double().numpy() for t in split_bf16x3(torch.from_numpy(d))]
    six = sum(qp[j] @ dp[i].T for i, j in SPLIT_PRODUCTS)
    assert (np.abs(six - exact) <= SPLIT_DROPPED_REL * mass).all()
    assert np.abs(six - exact).max() > 0  # the dropped products are not all zero

    twin = split_scores(torch.from_numpy(q), torch.from_numpy(d)).numpy()
    assert twin.dtype == np.float32 and twin.shape == (8, 300)
    bound = (SPLIT_DROPPED_REL + 6 * H * U) * mass
    assert (np.abs(twin - exact) <= bound).all()

    j = np.asarray(jnp.dot(jnp.asarray(q), jnp.asarray(d).T,
                           precision=jax.lax.Precision.HIGHEST))
    assert (np.abs(twin - j) <= bound + H * U * mass).all()

    one_pass = qp[0] @ dp[0].T
    assert (np.abs(one_pass - exact) > SPLIT_DROPPED_REL * mass).any()


@pytest.mark.parametrize("N,tile_n", [(1000, 256), (4096, 512)])
def test_split_scores_rank_as_jax_segmax(N, tile_n):
    """On f32 unit rows the six-product scores pick the same top-50 ids as
    JAX's f32 fused_topk_segmax (Pallas interpret mode, HIGHEST) and as the
    port's fused_topk_segmax on the CPU (segmax_reference, its plain version),
    whose values stay within 1e-5 relative / 1e-6 of JAX's."""
    rng = np.random.default_rng(N)
    q, d = _unit_rows(rng, 8, 32), _unit_rows(rng, N, 32)
    j_vals, j_ids = jax_fused_topk_segmax(jnp.asarray(q), jnp.asarray(d), k=50,
                                          tile_n=tile_n, interpret=True)
    vals, ids = fused_topk_segmax(torch.from_numpy(q), torch.from_numpy(d), k=50, tile_n=tile_n)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(vals.numpy(), np.asarray(j_vals), rtol=1e-5, atol=1e-6)
    s_vals, s_ids = torch.sort(split_scores(torch.from_numpy(q), torch.from_numpy(d)),
                               dim=1, descending=True, stable=True)
    np.testing.assert_array_equal(s_ids[:, :50].numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(s_vals[:, :50].numpy(), np.asarray(j_vals), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("M,K,N", [(16, 8, 24), (33, 64, 130), (7, 512, 64)])
def test_matmul_split_within_the_stated_bound(M, K, N):
    """``matmul_split(a, b)`` (the f32 attention kernels' products) is
    within SPLIT_DROPPED_REL * sum_k |a_k b_k| of the exact product, plus
    the rounding of its f32 sums (six products of K terms each, then five
    adds), over values of both signs and a spread of magnitudes; taking
    hi.hi alone is far outside that bound."""
    rng = np.random.default_rng(M * K + N)
    a = (rng.standard_normal((M, K)) * np.exp2(rng.uniform(-4, 4, (M, K)))).astype(np.float32)
    b = (rng.standard_normal((K, N)) * np.exp2(rng.uniform(-4, 4, (K, N)))).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    mass = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    got = matmul_split(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    bound = (SPLIT_DROPPED_REL + (6 * K + 5) * U) * mass
    assert (np.abs(got.numpy() - exact) <= bound).all()
    hi_hi = split_bf16x3(torch.from_numpy(a))[0].double() @ split_bf16x3(torch.from_numpy(b))[0].double()
    assert (np.abs(hi_hi.numpy() - exact) > SPLIT_DROPPED_REL * mass).any()
