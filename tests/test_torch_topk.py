"""The port's exact top-k search against the JAX package's.

On the CPU the port's ``fused_topk_segmax`` runs the plain version of its
segment-max kernel and the torch phase 2; it is held against the JAX
``fused_topk_segmax`` in Pallas interpret mode and against ``topk_oracle``
on the same numpy inputs (f32 storage). Ids must match exactly (the data
has no tied scores), values within rtol 1e-5 / atol 1e-6 (f32 sums in
another order).
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twotowermlretrieval_tpu.ops.topk import fused_topk_segmax as jax_fused_topk_segmax
from twotowermlretrieval_tpu.ops.topk import topk_oracle as jax_topk_oracle
from twotowermlretrieval_tpu_torch.ops.topk import (
    NEG_INF,
    fused_topk_segmax,
    segmax,
    segmax_reference,
    topk_oracle,
)

RTOL, ATOL = 1e-5, 1e-6


def _data(seed, B=8, N=1000, H=32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H)).astype(np.float32)
    d = rng.normal(size=(N, H)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return q, d


def _port(q, d, **kw):
    vals, ids = fused_topk_segmax(torch.from_numpy(q), torch.from_numpy(d), **kw)
    assert vals.dtype == torch.float32 and ids.dtype == torch.int32
    return vals.numpy(), ids.numpy()


@pytest.mark.parametrize("phase2", ["rescore", "gather"])
@pytest.mark.parametrize("N,tile_n", [(1000, 256), (777, 256), (100, 128), (4096, 512)])
def test_matches_jax_kernel_and_oracle(N, tile_n, phase2):
    q, d = _data(N, N=N)
    k = min(50, N)
    vals, ids = _port(q, d, k=k, tile_n=tile_n, phase2=phase2)
    j_vals, j_ids = jax_fused_topk_segmax(
        jnp.asarray(q), jnp.asarray(d), k=k, tile_n=tile_n, interpret=True, phase2=phase2
    )
    o_vals, o_ids = jax_topk_oracle(jnp.asarray(q), jnp.asarray(d), k)
    np.testing.assert_array_equal(ids, np.asarray(j_ids))
    np.testing.assert_array_equal(ids, np.asarray(o_ids))
    np.testing.assert_allclose(vals, np.asarray(j_vals), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(vals, np.asarray(o_vals), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("phase2", ["rescore", "gather"])
def test_prepadded_corpus_with_n_valid(phase2):
    """The serving index pads rows once and passes n_valid: results equal
    the unpadded corpus's."""
    q, d = _data(5, B=4, N=900, H=16)
    padded = np.concatenate([d, np.zeros((124, 16), np.float32)])
    vals, ids = _port(q, padded, k=20, tile_n=256, n_valid=900, phase2=phase2)
    j_vals, j_ids = jax_fused_topk_segmax(
        jnp.asarray(q), jnp.asarray(padded), k=20, tile_n=256, interpret=True, n_valid=900,
        phase2=phase2,
    )
    o_vals, o_ids = jax_topk_oracle(jnp.asarray(q), jnp.asarray(d), 20)
    np.testing.assert_array_equal(ids, np.asarray(j_ids))
    np.testing.assert_array_equal(ids, np.asarray(o_ids))
    np.testing.assert_allclose(vals, np.asarray(o_vals), rtol=RTOL, atol=ATOL)


def test_negative_scores_beat_padding():
    rng = np.random.default_rng(6)
    q = -np.abs(rng.normal(size=(2, 8))).astype(np.float32)
    d = np.abs(rng.normal(size=(300, 8))).astype(np.float32)
    vals, ids = _port(q, d, k=5, tile_n=256)
    assert (vals < 0).all() and (ids >= 0).all() and (ids < 300).all()
    j_vals, j_ids = jax_fused_topk_segmax(
        jnp.asarray(q), jnp.asarray(d), k=5, tile_n=256, interpret=True
    )
    np.testing.assert_array_equal(ids, np.asarray(j_ids))


def test_k_beyond_candidates_pads_with_minus_one():
    """A corpus of 3 real rows asked for 5: the last two are -1 / NEG_INF."""
    q, d = _data(7, B=2, N=3, H=8)
    padded = np.concatenate([d, np.zeros((125, 8), np.float32)])
    vals, ids = _port(q, padded, k=5, tile_n=128, n_valid=3)
    assert (ids[:, 3:] == -1).all() and (vals[:, 3:] <= NEG_INF).all()
    assert sorted(ids[0, :3]) == [0, 1, 2]


def test_ties_go_to_the_lower_doc_id():
    """Duplicate docs score identically; with the candidates in ascending
    id order (sort_candidates) the lower id ranks first, as lax.top_k
    orders the oracle's ties."""
    q, d = _data(8, B=3, N=600, H=16)
    d[450] = d[17]
    d[300] = d[17]
    vals, ids = _port(q, d, k=600, tile_n=128, sort_candidates=True)
    o_vals, o_ids = jax_topk_oracle(jnp.asarray(q), jnp.asarray(d), 600)
    np.testing.assert_array_equal(ids, np.asarray(o_ids))


def test_query_blocks_beyond_kernel_rows():
    """More query rows than one kernel pass holds run in blocks."""
    q, d = _data(9, B=40, N=700, H=16)
    vals, ids = _port(q, d, k=10, tile_n=256, phase2="gather")
    o_vals, o_ids = topk_oracle(torch.from_numpy(q), torch.from_numpy(d), 10)
    np.testing.assert_array_equal(ids, o_ids.numpy())


def test_bf16_storage_scores_the_rounded_corpus():
    """bf16 storage: the scores are f32 sums over bf16-rounded operands,
    the same values as an f32 product of the rounded arrays."""
    q, d = _data(10, B=8, N=512, H=32)
    qb, db = torch.from_numpy(q).bfloat16(), torch.from_numpy(d).bfloat16()
    vals, ids = fused_topk_segmax(qb, db, k=20, tile_n=256)
    o_vals, o_ids = topk_oracle(qb.float(), db.float(), 20)
    np.testing.assert_array_equal(ids.numpy(), o_ids.numpy())
    np.testing.assert_allclose(vals.numpy(), o_vals.numpy(), rtol=RTOL, atol=ATOL)
    j_vals, j_ids = jax_fused_topk_segmax(
        jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(d).astype(jnp.bfloat16),
        k=20, tile_n=256, interpret=True,
    )
    np.testing.assert_allclose(vals.numpy(), np.asarray(j_vals), rtol=RTOL, atol=ATOL)


def test_cpu_wrapper_is_the_plain_version():
    q, d = _data(11, B=4, N=256, H=16)
    qt, dt = torch.from_numpy(q), torch.from_numpy(d)
    seg, cache = segmax(qt, dt, 200, with_cache=True)
    r_seg, r_cache = segmax_reference(qt, dt, 200, with_cache=True)
    torch.testing.assert_close(seg, r_seg, rtol=0, atol=0)
    torch.testing.assert_close(cache, r_cache, rtol=0, atol=0)
    assert seg.shape == (2, 4) and (cache[200:] == NEG_INF).all()


@pytest.mark.parametrize("phase2", ["rescore", "gather"])
@pytest.mark.parametrize("sort_candidates", [False, True])
def test_bitwise_tie_at_the_k_boundary_resolves_as_jax(sort_candidates, phase2):
    """Docs 10 (segment 0) and 400 (segment 3) score exactly 0.5 for a
    one-hot query, tied for third place; segment 3 holds the best score,
    so it ranks before segment 0. Unsorted candidates keep that rank order
    and the tie goes to doc 400; sorted candidates go by id and it goes to
    doc 10. The port matches the JAX kernel id for id either way."""
    rng = np.random.default_rng(12)
    d = rng.uniform(-0.4, 0.4, size=(512, 16)).astype(np.float32)
    d[:, 0] = rng.uniform(-0.4, 0.4, size=512).astype(np.float32)
    d[450, 0], d[200, 0] = 0.9, 0.8  # segments 3 and 1
    d[400] = d[10]
    d[10, 0] = d[400, 0] = 0.5
    q = np.zeros((2, 16), np.float32)
    q[:, 0] = 1.0  # scores are d[:, 0] exactly
    vals, ids = _port(q, d, k=3, tile_n=128, phase2=phase2, sort_candidates=sort_candidates)
    j_vals, j_ids = jax_fused_topk_segmax(
        jnp.asarray(q), jnp.asarray(d), k=3, tile_n=128, interpret=True, phase2=phase2,
        sort_candidates=sort_candidates,
    )
    np.testing.assert_array_equal(ids, np.asarray(j_ids))
    np.testing.assert_array_equal(vals, np.asarray(j_vals))
    assert list(ids[0]) == [450, 200, 10 if sort_candidates else 400]
