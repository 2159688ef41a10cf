"""The port's int8 and running top-k searches against the JAX package's.

On the CPU every kernel wrapper of the port runs its plain version; the
JAX functions run their Pallas kernels in interpret mode. Inputs come from
numpy seeds and go through both. Tolerances:

- quantizers (``quantize_segments``, ``quantize_rows``,
  ``quantize_query_rows``): bit for bit;
- the per-segment s8 search (``fused_topk_segmax_s8``,
  ``topk_segmented_s8``): ids equal and values bitwise. The integer scores
  are exact in both packages and the dequantizing multiplies run in the
  same order, so nothing is left to round differently;
- the bf16-product searches over a per-row int8 corpus and the running
  top-k (``fused_topk_segmax_int8``, ``fused_topk[_int8]``,
  ``topk_segmented_int8``): ids equal and values within rtol 1e-5 /
  atol 1e-6 (f32 sums of exact products, in another order; the data has
  no score gaps that small).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twotowermlretrieval_tpu.ops import topk as jt
from twotowermlretrieval_tpu_torch.ops.topk import (
    NEG_INF,
    fused_topk,
    fused_topk_int8,
    fused_topk_segmax_int8,
    fused_topk_segmax_s8,
    quantize_query_rows,
    quantize_rows,
    quantize_segments,
    segmax_int8,
    segmax_int8_reference,
    segmax_s8,
    segmax_s8_reference,
    topk_segmented,
    topk_segmented_int8,
    topk_segmented_s8,
    topk_stream,
    topk_stream_int8,
    topk_stream_reference,
)

RTOL, ATOL = 1e-5, 1e-6


def _data(seed, B=8, N=1000, H=32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H)).astype(np.float32)
    d = rng.normal(size=(N, H)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return q, d


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _np(*tensors):
    return [t.numpy() for t in tensors]


def _assert_bitwise(port, jax_out):
    vals, ids = port
    j_vals, j_ids = (np.asarray(x) for x in jax_out)
    assert vals.dtype == np.float32 and ids.dtype == np.int32
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_array_equal(vals, j_vals)


def _assert_close(port, jax_out):
    vals, ids = port
    j_vals, j_ids = (np.asarray(x) for x in jax_out)
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_allclose(vals, j_vals, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seg", [32, 64, 128])
def test_quantize_segments_bit_for_bit(seg):
    _, d = _data(1, N=512, H=48)
    d[256:384] = 0.0  # an all-zero segment: scale 1, values 0
    values, scales = quantize_segments(d, seg=seg)
    j_values, j_scales = jt.quantize_segments(d, seg=seg)
    np.testing.assert_array_equal(values, j_values)
    np.testing.assert_array_equal(scales, j_scales)
    assert values.dtype == np.int8 and scales.dtype == np.float32
    assert scales.shape == (512 // seg,) and scales[256 // seg] == 1.0
    with pytest.raises(ValueError):
        quantize_segments(d[:100], seg=seg)


def test_quantize_rows_bit_for_bit():
    _, d = _data(2, N=300, H=40)
    d[7] = 0.0
    values, scales = quantize_rows(d)
    j_values, j_scales = jt.quantize_rows(d)
    np.testing.assert_array_equal(values, j_values)
    np.testing.assert_array_equal(scales, j_scales)


def test_quantize_query_rows_bit_for_bit():
    """Random rows, a zero row and a row of integers (scale 1), against
    the JAX quantizer as every JAX search runs it: jitted, where XLA turns
    the division by 127 into a product with its f32 reciprocal (eager
    JAX divides, and 4% of scales then differ in the last bit). Halves
    round to even in both packages."""
    q, _ = _data(3, B=64, H=64)
    q[1] = 0.0
    q[2] = np.linspace(-127.0, 127.0, 64, dtype=np.float32).round()
    q_i8, q_scale = quantize_query_rows(torch.from_numpy(q))
    j_i8, j_scale = jax.jit(jt.quantize_query_rows)(jnp.asarray(q))
    assert q_i8.dtype == torch.int8 and q_scale.shape == (64, 1)
    assert q_scale[2, 0] == 1.0 and q_scale[1, 0] == 1.0
    np.testing.assert_array_equal(q_i8.numpy(), np.asarray(j_i8))
    np.testing.assert_array_equal(q_scale.numpy(), np.asarray(j_scale))
    # ties to even, as jnp.round
    halves = torch.tensor([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0]])
    assert quantize_query_rows(halves)[0].tolist() == [[0, 2, 2, 0, -2, 127]]


# ---------------------------------------------------------------------------
# the per-segment s8 search (kernel 5's path)
# ---------------------------------------------------------------------------


def _s8_index(seed, B, N, H, n_valid, seg):
    q, d = _data(seed, B=B, N=N, H=H)
    if n_valid is not None:
        d[n_valid:] = 0.0  # the index pads with zero rows
    values, scales = quantize_segments(d, seg=seg)
    return q, values, scales


@pytest.mark.parametrize("seg", [32, 64, 128])
@pytest.mark.parametrize("phase2", ["rescore", "gather"])
@pytest.mark.parametrize("sort_candidates", [False, True])
@pytest.mark.parametrize("N,n_valid", [(1024, None), (1024, 900)])
def test_s8_search_equals_jax_bitwise(seg, phase2, sort_candidates, N, n_valid):
    q, values, scales = _s8_index(seg + N, 8, N, 32, n_valid, seg)
    kw = dict(k=20, tile_n=256, n_valid=n_valid, seg=seg, phase2=phase2,
              sort_candidates=sort_candidates)
    port = _np(*fused_topk_segmax_s8(*_t(q, values, scales), **kw))
    _assert_bitwise(port, jt.fused_topk_segmax_s8(
        jnp.asarray(q), jnp.asarray(values), jnp.asarray(scales), interpret=True, **kw))
    _assert_bitwise(port, jt.topk_segmented_s8(
        jnp.asarray(q), jnp.asarray(values), jnp.asarray(scales), k=20, n_valid=n_valid,
        seg=seg))
    limit = N if n_valid is None else n_valid
    assert ((port[1] >= 0) & (port[1] < limit)).all()


@pytest.mark.parametrize("N,n_valid,seg", [(1024, 900, 128), (512, 130, 128), (1152, 1100, 64)])
def test_s8_two_phase_equals_jax_bitwise(N, n_valid, seg):
    q, values, scales = _s8_index(N, 8, N, 32, n_valid, seg)
    port = _np(*topk_segmented_s8(*_t(q, values, scales), k=15, n_valid=n_valid, seg=seg))
    _assert_bitwise(port, jt.topk_segmented_s8(
        jnp.asarray(q), jnp.asarray(values), jnp.asarray(scales), k=15, n_valid=n_valid,
        seg=seg))
    fused = _np(*fused_topk_segmax_s8(*_t(q, values, scales), k=15, tile_n=256,
                                      n_valid=n_valid, seg=seg))
    _assert_bitwise(fused, port)


def _wide_s8_index(kind):
    """H=1056 (past the 1040 where 127 * 127 * H reaches 2^24). "random":
    unit rows. "rounding": rows of 1.0 but column 1, which is r / 127 for r
    in 0..127, and queries of 1.0 but column 1, +-1 / 127: the integer
    scores are 127 * 127 * 1055 +- r, past 2^24, where f32 keeps even
    integers only, so neighbouring r round to one value (ties to even) and
    the top k must break those ties toward the lower id."""
    rng = np.random.default_rng(22)
    if kind == "random":
        q, d = _data(21, B=4, N=2048, H=1056)
    else:
        d = np.ones((2048, 1056), np.float32)
        d[:, 1] = rng.integers(0, 128, 2048) / np.float32(127.0)
        q = np.ones((2, 1056), np.float32)
        q[:, 1] = np.array([1.0, -1.0], np.float32) / np.float32(127.0)
    values, scales = quantize_segments(d)
    return q, values, scales


@pytest.mark.parametrize("phase2", ["rescore", "gather"])
@pytest.mark.parametrize("kind", ["random", "rounding"])
def test_s8_search_past_1040_columns_equals_jax_bitwise(kind, phase2):
    """At H=1056 the port's s8 search equals JAX's fused_topk_segmax_s8
    (interpret mode) and topk_segmented_s8 in every bit: both keep exact
    integer sums and convert them once to f32, so scores past 2^24 round
    alike, and the ties that rounding makes go to the lower id."""
    q, values, scales = _wide_s8_index(kind)
    if kind == "rounding":
        q_i8, _ = quantize_query_rows(torch.from_numpy(q))
        maxima, _ = segmax_s8(q_i8, torch.from_numpy(values))
        assert maxima.max().item() > 2 ** 24
    kw = dict(k=20, tile_n=1024, phase2=phase2)
    port = _np(*fused_topk_segmax_s8(*_t(q, values, scales), **kw))
    _assert_bitwise(port, jt.fused_topk_segmax_s8(
        jnp.asarray(q), jnp.asarray(values), jnp.asarray(scales), interpret=True, **kw))
    _assert_bitwise(port, jt.topk_segmented_s8(
        jnp.asarray(q), jnp.asarray(values), jnp.asarray(scales), k=20))
    _assert_bitwise(_np(*topk_segmented_s8(*_t(q, values, scales), k=20)), port)
    if kind == "rounding":  # ties of equal value are in ascending id order
        vals, ids = port
        for v_row, i_row in zip(vals, ids):
            for a in range(19):
                assert v_row[a] > v_row[a + 1] or i_row[a] < i_row[a + 1]
        assert any((v_row[:-1] == v_row[1:]).any() for v_row in vals)


def test_s8_all_negative_scores_with_padding():
    """All real scores negative + zero padding rows: the unmasked phase-1
    maxima promote the padding segment, and the extra candidate segment
    still recovers the true (negative) top-k, as in the JAX package."""
    rng = np.random.default_rng(5)
    H = 16
    q = np.abs(rng.normal(size=(2, H))).astype(np.float32)
    d = -np.abs(rng.normal(size=(384, H))).astype(np.float32)
    d_pad = np.concatenate([d, np.zeros((128, H), np.float32)])  # one fake segment
    values, scales = quantize_segments(d_pad)
    port = _np(*fused_topk_segmax_s8(*_t(q, values, scales), k=5, tile_n=256, n_valid=384))
    assert (port[0] < 0).all() and ((port[1] >= 0) & (port[1] < 384)).all()
    _assert_bitwise(port, jt.fused_topk_segmax_s8(
        jnp.asarray(q), jnp.asarray(values), jnp.asarray(scales), k=5, tile_n=256,
        interpret=True, n_valid=384))


def test_s8_query_blocks_beyond_kernel_rows():
    """40 query rows run as blocks of 32 (gather falls back to re-score, as
    beyond the JAX package's unroll bound): the same bits as JAX."""
    q, values, scales = _s8_index(6, 40, 768, 32, 700, 128)
    kw = dict(k=10, tile_n=256, n_valid=700)
    port = _np(*fused_topk_segmax_s8(*_t(q, values, scales), phase2="gather", **kw))
    _assert_bitwise(port, jt.fused_topk_segmax_s8(
        jnp.asarray(q), jnp.asarray(values), jnp.asarray(scales), interpret=True,
        phase2="gather", **kw))


def test_s8_recall_vs_f32():
    """Per-segment int8 keeps >= 0.9 top-20 recall against exact f32."""
    q, d = _data(7, B=8, N=2048, H=64)
    values, scales = quantize_segments(d)
    _, ids = fused_topk_segmax_s8(*_t(q, values, scales), k=20, tile_n=256)
    ref = np.argsort(-(q @ d.T), axis=1, kind="stable")[:, :20]
    recall = np.mean([len(set(ids[b].tolist()) & set(ref[b])) / 20 for b in range(8)])
    assert recall >= 0.9, recall


def test_segmax_s8_cpu_wrapper_is_exact_and_does_not_wrap():
    """Scores of +-127 values reach 127 * 127 * H: exact (no int8 wrap of a
    CPU int8 matmul), equal to numpy's int64 product, the segment max over
    each seg rows, and the cache the scores."""
    rng = np.random.default_rng(8)
    values = rng.choice(np.array([-127, 127], np.int8), size=(256, 128))
    q_i8 = values[:3].copy()
    seg, cache = segmax_s8(*_t(q_i8, values), seg=64, with_cache=True)
    exact = values.astype(np.int64) @ q_i8.astype(np.int64).T
    assert exact.max() == 127 * 127 * 128
    np.testing.assert_array_equal(cache.numpy(), exact.astype(np.float32))
    np.testing.assert_array_equal(seg.numpy(), exact.reshape(4, 64, 3).max(axis=1))
    r_seg, r_cache = segmax_s8_reference(*_t(q_i8, values), seg=64, with_cache=True)
    assert torch.equal(seg, r_seg) and torch.equal(cache, r_cache)


def test_s8_rejects_a_malformed_index():
    q, values, scales = _s8_index(9, 2, 256, 16, None, 128)
    with pytest.raises(ValueError, match="malformed"):
        fused_topk_segmax_s8(*_t(q, values, scales[:1]), k=5, tile_n=256)
    with pytest.raises(ValueError, match="phase2"):
        fused_topk_segmax_s8(*_t(q, values, scales), k=5, tile_n=256, phase2="bogus")
    with pytest.raises(ValueError, match="larger than corpus"):
        topk_segmented_s8(*_t(q, values, scales), k=300)


# ---------------------------------------------------------------------------
# the per-row int8 segment-max search (kernel 6's path)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N,n_valid", [(3000, None), (3000, 2900), (1024, 1000)])
def test_segmax_int8_search_matches_jax(N, n_valid):
    q, d = _data(N, B=8, N=N, H=128)
    values, scales = quantize_rows(d)
    kw = dict(k=20, tile_n=1024, n_valid=n_valid)
    port = _np(*fused_topk_segmax_int8(*_t(q, values, scales), **kw))
    _assert_close(port, jt.fused_topk_segmax_int8(
        jnp.asarray(q), jnp.asarray(values), jnp.asarray(scales), interpret=True, **kw))
    _assert_close(port, jt.topk_segmented_int8(
        jnp.asarray(q), jnp.asarray(values), jnp.asarray(scales), k=20, n_valid=n_valid))
    two_phase = _np(*topk_segmented_int8(*_t(q, values, scales), k=20, n_valid=n_valid))
    _assert_close(port, two_phase)


def test_segmax_int8_cpu_wrapper_is_the_plain_version():
    q, d = _data(10, B=4, N=256, H=32)
    values, scales = quantize_rows(d)
    qb = torch.from_numpy(q).bfloat16()
    seg = segmax_int8(qb, *_t(values, scales), 200)
    assert torch.equal(seg, segmax_int8_reference(qb, *_t(values, scales), 200))
    assert seg.shape == (2, 4)
    with pytest.raises(ValueError, match="bf16 queries"):
        segmax_int8(qb.float(), *_t(values, scales), 200)


# ---------------------------------------------------------------------------
# the running top-k (kernels 7 and 8)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N,tile_n", [(1000, 256), (256, 256), (4096, 512), (777, 256)])
def test_fused_topk_matches_jax(N, tile_n):
    q, d = _data(N + 1, B=8, N=N, H=32)
    port = _np(*fused_topk(*_t(q, d), k=50, tile_n=tile_n))
    _assert_close(port, jt.fused_topk(jnp.asarray(q), jnp.asarray(d), k=50, tile_n=tile_n,
                                      interpret=True))
    _assert_close(port, jt.topk_oracle(jnp.asarray(q), jnp.asarray(d), 50))
    assert (np.diff(port[0], axis=1) <= 0).all()


def test_fused_topk_bf16_storage_matches_jax():
    q, d = _data(11, B=4, N=512, H=32)
    qb, db = torch.from_numpy(q).bfloat16(), torch.from_numpy(d).bfloat16()
    port = _np(*fused_topk(qb, db, k=10, tile_n=256))
    _assert_close(port, jt.fused_topk(jnp.asarray(q).astype(jnp.bfloat16),
                                      jnp.asarray(d).astype(jnp.bfloat16), k=10, tile_n=256,
                                      interpret=True))
    _assert_close(port, _np(*topk_segmented(qb, db, k=10)))


@pytest.mark.parametrize("n_valid", [None, 2900])
def test_fused_topk_int8_matches_jax(n_valid):
    q, d = _data(12, B=8, N=3000, H=128)
    values, scales = quantize_rows(d)
    kw = dict(k=20, tile_n=1024, n_valid=n_valid)
    port = _np(*fused_topk_int8(*_t(q, values, scales), **kw))
    _assert_close(port, jt.fused_topk_int8(
        jnp.asarray(q), jnp.asarray(values), jnp.asarray(scales), interpret=True, **kw))
    _assert_close(port, _np(*topk_segmented_int8(*_t(q, values, scales), k=20,
                                                 n_valid=n_valid)))


def test_fused_topk_ties_go_to_the_lower_id():
    """Duplicate docs score bit-identically; the running top-k orders them
    by id, as the JAX kernel's extract pass does."""
    q, d = _data(13, B=3, N=600, H=16)
    d[450] = d[300] = d[17]
    port = _np(*fused_topk(*_t(q, d), k=600, tile_n=128))
    _assert_close(port, jt.fused_topk(jnp.asarray(q), jnp.asarray(d), k=600, tile_n=128,
                                      interpret=True))
    for row in port[1]:
        pos = [list(row).index(i) for i in (17, 300, 450)]
        assert pos == sorted(pos) and pos[1] == pos[0] + 1


def test_fused_topk_negative_scores_and_short_corpus():
    """All-negative scores beat the zero padding; a corpus of 3 valid rows
    asked for 5 pads with NEG_INF / -1, as the JAX kernel does."""
    rng = np.random.default_rng(14)
    q = -np.abs(rng.normal(size=(2, 8))).astype(np.float32)
    d = np.abs(rng.normal(size=(300, 8))).astype(np.float32)
    vals, ids = _np(*fused_topk(*_t(q, d), k=5, tile_n=256))
    assert (vals < 0).all() and ((ids >= 0) & (ids < 300)).all()
    vals, ids = _np(*fused_topk(*_t(q, d), k=5, tile_n=128, n_valid=3))
    j_vals, j_ids = jt.fused_topk(jnp.asarray(q), jnp.asarray(d), k=5, tile_n=128,
                                  interpret=True, n_valid=3)
    np.testing.assert_array_equal(ids, np.asarray(j_ids))
    assert (ids[:, 3:] == -1).all() and (vals[:, 3:] <= NEG_INF).all()
    with pytest.raises(ValueError, match="larger than corpus"):
        fused_topk(*_t(q, d[:4]), k=5)


def test_topk_stream_cpu_wrappers_are_the_plain_version():
    q, d = _data(15, B=4, N=384, H=32)
    values, scales = quantize_rows(d)
    qt, dt = _t(q, d)
    for got, want in (
        (topk_stream(qt, dt, 7, 300), topk_stream_reference(qt, dt, 7, 300)),
        (topk_stream_int8(qt.bfloat16(), *_t(values, scales), 7, 300),
         topk_stream_reference(qt.bfloat16(), *_t(values), 7, 300, torch.from_numpy(scales))),
    ):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError):
        topk_stream(qt.bfloat16(), dt, 7, 300)  # dtype mismatch
