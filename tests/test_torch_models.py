"""The port's towers and weight format against the JAX package's.

Both packages encode the same numpy token batches with the same weights
(the JAX init carried over by ``params_from_jax``). Tolerances: f32 compute
atol 1e-5 (same arithmetic, sums in another order); bf16 compute max abs
difference < 0.05, the bf16 envelope of tests/test_models.py — the JAX
CPU scan keeps the input projection in f32 while the port rounds it to
bf16 as the TPU kernel does.
"""

import jax
import numpy as np
import pytest
import torch

from twotowermlretrieval_tpu.config import Config as JaxConfig
from twotowermlretrieval_tpu.models.rnn import RNNSpec as JaxRNNSpec
from twotowermlretrieval_tpu.models.two_tower import TwoTowerSpec as JaxTwoTowerSpec
from twotowermlretrieval_tpu.models.two_tower import encode_document as jax_encode_document
from twotowermlretrieval_tpu.models.two_tower import encode_query as jax_encode_query
from twotowermlretrieval_tpu.models.two_tower import init_two_tower as jax_init_two_tower
from twotowermlretrieval_tpu.utils.pytree import flatten_params as jax_flatten_params
from twotowermlretrieval_tpu.utils.pytree import load_params_npz as jax_load_params_npz
from twotowermlretrieval_tpu.utils.pytree import save_params_npz as jax_save_params_npz
from twotowermlretrieval_tpu_torch.config import Config
from twotowermlretrieval_tpu_torch.models.rnn import RNNSpec
from twotowermlretrieval_tpu_torch.models.two_tower import (
    TwoTowerSpec,
    encode_document,
    encode_query,
    init_two_tower,
    params_from_jax,
)
from twotowermlretrieval_tpu_torch.utils.pytree import (
    flatten_params,
    load_params_npz,
    save_params_npz,
)

V, E, H, T = 60, 16, 32, 10


def _specs(rnn_type="GRU", num_layers=2, bidirectional=True, compute_dtype="float32",
           hidden_dim=H):
    kw = dict(vocab_size=V, embed_dim=E, hidden_dim=hidden_dim, rnn_type=rnn_type,
              num_layers=num_layers, bidirectional=bidirectional,
              compute_dtype=compute_dtype)
    return JaxTwoTowerSpec(rnn=JaxRNNSpec(**kw)), TwoTowerSpec(rnn=RNNSpec(**kw))


def _batch(seed, B=12):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, V, size=(B, T)).astype(np.int32)
    lengths = rng.integers(1, T + 1, size=B).astype(np.int32)
    lengths[:3] = [0, 1, T]  # zero-length, length-1 and full rows
    return tokens, lengths


def _jax_params(spec, seed=0):
    tree = jax_init_two_tower(jax.random.key(seed), spec)
    return jax.tree.map(np.asarray, tree)


def _encode_both(jspec, pspec, jparams, tokens, lengths):
    pparams = params_from_jax(jparams)
    out = {}
    for name, jfn, pfn in (("query", jax_encode_query, encode_query),
                           ("doc", jax_encode_document, encode_document)):
        j = np.asarray(jfn(jparams, tokens, lengths, jspec))
        p = pfn(pparams, torch.from_numpy(tokens), torch.from_numpy(lengths), pspec).numpy()
        out[name] = (j, p)
    return out


@pytest.mark.parametrize(
    "rnn_type,num_layers,bidirectional,hidden_dim",
    [
        pytest.param("GRU", 2, True, H, id="GRU-2-True"),
        pytest.param("GRU", 1, False, H, id="GRU-1-False"),
        pytest.param("LSTM", 1, True, H, id="LSTM-1-True"),
        pytest.param("RNN", 2, True, H, id="RNN-2-True"),
        # an odd width: JAX takes its XLA scan (no Pallas plan for H % 128),
        # the port's kernels zero-pad it (on the CPU: the plain versions)
        pytest.param("GRU", 2, True, 50, id="GRU-2-True-H50"),
    ],
)
def test_encoders_match_jax_f32(rnn_type, num_layers, bidirectional, hidden_dim):
    jspec, pspec = _specs(rnn_type, num_layers, bidirectional, hidden_dim=hidden_dim)
    tokens, lengths = _batch(1)
    for name, (j, p) in _encode_both(jspec, pspec, _jax_params(jspec), tokens, lengths).items():
        np.testing.assert_allclose(p, j, rtol=0, atol=1e-5, err_msg=name)
        assert (p[0] == 0).all(), f"{name}: a zero-length row must encode to exact zeros"
        np.testing.assert_allclose(np.linalg.norm(p[1:], axis=1), 1.0, rtol=1e-5)


def test_encoders_match_jax_bf16():
    jspec, pspec = _specs(compute_dtype="bfloat16")
    tokens, lengths = _batch(2)
    for name, (j, p) in _encode_both(jspec, pspec, _jax_params(jspec), tokens, lengths).items():
        assert np.abs(p - j).max() < 0.05, name
        assert (p[0] == 0).all() and (j[0] == 0).all()


def test_weights_round_trip_bit_exact(tmp_path):
    """JAX init -> JAX model.npz -> port -> port model.npz -> JAX loader:
    every array bit-identical, every key the same."""
    jspec, _ = _specs()
    jparams = _jax_params(jspec, seed=3)
    jax_save_params_npz(tmp_path / "jax.npz", jparams)
    ported = params_from_jax(load_params_npz(tmp_path / "jax.npz"))
    assert isinstance(ported["query"]["layers"], tuple)
    save_params_npz(tmp_path / "port.npz", ported)
    back = jax_flatten_params(jax_load_params_npz(tmp_path / "port.npz"))
    ref = jax_flatten_params(jparams)
    assert set(back) == set(ref)
    for k in ref:
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)
    # the flat dict form carries over the same way
    flat = params_from_jax(jax_flatten_params(jparams))
    for k, v in flatten_params(flat).items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)


def test_port_init_serves_through_jax():
    """Weights made by the port's seeded init have the JAX layout: the JAX
    towers encode with them exactly as the port does (f32)."""
    jspec, pspec = _specs()
    pparams = init_two_tower(torch.Generator().manual_seed(0), pspec)
    as_numpy = jax.tree.map(lambda t: t.numpy(), pparams)
    jax_layout = jax.tree.map(np.asarray, jax_init_two_tower(jax.random.key(0), jspec))
    assert jax.tree.structure(as_numpy) == jax.tree.structure(jax_layout)
    tokens, lengths = _batch(4)
    j = np.asarray(jax_encode_query(as_numpy, tokens, lengths, jspec))
    p = encode_query(pparams, torch.from_numpy(tokens), torch.from_numpy(lengths), pspec).numpy()
    np.testing.assert_allclose(p, j, rtol=0, atol=1e-5)


def test_seeded_init_is_deterministic():
    _, pspec = _specs()
    a = flatten_params(init_two_tower(torch.Generator().manual_seed(7), pspec))
    b = flatten_params(init_two_tower(torch.Generator().manual_seed(7), pspec))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["query/layers/0/fwd/w_hh"], a["doc/layers/0/fwd/w_hh"])


def test_spec_from_config_and_transformer_not_ported():
    """Both tower types build from a config, with the mesh knobs too (JAX's
    specs name the same axes); a spec that shards the table, called
    without its process group, raises."""
    cfg = Config(vocab_size=V, embed_dim=E, hidden_dim=H)
    spec = TwoTowerSpec.from_config(cfg)
    assert spec.rnn.num_layers == 2 and spec.rnn.bidirectional and spec.hidden_dim == H
    assert spec.rnn.embedding_axis is None
    tf = TwoTowerSpec.from_config(cfg.replace(tower_type="transformer"))
    assert tf.tower_type == "transformer" and tf.rnn is None and tf.hidden_dim == H
    for kw in ({"mesh_model": 2}, {"shard_embedding_table": True}):
        for tower in ("rnn", "transformer"):
            ours = TwoTowerSpec.from_config(cfg.replace(tower_type=tower, num_heads=2, **kw))
            theirs = JaxTwoTowerSpec.from_config(JaxConfig(
                vocab_size=V, embed_dim=E, hidden_dim=H, tower_type=tower, num_heads=2, **kw))
            sub, jsub = (ours.rnn, theirs.rnn) if tower == "rnn" else (ours.transformer,
                                                                       theirs.transformer)
            assert sub.embedding_axis == jsub.embedding_axis
            if tower == "transformer":
                assert (sub.model_axis, sub.model_axis_size) == (jsub.model_axis,
                                                                 jsub.model_axis_size)
    sharded = TwoTowerSpec.from_config(cfg.replace(shard_embedding_table=True))
    pparams = init_two_tower(torch.Generator().manual_seed(0), sharded)
    tokens, lengths = _batch(4)
    with pytest.raises(ValueError, match="model_group"):
        encode_query(pparams, torch.from_numpy(tokens), torch.from_numpy(lengths), sharded)
