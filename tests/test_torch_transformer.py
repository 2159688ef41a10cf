"""The port's transformer tower against the JAX package's.

Small sizes (2 blocks, H=16, 2 heads of width 8, FFN 32, T <= 16); the JAX
init's weights carried over by ``params_from_jax``, inputs made with numpy
and handed to both; the port runs its plain kernel versions on the CPU,
and the JAX fused route runs its kernel in interpret mode (its VJP patched
as tests/test_models.py does, restored in ``finally``). Gradients are
compared on batches without zero-length rows: there JAX's gradient is NaN
(the clamped norm at 0) and the port's 0, as for the recurrent towers.

Tolerances:

- f32 compute, both attention routes: outputs atol 1e-5, per-leaf
  gradients atol 1e-5 + rtol 1e-4 (the same arithmetic, sums in another
  order; measured 2e-7 and 9e-7);
- bf16 compute or a bf16 residual stream: outputs atol 2^-8 (one bf16 ulp
  at magnitude 1), each leaf's gradient within 2^-5 of that leaf's largest
  JAX magnitude. Both round the same operands, but a last-bit difference
  of an f32 sum can flip a bf16 rounding, which the next layers carry on;
  measured: bf16 compute 6e-8 in the outputs and 2.1e-4 of a leaf's scale,
  a bf16 residual stream 9.0e-4 and 8.3e-3;
- a 10-step f32 in_batch trajectory of the two towers within 2e-4 in the
  loss, as tests/test_torch_train.py holds the recurrent towers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twotowermlretrieval_tpu.config import Config as JaxConfig
from twotowermlretrieval_tpu.data.batching import Batch as JaxBatch
from twotowermlretrieval_tpu.models import transformer as jax_transformer
from twotowermlretrieval_tpu.models.two_tower import TwoTowerSpec as JaxTwoTowerSpec
from twotowermlretrieval_tpu.models.two_tower import init_two_tower as jax_init_two_tower
from twotowermlretrieval_tpu.ops import attention as jax_attention
from twotowermlretrieval_tpu.train.train_step import create_train_state as jax_create_state
from twotowermlretrieval_tpu.train.train_step import make_train_step as jax_make_train_step
from twotowermlretrieval_tpu.utils.pytree import flatten_params as jax_flatten_params
from twotowermlretrieval_tpu.utils.pytree import load_params_npz as jax_load_params_npz
from twotowermlretrieval_tpu.utils.pytree import save_params_npz as jax_save_params_npz
from twotowermlretrieval_tpu_torch.config import Config
from twotowermlretrieval_tpu_torch.data.batching import Batch
from twotowermlretrieval_tpu_torch.models.transformer import (
    TransformerSpec,
    init_transformer_encoder,
    transformer_encode,
)
from twotowermlretrieval_tpu_torch.models.two_tower import TwoTowerSpec, params_from_jax
from twotowermlretrieval_tpu_torch.ops.attention import attention_bwd, attention_fwd
from twotowermlretrieval_tpu_torch.train.train_step import create_train_state, make_train_step
from twotowermlretrieval_tpu_torch.utils.pytree import load_params_npz, named_leaves, save_params_npz

V, E, H, T = 50, 8, 16, 16
KW = dict(vocab_size=V, embed_dim=E, hidden_dim=H, num_layers=2, num_heads=2, ffn_dim=32,
          compute_dtype="float32", max_len=T)


@pytest.fixture
def interpreted_jax_kernel():
    """The JAX fused route with its kernel in interpret mode (CPU)."""
    orig_fwd = jax_attention._fused_attention_fwd
    orig_bwd = jax_attention._fused_attention_bwd
    jax_attention.fused_attention.defvjp(
        lambda q, k, v, b, s, c, i: orig_fwd(q, k, v, b, s, c, True),
        lambda s, c, i, res, do: orig_bwd(s, c, True, res, do),
    )
    try:
        yield
    finally:
        jax_attention.fused_attention.defvjp(orig_fwd, orig_bwd)


def _batch(seed, lengths=(16, 5, 3, 1)):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, V, (len(lengths), T)).astype(np.int32)
    return tokens, np.asarray(lengths, np.int32), rng.standard_normal(
        (len(lengths), H)).astype(np.float32)


def _jax_params(seed=0, **kw):
    spec = jax_transformer.TransformerSpec(**{**KW, **kw})
    return jax.tree.map(np.asarray, jax_transformer.init_transformer_encoder(
        jax.random.key(seed), spec))


def _both(jparams, tokens, lengths, ct, **kw):
    """(JAX out, JAX per-leaf grads, port out, port grads) of sum(out * ct)."""
    jspec = jax_transformer.TransformerSpec(**{**KW, **kw})
    out, vjp = jax.vjp(lambda p: jax_transformer.transformer_encode(p, tokens, lengths, jspec),
                       jparams)
    jgrads = [np.asarray(g) for g in jax.tree.leaves(vjp(jnp.asarray(ct))[0])]
    params = params_from_jax(jparams)
    leaves = [t.requires_grad_(True) for _, t in named_leaves(params)]
    pout = transformer_encode(params, torch.from_numpy(tokens), torch.from_numpy(lengths),
                              TransformerSpec(**{**KW, **kw}))
    pgrads = torch.autograd.grad((pout * torch.from_numpy(ct)).sum(), leaves)
    return np.asarray(out), jgrads, pout.detach().numpy(), [g.numpy() for g in pgrads]


@pytest.mark.parametrize("fused", [None, True], ids=["torch-route", "fused-route"])
def test_encode_and_grads_match_jax_f32(interpreted_jax_kernel, fused):
    tokens, lengths, ct = _batch(1)
    jout, jgrads, pout, pgrads = _both(_jax_params(), tokens, lengths, ct, fused_attention=fused)
    np.testing.assert_allclose(pout, jout, rtol=0, atol=1e-5)
    assert len(pgrads) == len(jgrads) == 4 + 2 * 12 + 2  # table, input_proj, positions; blocks; ln_final
    for p, j in zip(pgrads, jgrads):
        np.testing.assert_allclose(p, j, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(compute_dtype="bfloat16"),
    dict(compute_dtype="bfloat16", fused_attention=True),
    dict(residual_dtype="bfloat16"),
    dict(residual_dtype="bfloat16", fused_attention=True),
    dict(compute_dtype="bfloat16", residual_dtype="bfloat16", fused_attention=True),
], ids=["bf16", "bf16-fused", "bf16-residual", "bf16-residual-fused", "bf16-both-fused"])
def test_bf16_compute_and_residual_within_envelope(interpreted_jax_kernel, kw):
    tokens, lengths, ct = _batch(2)
    jout, jgrads, pout, pgrads = _both(_jax_params(seed=1), tokens, lengths, ct, **kw)
    assert np.abs(pout - jout).max() <= 2 ** -8
    for p, j in zip(pgrads, jgrads):
        assert np.abs(p - j).max() <= 2 ** -5 * max(np.abs(j).max(), 1e-6)


def test_zero_length_rows_encode_to_zero_with_finite_grads(interpreted_jax_kernel):
    tokens, lengths, ct = _batch(3, lengths=(0, 7, 0, 16))
    for fused in (None, True):
        jspec = jax_transformer.TransformerSpec(**KW, fused_attention=fused)
        jparams = _jax_params(seed=2)
        jout, _ = jax.vjp(lambda p: jax_transformer.transformer_encode(p, tokens, lengths, jspec),
                          jparams)
        params = params_from_jax(jparams)
        leaves = [t.requires_grad_(True) for _, t in named_leaves(params)]
        out = transformer_encode(params, torch.from_numpy(tokens), torch.from_numpy(lengths),
                                 TransformerSpec(**KW, fused_attention=fused))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=0, atol=1e-5)
        assert (out[0] == 0).all() and (out[2] == 0).all()
        grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), leaves)
        assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_legacy_qkv_layout_encodes_the_same():
    """Checkpoints from before the head-major layout hold qkv as [H, 3H] /
    [3H], columns ordered q|k|v; both packages read them the same way."""
    tokens, lengths, _ = _batch(4)
    jparams = _jax_params(seed=3)
    legacy = dict(jparams, blocks=tuple(
        dict(b, qkv={"w": b["qkv"]["w"].reshape(H, 3 * H), "b": b["qkv"]["b"].reshape(3 * H)})
        for b in jparams["blocks"]))
    spec = TransformerSpec(**KW)
    args = (torch.from_numpy(tokens), torch.from_numpy(lengths), spec)
    head_major = transformer_encode(params_from_jax(jparams), *args)
    flat = transformer_encode(params_from_jax(legacy), *args)
    assert torch.equal(head_major, flat)
    jout = jax_transformer.transformer_encode(legacy, tokens, lengths,
                                              jax_transformer.TransformerSpec(**KW))
    np.testing.assert_allclose(flat.numpy(), np.asarray(jout), rtol=0, atol=1e-5)


@pytest.mark.parametrize("fused", [None, True], ids=["torch-route", "fused-route"])
def test_remat_equals_no_remat_with_dropout(fused):
    """remat_blocks recomputes each block in the backward with the same
    dropout masks (drawn before the block), so the loss and every gradient
    equal the run without remat."""
    params = init_transformer_encoder(torch.Generator().manual_seed(0), TransformerSpec(**KW))
    tokens, lengths, ct = _batch(5)
    results = []
    for remat in (False, True):
        spec = TransformerSpec(**KW, dropout=0.3, remat_blocks=remat, fused_attention=fused)
        leaves = [t.detach().clone().requires_grad_(True) for _, t in named_leaves(params)]
        tree = dict(zip([n for n, _ in named_leaves(params)], leaves))
        from twotowermlretrieval_tpu_torch.utils.pytree import unflatten_params

        p = unflatten_params(tree)
        out = transformer_encode(p, torch.from_numpy(tokens), torch.from_numpy(lengths), spec,
                                 train=True, generator=torch.Generator().manual_seed(9))
        loss = (out * torch.from_numpy(ct)).sum()
        results.append((loss.item(), torch.autograd.grad(loss, leaves)))
    (l0, g0), (l1, g1) = results
    assert l0 == pytest.approx(l1, rel=1e-6)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    # dropout is on: the same weights without it encode differently
    plain = transformer_encode(params, torch.from_numpy(tokens), torch.from_numpy(lengths),
                               TransformerSpec(**KW, dropout=0.3))
    assert (plain * torch.from_numpy(ct)).sum().item() != pytest.approx(l0, rel=1e-6)
    with pytest.raises(ValueError, match="generator"):
        transformer_encode(params, torch.from_numpy(tokens), torch.from_numpy(lengths),
                           TransformerSpec(**KW, dropout=0.3), train=True)


def test_dropout_rate_and_scale():
    """Each sublayer's mask keeps 1 - dropout of its units and the kept
    units scale by 1 / keep (rounded to the stream dtype, as in JAX)."""
    from twotowermlretrieval_tpu_torch.models.transformer import _dropout
    from twotowermlretrieval_tpu_torch.utils.dtypes import bernoulli_mask

    x = torch.ones((64, 32, 16), dtype=torch.bfloat16)
    mask = bernoulli_mask(torch.Generator().manual_seed(0), 0.9, x.shape, x.device)
    y = _dropout(x, mask, 0.9)
    assert y.dtype == torch.bfloat16
    assert abs(mask.float().mean().item() - 0.9) < 0.01
    assert set(y.unique().tolist()) == {0.0, float(torch.tensor(1.0 / 0.9).bfloat16())}
    assert _dropout(x, None, 0.9) is x


def test_model_npz_round_trip_through_params_from_jax(tmp_path):
    """JAX two-tower transformer init -> JAX model.npz -> port -> port
    model.npz -> JAX loader: every array bit-identical, every key the same,
    and the port encodes with it as JAX does."""
    jcfg = JaxConfig(vocab_size=V, embed_dim=E, hidden_dim=H, tower_type="transformer",
                     num_layers=2, num_heads=2, ffn_dim=32, max_query_len=8, max_doc_len=T,
                     compute_dtype="float32")
    jspec = JaxTwoTowerSpec.from_config(jcfg)
    jparams = jax.tree.map(np.asarray, jax_init_two_tower(jax.random.key(4), jspec))
    jax_save_params_npz(tmp_path / "jax.npz", jparams)
    ported = params_from_jax(load_params_npz(tmp_path / "jax.npz"))
    assert isinstance(ported["doc"]["blocks"], tuple) and ported["doc"]["blocks"][0]["qkv"][
        "w"].shape == (H, 3, H)
    save_params_npz(tmp_path / "port.npz", ported)
    back = jax_flatten_params(jax_load_params_npz(tmp_path / "port.npz"))
    ref = jax_flatten_params(jparams)
    assert set(back) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)
    spec = TwoTowerSpec.from_config(Config.from_dict(jcfg.to_dict()))
    assert spec.tower_type == "transformer" and spec.hidden_dim == H
    tokens, lengths, _ = _batch(6)
    from twotowermlretrieval_tpu.models.two_tower import encode_document as jax_encode_document
    from twotowermlretrieval_tpu_torch.models.two_tower import encode_document

    np.testing.assert_allclose(
        encode_document(ported, torch.from_numpy(tokens), torch.from_numpy(lengths), spec).numpy(),
        np.asarray(jax_encode_document(jparams, tokens, lengths, jspec)), rtol=0, atol=1e-5)


def test_port_init_has_the_jax_layout():
    spec = TransformerSpec(**KW)
    ours = jax.tree.map(lambda t: t.numpy(), init_transformer_encoder(
        torch.Generator().manual_seed(0), spec))
    theirs = _jax_params()
    assert jax.tree.structure(ours) == jax.tree.structure(theirs)
    assert all(a.shape == b.shape for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)))
    a = init_transformer_encoder(torch.Generator().manual_seed(7), spec)
    b = init_transformer_encoder(torch.Generator().manual_seed(7), spec)
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(named_leaves(a), named_leaves(b)))


def test_mesh_knobs_raise_naming_the_roadmap_item():
    """The mesh knobs build specs (the model axis is ported; its ranks are
    held in tests/test_torch_model_axis.py); what raises is JAX's
    divisibility of heads and FFN columns over the axis, and a
    tensor-parallel spec called without its process group."""
    tp = TransformerSpec(**KW, model_axis="model", model_axis_size=2)
    assert tp.head_dim == 8 and TransformerSpec(**KW, embedding_axis="model").embedding_axis
    with pytest.raises(ValueError, match=r"num_heads=2 must divide evenly over the model axis \(4\)"):
        TransformerSpec(**KW, model_axis="model", model_axis_size=4)
    with pytest.raises(ValueError, match=r"ffn_dim=31 must divide evenly over the model axis \(2\)"):
        TransformerSpec(**{**KW, "ffn_dim": 31}, model_axis="model", model_axis_size=2)
    for jkw in ({"model_axis_size": 4}, {"ffn_dim": 31, "model_axis_size": 2}):
        with pytest.raises(ValueError, match="must divide evenly over the model axis"):
            jax_transformer.TransformerSpec(**{**KW, **jkw}, model_axis="model")
    tokens, lengths, _ = _batch(1)
    with pytest.raises(ValueError, match="model_group"):
        transformer_encode(params_from_jax(_jax_params()), torch.from_numpy(tokens),
                           torch.from_numpy(lengths), tp)
    cfg = Config(vocab_size=V, embed_dim=E, hidden_dim=H, tower_type="transformer", num_heads=2)
    assert TwoTowerSpec.from_config(cfg).transformer.head_dim == 8
    spec = TwoTowerSpec.from_config(cfg.replace(mesh_model=2)).transformer
    assert (spec.model_axis, spec.model_axis_size, spec.embedding_axis) == ("model", 2, None)
    spec = TwoTowerSpec.from_config(cfg.replace(shard_embedding_table=True)).transformer
    assert (spec.model_axis, spec.model_axis_size, spec.embedding_axis) == (None, 1, "model")


# ---------------------------------------------------------------------------
# training: a 10-step trajectory against JAX's make_train_step
# ---------------------------------------------------------------------------

B, TQ, TD, STEPS = 8, 6, 10, 10


def _configs(**kw):
    base = dict(vocab_size=V, embed_dim=E, hidden_dim=H, tower_type="transformer",
                num_layers=2, num_heads=2, ffn_dim=32, dropout=0.0, batch_size=B, lr=1e-3,
                max_query_len=TQ, max_doc_len=TD, compute_dtype="float32",
                freeze_embeddings=False, loss_type="in_batch", triplet_metrics=False,
                temperature=0.05)
    base.update(kw)
    return JaxConfig(**base), Config(**base)


@pytest.mark.parametrize("fused", [None, True], ids=["torch-route", "fused-route"])
def test_ten_step_in_batch_trajectory_matches_jax_f32(interpreted_jax_kernel, fused):
    """Config 5's training recipe at a tiny size: a trainable table, the
    in_batch loss without the negative pass, 10 steps from the same params
    and batches (the last with 2 repeat-padded rows)."""
    jcfg, cfg = _configs(fused_attention=fused)
    rng = np.random.default_rng(0)
    table = (rng.standard_normal((V, E)) * 0.3).astype(np.float32)
    jspec = JaxTwoTowerSpec.from_config(jcfg)
    params = jax_init_two_tower(jax.random.key(0), jspec, pretrained_embeddings=table)
    jstate = jax_create_state(jax.random.key(1), params, jcfg)
    jstep = jax.jit(jax_make_train_step(jspec, jcfg))
    state = create_train_state(torch.Generator().manual_seed(1),
                               params_from_jax(jax.tree.map(np.asarray, params)), cfg)
    assert state.frozen == {} and "embedding" in state.trainable["query"]
    step = make_train_step(TwoTowerSpec.from_config(cfg), cfg)
    ours, theirs = [], []
    before = attention_fwd.launches, attention_bwd.launches
    for i in range(STEPS):
        def tok(L):
            return (rng.integers(1, V, (B, L)).astype(np.int32),
                    rng.integers(1, L + 1, (B,)).astype(np.int32))
        (q, ql), (p, pl), (n, nl) = tok(TQ), tok(TD), tok(TD)
        w = np.ones(B, np.float32)
        if i == STEPS - 1:
            w[-2:] = 0.0
        arrs = (q, ql, p, pl, n, nl, w)
        jstate, jm = jstep(jstate, JaxBatch(*[jnp.asarray(a) for a in arrs]))
        theirs.append(jax.tree.map(np.asarray, jm))
        state, m = step(state, Batch(*[torch.from_numpy(a) for a in arrs]))
        ours.append({k: v.numpy() for k, v in m.items()})
    assert (attention_fwd.launches, attention_bwd.launches) == before  # plain versions on the CPU
    assert sorted(ours[0]) == sorted(theirs[0]) and "neg_similarity" not in ours[0]
    np.testing.assert_allclose([m["loss"] for m in ours], [m["loss"] for m in theirs],
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose([m["grad_norm"] for m in ours], [m["grad_norm"] for m in theirs],
                               rtol=2e-3, atol=2e-4)
    for key in theirs[-1]:
        np.testing.assert_allclose(ours[-1][key], theirs[-1][key], rtol=2e-3, atol=2e-3,
                                   err_msg=key)
    assert state.step == STEPS


def test_train_and_serve_a_transformer_on_the_cpu(tmp_path):
    """The training loop behind ``ttr-torch-train --device cpu`` on a transformer
    config: it trains (finite losses, the loss falls), exports, and the
    port's engine serves the export."""
    from twotowermlretrieval_tpu_torch.data.synthetic import generate_corpus, synthetic_config
    from twotowermlretrieval_tpu_torch.serve.engine import SearchEngine
    from twotowermlretrieval_tpu_torch.train.loop import train

    generate_corpus(tmp_path / "corpus", num_queries=60, num_topics=6, words_per_topic=12,
                    embed_dim=16)
    cfg = synthetic_config(tmp_path / "corpus", tower_type="transformer", hidden_dim=16,
                           num_layers=2, num_heads=2, ffn_dim=32, dropout=0.1, lr=3e-3,
                           loss_type="in_batch", triplet_metrics=False,
                           freeze_embeddings=False, epochs=3, fused_attention=True,
                           max_query_len=8, max_doc_len=16)
    res = train(cfg, output_root=tmp_path / "out", device="cpu")
    losses = res["step_losses"]
    assert res["steps"] == len(losses) > 5 and np.isfinite(losses).all()
    assert res["epochs"][-1]["avg_train_loss"] < res["epochs"][0]["avg_train_loss"]
    engine = SearchEngine(res["artifacts_dir"], device="cpu")
    assert engine.index.num_docs > 0
    out = engine.search("t1w3 t1w5", alpha=0.5)["results"]
    assert 0 < len(out) <= 10 and all(np.isfinite(r["score"]) for r in out)


def test_spec_fields_match_jax():
    """Every field of the JAX TransformerSpec exists in the port's, and
    from_config fills them alike (the mesh knobs left at one device)."""
    names = {f.name for f in dataclasses.fields(jax_transformer.TransformerSpec)}
    assert names == {f.name for f in dataclasses.fields(TransformerSpec)}
    jcfg, cfg = _configs(remat_blocks=True, residual_dtype="bfloat16", fused_attention=True)
    assert dataclasses.asdict(TransformerSpec.from_config(cfg)) == dataclasses.asdict(
        jax_transformer.TransformerSpec.from_config(jcfg))
