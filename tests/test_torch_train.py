"""The port's training path against the JAX package's.

Small sizes (2-layer bidirectional towers, H=16, B=16, T <= 10), inputs
made from numpy seeds and handed to both packages; the port runs its plain
kernel versions on the CPU. Tolerances:

- the 10-step loss trajectory at f32 within 2e-4, the bound the JAX
  package's own torch-twin parity test meets
  (tests/test_torch_train_parity.py);
- a bf16 trajectory within 5e-3: the port rounds the input projection to
  bf16 before the time loop, as the TPU kernel does, where JAX's CPU scan
  keeps it in f32 (ROADMAP Queue 3); the losses drift apart by 3.7e-4 over
  10 steps at these sizes (f32: 6e-8);
- the losses, the optimizer and the evaluators' metrics to f32 rounding.
"""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from twotowermlretrieval_tpu.config import Config as JaxConfig
from twotowermlretrieval_tpu.data.batching import Batch as JaxBatch
from twotowermlretrieval_tpu.models import losses as jax_losses
from twotowermlretrieval_tpu.models.two_tower import TwoTowerSpec as JaxTwoTowerSpec
from twotowermlretrieval_tpu.models.two_tower import init_two_tower as jax_init_two_tower
from twotowermlretrieval_tpu.train import evaluators as jax_evaluators
from twotowermlretrieval_tpu.train.train_step import create_train_state as jax_create_state
from twotowermlretrieval_tpu.train.train_step import make_optimizer as jax_make_optimizer
from twotowermlretrieval_tpu.train.train_step import make_train_step as jax_make_train_step
from twotowermlretrieval_tpu_torch.config import Config
from twotowermlretrieval_tpu_torch.data.batching import Batch, TripletBatcher
from twotowermlretrieval_tpu_torch.models import losses
from twotowermlretrieval_tpu_torch.models.two_tower import TwoTowerSpec, params_from_jax
from twotowermlretrieval_tpu_torch.train import evaluators
from twotowermlretrieval_tpu_torch.train.checkpoint import CheckpointManager
from twotowermlretrieval_tpu_torch.train.train_step import (
    apply_clip_and_adam,
    create_train_state,
    make_train_step,
)
from twotowermlretrieval_tpu_torch.utils.pytree import named_leaves

VOCAB, EMBED, HIDDEN, B, TQ, TD, STEPS = 80, 12, 16, 16, 6, 10, 10


@pytest.fixture
def unused_tcp_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _configs(**kw):
    base = dict(
        vocab_size=VOCAB, embed_dim=EMBED, hidden_dim=HIDDEN, rnn_type="GRU", num_layers=2,
        bidirectional=True, dropout=0.0, batch_size=B, lr=1e-3, margin=0.5,
        max_query_len=TQ, max_doc_len=TD, compute_dtype="float32", freeze_embeddings=True,
    )
    base.update(kw)
    return JaxConfig(**base), Config(**base)


def _batches(rng, n):
    """n batches of numpy arrays; the last has 3 repeat-padded rows."""
    out = []
    for i in range(n):
        def tok(L):
            lengths = rng.integers(1, L + 1, (B,)).astype(np.int32)
            t = rng.integers(1, VOCAB, (B, L)).astype(np.int32)
            return t, lengths
        q, ql = tok(TQ)
        p, pl = tok(TD)
        ng, nl = tok(TD)
        w = np.ones(B, np.float32)
        if i == n - 1:
            w[-3:] = 0.0
        out.append((q, ql, p, pl, ng, nl, w))
    return out


def _trajectories(jcfg, cfg, steps=STEPS, seed=0):
    """(JAX metrics, port metrics) per step from the same initial params."""
    rng = np.random.default_rng(seed)
    table = (rng.standard_normal((VOCAB, EMBED)) * 0.3).astype(np.float32)
    jspec = JaxTwoTowerSpec.from_config(jcfg)
    params = jax_init_two_tower(jax.random.key(0), jspec, pretrained_embeddings=table)
    jstate = jax_create_state(jax.random.key(1), params, jcfg)
    jstep = jax.jit(jax_make_train_step(jspec, jcfg))

    spec = TwoTowerSpec.from_config(cfg)
    state = create_train_state(torch.Generator().manual_seed(1),
                               params_from_jax(jax.tree.map(np.asarray, params)), cfg)
    step = make_train_step(spec, cfg)

    ours, theirs = [], []
    for arrs in _batches(rng, steps):
        jstate, jm = jstep(jstate, JaxBatch(*[jnp.asarray(a) for a in arrs]))
        theirs.append(jax.tree.map(np.asarray, jm))
        state, m = step(state, Batch(*[torch.from_numpy(a) for a in arrs]))
        ours.append({k: v.numpy() for k, v in m.items()})
    return theirs, ours, state


@pytest.mark.parametrize("triplet_metrics", [True, False])
@pytest.mark.parametrize("loss_type", ["triplet", "in_batch", "triplet+in_batch"])
def test_ten_step_trajectory_matches_jax_f32(loss_type, triplet_metrics):
    jcfg, cfg = _configs(loss_type=loss_type, triplet_metrics=triplet_metrics)
    theirs, ours, state = _trajectories(jcfg, cfg)
    # the same metric set: the negative's pass and its metrics are skipped
    # exactly when the JAX step skips them
    assert [sorted(m) for m in ours] == [sorted(m) for m in theirs]
    np.testing.assert_allclose([m["loss"] for m in ours], [m["loss"] for m in theirs],
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose([m["grad_norm"] for m in ours],
                               [m["grad_norm"] for m in theirs], rtol=2e-3, atol=2e-4)
    for key in theirs[-1]:
        np.testing.assert_allclose(ours[-1][key], theirs[-1][key], rtol=2e-3, atol=2e-3,
                                   err_msg=key)
    assert state.step == STEPS and int(state.opt_state["count"]) == STEPS


def test_trajectory_bf16_within_envelope():
    jcfg, cfg = _configs(compute_dtype="bfloat16")
    theirs, ours, _ = _trajectories(jcfg, cfg, seed=1)
    np.testing.assert_allclose([m["loss"] for m in ours], [m["loss"] for m in theirs],
                               rtol=0, atol=5e-3)


def test_param_stats_and_histograms_match_jax():
    jcfg, cfg = _configs(log_param_stats=True, log_param_histograms=True)
    theirs, ours, _ = _trajectories(jcfg, cfg, steps=1, seed=2)
    j, o = theirs[0], ours[0]
    assert sorted(o) == sorted(j)
    names = [k for k in j if k.startswith("grad_norm/")]
    assert len(names) == 2 * (2 * 2 * 4 + 2)  # towers x (layers x dirs x 4 + projection)
    for key in j:
        if "hist/" in key:
            assert o[key].sum() == j[key].sum()
            assert np.abs(o[key] - j[key]).sum() <= 2, key  # a value on a bin edge may move
        else:
            np.testing.assert_allclose(o[key], j[key], rtol=1e-4, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("target_norm", [0.5, 5.0], ids=["below-1", "above-1"])
def test_clip_and_adam_match_optax(target_norm):
    """optax's clip (no 1e-6 in the denominator) then Adam, over two
    updates, against optax itself on the same params and gradients."""
    jcfg, cfg = _configs(lr=1e-2)
    rng = np.random.default_rng(3)
    params = {"query": {"w": rng.normal(size=(4, 6)).astype(np.float32),
                        "b": rng.normal(size=(6,)).astype(np.float32)}}
    tx = jax_make_optimizer(jcfg)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    state = create_train_state(torch.Generator(), params_from_jax(params),
                               cfg.replace(freeze_embeddings=False))
    import optax

    for _ in range(2):
        grads = {"query": {k: rng.normal(size=v.shape).astype(np.float32)
                           for k, v in params["query"].items()}}
        norm = np.sqrt(sum((g ** 2).sum() for g in grads["query"].values()))
        grads = jax.tree.map(lambda g: (g * target_norm / norm).astype(np.float32), grads)
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        gnorm = apply_clip_and_adam(
            state, [torch.from_numpy(g) for _, g in named_leaves(grads)], cfg)
        np.testing.assert_allclose(float(gnorm), target_norm, rtol=1e-6)
    for (name, p), (_, jp) in zip(named_leaves(state.trainable), named_leaves(jparams)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("loss_type", ["triplet", "in_batch", "triplet+in_batch"])
def test_losses_and_their_grads_match_jax(loss_type, unused_tcp_port):
    rng = np.random.default_rng(4)
    q, p, n = (rng.normal(size=(8, 5)).astype(np.float32) for _ in range(3))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    p[6] = p[2]  # a repeat-padded row duplicates a real document
    w = np.ones(8, np.float32)
    w[6:] = 0.0

    def jloss(q, p, n):
        return jax_losses.combined_loss(q, p, n, loss_type, 0.5, 0.05, weights=jnp.asarray(w))

    jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(p), jnp.asarray(n))
    tq, tp, tn = (torch.from_numpy(x).requires_grad_(True) for x in (q, p, n))
    val = losses.combined_loss(tq, tp, tn, loss_type, 0.5, 0.05, weights=torch.from_numpy(w))
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-6, atol=1e-7)
    for t, g in zip((tq, tp, tn), jgrads):
        got = np.zeros_like(np.asarray(g)) if t.grad is None else t.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(g), rtol=1e-5, atol=1e-7)
    # the cross-device form in a world of one gloo rank: the plain form
    import torch.distributed as dist

    from twotowermlretrieval_tpu_torch.parallel.mesh import initialize_multihost, make_mesh

    initialize_multihost(f"127.0.0.1:{unused_tcp_port}", num_processes=1, process_id=0,
                         device="cpu")
    try:
        group = make_mesh(1, 1).data_group
        assert dist.get_world_size(group) == 1
        grads = [t.grad for t in (tq, tp, tn)]
        for t in (tq, tp, tn):
            t.grad = None
        val1 = losses.combined_loss(tq, tp, tn, loss_type, 0.5, 0.05,
                                    weights=torch.from_numpy(w), axis_name=group)
        val1.backward()
        assert val1.item() == val.item()
        for t, g in zip((tq, tp, tn), grads):
            if g is None:
                assert t.grad is None
            else:
                np.testing.assert_allclose(t.grad.numpy(), g.numpy(), rtol=1e-6, atol=1e-8)
    finally:
        dist.destroy_process_group()


def test_cosine_guards_each_norm():
    z = torch.zeros((2, 3))
    a = torch.ones((2, 3))
    assert torch.equal(losses._cosine(z, a), torch.zeros(2))
    np.testing.assert_allclose(
        losses._cosine(z, a).numpy(), np.asarray(jax_losses._cosine(jnp.zeros((2, 3)),
                                                                    jnp.ones((2, 3)))))


# ---------------------------------------------------------------------------
# evaluators
# ---------------------------------------------------------------------------


class _FixedEncoder:
    """Embeddings from a fixed table keyed by text, for both packages."""

    device = torch.device("cpu")

    def __init__(self, table):
        self.table = table

    def encode_documents(self, texts):
        return np.stack([self.table[t] for t in texts]).astype(np.float32)

    encode_queries = encode_documents


def _eval_data(seed=5):
    rng = np.random.default_rng(seed)
    queries = [f"q{i}" for i in range(40)]
    docs = [f"d{i}" for i in range(120)]
    triplets = [(queries[i % 40], docs[i], docs[(i * 7 + 3) % 120]) for i in range(100)]
    vecs = rng.normal(size=(160, 8)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    table = dict(zip(queries + docs, vecs))
    table["d5"] = table["d9"]  # exact ties
    return triplets, table


def test_corpus_and_test_evaluators_match_jax():
    triplets, table = _eval_data()
    enc = _FixedEncoder(table)
    ours = evaluators.CorpusEvaluator(max_candidates=60, max_queries=30, seed=1).evaluate(
        enc, triplets)
    theirs = jax_evaluators.CorpusEvaluator(max_candidates=60, max_queries=30, seed=1).evaluate(
        enc, triplets)
    assert ours == pytest.approx(theirs, abs=1e-12)
    ours = evaluators.TestEvaluator(seed=2).evaluate(enc, triplets, print_fn=lambda *a: None)
    theirs = jax_evaluators.TestEvaluator(seed=2).evaluate(enc, triplets,
                                                            print_fn=lambda *a: None)
    assert [r["query"] for r in ours] == [r["query"] for r in theirs]
    assert [[x["doc"] for x in r["retrieved"]] for r in ours] == \
        [[x["doc"] for x in r["retrieved"]] for r in theirs]


def test_block_ranks_match_jax_with_ties():
    rng = np.random.default_rng(6)
    q = rng.normal(size=(30, 8)).astype(np.float32)
    d = rng.normal(size=(30, 8)).astype(np.float32)
    d[7] = d[3]  # query 7's positive ties with column 3
    q[12] = 0.0  # an all-zero query: every column ties
    ours = torch.cat([evaluators._block_ranks(torch.from_numpy(q[i : i + 8]),
                                              torch.from_numpy(d), i) for i in range(0, 30, 8)])
    theirs = np.concatenate([np.asarray(jax_evaluators._block_ranks(
        jnp.asarray(q[i : i + 8]), jnp.asarray(d), i)) for i in range(0, 30, 8)])
    np.testing.assert_array_equal(ours.numpy(), theirs)
    np.testing.assert_array_equal(evaluators.ranks_of_diagonal(q @ d.T),
                                  jax_evaluators.ranks_of_diagonal(q @ d.T))
    assert ours[12] == 13  # ties rank as a stable sort would


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from twotowermlretrieval_tpu_torch.data.synthetic import generate_corpus, synthetic_config

    out = tmp_path_factory.mktemp("torch_corpus")
    generate_corpus(out, num_queries=120, num_topics=12, words_per_topic=20, embed_dim=16)
    cfg = synthetic_config(out, hidden_dim=16, num_layers=2, bidirectional=True, dropout=0.2,
                           lr=5e-3, length_buckets=[16, 24], steps_per_dispatch=2,
                           log_every_steps=100)
    return out, cfg


def test_train_end_to_end_on_the_cpu(corpus, tmp_path):
    from twotowermlretrieval_tpu_torch.serve.engine import SearchEngine
    from twotowermlretrieval_tpu_torch.train.loop import train

    _, cfg = corpus
    res = train(cfg.replace(epochs=3), output_root=tmp_path, device="cpu")
    losses_ = res["step_losses"]
    assert res["steps"] == len(losses_) > 10 and np.isfinite(losses_).all()
    first, last = res["epochs"][0], res["epochs"][-1]
    assert last["avg_train_loss"] < first["avg_train_loss"]
    assert last["batch_Recall@10"] >= 0.5
    engine = SearchEngine(res["artifacts_dir"], device="cpu")
    out = engine.search("t1w3 t1w5", alpha=0.5)
    assert 0 < len(out["results"]) <= 10
    # eval-only mode on the exported weights: test evaluation only
    res2 = train(cfg, output_root=tmp_path / "eval", device="cpu",
                 model_path=f"{res['artifacts_dir']}/model.npz")
    assert "test_eval" in res2 and "artifacts_dir" not in res2


def test_resume_replays_the_same_batch_order(corpus, tmp_path):
    """A run interrupted mid-epoch and resumed from its checkpoint takes
    exactly the steps, with exactly the losses, of an uninterrupted run:
    params, Adam state, the dropout generator and the data position all
    round-trip."""
    from twotowermlretrieval_tpu_torch.train.loop import train

    _, cfg = corpus
    cfg = cfg.replace(epochs=2, checkpoint_every_steps=4)
    straight = train(cfg, output_root=tmp_path / "a", device="cpu")["step_losses"]
    ckpt = tmp_path / "ckpt"
    train(cfg.replace(epochs=1), output_root=tmp_path / "b", checkpoint_dir=ckpt, device="cpu")
    manager = CheckpointManager(ckpt)
    steps = manager.all_steps()
    # drop the epoch-end checkpoint: the latest is then a mid-epoch one
    import shutil

    shutil.rmtree(ckpt / f"step_{steps[-1]:08d}")
    resume_at = manager.latest_step()
    assert 0 < resume_at < steps[-1]
    resumed = train(cfg, output_root=tmp_path / "c", checkpoint_dir=ckpt, resume=True,
                    device="cpu")["step_losses"]
    assert resumed == straight[resume_at:]


def test_checkpoint_round_trips_bit_for_bit(tmp_path):
    jcfg, cfg = _configs(dropout=0.3)
    _, _, state = _trajectories(jcfg, cfg, steps=2, seed=7)
    state.generator.manual_seed(11)
    manager = CheckpointManager(tmp_path, max_to_keep=2)
    manager.save(state, {"epoch": 0, "batch_index": 2})
    _, _, other = _trajectories(jcfg, cfg, steps=1, seed=8)
    restored, position = manager.restore(other)
    assert position == {"epoch": 0, "batch_index": 2} and restored.step == 2
    for tree in ("trainable", "frozen"):
        for (_, a), (_, b) in zip(named_leaves(getattr(state, tree)),
                                  named_leaves(getattr(restored, tree))):
            assert torch.equal(a, b)
    for key in ("mu", "nu"):
        for (_, a), (_, b) in zip(named_leaves(state.opt_state[key]),
                                  named_leaves(restored.opt_state[key])):
            assert torch.equal(a, b)
    assert torch.equal(restored.generator.get_state(), state.generator.get_state())
    for step in (3, 4):
        state.step = step
        manager.save(state)
    assert manager.all_steps() == [3, 4]  # max_to_keep
    assert not (tmp_path / "step_00000002.position.json").exists()


def test_batcher_copy_matches_jax(synth_config):
    from twotowermlretrieval_tpu.data.batching import TripletBatcher as JaxBatcher
    from twotowermlretrieval_tpu.data.loader import TripletBuilder as JaxBuilder
    from twotowermlretrieval_tpu.tokenizer import Tokenizer as JaxTokenizer
    from twotowermlretrieval_tpu_torch.data.loader import TripletBuilder
    from twotowermlretrieval_tpu_torch.tokenizer import Tokenizer

    data = TripletBuilder(synth_config).load_datasets()
    assert data == JaxBuilder(synth_config).load_datasets()
    with open(synth_config.word_to_idx_path, "rb") as f:
        vocab = pickle.load(f)
    a = TripletBatcher(data["train"], Tokenizer(vocab), 16, 16, 32, length_buckets=[16, 24])
    b = JaxBatcher(data["train"], JaxTokenizer(vocab), 16, 16, 32, length_buckets=[16, 24])
    for x, y in zip(a.batches(seed=3), b.batches(seed=3)):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)
    assert len(a) == len(b)


def test_train_defaults_to_cuda_and_unported_options_raise(corpus, tmp_path):
    """train() asks for the card unless told the CPU; the mesh knobs a lone
    process cannot hold raise the mesh's ValueErrors; --profile_dir traces;
    SHARD_EMBEDDING_TABLE is dropped without a model group, as in JAX."""
    from pathlib import Path

    from twotowermlretrieval_tpu_torch.train.loop import train
    from twotowermlretrieval_tpu_torch.utils.profiling import trace_files
    from twotowermlretrieval_tpu_torch.utils.pytree import load_params_npz

    _, cfg = corpus
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train(cfg)
    # a data axis of 2 in a lone process: more ranks than the world holds
    with pytest.raises(ValueError, match="needs 2 ranks but the world holds 1"):
        train(cfg.replace(mesh_data=2), device="cpu")
    # a model axis of 2 in a lone process: the world does not split over it
    with pytest.raises(ValueError, match="not divisible by model=2"):
        train(cfg.replace(mesh_model=2), device="cpu")
    # --profile_dir is ported: a run of 16 steps ends inside the window that
    # opens at step 10, and the trace is finalized with the run
    res = train(cfg.replace(epochs=2), output_root=tmp_path / "out", device="cpu",
                profile_dir=tmp_path / "prof")
    assert res["steps"] == 16 and len(trace_files(tmp_path / "prof")) == 1
    # a lone process drops SHARD_EMBEDDING_TABLE, as the JAX driver does: the
    # run is the one without it, step for step, and exports the whole table
    for tower in ("rnn", "transformer"):
        kw = dict(tower_type=tower, num_heads=2, ffn_dim=32, freeze_embeddings=False)
        sharded = train(cfg.replace(shard_embedding_table=True, **kw),
                        output_root=tmp_path / f"{tower}-sharded", device="cpu")
        plain = train(cfg.replace(**kw), output_root=tmp_path / tower, device="cpu")
        assert sharded["step_losses"] == plain["step_losses"] and sharded["steps"] == 8
        whole = tuple(plain["state"].trainable["query"]["embedding"].shape)
        assert tuple(sharded["state"].trainable["query"]["embedding"].shape) == whole
        exported = load_params_npz(Path(sharded["artifacts_dir"]) / "model.npz")
        assert exported["query"]["embedding"].shape == whole
