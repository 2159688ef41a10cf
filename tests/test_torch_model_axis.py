"""The port's model axis: ranks on the CPU over gloo, each a process
(``tests/torch_parallel_runner.py``), against JAX's ``shard_map`` on a
1x2 (and 2x2) sub-mesh of the conftest's virtual devices, jitted, and
against one process holding the whole model.

Small shapes: towers of 1-2 layers, H=16, 2 heads of width 8, FFN 32,
V=64, E=16, B=16, T=8, f32 compute. The weights are JAX's init, carried
over by ``params_from_jax`` and cut to each rank's shard by
``shard_params``. Tolerances, as the JAX package's own tests
(``tests/test_parallel.py``) hold its sharded paths:

- the sharded lookup: out rtol 1e-6, its gradient rtol 1e-5 / atol 1e-6;
- the encodes (GRU over a sharded table, the tensor-parallel transformer
  over a sharded table, both attention routes): rtol 1e-5 / atol 1e-6;
- gradients (remat, the step): rtol 1e-4 / atol 1e-5; the step's loss
  within 1e-5 relative, ``grad_norm`` within 1e-4;
- ``train()`` over 1x2 against one process: its metrics within 1e-3
  relative (``tests/test_multihost.py``);
- checkpoints across mesh shapes, the export and the ranks' replicated
  leaves: bit for bit.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from twotowermlretrieval_tpu.config import Config as JaxConfig
from twotowermlretrieval_tpu.data.batching import Batch as JaxBatch
from twotowermlretrieval_tpu.models import rnn as jax_rnn
from twotowermlretrieval_tpu.models import transformer as jax_tf
from twotowermlretrieval_tpu.models.two_tower import TwoTowerSpec as JaxTwoTowerSpec
from twotowermlretrieval_tpu.models.two_tower import init_two_tower as jax_init_two_tower
from twotowermlretrieval_tpu.ops import attention as jax_attention
from twotowermlretrieval_tpu.parallel.distributed import (
    make_distributed_train_step as jax_dist_step,
)
from twotowermlretrieval_tpu.parallel.distributed import replicate_state as jax_replicate
from twotowermlretrieval_tpu.parallel.distributed import state_partition_specs as jax_specs
from twotowermlretrieval_tpu.parallel.distributed import transformer_tp_spec as jax_tp_spec
from twotowermlretrieval_tpu.parallel.embedding import sharded_embedding_lookup as jax_lookup
from twotowermlretrieval_tpu.parallel.mesh import make_mesh as jax_make_mesh
from twotowermlretrieval_tpu.parallel.mesh import put_global as jax_put_global
from twotowermlretrieval_tpu.train.train_step import _forward_and_metrics as jax_forward
from twotowermlretrieval_tpu.train.train_step import create_train_state as jax_create_state
from twotowermlretrieval_tpu.train.train_step import merge_params as jax_merge
from twotowermlretrieval_tpu_torch.config import Config
from twotowermlretrieval_tpu_torch.models.transformer import TransformerSpec, transformer_encode
from twotowermlretrieval_tpu_torch.models.two_tower import (
    TwoTowerSpec,
    init_two_tower,
    params_from_jax,
)
from twotowermlretrieval_tpu_torch.parallel.distributed import (
    partition_rules,
    shard_params,
    state_partition_specs,
)
from twotowermlretrieval_tpu_torch.train.checkpoint import CheckpointManager
from twotowermlretrieval_tpu_torch.train.train_step import create_train_state
from twotowermlretrieval_tpu_torch.utils.pytree import (
    flatten_params,
    load_params_npz,
    named_leaves,
    save_params_npz,
)

ROOT = Path(__file__).resolve().parent.parent
RUNNER = Path(__file__).resolve().parent / "torch_parallel_runner.py"
V, E, H, B, T = 64, 16, 16, 16, 8
WAIT_S = 240
TF_SPEC = dict(vocab_size=V, embed_dim=E, hidden_dim=H, num_layers=2, num_heads=2, ffn_dim=32,
               compute_dtype="float32", max_len=T)
GRU_SPEC = dict(vocab_size=V, embed_dim=E, hidden_dim=H, compute_dtype="float32")
TF_CASES = {"torch": {}, "fused": {"fused_attention": True},
            "remat": {"remat_blocks": True}}
TRAIN = dict(tower_type="transformer", hidden_dim=16, num_layers=1, num_heads=2, ffn_dim=32,
             lr=5e-3, length_buckets=[16, 24], steps_per_dispatch=2, log_every_steps=100,
             freeze_embeddings=False, dropout=0.0, epochs=1, seed=0, mesh_data=-1,
             checkpoint_every_steps=4)
# the GRU towers with a sharded, trained table (the learned-table configuration)
TRAIN_GRU = {**TRAIN, "tower_type": "rnn", "num_layers": 2, "bidirectional": True}


def _step_config(data, model):
    return dict(tower_type="transformer", vocab_size=V, embed_dim=E, hidden_dim=H,
                num_layers=2, num_heads=2, ffn_dim=32, batch_size=B, max_query_len=T,
                max_doc_len=T, compute_dtype="float32", dropout=0.0, lr=1e-2, margin=0.5,
                freeze_embeddings=False, loss_type="triplet+in_batch", triplet_metrics=True,
                cross_device_negatives=True, mesh_data=data, mesh_model=model,
                shard_embedding_table=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Ranks:
    """``world`` rank processes of one spec, logs to files (a rank blocked
    on a full pipe would stall the others' collectives), every wait timed
    out."""

    def __init__(self, out: Path, world: int, **spec):
        out.mkdir(parents=True, exist_ok=True)
        self.out, self.world = out, world
        spec = {"port": _free_port(), "world": world, "out": str(out), **spec}
        (out / "spec.json").write_text(json.dumps(spec))
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        env.pop("PYTEST_CURRENT_TEST", None)
        self.logs = [open(out / f"rank{r}.log", "w+") for r in range(world)]
        self.procs = [subprocess.Popen([sys.executable, str(RUNNER), str(out / "spec.json"),
                                        str(r)], stdout=log, stderr=subprocess.STDOUT,
                                       env=env, cwd=ROOT)
                      for r, log in enumerate(self.logs)]
        self._results = None

    def results(self):
        if self._results is None:
            try:
                for p in self.procs:
                    p.wait(timeout=WAIT_S)
            finally:
                for p in self.procs:
                    if p.poll() is None:
                        p.kill()
                    p.wait(timeout=30)
                texts = []
                for log in self.logs:
                    log.seek(0)
                    texts.append(log.read())
                    log.close()
            for r, (p, text) in enumerate(zip(self.procs, texts)):
                assert p.returncode == 0, f"rank {r} failed:\n{text[-4000:]}"
            self._results = [json.loads((self.out / f"rank{r}.json").read_text())
                             for r in range(self.world)]
        return self._results

    def arrays(self, name: str):
        self.results()
        return [np.load(self.out / f"rank{r}_{name}.npz") for r in range(self.world)]


def _batch_arrays(rng):
    def tok():
        return (rng.integers(1, V, (B, T)).astype(np.int32),
                rng.integers(1, T + 1, (B,)).astype(np.int32))

    (q, ql), (p, pl), (n, nl) = tok(), tok(), tok()
    return q, ql, p, pl, n, nl, np.ones(B, np.float32)


def _one_process_checkpoint(root: Path) -> dict:
    """A one-process state of the 1x2 step's config with every leaf
    non-trivial (moments drawn, count and step 7), saved as a checkpoint;
    returns its leaves by tree."""
    cfg = Config(**_step_config(1, 1))
    state = create_train_state(torch.Generator().manual_seed(5),
                               init_two_tower(torch.Generator().manual_seed(3),
                                              TwoTowerSpec.from_config(cfg)), cfg)
    gen = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for tree in (state.opt_state["mu"], state.opt_state["nu"]):
            for _, leaf in named_leaves(tree):
                leaf.copy_(torch.rand(leaf.shape, generator=gen))
    state.opt_state["count"].fill_(7)
    state.step = 7
    CheckpointManager(root / "ck_one").save(state, {"epoch": 1, "batch_index": 3})
    return {"trainable": flatten_params(state.trainable),
            "mu": flatten_params(state.opt_state["mu"]),
            "nu": flatten_params(state.opt_state["nu"])}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Inputs on disk, then a 1x2 pair (the encodes, the step, a restore,
    train()) and a 2x2 quad (the step), started at once."""
    from twotowermlretrieval_tpu_torch.data.synthetic import generate_corpus

    root = tmp_path_factory.mktemp("torch_model_axis")
    generate_corpus(root / "corpus", num_queries=120, num_topics=12, words_per_topic=20,
                    embed_dim=16)
    rng = np.random.default_rng(0)
    inputs = {
        "lookup/table": rng.standard_normal((V, E)).astype(np.float32),
        "lookup/tokens": rng.integers(0, V, (4, T)).astype(np.int32),
        "lookup/target": rng.standard_normal((4, T, E)).astype(np.float32),
        "enc/tokens": rng.integers(1, V, (4, T)).astype(np.int32),
        "enc/lengths": np.asarray([8, 5, 1, 0], np.int32),
        "enc/grad_lengths": np.asarray([8, 5, 1, 3], np.int32),
        "enc/ct": rng.standard_normal((4, H)).astype(np.float32),
    }
    inputs.update({f"step/{i}": a for i, a in enumerate(_batch_arrays(rng))})
    np.savez(root / "inputs.npz", **inputs)
    gru = jax.tree.map(np.asarray, jax_rnn.init_rnn_encoder(
        jax.random.key(0), jax_rnn.RNNSpec(**GRU_SPEC)))
    tf = jax.tree.map(np.asarray, jax_tf.init_transformer_encoder(
        jax.random.key(2), jax_tf.TransformerSpec(**TF_SPEC)))
    jcfg = JaxConfig(**_step_config(1, 2))
    step_params = jax.tree.map(np.asarray, jax_init_two_tower(
        jax.random.key(0), JaxTwoTowerSpec.from_config(jcfg)))
    for name, tree in (("gru", gru), ("tf", tf), ("step", step_params)):
        save_params_npz(root / f"{name}_params.npz", tree)
    one = _one_process_checkpoint(root)
    common = dict(inputs=str(root / "inputs.npz"), step_params=str(root / "step_params.npz"))
    pair = _Ranks(root / "pair", 2, mesh=[1, 2],
                  jobs=["model_axis", "tp_step", "restore", "train", "train_gru",
                        "train_gru_replicated"], **common,
                  gru_params=str(root / "gru_params.npz"), tf_params=str(root / "tf_params.npz"),
                  gru_spec={**GRU_SPEC, "embedding_axis": "model"},
                  tf_spec={**TF_SPEC, "model_axis": "model", "model_axis_size": 2,
                           "embedding_axis": "model"},
                  tf_cases=TF_CASES, dropout_seed=17, step_config=_step_config(1, 2),
                  ck_one=str(root / "ck_one"), corpus=str(root / "corpus"),
                  checkpoint_dir=str(root / "ck_pair"),
                  train_configs={
                      "train": {**TRAIN, "mesh_model": 2, "shard_embedding_table": True},
                      "train_gru": {**TRAIN_GRU, "mesh_model": 2, "shard_embedding_table": True},
                      "train_gru_replicated": {**TRAIN_GRU, "mesh_model": 2}})
    quad = _Ranks(root / "quad", 4, mesh=[2, 2], jobs=["tp_step"], **common,
                  step_config=_step_config(2, 2))
    return {"root": root, "inputs": inputs, "gru": gru, "tf": tf, "step_params": step_params,
            "one": one, "pair": pair, "quad": quad}


@pytest.fixture
def interpreted_jax_kernel():
    """The JAX fused attention with its kernel in interpret mode (CPU), as
    tests/test_torch_transformer.py runs it."""
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


def _mesh(data=1, model=2):
    return jax_make_mesh(data=data, model=model, devices=jax.devices()[: data * model])


def _param_specs(tree, shard_embedding=True, shard_transformer=True):
    def spec(path, leaf):
        names = {p.key for p in path if isinstance(p, jax.tree_util.DictKey)}
        if shard_embedding and "embedding" in names and leaf.ndim == 2:
            return P("model", None)
        return (jax_tp_spec(names, leaf) if shard_transformer else None) or P()

    return jax.tree_util.tree_map_with_path(spec, tree)


def _close(a, b, rtol, atol, what=""):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# the lookup and the encodes
# ---------------------------------------------------------------------------


def test_sharded_lookup_and_its_local_gradient_match_jax(setup):
    """Forward: every rank holds the full lookup; backward: each rank's
    gradient is its own rows of JAX's (shard_map with P('model', None)),
    and the backward ran no collective."""
    inputs = setup["inputs"]
    table, tokens, target = (jnp.asarray(inputs[f"lookup/{k}"])
                             for k in ("table", "tokens", "target"))
    mesh = _mesh()
    out = jax.jit(jax.shard_map(lambda t, tok: jax_lookup(t, tok, "model"), mesh=mesh,
                                in_specs=(P("model", None), P()), out_specs=P(),
                                check_vma=False))(table, tokens)

    def loss(shard):
        return jnp.sum((jax_lookup(shard, tokens, "model") - target) ** 2)

    grad = jax.jit(jax.shard_map(jax.grad(loss), mesh=mesh, in_specs=(P("model", None),),
                                 out_specs=P("model", None), check_vma=False))(table)
    ranks = setup["pair"].results()
    arrays = setup["pair"].arrays("model_axis")
    for r in range(2):
        assert ranks[r]["model_axis"]["backward_collectives"] == 0
        assert ranks[r]["model_axis"]["shard_rows"] == V // 2
        _close(arrays[r]["lookup/out"], np.asarray(out), 1e-6, 0)
        _close(arrays[r]["lookup/grad"], np.asarray(grad)[r * V // 2 : (r + 1) * V // 2],
               1e-5, 1e-6)


def test_gru_encode_through_a_sharded_table_matches_jax(setup):
    inputs = setup["inputs"]
    tokens, lengths = jnp.asarray(inputs["enc/tokens"]), jnp.asarray(inputs["enc/lengths"])
    spec = jax_rnn.RNNSpec(**GRU_SPEC, embedding_axis="model")
    params = jax.tree.map(jnp.asarray, setup["gru"])
    want = jax.jit(jax.shard_map(lambda p, t, l: jax_rnn.rnn_encode(p, t, l, spec),
                                 mesh=_mesh(), in_specs=(_param_specs(params, True, False),
                                                         P(), P()),
                                 out_specs=P(), check_vma=False))(params, tokens, lengths)
    dense = jax_rnn.rnn_encode(params, tokens, lengths, jax_rnn.RNNSpec(**GRU_SPEC))
    for got in setup["pair"].arrays("model_axis"):
        _close(got["gru"], np.asarray(want), 1e-5, 1e-6)
        _close(got["gru"], np.asarray(dense), 1e-5, 1e-6)


@pytest.mark.parametrize("case", ["torch", "fused"])
def test_tensor_parallel_encode_matches_jax_tp_and_replicated(setup, interpreted_jax_kernel,
                                                              case):
    """The two ranks' tensor-parallel encode over a sharded table, through
    the torch attention route or the fused one (the kernel's plain
    version on 2 x 1 local heads), against JAX's tensor-parallel encode
    under shard_map and its replicated encode; the ranks agree bit for
    bit."""
    inputs = setup["inputs"]
    tokens, lengths = jnp.asarray(inputs["enc/tokens"]), jnp.asarray(inputs["enc/lengths"])
    params = jax.tree.map(jnp.asarray, setup["tf"])
    kw = {k: v for k, v in TF_CASES[case].items()}
    spec_rep = jax_tf.TransformerSpec(**TF_SPEC, **kw)
    spec_tp = dataclasses.replace(spec_rep, model_axis="model", model_axis_size=2,
                                  embedding_axis="model")
    def encode(spec):  # through jax.vjp: its forward rule runs the kernel interpreted
        return lambda p, t, l: jax.vjp(
            lambda p: jax_tf.transformer_encode(p, t, l, spec), p)[0]

    tp = jax.jit(jax.shard_map(encode(spec_tp), mesh=_mesh(),
                               in_specs=(_param_specs(params), P(), P()),
                               out_specs=P(), check_vma=False))(params, tokens, lengths)
    rep = encode(spec_rep)(params, tokens, lengths)
    got = [a[f"tf/{case}"] for a in setup["pair"].arrays("model_axis")]
    np.testing.assert_array_equal(got[0], got[1])
    _close(got[0], np.asarray(tp), 1e-5, 1e-6)
    _close(got[0], np.asarray(rep), 1e-5, 1e-6)


def test_tensor_parallel_remat_gradients_match_replicated(setup):
    """remat_blocks under tensor parallelism re-runs the forward sums in the
    backward: the gathered gradients of sum(out * ct) equal JAX's
    replicated no-remat run's and its tensor-parallel remat run's."""
    inputs = setup["inputs"]
    tokens, lengths = jnp.asarray(inputs["enc/tokens"]), jnp.asarray(inputs["enc/grad_lengths"])
    ct = jnp.asarray(inputs["enc/ct"])
    params = jax.tree.map(jnp.asarray, setup["tf"])
    spec_rep = jax_tf.TransformerSpec(**TF_SPEC)
    spec_tp = dataclasses.replace(spec_rep, model_axis="model", model_axis_size=2,
                                  embedding_axis="model", remat_blocks=True)

    def loss(p, spec):
        return jnp.sum(jax_tf.transformer_encode(p, tokens, lengths, spec) * ct)

    _, ref = jax.value_and_grad(loss)(params, spec_rep)
    specs = _param_specs(params)
    _, tp = jax.jit(jax.shard_map(lambda p: jax.value_and_grad(loss)(p, spec_tp), mesh=_mesh(),
                                  in_specs=(specs,), out_specs=(P(), specs),
                                  check_vma=False))(params)
    arrays = setup["pair"].arrays("model_axis")
    for path, want in named_leaves(jax.tree.map(np.asarray, ref)):
        for a in arrays:
            _close(a[f"tf/remat/grad/{path}"], want, 1e-4, 1e-5, path)
    for path, want in named_leaves(jax.tree.map(np.asarray, tp)):
        _close(arrays[0][f"tf/remat/grad/{path}"], want, 1e-4, 1e-5, path)


def test_dropout_masks_agree_across_the_model_group(setup):
    """At dropout 0.25 both ranks' tensor-parallel encodes, from generators
    of one seed, are bit for bit equal and equal one process's encode of
    the whole model from that seed: the masks are [B, T, H] and drawn the
    same on every rank."""
    params = params_from_jax(setup["tf"])
    inputs = setup["inputs"]
    one = transformer_encode(params, torch.from_numpy(inputs["enc/tokens"]),
                             torch.from_numpy(inputs["enc/lengths"]),
                             TransformerSpec(**TF_SPEC, dropout=0.25), train=True,
                             generator=torch.Generator().manual_seed(17))
    got = [a["tf/dropout"] for a in setup["pair"].arrays("model_axis")]
    np.testing.assert_array_equal(got[0], got[1])
    _close(got[0], one.numpy(), 1e-5, 1e-6)
    assert not np.allclose(got[0], setup["pair"].arrays("model_axis")[0]["tf/torch"])


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def _jax_step(step_params, arrays, data, model):
    """JAX's distributed train step (loss, grad_norm) and the gradients of
    its shard_map body, gathered by their specs."""
    config = JaxConfig(**_step_config(data, model))
    spec = JaxTwoTowerSpec.from_config(config)
    mesh = _mesh(data, model)
    batch = JaxBatch(*[jnp.asarray(a) for a in arrays])
    state = jax_create_state(jax.random.key(1), jax.tree.map(jnp.asarray, step_params), config)
    specs = jax_specs(state, True, True)

    def grads_fn(trainable, batch):
        def loss_fn(tr):
            return jax_forward(jax_merge(tr, {}), batch, spec, config, None, train=False,
                               axis_name="data")

        (_, _), g = jax.value_and_grad(loss_fn, has_aux=True)(trainable)
        return jax.lax.pmean(g, "data")

    batch_specs = JaxBatch(*([P("data")] * len(JaxBatch._fields)))
    grads = jax.jit(jax.shard_map(grads_fn, mesh=mesh, in_specs=(specs.trainable, batch_specs),
                                  out_specs=specs.trainable, check_vma=False))(
        state.trainable, batch)
    placed = jax_replicate(state, mesh, shard_embedding=True, shard_transformer=True)
    dev_batch = jax.tree.map(lambda x: jax_put_global(x, NamedSharding(mesh, P("data"))), batch)
    _, metrics = jax_dist_step(spec, config, mesh, placed)(placed, dev_batch)
    return ({k: float(v) for k, v in metrics.items()},
            {p: np.asarray(g) for p, g in named_leaves(grads)})


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_sharded_step_matches_jax_shard_map(setup, mesh):
    """The tensor-parallel + sharded-table step (1x2: two ranks of 16 rows;
    2x2: data and model composed, 8 rows a data index): the loss, every
    metric and grad_norm against JAX's distributed step, the gathered
    gradients against its shard_map body's; after a second step at
    dropout 0.25 the replicated leaves agree bit for bit over the whole
    world, the split ones over the data group, and differ between the
    model group's shards."""
    data, model = map(int, mesh.split("x"))
    runs = setup["pair"] if data == 1 else setup["quad"]
    arrays = [setup["inputs"][f"step/{i}"] for i in range(7)]
    jmetrics, jgrads = _jax_step(setup["step_params"], arrays, data, model)
    ranks = [r["tp_step"] for r in runs.results()]
    grads = runs.arrays("tp_step")
    for r, res in enumerate(ranks):
        m = res["metrics"]
        assert m == ranks[0]["metrics"]
        assert m["loss"] == pytest.approx(jmetrics["loss"], rel=1e-5)
        assert m["grad_norm"] == pytest.approx(jmetrics["grad_norm"], rel=1e-4)
        for key in jmetrics:
            _close(m[key], jmetrics[key], 1e-5, 1e-6, key)
        assert res["state_agrees"] and res["split_differ_over_model"]
        assert sorted(k[len("grad/"):] for k in grads[r]) == sorted(jgrads)
        for path, want in jgrads.items():
            _close(grads[r][f"grad/{path}"], want, 1e-4, 1e-5, path)


def test_state_partition_specs_follow_jax():
    """Every leaf's split dimension is the one JAX's PartitionSpec names
    'model' in, the moments mirroring the params; a table whose rows do
    not split over the model axis raises as JAX refuses to place it."""
    cfg = _step_config(1, 2)
    jstate = jax_create_state(jax.random.key(1), jax_init_two_tower(
        jax.random.key(0), JaxTwoTowerSpec.from_config(JaxConfig(**cfg))), JaxConfig(**cfg))
    jspecs = jax_specs(jstate, True, True)
    pstate = create_train_state(torch.Generator().manual_seed(0), init_two_tower(
        torch.Generator().manual_seed(0), TwoTowerSpec.from_config(Config(**cfg))), Config(**cfg))
    ours = state_partition_specs(pstate, True, True)
    for tree in ("trainable", "mu", "nu"):
        jtree = jspecs.trainable if tree == "trainable" else getattr(jspecs.opt_state[1][0], tree)
        flat = jax.tree_util.tree_flatten_with_path(jtree, is_leaf=lambda x: isinstance(x, P))
        want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
                (tuple(s).index("model") if "model" in tuple(s) else None)
                for path, s in flat[0]}
        assert ours[tree] == want, tree
    rules = partition_rules(True, True)
    table = torch.zeros(V + 1, E)
    with pytest.raises(ValueError, match="does not split evenly over the model axis"):
        shard_params({"query": {"embedding": table}}, rules, 0, 2)
    with pytest.raises(Exception):
        jax.device_put(np.zeros((V + 1, E), np.float32), NamedSharding(_mesh(), P("model", None)))
    # the legacy [H, 3H] qkv layout is made head-major before it is cut
    legacy = {"blocks": ({"qkv": {"w": torch.arange(H * 3 * H, dtype=torch.float32)
                                  .reshape(H, 3 * H), "b": torch.arange(3 * H,
                                                                        dtype=torch.float32)}},)}
    cut = shard_params(legacy, rules, 1, 2)["blocks"][0]["qkv"]
    full = legacy["blocks"][0]["qkv"]
    assert torch.equal(cut["w"], full["w"].reshape(H, 3, H)[:, :, H // 2 :])
    assert torch.equal(cut["b"], full["b"].reshape(3, H)[:, H // 2 :])


# ---------------------------------------------------------------------------
# train(), checkpoints across meshes, the export
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("job", ["train", "train_gru", "train_gru_replicated"])
def test_one_by_two_train_matches_one_process_and_exports_the_gathered_params(setup,
                                                                              tmp_path, job):
    """train() over a 1x2 mesh (config 5's form: transformer heads and the
    table split; the GRU towers with the table split; the GRU towers
    replicated over the model group, as in JAX) against one process over
    the same batches: both ranks report the same metrics, within 1e-3
    relative of one process's; rank 0's export holds the gathered params
    bit for bit and serves in one process."""
    from twotowermlretrieval_tpu_torch.data.synthetic import synthetic_config
    from twotowermlretrieval_tpu_torch.serve.engine import SearchEngine
    from twotowermlretrieval_tpu_torch.train.loop import train

    r0, r1 = (r[job] for r in setup["pair"].results())
    assert r0["step_losses"] == r1["step_losses"]
    e0 = r0["epochs"][-1]
    assert e0 == r1["epochs"][-1]
    cfg = synthetic_config(setup["root"] / "corpus",
                           **{**(TRAIN if job == "train" else TRAIN_GRU), "mesh_model": 1,
                              "shard_embedding_table": True})
    one = train(cfg, output_root=tmp_path, device="cpu")["epochs"][-1]
    for key in ("avg_train_loss", "avg_val_loss", "batch_MRR", "batch_Recall@10"):
        assert np.isfinite(e0[key]), key
        assert e0[key] == pytest.approx(one[key], rel=1e-3), key
    final = setup["pair"].arrays(job)
    exported = flatten_params(load_params_npz(Path(r0["artifacts_dir"]) / "model.npz"))
    assert r1["artifacts_dir"] is None
    assert sorted(exported) == sorted(k[len("trainable/"):] for k in final[0].files
                                      if k.startswith("trainable/"))
    for key, value in exported.items():
        np.testing.assert_array_equal(value, final[0][f"trainable/{key}"], err_msg=key)
        np.testing.assert_array_equal(value, final[1][f"trainable/{key}"], err_msg=key)
    shards = [f["shard/trainable/query/embedding"] for f in final]
    if job == "train_gru_replicated":  # every rank holds the whole table
        for shard in shards:
            np.testing.assert_array_equal(shard, exported["query/embedding"])
    else:
        np.testing.assert_array_equal(np.concatenate(shards), exported["query/embedding"])
    config = json.loads((Path(r0["artifacts_dir"]) / "config.json").read_text())
    assert config["MESH_MODEL"] == 1 and config["SHARD_EMBEDDING_TABLE"] is False
    hit = SearchEngine(r0["artifacts_dir"], device="cpu").search("t1w3 t1w5", alpha=0.5)
    assert hit["results"] and np.isfinite(hit["results"][0]["score"])


def test_checkpoints_cross_mesh_shapes_bit_for_bit(setup):
    """1x2 -> 1x1: one process restores the pair's last checkpoint and holds
    its gathered final state bit for bit. 1x1 -> 1x2: each rank restores a
    one-process checkpoint into its shards, bit for bit its slice of the
    one-process state, and the pair's save of it is the same file's
    state."""
    from twotowermlretrieval_tpu_torch.data.synthetic import synthetic_config
    from twotowermlretrieval_tpu_torch.train.loop import setup as loop_setup

    root = setup["root"]
    cfg = synthetic_config(root / "corpus", **{**TRAIN, "mesh_model": 1})
    cfg, _, table = loop_setup(cfg)
    template = create_train_state(torch.Generator().manual_seed(0), init_two_tower(
        torch.Generator().manual_seed(1), TwoTowerSpec.from_config(cfg), table), cfg)
    state, position = CheckpointManager(root / "ck_pair").restore(template)
    final = setup["pair"].arrays("train")[0]
    trees = {"trainable": state.trainable, "mu": state.opt_state["mu"],
             "nu": state.opt_state["nu"]}
    for name, tree in trees.items():
        for path, leaf in named_leaves(tree):
            np.testing.assert_array_equal(leaf.detach().numpy(), final[f"{name}/{path}"],
                                          err_msg=f"{name}/{path}")
    assert position == {"epoch": 1, "batch_index": 0, "grouping": "per-width-v1"}

    ranks = setup["pair"].results()
    restored = setup["pair"].arrays("restored")
    rules = partition_rules(True, True)
    for r in range(2):
        assert ranks[r]["restore"]["step"] == 7
        assert ranks[r]["restore"]["position"] == {"epoch": 1, "batch_index": 3}
        for name, flat in setup["one"].items():
            cut = flatten_params(shard_params(
                {k: torch.from_numpy(v) for k, v in flat.items()}, rules, r, 2))
            for path, value in cut.items():
                np.testing.assert_array_equal(restored[r][f"{name}/{path}"], value,
                                              err_msg=f"rank {r} {name}/{path}")
    again = torch.load(setup["pair"].out / "ck_mesh" / "step_00000007" / "state.pt",
                       weights_only=True)
    orig = torch.load(root / "ck_one" / "step_00000007" / "state.pt", weights_only=True)
    for name in ("trainable", "frozen"):
        assert sorted(again[name]) == sorted(orig[name])
        for key in orig[name]:
            assert torch.equal(again[name][key], orig[name][key]), key
    for name in ("mu", "nu"):
        for key in orig["opt_state"][name]:
            assert torch.equal(again["opt_state"][name][key], orig["opt_state"][name][key])
    assert again["step"] == orig["step"] == 7
