"""The port's data-parallel path: two ranks on the CPU over gloo, each a
process (``tests/torch_parallel_runner.py``), against the port's one-device
step over the global batch and against JAX's ``shard_map`` step on a
two-device sub-mesh of the conftest's virtual devices.

The step cases take the model of the JAX package's own equivalence test
(``tests/test_parallel.py``: a 1-layer GRU tower, H=16, B=16 split 8 + 8,
f32, dropout 0) and its tolerances: the loss within 1e-6, the gradients
``atol=1e-6, rtol=1e-5``. ``train()`` runs 2-layer bidirectional towers
on a synthetic corpus; its metrics against one process within 1e-3
relative, as ``tests/test_multihost.py``.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from twotowermlretrieval_tpu.config import Config as JaxConfig
from twotowermlretrieval_tpu.data.batching import Batch as JaxBatch
from twotowermlretrieval_tpu.models.two_tower import TwoTowerSpec as JaxTwoTowerSpec
from twotowermlretrieval_tpu.models.two_tower import init_two_tower as jax_init_two_tower
from twotowermlretrieval_tpu.parallel.mesh import make_mesh as jax_make_mesh
from twotowermlretrieval_tpu.train.train_step import _forward_and_metrics as jax_forward
from twotowermlretrieval_tpu.train.train_step import merge_params as jax_merge
from twotowermlretrieval_tpu.train.train_step import partition_params as jax_partition
from twotowermlretrieval_tpu_torch.config import Config
from twotowermlretrieval_tpu_torch.data.batching import Batch
from twotowermlretrieval_tpu_torch.models.two_tower import TwoTowerSpec, params_from_jax
from twotowermlretrieval_tpu_torch.train.checkpoint import CheckpointManager
from twotowermlretrieval_tpu_torch.train.train_step import create_train_state, make_grad_step
from twotowermlretrieval_tpu_torch.utils.pytree import named_leaves, save_params_npz

ROOT = Path(__file__).resolve().parent.parent
RUNNER = Path(__file__).resolve().parent / "torch_parallel_runner.py"
VOCAB, EMBED, HIDDEN, B, TQ, TD = 64, 16, 16, 16, 8, 8
WAIT_S = 240

# (case, loss type, TRIPLET_METRICS, batch): "padded" has its 5
# zero-weight rows all on rank 1's half of the batch
CASES = [
    ("triplet", "triplet", True, "full"),
    ("triplet+in_batch", "triplet+in_batch", True, "full"),
    ("in_batch", "in_batch", False, "full"),
    ("padded", "triplet+in_batch", True, "padded"),
]
TRAIN = dict(hidden_dim=16, num_layers=2, bidirectional=True, lr=5e-3, length_buckets=[16, 24],
             steps_per_dispatch=2, log_every_steps=100, mesh_data=-1, seed=0)


def _config_kw(loss_type, triplet_metrics):
    return dict(
        vocab_size=VOCAB, embed_dim=EMBED, hidden_dim=HIDDEN, rnn_type="GRU", num_layers=1,
        bidirectional=False, dropout=0.0, batch_size=B, lr=1e-2, margin=0.5,
        max_query_len=TQ, max_doc_len=TD, compute_dtype="float32", freeze_embeddings=True,
        loss_type=loss_type, triplet_metrics=triplet_metrics, cross_device_negatives=True,
    )


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Pair:
    """Two rank processes of one spec. Logs go to files, not pipes: the
    parent waits on one rank while both run collectives, and a rank
    blocked on a full pipe would stall the other."""

    def __init__(self, out: Path, **spec):
        out.mkdir(parents=True, exist_ok=True)
        self.out = out
        spec = {"port": _free_port(), "world": 2, "out": str(out), **spec}
        (out / "spec.json").write_text(json.dumps(spec))
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        env.pop("PYTEST_CURRENT_TEST", None)
        self.logs = [open(out / f"rank{r}.log", "w+") for r in range(2)]
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
                             for r in range(2)]
        return self._results


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Inputs on disk and the two first pairs, started at once: ``steps``
    (the step cases, then ``train()`` at dropout 0) and ``straight`` (an
    uninterrupted two-epoch run at dropout 0.2 that checkpoints every 4
    steps)."""
    from twotowermlretrieval_tpu_torch.data.synthetic import generate_corpus

    root = tmp_path_factory.mktemp("torch_dp")
    generate_corpus(root / "corpus", num_queries=120, num_topics=12, words_per_topic=20,
                    embed_dim=16)
    rng = np.random.default_rng(0)
    table = (rng.standard_normal((VOCAB, EMBED)) * 0.3).astype(np.float32)
    jspec = JaxTwoTowerSpec.from_config(JaxConfig(**_config_kw("triplet", True)))
    params = jax.tree.map(np.asarray, jax_init_two_tower(jax.random.key(0), jspec,
                                                         pretrained_embeddings=table))
    save_params_npz(root / "params.npz", params)

    def tok(L):
        return (rng.integers(1, VOCAB, (B, L)).astype(np.int32),
                rng.integers(1, L + 1, (B,)).astype(np.int32))

    (q, ql), (p, pl), (n, nl) = tok(TQ), tok(TD), tok(TD)
    batches = {"full": (q, ql, p, pl, n, nl, np.ones(B, np.float32))}
    # a repeat-padded final batch as TripletBatcher makes it: rows 11-15
    # copy row 0 and weigh 0 (rank 1 holds rows 8-15)
    padded = [a.copy() for a in batches["full"]]
    for a in padded[:-1]:
        a[-5:] = a[0]
    padded[-1][-5:] = 0.0
    batches["padded"] = tuple(padded)
    inputs = {f"{name}/{i}": a for name, arrs in batches.items() for i, a in enumerate(arrs)}
    inputs["gather/x"] = rng.standard_normal((8, 5)).astype(np.float32)
    inputs["gather/q"] = rng.standard_normal((8, 5)).astype(np.float32)
    np.savez(root / "inputs.npz", **inputs)

    cases = [{"name": name, "batch": batch, "config": _config_kw(loss, tm)}
             for name, loss, tm, batch in CASES]
    steps = _Pair(root / "steps", jobs=["steps", "train"], params=str(root / "params.npz"),
                  inputs=str(root / "inputs.npz"), cases=cases, corpus=str(root / "corpus"),
                  train_config={**TRAIN, "dropout": 0.0, "epochs": 1})
    straight = _Pair(root / "straight", jobs=["train"], corpus=str(root / "corpus"),
                     checkpoint_dir=str(root / "ck"),
                     train_config={**TRAIN, "dropout": 0.2, "epochs": 2,
                                   "checkpoint_every_steps": 4})
    return {"root": root, "params": params, "batches": batches, "inputs": inputs,
            "steps": steps, "straight": straight}


def _port_single(params, case_kw, arrays):
    """The port's one-device gradient step over the global batch."""
    cfg = Config(**case_kw)
    state = create_train_state(torch.Generator().manual_seed(1), params_from_jax(params), cfg)
    grads, m = make_grad_step(TwoTowerSpec.from_config(cfg), cfg)(
        state, Batch(*[torch.from_numpy(a) for a in arrays]))
    names = [n for n, _ in named_leaves(state.trainable)]
    return ({k: float(v) for k, v in m.items()},
            {n: g.numpy() for n, g in zip(names, grads)})


def _jax_shard_map(params, case_kw, arrays):
    """JAX's data-parallel step body on a two-device 'data' mesh: the
    loss, the pmean of the gradients and of the metrics."""
    config = JaxConfig(**case_kw)
    spec = JaxTwoTowerSpec.from_config(config)
    trainable, frozen = jax_partition(jax.tree.map(jnp.asarray, params),
                                      config.freeze_embeddings)

    def fn(trainable, batch):
        def loss_fn(tr):
            return jax_forward(jax_merge(tr, frozen), batch, spec, config, None, train=False,
                               axis_name="data")

        (loss, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(trainable)
        return (jax.lax.pmean(loss, "data"), jax.lax.pmean(grads, "data"),
                jax.lax.pmean(metrics, "data"))

    mesh = jax_make_mesh(data=2, devices=jax.devices()[:2])
    batch_p = JaxBatch(*([P("data")] * len(JaxBatch._fields)))
    mapped = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(P(), batch_p),
                                   out_specs=(P(), P(), P()), check_vma=False))
    loss, grads, metrics = mapped(trainable, JaxBatch(*[jnp.asarray(a) for a in arrays]))
    flat = {n: np.asarray(g) for n, g in named_leaves(grads)}
    return float(loss), flat, {k: float(v) for k, v in metrics.items()}


@pytest.mark.parametrize("name,loss_type,triplet_metrics,batch", CASES,
                         ids=[c[0] for c in CASES])
def test_two_rank_step_matches_one_device_and_shard_map(setup, name, loss_type,
                                                        triplet_metrics, batch):
    """(a) The two ranks' loss, gradients and metrics equal the port's
    one-device step over the global batch; (b) and JAX's shard_map step on
    two devices, every metric included (in_batch_accuracy over each rank's
    local matrix); (c) with the padded rows all on rank 1."""
    kw = _config_kw(loss_type, triplet_metrics)
    arrays = setup["batches"][batch]
    jloss, jgrads, jmetrics = _jax_shard_map(setup["params"], kw, arrays)
    one_metrics, one_grads = _port_single(setup["params"], kw, arrays)
    ranks = setup["steps"].results()
    grads = [np.load(setup["steps"].out / f"rank{r}.npz") for r in range(2)]
    metrics = [r["steps"]["metrics"][name] for r in ranks]
    assert metrics[0] == metrics[1]  # every rank holds the global metrics
    assert sorted(metrics[0]) == sorted(jmetrics) == sorted(one_metrics)
    assert abs(metrics[0]["loss"] - one_metrics["loss"]) < 1e-6
    assert abs(metrics[0]["loss"] - jloss) < 1e-6
    for key in jmetrics:
        np.testing.assert_allclose(metrics[0][key], jmetrics[key], rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    assert sorted(one_grads) == sorted(jgrads)
    for leaf in one_grads:
        got = grads[0][f"{name}/grad/{leaf}"]
        np.testing.assert_array_equal(got, grads[1][f"{name}/grad/{leaf}"])
        np.testing.assert_allclose(got, one_grads[leaf], atol=1e-6, rtol=1e-5, err_msg=leaf)
        # against JAX the relative part is taken of the leaf's largest
        # magnitude: XLA and torch sum in other orders, and at an entry
        # where the batch's terms cancel (the padded case's query-tower
        # b_hh, |g| = 0.013) the port's ONE-device step already differs
        # from JAX by 1.2e-6
        err = np.abs(got - jgrads[leaf]).max()
        assert err <= 1e-6 + 1e-5 * np.abs(jgrads[leaf]).max(), (leaf, err)


def test_gather_backward_sums_over_ranks(setup):
    """(d) The gather's backward: each rank's rows get the sum over ranks
    of their cotangent, the single-process gradient of the whole product."""
    x = torch.from_numpy(setup["inputs"]["gather/x"]).requires_grad_(True)
    q = torch.from_numpy(setup["inputs"]["gather/q"])
    torch.log_softmax(q @ x.T, dim=-1).diagonal().sum().backward()
    setup["steps"].results()
    got = np.concatenate([np.load(setup["steps"].out / f"rank{r}.npz")["gather/grad"]
                          for r in range(2)])
    np.testing.assert_allclose(got, x.grad.numpy(), rtol=1e-6, atol=1e-7)


def test_two_process_train_matches_one_process_and_exports_once(setup, tmp_path):
    """(e) train() over two ranks: both report the same epoch metrics, the
    metrics of one process over the same batches, and only rank 0 exports;
    the port's engine serves the export."""
    from twotowermlretrieval_tpu_torch.data.synthetic import synthetic_config
    from twotowermlretrieval_tpu_torch.serve.engine import SearchEngine
    from twotowermlretrieval_tpu_torch.train.loop import train

    r0, r1 = (r["train"] for r in setup["steps"].results())
    e0, e1 = r0["epochs"][-1], r1["epochs"][-1]
    assert sorted(e0) == sorted(e1)
    for key in e0:
        assert e0[key] == pytest.approx(e1[key], rel=1e-6), key
    assert r0["step_losses"] == r1["step_losses"]
    cfg = synthetic_config(setup["root"] / "corpus", **{**TRAIN, "dropout": 0.0, "epochs": 1,
                                                        "mesh_data": 1})
    one = train(cfg, output_root=tmp_path, device="cpu")["epochs"][-1]
    for key in ("avg_train_loss", "avg_val_loss", "batch_MRR", "batch_Recall@10"):
        assert np.isfinite(e0[key]), key
        assert e0[key] == pytest.approx(one[key], rel=1e-3), key
    assert r0["artifacts_dir"] and r1["artifacts_dir"] is None
    assert not (setup["steps"].out / "artifacts" / "dp-1").exists()
    engine = SearchEngine(r0["artifacts_dir"], device="cpu")
    hit = engine.search("t1w3 t1w5", alpha=0.5)
    assert hit["results"] and np.isfinite(hit["results"][0]["score"])


def test_two_process_checkpoint_resumes_in_two_and_in_one(setup):
    """(f) Two fresh processes resume the two-process run's mid-epoch
    checkpoint and take exactly its remaining steps, with its losses, at
    dropout 0.2; one process (a world of one) restores the same
    checkpoint and carries on from its data position (elastic)."""
    from twotowermlretrieval_tpu_torch.data.synthetic import synthetic_config
    from twotowermlretrieval_tpu_torch.train.loop import train

    s0, s1 = (r["train"] for r in setup["straight"].results())
    straight = s0["step_losses"]
    assert straight == s1["step_losses"] and s0["steps"] == len(straight)
    root = setup["root"]
    steps = CheckpointManager(root / "ck").all_steps()
    resume_at = [s for s in steps if s < steps[-1]][-1]  # a mid-epoch checkpoint
    assert 0 < resume_at < len(straight) and resume_at % 4 == 0
    for name in ("ck2", "ck1"):
        shutil.copytree(root / "ck", root / name)
        shutil.rmtree(root / name / f"step_{steps[-1]:08d}")
    resumed = _Pair(root / "resumed", jobs=["train"], corpus=str(root / "corpus"),
                    checkpoint_dir=str(root / "ck2"), resume=True,
                    train_config={**TRAIN, "dropout": 0.2, "epochs": 2,
                                  "checkpoint_every_steps": 4})
    cfg = synthetic_config(root / "corpus", **{**TRAIN, "dropout": 0.2, "epochs": 2,
                                               "checkpoint_every_steps": 4, "mesh_data": 1})
    one = train(cfg, output_root=root / "one", checkpoint_dir=root / "ck1", resume=True,
                device="cpu")
    assert one["steps"] == len(straight) - resume_at and np.isfinite(one["step_losses"]).all()
    assert one["epochs"][-1]["avg_train_loss"] < s0["epochs"][0]["avg_train_loss"]
    r0, r1 = (r["train"] for r in resumed.results())
    assert r0["step_losses"] == r1["step_losses"] == straight[resume_at:]


def test_mesh_request_past_the_world_and_a_silent_coordinator_raise():
    """(g) MESH_DATA 2 in a lone process names the world size; an explicit
    coordinator that does not answer re-raises, where the argument-less
    call of a lone process passes."""
    import torch.distributed as dist

    from twotowermlretrieval_tpu_torch.parallel.mesh import (
        initialize_multihost,
        make_mesh,
        replicate_to_host,
        resolve_mesh,
    )

    assert resolve_mesh(1, 1) is None and resolve_mesh(-1, 1) is None
    mesh = make_mesh(-1, 1)  # a world of one: one rank, no group
    assert mesh.shape == {"data": 1, "model": 1} and mesh.data_group is None and mesh.is_lead
    host = replicate_to_host({"w": (torch.ones(2),)}, mesh)
    assert isinstance(host["w"][0], np.ndarray) and host["w"][0].tolist() == [1.0, 1.0]
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 ranks but the world holds 1"):
        resolve_mesh(2, 1)
    with pytest.raises(RuntimeError):
        initialize_multihost(f"127.0.0.1:{_free_port()}", num_processes=2, process_id=1,
                             device="cpu", timeout=timedelta(seconds=2))
    assert not dist.is_initialized()
    env = {k: os.environ.pop(k) for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
           if k in os.environ}
    try:
        initialize_multihost(device="cpu")  # a lone process: passed over
    finally:
        os.environ.update(env)
    assert not dist.is_initialized()
