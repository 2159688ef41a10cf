"""One rank of a multi-process run of the PyTorch port, on the CPU over
gloo; launched by ``tests/test_torch_parallel.py`` and
``tests/test_torch_model_axis.py``:

    python tests/torch_parallel_runner.py <spec.json> <rank>

The spec names the coordinator port, the world size, the mesh (``mesh``:
[data, model], default [world, 1]), the output directory and the jobs,
run in order: ``steps`` (the data-parallel gradient step on this rank's
rows of the saved batches, for each case, and the gather's backward),
``train`` (``train/loop.py:train`` on a synthetic corpus; ``train_<name>``
with ``train_configs[name]``), and on the
model axis ``model_axis`` (the sharded lookup, the towers' encodes),
``tp_step`` (the sharded train step's gradients and metrics) and
``restore`` (a one-process checkpoint restored into this rank's shards
and saved again). Results go to ``<out>/rank<r>.json`` (one entry a job)
and ``<out>/rank<r>.npz``. Imports no JAX.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch


def _steps(spec, rank, mesh, out):
    from twotowermlretrieval_tpu_torch.config import Config
    from twotowermlretrieval_tpu_torch.data.batching import Batch
    from twotowermlretrieval_tpu_torch.models.two_tower import TwoTowerSpec, params_from_jax
    from twotowermlretrieval_tpu_torch.parallel.collectives import all_gather_rows
    from twotowermlretrieval_tpu_torch.parallel.distributed import replicate_state
    from twotowermlretrieval_tpu_torch.parallel.mesh import put_global
    from twotowermlretrieval_tpu_torch.train.train_step import create_train_state, make_grad_step
    from twotowermlretrieval_tpu_torch.utils.pytree import load_params_npz, named_leaves

    params = load_params_npz(spec["params"])
    inputs = np.load(spec["inputs"])
    arrays, metrics = {}, {}
    for case in spec["cases"]:
        cfg = Config(**case["config"])
        state = replicate_state(
            create_train_state(torch.Generator().manual_seed(1), params_from_jax(params), cfg),
            mesh)
        batch = Batch(*[put_global(inputs[f"{case['batch']}/{i}"], mesh, "cpu")
                        for i in range(len(Batch._fields))])
        grads, m = make_grad_step(TwoTowerSpec.from_config(cfg), cfg, mesh.data_group)(
            state, batch)
        names = [n for n, _ in named_leaves(state.trainable)]
        for n, g in zip(names, grads):
            arrays[f"{case['name']}/grad/{n}"] = g.numpy()
        metrics[case["name"]] = {k: float(v) for k, v in m.items()}

    # the gather's backward: local queries against every rank's rows
    x = put_global(inputs["gather/x"], mesh, "cpu").requires_grad_(True)
    q = put_global(inputs["gather/q"], mesh, "cpu")
    rows = all_gather_rows(x, mesh.data_group)
    torch.log_softmax(q @ rows.T, dim=-1).diagonal(offset=mesh.rank * q.shape[0]).sum().backward()
    arrays["gather/grad"] = x.grad.numpy()
    np.savez(out / f"rank{rank}.npz", **arrays)
    return {"metrics": metrics}


def _train(spec, rank, out, job="train"):
    from twotowermlretrieval_tpu_torch.data.synthetic import synthetic_config
    from twotowermlretrieval_tpu_torch.parallel.distributed import gather_params, rules_for
    from twotowermlretrieval_tpu_torch.parallel.mesh import resolve_mesh
    from twotowermlretrieval_tpu_torch.train.loop import train
    from twotowermlretrieval_tpu_torch.utils.pytree import flatten_params

    cfg = synthetic_config(spec["corpus"], **spec.get("train_configs", {}).get(
        job, spec.get("train_config")))
    res = train(cfg, output_root=out / "artifacts", run_name=f"dp-{rank}" if job == "train"
                else f"{job}-{rank}", checkpoint_dir=spec.get("checkpoint_dir") if job == "train"
                else None, resume=spec.get("resume", False), device="cpu")
    if cfg.mesh_model > 1:  # the final state, gathered whole, and this rank's shards
        mesh = resolve_mesh(cfg.mesh_data, cfg.mesh_model)
        st = res["state"]
        trees = {"trainable": st.trainable, "frozen": st.frozen,
                 "mu": st.opt_state["mu"], "nu": st.opt_state["nu"]}
        whole = {k: gather_params(t, rules_for(cfg, mesh), mesh.model_group)
                 for k, t in trees.items()}
        np.savez(out / f"rank{rank}_{job}.npz", **flatten_params(whole),
                 **{f"shard/{k}": v for k, v in flatten_params(trees).items()})
    return {"epochs": res["epochs"], "steps": res["steps"], "step_losses": res["step_losses"],
            "artifacts_dir": res.get("artifacts_dir")}


class _Collectives:
    """Counts this process's all-reduce and all-gather calls while on."""

    def __init__(self):
        import torch.distributed as dist

        self.dist, self.calls, self.on = dist, 0, False
        for name in ("all_reduce", "all_gather_into_tensor"):
            def counted(*a, _fn=getattr(dist, name), **k):
                self.calls += self.on
                return _fn(*a, **k)
            setattr(dist, name, counted)


def _model_axis(spec, rank, mesh, out):
    """The sharded lookup's output and gradient (collectives in its
    backward counted), the GRU encode through a sharded table, the
    transformer's tensor-parallel encodes (both attention routes, a
    sharded table), its gradients under remat, and a dropout encode."""
    from twotowermlretrieval_tpu_torch.models.rnn import RNNSpec, rnn_encode
    from twotowermlretrieval_tpu_torch.models.transformer import (
        TransformerSpec,
        transformer_encode,
    )
    from twotowermlretrieval_tpu_torch.models.two_tower import params_from_jax
    from twotowermlretrieval_tpu_torch.parallel.distributed import (
        gather_params,
        partition_rules,
        shard_params,
    )
    from twotowermlretrieval_tpu_torch.parallel.embedding import sharded_embedding_lookup
    from twotowermlretrieval_tpu_torch.utils.pytree import (
        flatten_params,
        load_params_npz,
        named_leaves,
        tree_map,
    )

    inputs = np.load(spec["inputs"])
    group, index, size = mesh.model_group, mesh.model_index, mesh.model
    counter = _Collectives()
    arrays = {}

    def shard(tree, rules):
        return tree_map(lambda t: t.clone(), shard_params(tree, rules, index, size))

    table = torch.from_numpy(inputs["lookup/table"])
    mine = shard({"embedding": table}, partition_rules(True))["embedding"].requires_grad_(True)
    x = sharded_embedding_lookup(mine, torch.from_numpy(inputs["lookup/tokens"]), group)
    loss = torch.sum((x - torch.from_numpy(inputs["lookup/target"])) ** 2)
    counter.on = True
    loss.backward()
    counter.on = False
    arrays["lookup/out"], arrays["lookup/grad"] = x.detach().numpy(), mine.grad.numpy()
    backward_collectives = counter.calls

    tokens, lengths = (torch.from_numpy(inputs[k]) for k in ("enc/tokens", "enc/lengths"))
    gru = shard(params_from_jax(load_params_npz(spec["gru_params"])), partition_rules(True))
    arrays["gru"] = rnn_encode(gru, tokens, lengths, RNNSpec(**spec["gru_spec"]),
                               model_group=group).detach().numpy()

    tf_full = params_from_jax(load_params_npz(spec["tf_params"]))
    tf = shard(tf_full, partition_rules(True, True))
    ct = torch.from_numpy(inputs["enc/ct"])
    for name, kw in spec["tf_cases"].items():
        tspec = TransformerSpec(**{**spec["tf_spec"], **kw})
        leaves = [t.requires_grad_(True) for _, t in named_leaves(tf)]
        # gradients on rows of length > 0 (JAX's are NaN at a zero-length row)
        lens = torch.from_numpy(inputs["enc/grad_lengths"]) if tspec.remat_blocks else lengths
        out_ = transformer_encode(tf, tokens, lens, tspec, model_group=group)
        arrays[f"tf/{name}"] = out_.detach().numpy()
        if tspec.remat_blocks:
            grads = torch.autograd.grad(torch.sum(out_ * ct), leaves)
            paths = [p for p, _ in named_leaves(tf)]
            gathered = gather_params(dict(zip(paths, grads)), partition_rules(True, True), group)
            for p, g in gathered.items():
                arrays[f"tf/{name}/grad/{p}"] = g.numpy()
        for t in leaves:
            t.requires_grad_(False)
    # dropout: the ranks share their generator's seed, so their masks
    gen = torch.Generator().manual_seed(spec["dropout_seed"])
    tspec = TransformerSpec(**{**spec["tf_spec"], "embedding_axis": "model", "dropout": 0.25})
    arrays["tf/dropout"] = transformer_encode(tf, tokens, lengths, tspec, train=True,
                                              generator=gen, model_group=group).numpy()
    np.savez(out / f"rank{rank}_model_axis.npz", **arrays)
    return {"backward_collectives": backward_collectives,
            "shard_rows": int(mine.shape[0]),
            "tf_shapes": {k: list(v.shape) for k, v in flatten_params(tf).items()}}


def _tp_step(spec, rank, mesh, out):
    """One train step of the sharded towers over this rank's rows: the
    gradients (gathered whole), the metrics, and the step's grad_norm;
    the replicated leaves' checksums over the world after a second step."""
    from twotowermlretrieval_tpu_torch.config import Config
    from twotowermlretrieval_tpu_torch.data.batching import Batch
    from twotowermlretrieval_tpu_torch.models.two_tower import TwoTowerSpec, params_from_jax
    from twotowermlretrieval_tpu_torch.parallel.collectives import all_gather_rows
    from twotowermlretrieval_tpu_torch.parallel.distributed import (
        gather_params,
        leaf_checksums,
        make_distributed_train_step,
        replicate_state,
        rules_for,
        state_agrees,
    )
    from twotowermlretrieval_tpu_torch.parallel.mesh import put_global
    from twotowermlretrieval_tpu_torch.train.train_step import create_train_state, make_grad_step
    from twotowermlretrieval_tpu_torch.utils.pytree import load_params_npz, named_leaves

    cfg = Config(**spec["step_config"])
    tspec = TwoTowerSpec.from_config(cfg)
    inputs = np.load(spec["inputs"])
    batch = Batch(*[put_global(inputs[f"step/{i}"], mesh, "cpu")
                    for i in range(len(Batch._fields))])

    def fresh():
        st = create_train_state(torch.Generator().manual_seed(1),
                                params_from_jax(load_params_npz(spec["step_params"])), cfg)
        return replicate_state(st, mesh, rules)

    rules = rules_for(cfg, mesh)
    state = fresh()
    grads, m = make_grad_step(tspec, cfg, mesh.data_group, mesh.model_group)(state, batch)
    paths = [p for p, _ in named_leaves(state.trainable)]
    whole = gather_params(dict(zip(paths, grads)), rules, mesh.model_group)
    arrays = {f"grad/{p}": g.numpy() for p, g in whole.items()}
    step = make_distributed_train_step(tspec, cfg, mesh)
    state, metrics = step(state, batch)
    result = {"metrics": {k: float(v) for k, v in metrics.items()}}
    # a second step at dropout 0.25, then the replicated leaves' bits
    # against every rank's, the split ones' against the data group's and
    # the model group's (its shards differ)
    dcfg = cfg.replace(dropout=0.25)
    state, _ = make_distributed_train_step(TwoTowerSpec.from_config(dcfg), dcfg, mesh)(
        state, batch)
    result["state_agrees"] = state_agrees(state, mesh, rules)
    split = leaf_checksums({p: t for p, t in named_leaves(state.trainable)
                            if rules(p, t) is not None})
    result["split_differ_over_model"] = not bool(
        (all_gather_rows(split[None], mesh.model_group) == split[None]).all())
    np.savez(out / f"rank{rank}_tp_step.npz", **arrays)
    return result


def _restore(spec, rank, mesh, out):
    """A one-process checkpoint restored into this rank's shards (saved),
    then saved again from the mesh into ``<out>/ck_mesh``."""
    from twotowermlretrieval_tpu_torch.config import Config
    from twotowermlretrieval_tpu_torch.models.two_tower import TwoTowerSpec, init_two_tower
    from twotowermlretrieval_tpu_torch.parallel.distributed import (
        replicate_state,
        rules_for,
    )
    from twotowermlretrieval_tpu_torch.train.checkpoint import CheckpointManager
    from twotowermlretrieval_tpu_torch.train.train_step import create_train_state
    from twotowermlretrieval_tpu_torch.utils.pytree import flatten_params

    cfg = Config(**spec["step_config"])
    rules = rules_for(cfg, mesh)
    template = replicate_state(
        create_train_state(torch.Generator().manual_seed(5),
                           init_two_tower(torch.Generator().manual_seed(9),
                                          TwoTowerSpec.from_config(cfg)), cfg),
        mesh, rules)
    state, position = CheckpointManager(spec["ck_one"], mesh=mesh, rules=rules).restore(template)
    trees = {"trainable": state.trainable, "frozen": state.frozen,
             "mu": state.opt_state["mu"], "nu": state.opt_state["nu"]}
    np.savez(out / f"rank{rank}_restored.npz", **flatten_params(trees))
    CheckpointManager(out / "ck_mesh", mesh=mesh, rules=rules).save(state, position)
    return {"step": state.step, "position": position}


def main():
    spec = json.loads(Path(sys.argv[1]).read_text())
    rank = int(sys.argv[2])
    torch.set_num_threads(1)
    import torch.distributed as dist

    from twotowermlretrieval_tpu_torch.parallel.mesh import initialize_multihost, make_mesh

    initialize_multihost(f"127.0.0.1:{spec['port']}", num_processes=spec["world"],
                         process_id=rank, device="cpu")
    out = Path(spec["out"])
    result = {}
    jobs = {"model_axis": _model_axis, "tp_step": _tp_step, "restore": _restore}
    try:
        for job in spec["jobs"]:
            if job == "steps":
                result[job] = _steps(spec, rank, make_mesh(spec["world"], 1), out)
            elif job.startswith("train"):
                result[job] = _train(spec, rank, out, job)
            else:
                result[job] = jobs[job](spec, rank, make_mesh(*spec["mesh"]), out)
    finally:
        dist.destroy_process_group()
    (out / f"rank{rank}.json").write_text(json.dumps(result))


if __name__ == "__main__":
    main()
