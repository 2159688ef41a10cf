"""One rank of a two-process data-parallel run of the PyTorch port, on the
CPU over gloo; launched by ``tests/test_torch_parallel.py``:

    python tests/torch_parallel_runner.py <spec.json> <rank>

The spec names the coordinator port, the world size, the output directory
and the jobs, run in order: ``steps`` (the data-parallel gradient step on
this rank's rows of the saved batches, for each case, and the gather's
backward) and ``train`` (``train/loop.py:train`` on a synthetic corpus).
Results go to ``<out>/rank<r>.json`` (one entry a job) and
``<out>/rank<r>.npz``. Imports no JAX.
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


def _train(spec, rank, out):
    from twotowermlretrieval_tpu_torch.data.synthetic import synthetic_config
    from twotowermlretrieval_tpu_torch.train.loop import train

    cfg = synthetic_config(spec["corpus"], **spec["train_config"])
    res = train(cfg, output_root=out / "artifacts", run_name=f"dp-{rank}",
                checkpoint_dir=spec.get("checkpoint_dir"), resume=spec.get("resume", False),
                device="cpu")
    return {"epochs": res["epochs"], "steps": res["steps"], "step_losses": res["step_losses"],
            "artifacts_dir": res.get("artifacts_dir")}


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
    try:
        for job in spec["jobs"]:
            if job == "steps":
                result[job] = _steps(spec, rank, make_mesh(spec["world"], 1), out)
            else:
                result[job] = _train(spec, rank, out)
    finally:
        dist.destroy_process_group()
    (out / f"rank{rank}.json").write_text(json.dumps(result))


if __name__ == "__main__":
    main()
