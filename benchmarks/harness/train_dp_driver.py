"""The driver of data-parallel training cells: ``world`` processes, one a
card, over NCCL, each running the port's data-parallel step on its rows
of every global batch.

The process the benchmark starts is rank 0: it picks a free local port,
starts ranks 1.. as children of its own (``python3 -m
benchmarks.harness.train_dp_driver --worker ...``), and every rank then
does what ``train/loop.py`` does under a mesh: ``initialize_multihost``
(``tcp://localhost:<port>``), the mesh of ``MESH_DATA`` x ``MESH_MODEL``
ranks, the same seed-made state on every rank (``replicate_state``), the
step ``make_sharded_packed_train_step`` builds, and each packed group
copied as this rank's rows (``put_global`` over the mesh). Set-up, window
and check are ``harness/train_driver.py``'s; the window ends on the group
where rank 0's clock passes ``seconds`` (rank 0 sends its answer over a
gloo group after every group). A traced run traces every rank: the busy
time is their mean, the other readings rank 0's. Rank 0 waits for every
child and fails if one fails. The reference follows rank 0's
first steps at the global batch, with every rank's dropout masks.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import torch

from benchmarks.harness.train_driver import TrainRun

ROOT = Path(__file__).resolve().parents[2]
CHILD_TIMEOUT_S = 300


class DPTrainRun(TrainRun):
    def __init__(self, model: dict, mix: dict, seed: int, device, rank: int, world: int,
                 port: int):
        import torch.distributed as dist

        from twotowermlretrieval_tpu_torch.models.two_tower import TwoTowerSpec
        from twotowermlretrieval_tpu_torch.parallel.distributed import (
            make_distributed_train_step,
            replicate_state,
            rules_for,
        )
        from twotowermlretrieval_tpu_torch.parallel.mesh import (
            initialize_multihost,
            rank_device,
            resolve_mesh,
        )

        self.rank, self.world = rank, world
        os.environ["LOCAL_RANK"] = str(rank)
        initialize_multihost(f"localhost:{port}", num_processes=world, process_id=rank,
                             device=device)
        dev = rank_device(device)
        self.flags = dist.new_group(backend="gloo")
        super().__init__(model, mix, seed, dev)
        self.mesh = resolve_mesh(self.config.mesh_data, self.config.mesh_model)
        self.state = replicate_state(self.state, self.mesh, rules_for(self.config, self.mesh))
        self.step = make_distributed_train_step(TwoTowerSpec.from_config(self.config),
                                                self.config, self.mesh)

    def stop(self, elapsed: bool) -> bool:
        import torch.distributed as dist

        flag = torch.tensor([1 if elapsed else 0], dtype=torch.int32)
        dist.broadcast(flag, src=0, group=self.flags)
        return bool(flag.item())

    def close(self):
        import torch.distributed as dist

        if dist.is_initialized():
            dist.barrier(group=self.flags)
            dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def trace_path(tmpdir: str, tag: str, rank: int) -> str:
    return os.path.join(tmpdir, f"bench_trace_{tag}_rank{rank}.json")


def run_rank(cell: dict, model: dict, mix: dict, seed: int, seconds: float, trace: bool,
             device, rank: int, world: int, port: int, t_start: float, tmpdir: str,
             tag: str) -> dict:
    run = DPTrainRun(model, mix, seed, device, rank, world, port)
    run.setup()
    setup_s = time.perf_counter() - t_start
    win = run.window(seconds)
    out = {"e2e": {"train_examples_per_s": win["examples"] / win["wall_s"], "setup_s": setup_s},
           "window": win, "model": model}
    if trace:
        path = trace_path(tmpdir, tag, rank)
        out["traced_steps"] = run.traced(int(cell.get("trace_groups", 2)), path)
        out["trace_path"] = path
    out["attempted"], out["failed"] = run.finite_losses()
    dev = run.dev
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                                else 0)
    run.close()
    run.free()
    if rank == 0:
        out["numbers"] = run.check(ranks=world)
    return out


def run_cell(cell: dict, model: dict, mix: dict, seed: int, seconds: float, trace: bool,
             device, t_start: float, tmpdir: str, overrides: dict = None) -> dict:
    """Rank 0: start the other ranks, run rank 0, wait for them all."""
    world = int(cell["world"])
    port = _free_port()
    tag = str(os.getpid())
    children, logs = [], []
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.environ.get("PYTHONPATH"), str(ROOT)) if p))
    for r in range(1, world):
        log = open(os.path.join(tmpdir, f"bench_rank{r}_{os.getpid()}.log"), "w")
        args = {"cell": cell, "model": model, "mix": mix, "seed": seed, "seconds": seconds,
                "trace": trace, "device": device, "rank": r, "world": world, "port": port,
                "tmpdir": tmpdir, "tag": tag}
        children.append(subprocess.Popen(
            [sys.executable, "-m", "benchmarks.harness.train_dp_driver", "--worker",
             json.dumps(args)], cwd=str(ROOT), env=env, stdout=log, stderr=subprocess.STDOUT))
        logs.append(log)
    try:
        out = run_rank(cell, model, mix, seed, seconds, trace, device, 0, world, port, t_start,
                       tmpdir, tag)
    finally:
        codes = []
        for p in children:
            try:
                codes.append(p.wait(timeout=CHILD_TIMEOUT_S))
            except subprocess.TimeoutExpired:
                p.kill()
                codes.append(p.wait())
        for r, (log, code) in enumerate(zip(logs, codes), start=1):
            log.close()
            if code != 0:
                sys.stderr.write(f"rank {r} exited {code}:\n"
                                 + Path(log.name).read_text()[-3000:])
            Path(log.name).unlink(missing_ok=True)
    bad = [(r, c) for r, c in enumerate(codes, start=1) if c != 0]
    if bad:
        raise RuntimeError(f"data-parallel ranks failed: {bad}")
    if trace:  # the card's busy time of every rank; the other readings are rank 0's
        from benchmarks.harness.trace import Trace

        busy = []
        for r in range(world):
            path = Path(trace_path(tmpdir, tag, r))
            busy.append(Trace.load(path).busy_us / 1e6)
            if r:
                path.unlink(missing_ok=True)
        out["busy_s_per_chip"] = busy
    return out


def _worker(argv):
    a = json.loads(argv[0])
    torch.set_num_threads(1)
    run_rank(a["cell"], a["model"], a["mix"], a["seed"], a["seconds"], a["trace"], a["device"],
             a["rank"], a["world"], a["port"], time.perf_counter(), a["tmpdir"], a["tag"])


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", required=True)
    _worker([ap.parse_args().worker])
