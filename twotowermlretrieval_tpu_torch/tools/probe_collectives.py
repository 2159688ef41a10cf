"""Probe the ``torch.distributed`` collectives the data-parallel path uses,
on one CUDA card.

    python -m twotowermlretrieval_tpu_torch.tools.probe_collectives

Runs three worlds, each a set of processes on ``cuda:0``: two gloo ranks
(CUDA tensors through the host), one NCCL rank, and two NCCL ranks (which
NCCL refuses on one device). In each, every rank runs
``all_gather_into_tensor``, ``all_reduce``, ``broadcast``, ``barrier`` and
``reduce_scatter_tensor`` on a small tensor and times three all-reduces of
9.2 MB of f32, each from a synchronized card to a synchronized card. Each
world's logs are printed with its exit codes; a refused world is a finding,
not a failure of the probe. Needs a CUDA card.
"""

from __future__ import annotations

import datetime
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

WORLDS = (("gloo", 2), ("nccl", 1), ("nccl", 2))
BIG = 2_300_000  # f32 elements: 9.2 MB


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker(backend: str, rank: int, world: int, port: int) -> None:
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=60), **kwargs)
    print(f"[{backend} r{rank}] init {time.perf_counter() - t0:.2f} s", flush=True)
    x = torch.arange(4, dtype=torch.float32, device=dev) + 10 * rank
    out = torch.empty(4 * world, dtype=torch.float32, device=dev)
    for name, fn in (
        ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(out, x)),
        ("all_reduce", lambda: dist.all_reduce(x)),
        ("broadcast", lambda: dist.broadcast(x, 0)),
        ("barrier", dist.barrier),
        ("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
            torch.empty(4 // world, device=dev), torch.ones(4, device=dev))),
    ):
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            fn()
            torch.cuda.synchronize()
        except (RuntimeError, ValueError) as e:
            print(f"[{backend} r{rank}] {name} FAILED: {type(e).__name__}: {str(e)[:300]}",
                  flush=True)
            continue
        print(f"[{backend} r{rank}] {name} ok {1e3 * (time.perf_counter() - t):.2f} ms: "
              f"gathered {out.tolist()}, x {x.tolist()}", flush=True)
    big = torch.ones(BIG, device=dev)
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        dist.all_reduce(big)
        torch.cuda.synchronize()
        print(f"[{backend} r{rank}] all_reduce {4 * BIG / 1e6:.1f} MB "
              f"{1e3 * (time.perf_counter() - t):.2f} ms", flush=True)
    dist.destroy_process_group()


def main() -> int:
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("probe_collectives: no CUDA device", file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda,
          f"gloo {dist.is_gloo_available()}, nccl {dist.is_nccl_available()}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for backend, world in WORLDS:
            port = _free_port()
            logs = [open(Path(tmp) / f"{backend}{world}_{r}.log", "w+") for r in range(world)]
            procs = [subprocess.Popen([sys.executable, "-m", __spec__.name, backend, str(r),
                                       str(world), str(port)], stdout=log,
                                      stderr=subprocess.STDOUT) for r, log in enumerate(logs)]
            try:
                for p in procs:
                    p.wait(timeout=120)
            except subprocess.TimeoutExpired:
                print(f"{backend} x {world}: timed out", flush=True)
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                    p.wait()
            print(f"== {backend}, {world} rank(s) on cuda:0: exit codes "
                  f"{[p.returncode for p in procs]}", flush=True)
            for log in logs:
                log.seek(0)
                print(log.read()[-3000:], flush=True)
                log.close()
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1:
        worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
    else:
        sys.exit(main())
