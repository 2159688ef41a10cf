"""The ('data', 'model') meshes: over processes for training, over the
devices of one process for sharded search.

The port of the JAX package's ``parallel/mesh.py``. JAX lays a device mesh
over the chips one program sees. Here training takes one rank per process
of a ``torch.distributed`` world (:class:`Mesh`), and the mesh is its
process groups:

- ``data``: the batch-split axis. A rank holds the whole replicated train
  state and takes a contiguous block of each global batch's rows, as
  JAX's ``P('data')`` splits them;
- ``model``: the axis the transformer's heads and FFN columns and a
  row-sharded embedding table are split over (``parallel/distributed.py``);
  with one rank on it, it holds no group.

Rank ``r`` sits at ``(r // model, r % model)``, the place JAX's
``devices.reshape(data, model)`` gives device ``r``. The world is started
by :func:`initialize_multihost` (NCCL for CUDA tensors, gloo for CPU
ones); a process that never starts one is a world of one.

Serving takes one process over a :class:`DeviceMesh`: the devices of a
``data`` x ``model`` grid in row-major order, as JAX's serving mesh holds
the chips one program sees. The corpus splits row-wise over ``data``, each
shard held once, on the first device of its row (the ``model`` replicas
of JAX compute the same lists); ``parallel/topk.py`` and
``parallel/ivf.py`` search it. A device list may repeat a device, so D
shards can share one card (or the CPU, as JAX's virtual CPU mesh).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from twotowermlretrieval_tpu_torch.utils.dtypes import resolve_device
from twotowermlretrieval_tpu_torch.utils.profiling import annotate

DATA_AXIS = "data"
MODEL_AXIS = "model"

_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``data`` x ``model`` layout of the world's ranks. ``data_group``
    is the group of the ranks that share this rank's ``model`` index (the
    ranks it splits batches with); ``model_group`` is ``None`` while the
    ``model`` axis holds one rank."""

    data: int
    model: int
    rank: int
    data_group: Any
    model_group: Any = None

    @property
    def shape(self) -> dict:
        """Ranks on each axis, as a JAX mesh's ``shape``."""
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        """This rank's place on 'model': the shard it holds."""
        return self.rank % self.model

    @property
    def is_lead(self) -> bool:
        """Rank 0, the one rank that writes files and owns the metric sinks."""
        return self.rank == 0


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A ``data`` x ``model`` grid of the devices one process drives;
    ``devices`` in row-major order (device ``(d, m)`` at ``d * model +
    m``), as JAX's ``devices.reshape(data, model)`` lays them."""

    data: int
    model: int
    devices: Tuple[torch.device, ...]

    @property
    def shape(self) -> dict:
        """Devices on each axis, as a JAX mesh's ``shape``."""
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def shard_devices(self) -> Tuple[torch.device, ...]:
        """The device that holds each data shard: the first of its row."""
        return self.devices[:: self.model]

    @property
    def lead(self) -> torch.device:
        """The first device: queries, the query tower and the merge."""
        return self.devices[0]


def make_device_mesh(data: int = -1, model: int = 1,
                     devices: Optional[Sequence] = None) -> DeviceMesh:
    """The ('data', 'model') mesh over ``devices`` (default: every visible
    card, ``cuda:0..n-1``); data=-1 takes every device not on 'model'. A
    device may be named more than once. A CUDA device without a card
    raises, as ``resolve_device`` does."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        devs.append(dev)
    n = len(devs)
    if data == -1:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data < 1 or model < 1 or data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return DeviceMesh(data, model, tuple(devs))


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def mesh_shape(data: int, model: int) -> Tuple[int, int]:
    """(data, model) against the world: data=-1 claims every rank not on
    'model'. Raises when the mesh needs more ranks than the world holds,
    or leaves some rank out of it (a rank outside the mesh would have no
    rows to train on)."""
    n = world_size()
    if data == -1:
        if n % model:
            raise ValueError(f"a world of {n} ranks is not divisible by model={model}")
        data = max(n // model, 1)
    if data * model > n:
        raise ValueError(
            f"mesh {data}x{model} needs {data * model} ranks but the world holds {n} "
            "(start one process per rank: torchrun --nproc-per-node N)"
        )
    if 1 < data * model < n:
        raise ValueError(f"mesh {data}x{model} covers {data * model} of the world's {n} ranks")
    return data, model


def make_mesh(data: int = -1, model: int = 1) -> Mesh:
    """The ('data', 'model') mesh over the world; data=-1 takes every rank
    not on 'model'. Every rank of the world must call it, in the same
    order as its other group creations (``new_group`` is collective)."""
    data, model = mesh_shape(data, model)
    rank = world_rank()
    if data * model == 1:
        return Mesh(1, 1, rank, dist.group.WORLD if dist.is_initialized() else None)
    data_group = model_group = None
    for m in range(model):
        group = dist.new_group([d * model + m for d in range(data)])
        if rank % model == m:
            data_group = group
    if model > 1:
        for d in range(data):
            group = dist.new_group([d * model + m for m in range(model)])
            if rank // model == d:
                model_group = group
    return Mesh(data, model, rank, data_group, model_group)


def resolve_mesh(data: int, model: int) -> Optional[Mesh]:
    """The mesh a (data, model) request asks for, or ``None`` for 1x1 (the
    single-device path), as the JAX package's ``resolve_mesh``. Shared by
    the training driver's ``build_mesh``."""
    data, model = mesh_shape(data, model)
    if data * model <= 1:
        return None
    return make_mesh(data, model)


def rank_device(device) -> torch.device:
    """This rank's device: ``cuda`` without an index becomes
    ``cuda:LOCAL_RANK`` (torchrun's variable; 0 when it is unset), which is
    also made the current device. A device with an index is kept, so
    several ranks may share one card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    return dev


def local_rows(n: int, mesh: Optional[Mesh]) -> slice:
    """This rank's contiguous block of ``n`` global rows (all of them
    without a mesh)."""
    if mesh is None:
        return slice(0, n)
    if n % mesh.data:
        raise ValueError(f"{n} rows do not split over the data axis ({mesh.data})")
    per = n // mesh.data
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def put_global(array: np.ndarray, mesh: Optional[Mesh], device, axis: int = 0) -> torch.Tensor:
    """This rank's rows of a host array (every rank holds the same global
    array) on ``device``: the rows of ``axis`` split over 'data'. Without
    a mesh, the whole array."""
    index = [slice(None)] * array.ndim
    index[axis] = local_rows(array.shape[axis], mesh)
    with annotate("ttr.data.copy"):
        return torch.from_numpy(np.ascontiguousarray(array[tuple(index)])).to(device)


def replicate_to_host(tree, mesh: Optional[Mesh] = None):
    """A replicated tree of tensors as host numpy arrays. Every rank holds
    the whole replicated state, so this is a plain fetch on each rank
    (no collective); ``mesh`` is the JAX package's argument, unused."""
    if isinstance(tree, dict):
        return {k: replicate_to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate_to_host(v) for v in tree)
    return tree.detach().cpu().numpy()


def initialize_multihost(coordinator_address: Optional[str] = None, *,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, device="cuda",
                         backend: Optional[str] = None,
                         timeout: Optional[datetime.timedelta] = None) -> None:
    """Start this process's ``torch.distributed`` world (a no-op if it is
    already started).

    With no coordinator it reads torchrun's ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT``; a lone process without them stays
    a world of one. With ``coordinator_address`` ("host:port") it meets
    ``num_processes`` ranks there as rank ``process_id``. The backend is
    NCCL for CUDA tensors and gloo for CPU ones unless ``backend`` names
    one (gloo takes CUDA tensors too, through the host). Under NCCL the
    world is bound to this rank's card (:func:`rank_device`).

    Only "already initialized" and the argument-less call of a lone
    process are passed over; any other failure of the bootstrap (an
    address that does not answer, a timeout) is raised: carrying on alone
    would train D different models."""
    if dist.is_initialized():
        print("torch.distributed already initialized", flush=True)
        return
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = timeout
    if backend == "nccl":
        kwargs["device_id"] = rank_device(dev)
    if coordinator_address is None:
        missing = [v for v in _TORCHRUN_VARS if v not in os.environ]
        if missing:
            print(f"torch.distributed not initialized: no {', '.join(missing)} "
                  "in the environment (a lone process)", flush=True)
            return
        init = {"init_method": "env://"}
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        init = {"init_method": f"tcp://{coordinator_address}",
                "world_size": num_processes, "rank": process_id}
    try:
        dist.init_process_group(backend, **init, **kwargs)
    except (RuntimeError, ValueError) as e:
        if "already" not in str(e).lower():
            raise
        print(f"torch.distributed already initialized: {e}", flush=True)
        return
    print(f"torch.distributed: backend {backend}, rank {dist.get_rank()} of "
          f"{dist.get_world_size()}", flush=True)
