"""Data and model parallelism over ``torch.distributed`` processes, and
sharded search over the devices of one process: the meshes (``mesh.py``),
the collectives the losses, the towers and the step use
(``collectives.py``), the row-sharded table lookup (``embedding.py``), the
sharding rules, the parallel steps and encoder (``distributed.py``,
served lazily here through a module-level ``__getattr__``: it imports the
train step, which imports the losses, which import ``collectives``, so an
eager import would close that cycle), and the exact and IVF searches over a
corpus split across devices (``topk.py``, ``ivf.py``)."""

from twotowermlretrieval_tpu_torch.parallel.embedding import sharded_embedding_lookup  # noqa: F401
from twotowermlretrieval_tpu_torch.parallel.ivf import (  # noqa: F401
    ShardedIVF,
    distributed_ivf_search,
    shard_ivf,
)
from twotowermlretrieval_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    DeviceMesh,
    Mesh,
    initialize_multihost,
    make_device_mesh,
    make_mesh,
    put_global,
    replicate_to_host,
    resolve_mesh,
)
from twotowermlretrieval_tpu_torch.parallel.topk import (  # noqa: F401
    distributed_topk,
    distributed_topk_int8,
    distributed_topk_s8,
    shard_corpus,
    shard_corpus_int8,
    shard_corpus_s8,
)

_DISTRIBUTED = (
    "make_distributed_eval_step",
    "make_distributed_train_step",
    "make_sharded_packed_eval_step",
    "make_sharded_packed_train_step",
    "replicate_state",
)


def __getattr__(name):
    if name in _DISTRIBUTED:
        from twotowermlretrieval_tpu_torch.parallel import distributed

        return getattr(distributed, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
