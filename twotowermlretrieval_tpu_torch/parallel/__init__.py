"""Data and model parallelism over ``torch.distributed`` processes: the
mesh (``mesh.py``), the collectives the losses, the towers and the step
use (``collectives.py``), the row-sharded table lookup (``embedding.py``)
and the sharding rules, the parallel steps and encoder
(``distributed.py``, imported from there: it imports the train step,
which imports the losses, which import ``collectives``)."""

from twotowermlretrieval_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    initialize_multihost,
    make_mesh,
    put_global,
    replicate_to_host,
    resolve_mesh,
)
