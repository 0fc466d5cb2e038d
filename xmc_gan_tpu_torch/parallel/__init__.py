"""Data and tensor parallelism on ``torch.distributed`` (port of
``xmc_gan_tpu/parallel``): one process per card on a ``(data, model)`` grid
(``mesh``), the batch split by rows over the data axis and the collectives
that crosses stated explicitly (``collectives``), the large weights split by
output features over the model axis (``tensor``)."""

from xmc_gan_tpu_torch.parallel.mesh import (
    Mesh,
    any_rank,
    barrier,
    make_mesh,
    replicate,
    shard_batch,
    shutdown,
)
from xmc_gan_tpu_torch.parallel.tensor import (
    gather_state,
    load_state,
    shard_model,
    shard_state,
    state_shardings,
)

__all__ = ["Mesh", "make_mesh", "shard_batch", "replicate", "barrier", "any_rank", "shutdown",
           "state_shardings", "shard_model", "shard_state", "gather_state", "load_state"]
