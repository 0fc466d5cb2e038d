"""Data parallelism on ``torch.distributed`` (port of ``xmc_gan_tpu/parallel``):
one process per card, the batch split by rows (``mesh``), and the step's
collectives stated explicitly (``collectives``)."""

from xmc_gan_tpu_torch.parallel.mesh import (
    Mesh,
    any_rank,
    barrier,
    make_mesh,
    replicate,
    shard_batch,
    shutdown,
)

__all__ = ["Mesh", "make_mesh", "shard_batch", "replicate", "barrier", "any_rank", "shutdown"]
