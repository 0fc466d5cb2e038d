"""The data-parallel process group (port of ``xmc_gan_tpu/parallel/mesh.py``).

The JAX package lays a ``(data, model)`` device mesh over its chips and lets
GSPMD insert the collectives.  The port runs one process per card on
``torch.distributed`` and states every collective in the step itself
(``parallel/collectives.py``).  Here:

* ``make_mesh(dp, tp)`` joins (or starts) the default process group and
  returns a ``Mesh``: this process's rank, the world size and its device.
  The group starts from torchrun's ``env://`` variables (``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``) unless the
  caller names an ``init_method`` (the tests use a ``file://`` store).  The
  backend is NCCL on the card and gloo on the CPU; a caller may name gloo on
  the card (two ranks sharing one card, which NCCL refuses).  Host-side
  agreements (the SIGTERM flag, barriers around checkpoint files) run on a
  gloo group beside NCCL, so they never wait on the card's queue.
* ``shard_batch`` takes this rank's contiguous rows of a global batch.
* ``replicate`` broadcasts a ``TrainState`` from rank 0.

Only data parallelism: ``tp`` > 1 (the JAX package's ``state_shardings``
over the ``model`` axis) raises ``NotImplementedError``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from xmc_gan_tpu_torch.device import resolve_device

__all__ = ["Mesh", "make_mesh", "shard_batch", "replicate", "barrier", "any_rank",
           "shutdown"]

TP_REFUSAL = ("tensor parallelism (tp > 1, the JAX package's 'model' mesh axis) is not "
              "ported; the port shards the batch only (dp)")


@dataclass(frozen=True, eq=False)
class Mesh:
    """One process of a data-parallel group (the default process group):
    ``rank`` of ``world``, its ``device``, the group's ``backend`` and
    ``host_group``, a gloo group for host-side flags (``None``: the default
    group is gloo already)."""

    rank: int
    world: int
    device: torch.device
    backend: str
    host_group: Any = None

    def rows(self, n_local: int) -> slice:
        """This rank's rows of a global batch of ``n_local * world`` rows."""
        return slice(self.rank * n_local, (self.rank + 1) * n_local)


def _device(device: str | torch.device | None) -> torch.device:
    """``cuda:LOCAL_RANK`` for ``None`` or a bare ``cuda``; otherwise as given."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def make_mesh(dp: int | None = None, tp: int = 1, *, device: str | torch.device | None = None,
              backend: str | None = None, init_method: str | None = None,
              rank: int | None = None, world_size: int | None = None) -> Mesh:
    """This process's place in a data-parallel group of ``dp`` processes.

    Starts the default process group unless one is running: from
    ``init_method`` (default ``env://``, torchrun's variables) with
    ``backend`` (default NCCL for a card, gloo for the CPU), ``rank`` and
    ``world_size``.  ``device`` defaults to ``cuda:LOCAL_RANK``; pass
    ``"cpu"`` for the CPU.  ``dp`` defaults to the world size and must equal
    it; ``tp`` > 1 raises ``NotImplementedError``."""
    if tp != 1:
        raise NotImplementedError(TP_REFUSAL)
    dev = _device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        kw = {} if rank is None else {"rank": rank, "world_size": world_size}
        dist.init_process_group(backend, init_method=init_method or "env://", **kw)
    world = dist.get_world_size()
    if dp is None:
        dp = world
    if dp != world:
        raise ValueError(f"dp={dp} needs {dp} processes (one per card); the group has {world}")
    backend = dist.get_backend()
    host_group = None if backend == "gloo" else dist.new_group(backend="gloo")
    return Mesh(dist.get_rank(), world, dev, backend, host_group)


def shutdown() -> None:
    """Leave the process group (where one is running)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's contiguous rows of every array or tensor of a global
    ``batch`` (the JAX package's ``P('data')`` layout); ``None`` stays."""
    out = {}
    for k, v in batch.items():
        if v is None:
            out[k] = None
            continue
        n = v.shape[0]
        if n % mesh.world:
            raise ValueError(f"batch[{k!r}] has {n} rows, not a multiple of dp={mesh.world}")
        out[k] = v[mesh.rows(n // mesh.world)]
    return out


def barrier(mesh: Mesh) -> None:
    """Every rank waits here for the others (on the host group)."""
    dist.barrier(group=mesh.host_group)


def any_rank(mesh: Mesh, flag: bool) -> bool:
    """Whether ``flag`` is true on any rank: an OR over the host group, a
    collective every rank must reach."""
    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.host_group)
    return bool(t.item())


def _broadcast_(t: torch.Tensor, mesh: Mesh) -> None:
    """Rank 0's value of ``t`` into ``t`` on every rank; a host tensor
    crosses through the device where the backend needs it (NCCL)."""
    if mesh.backend == "nccl" and t.device.type == "cpu":
        on_dev = t.to(mesh.device)
        dist.broadcast(on_dev, 0)
        t.copy_(on_dev.cpu())
    else:
        dist.broadcast(t, 0)


@torch.no_grad()
def replicate(mesh: Mesh, state) -> None:
    """Broadcast a ``train.TrainState`` from rank 0, in place: G's and D's
    parameters and buffers (D's power-iteration vectors), both Adam states
    and the step counter.  Every rank must hold a state of the same
    configuration, and the same optimizer-state entries (a fresh state, or
    the same checkpoint restored)."""
    for net in (state.g, state.d):
        for t in [*net.parameters(), *net.buffers()]:
            _broadcast_(t.data, mesh)
    for opt in (state.g_opt, state.d_opt):
        for group in opt.param_groups:
            for p in group["params"]:
                for key in sorted(opt.state.get(p, {})):
                    v = opt.state[p][key]
                    if isinstance(v, torch.Tensor):
                        _broadcast_(v, mesh)
    step = torch.tensor([int(state.step)], dtype=torch.int64)
    _broadcast_(step, mesh)
    state.step = int(step.item())

