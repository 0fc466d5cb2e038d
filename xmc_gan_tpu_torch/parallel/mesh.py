"""The ``(data, model)`` process grid (port of ``xmc_gan_tpu/parallel/mesh.py``).

The JAX package lays a ``(data, model)`` device mesh over its chips and lets
GSPMD insert the collectives.  The port runs one process per card on
``torch.distributed`` and states every collective in the step itself
(``parallel/collectives.py`` for the batch, ``parallel/tensor.py`` for the
model's weights).  Here:

* ``make_mesh(dp, tp)`` joins (or starts) the default process group of
  ``dp * tp`` processes and returns a ``Mesh``: rank ``r`` sits at data
  index ``r // tp`` and model index ``r % tp`` (JAX's ``devices.reshape(dp,
  tp)``).  The *data group* holds the ranks of one model index (the ``dp``
  replicas of one weight shard: the batch's rows cross it); the *model
  group* holds the ranks of one data index (the ``tp`` shards of one
  replica: the same rows, each with its part of the large weights).  The
  group starts from torchrun's ``env://`` variables (``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``) unless
  the caller names an ``init_method`` (the tests use a ``file://`` store).
  The backend is NCCL on the card and gloo on the CPU; a caller may name
  gloo on the card (ranks sharing one card, which NCCL refuses).  Host-side
  agreements (the SIGTERM flag, barriers around checkpoint files) run on a
  gloo group beside NCCL, so they never wait on the card's queue.
* ``shard_batch`` takes this rank's contiguous rows of a global batch, by
  its data index: the ``tp`` ranks of a model group hold the same rows.
* ``replicate`` broadcasts a ``TrainState`` from rank 0; a weight shard
  (``parallel.tensor.shard_state``) comes from the data group's first rank,
  so every rank keeps its own shard.
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


@dataclass(frozen=True, eq=False)
class Mesh:
    """One process of a ``(data, model)`` grid of ``world = dp * tp``
    processes (the default process group): its global ``rank``, its
    ``device``, the group's ``backend`` and ``host_group`` (a gloo group for
    host-side flags; ``None``: the default group is gloo already).

    ``data_group`` / ``model_group`` are the process groups of the ranks
    with this rank's model / data index (``None`` stands for the default
    group, as for the data group when ``tp`` = 1)."""

    rank: int
    world: int
    device: torch.device
    backend: str
    host_group: Any = None
    tp: int = 1
    data_group: Any = None
    model_group: Any = None

    @property
    def dp(self) -> int:
        return self.world // self.tp

    @property
    def data_rank(self) -> int:
        """This rank's data index: which rows of the global batch it holds."""
        return self.rank // self.tp

    @property
    def model_rank(self) -> int:
        """This rank's model index: which shard of a sharded weight it holds."""
        return self.rank % self.tp

    def rows(self, n_local: int) -> slice:
        """This rank's rows of a global batch of ``n_local * dp`` rows."""
        return slice(self.data_rank * n_local, (self.data_rank + 1) * n_local)


def _device(device: str | torch.device | None) -> torch.device:
    """``cuda:LOCAL_RANK`` for ``None`` or a bare ``cuda``; otherwise as given."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def _group(rank_lists: list[list[int]], mine: int) -> Any:
    """Every rank creates every group (``new_group`` is collective), in the
    same order; returns the one holding ``mine``."""
    out = None
    for ranks in rank_lists:
        g = dist.new_group(ranks)
        if mine in ranks:
            out = g
    return out


def make_mesh(dp: int | None = None, tp: int = 1, *, device: str | torch.device | None = None,
              backend: str | None = None, init_method: str | None = None,
              rank: int | None = None, world_size: int | None = None) -> Mesh:
    """This process's place in a ``dp x tp`` grid of processes.

    Starts the default process group unless one is running: from
    ``init_method`` (default ``env://``, torchrun's variables) with
    ``backend`` (default NCCL for a card, gloo for the CPU), ``rank`` and
    ``world_size``.  ``device`` defaults to ``cuda:LOCAL_RANK``; pass
    ``"cpu"`` for the CPU.  ``dp`` defaults to ``world // tp``; ``dp * tp``
    must equal the world size."""
    dev = _device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        kw = {} if rank is None else {"rank": rank, "world_size": world_size}
        dist.init_process_group(backend, init_method=init_method or "env://", **kw)
    world = dist.get_world_size()
    if tp < 1 or world % tp:
        raise ValueError(f"tp={tp} must divide the world size {world}")
    if dp is None:
        dp = world // tp
    if dp * tp != world:
        raise ValueError(f"dp={dp} x tp={tp} needs {dp * tp} processes (one per card); the "
                         f"group has {world}")
    backend = dist.get_backend()
    me = dist.get_rank()
    host_group = None if backend == "gloo" else dist.new_group(backend="gloo")
    if tp == 1:
        return Mesh(me, world, dev, backend, host_group)
    data = _group([[d * tp + m for d in range(dp)] for m in range(tp)], me)
    model = _group([[d * tp + m for m in range(tp)] for d in range(dp)], me)
    return Mesh(me, world, dev, backend, host_group, tp, data, model)


def shutdown() -> None:
    """Leave the process group (where one is running)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's contiguous rows of every array or tensor of a global
    ``batch`` (the JAX package's ``P('data')`` layout), by its data index;
    ``None`` stays."""
    out = {}
    for k, v in batch.items():
        if v is None:
            out[k] = None
            continue
        n = v.shape[0]
        if n % mesh.dp:
            raise ValueError(f"batch[{k!r}] has {n} rows, not a multiple of dp={mesh.dp}")
        out[k] = v[mesh.rows(n // mesh.dp)]
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


def _broadcast_(t: torch.Tensor, mesh: Mesh, src: int = 0, group: Any = None) -> None:
    """Global rank ``src``'s value of ``t`` into ``t`` on every rank of
    ``group`` (default: all); a host tensor crosses through the device where
    the backend needs it (NCCL)."""
    if mesh.backend == "nccl" and t.device.type == "cpu":
        on_dev = t.to(mesh.device)
        dist.broadcast(on_dev, src, group=group)
        t.copy_(on_dev.cpu())
    else:
        dist.broadcast(t, src, group=group)


@torch.no_grad()
def replicate(mesh: Mesh, state) -> None:
    """Broadcast a ``train.TrainState`` from rank 0, in place: G's and D's
    parameters and buffers (D's power-iteration vectors), both Adam states
    and the step counter.  Every rank must hold a state of the same
    configuration, and the same optimizer-state entries (a fresh state, or
    the same checkpoint restored).  A sharded weight and its Adam moments
    (``parallel.tensor.shard_state``) come from the first rank of this
    rank's data group (global rank = this model index), so each rank keeps
    its own shard."""
    from xmc_gan_tpu_torch.parallel.tensor import sharded_tensors

    def bcast(t: torch.Tensor, sharded: bool) -> None:
        if sharded:
            _broadcast_(t, mesh, mesh.model_rank, mesh.data_group)
        else:
            _broadcast_(t, mesh)

    for net, opt in ((state.g, state.g_opt), (state.d, state.d_opt)):
        shards = sharded_tensors(net)
        for t in [*net.parameters(), *net.buffers()]:
            bcast(t.data, id(t) in shards)
        for group in opt.param_groups:
            for p in group["params"]:
                for key in sorted(opt.state.get(p, {})):
                    v = opt.state[p][key]
                    if isinstance(v, torch.Tensor):
                        bcast(v, id(p) in shards and v.dim() > 0)
    step = torch.tensor([int(state.step)], dtype=torch.int64)
    _broadcast_(step, mesh)
    state.step = int(step.item())
