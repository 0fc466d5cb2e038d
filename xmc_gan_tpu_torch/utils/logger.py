"""Logging and metric writers (the port's copy of ``xmc_gan_tpu/utils/logger.py``).

Reference surface (``utils/logger.py:5-23`` + ``train_gan.py:297-321,430-438``):
a stdout+file python logger with a rank guard, and per-epoch scalar logging to
TensorBoard or wandb selected by ``--log_type``, plus an images/sec
throughput meter.  ``tensorboardX`` and ``wandb`` are imported only when
their writer is asked for; a missing one raises.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from typing import Mapping

__all__ = ["setup_logger", "MetricWriter", "Throughput"]


def setup_logger(name: str, save_dir: str | None, distributed_rank: int = 0) -> logging.Logger:
    """stdout + ``{save_dir}/log.txt`` logger; non-zero ranks get a silent
    logger (reference ``utils/logger.py:5-23``)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    logger.handlers.clear()
    if distributed_rank > 0:
        return logger
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
    sh = logging.StreamHandler(stream=sys.stdout)
    sh.setLevel(logging.DEBUG)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(save_dir, "log.txt"))
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class MetricWriter:
    """Scalar writer: ``log_type`` in {'tb', 'wandb', 'none'}; no-op on
    non-zero ranks (rank-0-only logging)."""

    def __init__(
        self,
        log_dir: str,
        log_type: str = "tb",
        rank: int = 0,
        wandb_kwargs: Mapping | None = None,
    ):
        self._tb = None
        self._wandb = None
        if rank != 0 or log_type == "none":
            return
        if log_type == "wdb":  # reference spelling (train_gan.py:162,300)
            log_type = "wandb"
        if log_type == "tb":
            from tensorboardX import SummaryWriter

            self._tb = SummaryWriter(log_dir)
        elif log_type == "wandb":
            try:
                import wandb
            except ImportError as e:
                raise RuntimeError(
                    "--log_type wandb requested but wandb is not installed"
                ) from e
            wandb.init(**dict(wandb_kwargs or {}))
            self._wandb = wandb
        else:
            raise ValueError(f"Unknown log_type {log_type!r}")

    def scalars(self, step: int, values: Mapping[str, float]) -> None:
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(k, float(v), step)
        if self._wandb is not None:
            self._wandb.log(dict(values), step=step)

    @property
    def active(self) -> bool:
        return self._tb is not None or self._wandb is not None

    def histograms(self, step: int, values: Mapping[str, "object"]) -> None:
        """Per-tensor histograms (``wandb.watch`` telemetry,
        reference ``train_gan.py:163-164``): wandb ``Histogram`` objects or
        TB ``add_histogram`` events, rank 0 only like scalars."""
        import numpy as np

        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_histogram(k, np.asarray(v).ravel(), step)
        if self._wandb is not None:
            self._wandb.log(
                {k: self._wandb.Histogram(np.asarray(v).ravel())
                 for k, v in values.items()},
                step=step,
            )

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()


class Throughput:
    """images/sec (and per-chip) meter over a sliding window of steps."""

    def __init__(self, batch_size: int, n_chips: int = 1):
        self.batch_size = batch_size
        self.n_chips = max(1, n_chips)
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0

    def step(self, n: int = 1) -> None:
        self._steps += n

    def rates(self) -> dict[str, float]:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        ips = self._steps * self.batch_size / dt
        return {
            "steps_per_sec": self._steps / dt,
            "images_per_sec": ips,
            "images_per_sec_per_chip": ips / self.n_chips,
        }
