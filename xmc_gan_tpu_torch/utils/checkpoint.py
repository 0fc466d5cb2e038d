"""Checkpoints of the whole train state (the port's ``CheckpointManager``,
the API of ``xmc_gan_tpu/utils/checkpoint.py``).

Each save is one ``torch.save`` file per epoch (or step, for the trainer's
``auto/`` manager) holding the complete ``train.TrainState``: G's and D's
``state_dict`` (D's includes its spectral ``weight_u``/``weight_v``
buffers), both Adam states and ``step``.  As in the JAX package, resuming an
epoch restores the optimizer state saved with it (the reference overwrote
its optimizer files every epoch, ``train_gan.py:331-332,490-493``).  A save
is written to a temporary file in the same directory and renamed into place,
so a crash never leaves a torn checkpoint; saves are synchronous, and
``wait`` is there for the JAX package's API.

The port cannot read the JAX package's Orbax checkpoints (Orbax needs JAX).
A JAX state crosses over as numpy trees through
``utils/convert.train_state_from_jax``, which starts fresh Adam moments.
"""

from __future__ import annotations

import os
import re
import tempfile

import torch

__all__ = ["CheckpointManager"]

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    """Epoch-indexed checkpoints of a ``train.TrainState`` under ``directory``,
    keeping the newest ``max_to_keep`` (all when None)."""

    def __init__(self, directory: str, max_to_keep: int | None = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"ckpt_{epoch}.pt")

    def save(self, epoch: int, state, *, force: bool = False) -> bool:
        """Write ``state`` as ``epoch``; an existing epoch is kept unless
        ``force``.  Returns whether a file was written."""
        if not force and epoch in self.all_epochs():
            return False
        payload = {"step": int(state.step), "g": state.g.state_dict(), "d": state.d.state_dict(),
                   "g_opt": state.g_opt.state_dict(), "d_opt": state.d_opt.state_dict()}
        fd, tmp = tempfile.mkstemp(dir=self.directory, prefix=f".ckpt_{epoch}.", suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                torch.save(payload, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path(epoch))
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        if self.max_to_keep:
            for old in self.all_epochs()[: -self.max_to_keep]:
                os.unlink(self.path(old))
        return True

    def restore(self, template, epoch: int | None = None):
        """Load ``epoch`` (or the latest) into ``template``, a ``TrainState``
        of the same configuration (e.g. a fresh ``create_train_state``), in
        place, on its device.  Returns ``(template, epoch)``."""
        if epoch is None:
            epoch = self.latest_epoch()
            if epoch is None:
                raise FileNotFoundError(f"No checkpoints under {self.directory}")
        payload = torch.load(self.path(epoch), map_location="cpu", weights_only=True)
        template.g.load_state_dict(payload["g"], strict=True)
        template.d.load_state_dict(payload["d"], strict=True)
        template.g_opt.load_state_dict(payload["g_opt"])
        template.d_opt.load_state_dict(payload["d_opt"])
        template.step = int(payload["step"])
        return template, epoch

    def latest_epoch(self) -> int | None:
        epochs = self.all_epochs()
        return epochs[-1] if epochs else None

    def all_epochs(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m)

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""

    def close(self) -> None:
        """Nothing is held open between saves."""
