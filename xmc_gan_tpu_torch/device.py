"""Device selection for the port's entry points.

The port runs on the card: an entry point given no device uses ``cuda`` and
raises when there is none.  The CPU is used only when the caller asks for it
(the tests do); nothing falls back to it silently.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "to_device", "DTYPES"]

# CLI / config spelling -> torch dtype
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a usable GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def to_device(x, dev: torch.device) -> torch.Tensor:
    """A numpy array or tensor as a tensor on ``dev``.  A host array bound for
    the card crosses from pinned memory with ``non_blocking=True``: a plain
    copy from pageable memory waits for every kernel already queued on the
    stream, which would serialize the host's next batch with the card."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    if dev.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)
