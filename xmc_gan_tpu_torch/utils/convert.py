"""JAX-package parameter trees -> the port's ``state_dict``s, and ``.pth`` loading.

The port's modules carry the reference's names and PyTorch layouts, so a
reference ``state_dict`` (``text_encoder100.pth``, a reference ``NetG``
checkpoint, or one exported from the JAX package by its
``df_gan_generator_state_dict``) loads directly.  This module converts the
JAX package's own parameter trees (nested dicts of numpy arrays, e.g. from
its checkpoints) into those names.  Layout rules, the inverse of the JAX
package's ``utils/convert.py``:

* Dense ``kernel`` ``[in, out]``      -> ``weight`` ``[out, in]`` (transpose)
* Conv ``kernel`` HWIO ``[kH, kW, I, O]`` -> ``weight`` ``[O, I, kH, kW]``
* RNN weights already use the torch layout (rename only)
* spectral ``u`` -> ``weight_u``; conv ``v`` re-ordered from the JAX
  flattening ``(kH, kW, I)`` to PyTorch's ``(I, kH, kW)`` -> ``weight_v``
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

__all__ = [
    "load_state_dict",
    "dense_state_dict",
    "conv_state_dict",
    "rnn_encoder_state_dict",
    "df_gan_generator_state_dict",
]


def load_state_dict(path: str) -> dict[str, torch.Tensor]:
    """Load a ``.pth`` state_dict (or a pickled module's) onto the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return dict(sd)


def _t(arr: Any) -> torch.Tensor:
    return torch.tensor(np.asarray(arr, np.float32))


def _spectral(sd: dict, prefix: str, spec: Mapping | None, kernel: np.ndarray) -> None:
    if not spec:
        return
    v = np.asarray(spec["v"], np.float32)
    if kernel.ndim == 4:
        kh, kw, i, _ = kernel.shape
        v = v.reshape(kh, kw, i).transpose(2, 0, 1).reshape(-1)
    sd[f"{prefix}weight_u"] = _t(spec["u"])
    sd[f"{prefix}weight_v"] = _t(v)


def dense_state_dict(node: Mapping, spec: Mapping | None = None,
                     prefix: str = "") -> dict[str, torch.Tensor]:
    """JAX ``SNDense`` params (+ optional ``spectral`` u/v) -> port ``SNDense``."""
    kernel = np.asarray(node["kernel"], np.float32)
    sd = {f"{prefix}weight": _t(kernel.T)}
    if "bias" in node:
        sd[f"{prefix}bias"] = _t(node["bias"])
    _spectral(sd, prefix, spec, kernel)
    return sd


def conv_state_dict(node: Mapping, spec: Mapping | None = None,
                    prefix: str = "") -> dict[str, torch.Tensor]:
    """JAX ``SNConv`` params (+ optional ``spectral`` u/v) -> port ``SNConv``."""
    kernel = np.asarray(node["kernel"], np.float32)
    sd = {f"{prefix}weight": _t(kernel.transpose(3, 2, 0, 1))}
    if "bias" in node:
        sd[f"{prefix}bias"] = _t(node["bias"])
    _spectral(sd, prefix, spec, kernel)
    return sd


def rnn_encoder_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``RNNEncoder`` params -> port ``RNNEncoder`` (reference names)."""
    return {("encoder.weight" if k == "embedding" else f"rnn.{k}"): _t(v)
            for k, v in params.items()}


def df_gan_generator_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``NetG`` params -> port ``NetG`` (reference names).  Name map:
    ``block{i}`` -> ``upblocks.{i}``; ``affine{j}/fc_gamma_{k}`` ->
    ``affine{j}.fc_gamma.linear{k}``; ``conv_out`` -> ``conv_out.1``;
    ``proj_sent_dense`` -> ``proj_sent``."""
    sd: dict[str, torch.Tensor] = {}
    for key, node in params.items():
        if key == "proj_noise":
            sd.update(dense_state_dict(node, prefix="proj_noise."))
        elif key == "proj_sent_dense":
            sd.update(dense_state_dict(node, prefix="proj_sent."))
        elif key == "conv_out":
            sd.update(conv_state_dict(node, prefix="conv_out.1."))
        elif key.startswith("block"):
            pre = f"upblocks.{int(key[len('block'):])}."
            for sub, snode in node.items():
                if sub in ("c1", "c2", "c_sc"):
                    sd.update(conv_state_dict(snode, prefix=f"{pre}{sub}."))
                elif sub == "gamma":
                    sd[f"{pre}gamma"] = _t(snode).reshape(1)
                elif sub.startswith("affine"):
                    for leaf, lnode in snode.items():
                        fc, k = leaf.rsplit("_", 1)  # fc_gamma_1 -> fc_gamma, 1
                        sd.update(dense_state_dict(lnode, prefix=f"{pre}{sub}.{fc}.linear{k}."))
                else:
                    raise KeyError(f"Unexpected NetG param {key}/{sub}")
        else:
            raise KeyError(f"Unexpected NetG param {key}")
    return sd
