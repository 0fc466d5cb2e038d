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
    "df_gan_discriminator_state_dict",
    "train_state_from_jax",
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


_D_BLOCK_NAMES = {"conv_r1": "conv_r.0", "conv_r2": "conv_r.2", "conv_s": "conv_s"}
_D_HEAD_NAMES = {"joint_conv1": "joint_conv.0", "joint_conv2": "joint_conv.2"}


def df_gan_discriminator_state_dict(params: Mapping[str, Any],
                                    spectral: Mapping[str, Any] | None = None
                                    ) -> dict[str, torch.Tensor]:
    """JAX ``NetD`` params (+ its ``spectral`` tree of ``u``/``v``) -> port
    ``NetD``.  Name map: ``block{k}`` -> ``downblocks.{k-1}`` with
    ``conv_r1``/``conv_r2`` -> ``conv_r.0``/``conv_r.2``; ``cond_dnet`` ->
    ``COND_DNET`` with ``joint_conv1``/``joint_conv2`` -> ``joint_conv.0``/
    ``joint_conv.2``; ``conv_img``, ``conv_s``, ``gamma``, ``proj_match`` and
    ``region_proj`` keep their names."""
    spectral = spectral or {}
    sd: dict[str, torch.Tensor] = {}
    for key, node in params.items():
        spec = spectral.get(key) or {}
        if key in ("conv_img", "region_proj"):
            sd.update(conv_state_dict(node, spec, prefix=f"{key}."))
        elif key.startswith("block"):
            pre = f"downblocks.{int(key[len('block'):]) - 1}."
            for sub, snode in node.items():
                if sub == "gamma":
                    sd[f"{pre}gamma"] = _t(snode).reshape(1)
                elif sub in _D_BLOCK_NAMES:
                    sd.update(conv_state_dict(snode, spec.get(sub),
                                              prefix=f"{pre}{_D_BLOCK_NAMES[sub]}."))
                else:
                    raise KeyError(f"Unexpected NetD param {key}/{sub}")
        elif key == "cond_dnet":
            for sub, snode in node.items():
                if sub == "proj_match":
                    sd.update(dense_state_dict(snode, spec.get(sub),
                                               prefix="COND_DNET.proj_match."))
                elif sub in _D_HEAD_NAMES:
                    sd.update(conv_state_dict(snode, spec.get(sub),
                                              prefix=f"COND_DNET.{_D_HEAD_NAMES[sub]}."))
                else:
                    raise KeyError(f"Unexpected NetD param {key}/{sub}")
        else:
            raise KeyError(f"Unexpected NetD param {key}")
    return sd


def train_state_from_jax(cfg, g_params: Mapping[str, Any], d_params: Mapping[str, Any],
                         d_spectral: Mapping[str, Any] | None = None, *, step: int = 0,
                         dtype: torch.dtype = torch.float32,
                         device: str | torch.device | None = None):
    """The G, D and spectral trees of a JAX ``TrainState`` (numpy trees) as
    the port's ``train.TrainState`` on ``device`` (default ``cuda``), with
    fresh Adam moments on both sides (the JAX optimizer states are not
    carried over)."""
    from xmc_gan_tpu_torch.train import create_train_state

    return create_train_state(
        cfg, dtype, device, step=step, g_state_dict=df_gan_generator_state_dict(g_params),
        d_state_dict=df_gan_discriminator_state_dict(d_params, d_spectral))
