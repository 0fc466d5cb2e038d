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
* GroupedDense ``kernel`` ``[g, d_in, f]`` -> grouped 1x1 conv ``weight``
  ``[g*f, d_in, 1, 1]``, ``bias`` ``[g, f]`` -> ``[g*f]``
* GroupNorm ``scale`` -> ``weight``
* RNN weights already use the torch layout (rename only)
* spectral ``u`` -> ``weight_u``; conv ``v`` re-ordered from the JAX
  flattening ``(kH, kW, I)`` to PyTorch's ``(I, kH, kW)`` -> ``weight_v``
"""

from __future__ import annotations

import re
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
    "concept_generator_state_dict",
    "df_concept_generator_state_dict",
    "concept_discriminator_state_dict",
    "train_state_from_jax",
    "inception_state_dict_from_jax",
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


def grouped_state_dict(node: Mapping, spec: Mapping | None = None,
                       prefix: str = "") -> dict[str, torch.Tensor]:
    """JAX ``GroupedDense`` params (+ optional ``spectral`` u/v) -> port
    ``GroupedDense`` (the reference's grouped 1x1 conv layout, output
    channels group-major).  Both packages normalize the ``(groups*f, d_in)``
    matricization, so u and v carry over as they are."""
    kernel = np.asarray(node["kernel"], np.float32)  # [g, d_in, f]
    g, d_in, f = kernel.shape
    sd = {f"{prefix}weight": _t(kernel.transpose(0, 2, 1).reshape(g * f, d_in, 1, 1))}
    if "bias" in node:
        sd[f"{prefix}bias"] = _t(np.asarray(node["bias"], np.float32).reshape(-1))
    _spectral(sd, prefix, spec, kernel)
    return sd


def _flatten(node: Mapping, prefix: str, sd: dict, spec: Mapping | None = None) -> None:
    """A JAX module tree (and its ``spectral`` tree of u/v, where it has
    one) under the port's names: the module path joined by dots, each
    layer's leaves in PyTorch layout (dense, conv and grouped kernels told
    apart by their rank), other parameters as they are."""
    spec = spec or {}
    if "kernel" in node:
        kernel = np.asarray(node["kernel"])
        convert = {2: dense_state_dict, 4: conv_state_dict}.get(kernel.ndim, grouped_state_dict)
        sd.update(convert(node, spec, prefix=prefix))
    elif set(node) == {"scale", "bias"}:  # GroupNorm
        sd[f"{prefix}weight"], sd[f"{prefix}bias"] = _t(node["scale"]), _t(node["bias"])
    else:
        for key, sub in node.items():
            if isinstance(sub, Mapping):
                _flatten(sub, f"{prefix}{key}.", sd, spec.get(key))
            else:
                sd[f"{prefix}{key}"] = _t(sub)


def concept_generator_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX word-attention ``InNetG``/``OutNetG`` params (``models/concept_gan.py``)
    -> port ``concept_gan.InNetG``/``OutNetG``.  The reference module never
    ran, so the names are the JAX module tree's (``block{i}.concept1.
    concept_sampler1.key_gconv.weight``)."""
    sd: dict[str, torch.Tensor] = {}
    _flatten(params, "", sd)
    return sd


# JAX tree path -> reference name (xmc_gan_tpu/utils/convert.py:244-311 reads these)
_DF_CONCEPT_RENAMES = (
    (r"^block(\d+)\.", r"upblocks.\1."),
    (r"^conv_out\.", "conv_out.1."),
    (r"^proj_sent_dense\.", "proj_sent."),
    (r"_gconv\.g1\.", "_gconv.0."),
    (r"_gconv\.g2\.", "_gconv.2."),
)


def df_concept_generator_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX concept-DF ``InNetG``/``OutNetG`` params (``models/df_concept_gan.py``)
    -> port ``df_concept_gan.InNetG``/``OutNetG`` under the reference names:
    ``block{i}`` -> ``upblocks.{i}``, ``conv_out`` -> ``conv_out.1``,
    ``proj_sent_dense`` -> ``proj_sent``, the gamma/beta MLPs' ``g1``/``g2`` ->
    their Sequential indices ``0``/``2``; grouped projections as grouped 1x1
    conv weights, GroupNorm ``scale`` as ``weight``."""
    sd: dict[str, torch.Tensor] = {}
    for name, value in concept_generator_state_dict(params).items():
        for pattern, repl in _DF_CONCEPT_RENAMES:
            name = re.sub(pattern, repl, name)
        sd[name] = value
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


def concept_discriminator_state_dict(params: Mapping[str, Any],
                                     spectral: Mapping[str, Any] | None = None
                                     ) -> dict[str, torch.Tensor]:
    """JAX concept ``NetD`` params (+ its ``spectral`` tree of ``u``/``v``)
    (``models/df_concept_gan.py``, ``CONCEPT_NETD``) -> port
    ``df_concept_gan.NetD``: ``block{k}`` -> ``downblocks.{k-1}`` and
    ``cond_dnet`` -> ``COND_DNET`` with its head convs renamed as
    ``NetD``'s; every other name is the JAX module tree's
    (``downblocks.0.concept_sampler.key_gconv.weight``)."""
    flat: dict[str, torch.Tensor] = {}
    _flatten(params, "", flat, spectral)
    sd = {}
    for name, value in flat.items():
        name = re.sub(r"^block(\d+)\.", lambda m: f"downblocks.{int(m.group(1)) - 1}.", name)
        for jname, pname in _D_HEAD_NAMES.items():
            name = name.replace(f"cond_dnet.{jname}.", f"cond_dnet.{pname}.")
        sd[re.sub(r"^cond_dnet\.", "COND_DNET.", name)] = value
    return sd


_G_TREES = {"DF_GEN": df_gan_generator_state_dict,
            "CONCEPT_IN_DF_GEN": df_concept_generator_state_dict,
            "CONCEPT_OUT_DF_GEN": df_concept_generator_state_dict,
            "CONCEPT_INATTN_GEN": concept_generator_state_dict,
            "CONCEPT_OUTATTN_GEN": concept_generator_state_dict}
_D_TREES = {"DF_DISC": df_gan_discriminator_state_dict,
            "CONCEPT_NETD": concept_discriminator_state_dict}


def train_state_from_jax(cfg, g_params: Mapping[str, Any], d_params: Mapping[str, Any],
                         d_spectral: Mapping[str, Any] | None = None, *, step: int = 0,
                         dtype: torch.dtype = torch.float32,
                         device: str | torch.device | None = None):
    """The G, D and spectral trees of a JAX ``TrainState`` (numpy trees) as
    the port's ``train.TrainState`` on ``device`` (default ``cuda``), with
    fresh Adam moments on both sides (the JAX optimizer states are not
    carried over).  The trees convert by ``GEN.ENCODER_NAME`` and
    ``DISC.ENCODER_NAME``."""
    from xmc_gan_tpu_torch.train import create_train_state

    g_tree = _G_TREES[cfg.GEN.ENCODER_NAME or "DF_GEN"]
    d_tree = _D_TREES[cfg.DISC.ENCODER_NAME or "DF_DISC"]
    return create_train_state(cfg, dtype, device, step=step, g_state_dict=g_tree(g_params),
                              d_state_dict=d_tree(d_params, d_spectral))


def inception_state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``InceptionV3`` variables (``{"params", "batch_stats"}``, numpy
    trees; also what the JAX CLI's ``convert-fid-weights`` writes as ``.npz``)
    -> the port's ``models.inception.InceptionV3`` names, which are
    torchvision's: ``conv.kernel`` HWIO -> ``conv.weight`` OIHW, ``bn.scale``
    / ``bias`` / ``mean`` / ``var`` -> ``bn.weight`` / ``bias`` /
    ``running_mean`` / ``running_var`` (``num_batches_tracked`` 0), ``fc``
    as a dense layer."""
    sd: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, path: tuple[str, ...], stats: bool) -> None:
        for key, child in node.items():
            if isinstance(child, Mapping):
                walk(child, path + (key,), stats)
                continue
            arr = np.asarray(child, np.float32)
            name = ".".join(path)
            if stats:
                sd[f"{name}.running_{key}"] = _t(arr)
                sd[f"{name}.num_batches_tracked"] = torch.tensor(0)
            elif path[-1] == "conv" and key == "kernel":
                sd[f"{name}.weight"] = _t(arr.transpose(3, 2, 0, 1))
            elif path[-1] == "bn":
                sd[f"{name}.{'weight' if key == 'scale' else key}"] = _t(arr)
            elif path == ("fc",):
                sd[f"fc.{'weight' if key == 'kernel' else key}"] = _t(arr.T if key == "kernel"
                                                                      else arr)
            else:
                raise KeyError(f"Unexpected Inception tensor {name}/{key}")

    walk(variables["params"], (), False)
    walk(variables.get("batch_stats", {}), (), True)
    return sd
