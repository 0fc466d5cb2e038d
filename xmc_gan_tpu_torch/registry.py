"""String -> module registries for generators, discriminators, text
encoders and datasets, mirroring
``xmc_gan_tpu/registry.py`` (reference ``train_gan.py:40-49``).

Names the JAX package knows but this port has not reached yet raise
``NotImplementedError`` naming the slice that brings them; unknown names
raise ``KeyError``.  Imports are lazy, as in the JAX package.
"""

from __future__ import annotations

import importlib

__all__ = ["get_generator", "get_discriminator", "get_text_encoder", "get_dataset"]


def _lazy(module: str, cls: str):
    """A loader of ``xmc_gan_tpu_torch.models.<module>.<cls>``."""
    return lambda: getattr(importlib.import_module(f"xmc_gan_tpu_torch.models.{module}"), cls)


_GENERATORS = {
    "DF_GEN": _lazy("df_gan", "NetG"),
    "CONCEPT_IN_DF_GEN": _lazy("df_concept_gan", "InNetG"),
    "CONCEPT_OUT_DF_GEN": _lazy("df_concept_gan", "OutNetG"),
    "CONCEPT_INATTN_GEN": _lazy("concept_gan", "InNetG"),
    "CONCEPT_OUTATTN_GEN": _lazy("concept_gan", "OutNetG"),
}
_DISCRIMINATORS = {"DF_DISC": _lazy("df_gan", "NetD")}
_DISC_LATER = {"CONCEPT_NETD": "the concept training slice"}
_ENCODERS = {"RNN": _lazy("encoder", "RNNEncoder")}
_ENC_LATER = {"SBERT": "the SBERT text-encoder slice"}
_DATASETS = {"WORD": lambda: importlib.import_module(
    "xmc_gan_tpu_torch.data.pipeline").WordTextDataset}
_DATASETS_LATER = {"SENT": "the SBERT text-encoder slice"}


def _lookup(kind: str, name: str, ported: dict, later: dict):
    if name in ported:
        return ported[name]()
    if name in later:
        raise NotImplementedError(f"{kind} {name!r} is not ported yet; it comes with {later[name]}")
    raise KeyError(f"Unknown {kind} {name!r}; available: {sorted(ported) + sorted(later)}")


def get_generator(name: str):
    return _lookup("generator", name, _GENERATORS, {})


def get_discriminator(name: str):
    return _lookup("discriminator", name, _DISCRIMINATORS, _DISC_LATER)


def get_text_encoder(name: str):
    return _lookup("text encoder", name, _ENCODERS, _ENC_LATER)


def get_dataset(name: str):
    """``TEXT.TYPE`` -> dataset class (``WORD``: ``WordTextDataset``)."""
    return _lookup("dataset type", name, _DATASETS, _DATASETS_LATER)
