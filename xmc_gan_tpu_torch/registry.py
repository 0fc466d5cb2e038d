"""String -> module registries for generators, discriminators, text
encoders and datasets, mirroring
``xmc_gan_tpu/registry.py`` (reference ``train_gan.py:40-49``).

Every name the JAX package registers resolves; unknown names raise
``KeyError``.  Imports are lazy, as in the JAX package.
"""

from __future__ import annotations

import importlib

__all__ = ["get_generator", "get_discriminator", "get_text_encoder", "get_dataset"]


def _lazy(module: str, cls: str):
    """A loader of ``xmc_gan_tpu_torch.<module>.<cls>``."""
    return lambda: getattr(importlib.import_module(f"xmc_gan_tpu_torch.{module}"), cls)


_GENERATORS = {
    "DF_GEN": _lazy("models.df_gan", "NetG"),
    "CONCEPT_IN_DF_GEN": _lazy("models.df_concept_gan", "InNetG"),
    "CONCEPT_OUT_DF_GEN": _lazy("models.df_concept_gan", "OutNetG"),
    "CONCEPT_INATTN_GEN": _lazy("models.concept_gan", "InNetG"),
    "CONCEPT_OUTATTN_GEN": _lazy("models.concept_gan", "OutNetG"),
}
_DISCRIMINATORS = {"DF_DISC": _lazy("models.df_gan", "NetD"),
                   "CONCEPT_NETD": _lazy("models.df_concept_gan", "NetD")}
_ENCODERS = {"RNN": _lazy("models.encoder", "RNNEncoder"),
             "SBERT": _lazy("models.encoder", "SBERTEncoder")}

_DATASETS = {"WORD": _lazy("data.pipeline", "WordTextDataset"),
             "SENT": _lazy("data.pipeline", "SentTextDataset")}


def _lookup(kind: str, name: str, table: dict):
    if name in table:
        return table[name]()
    raise KeyError(f"Unknown {kind} {name!r}; available: {sorted(table)}")


def get_generator(name: str):
    return _lookup("generator", name, _GENERATORS)


def get_discriminator(name: str):
    return _lookup("discriminator", name, _DISCRIMINATORS)


def get_text_encoder(name: str):
    return _lookup("text encoder", name, _ENCODERS)


def get_dataset(name: str):
    """``TEXT.TYPE`` -> dataset class (``WORD``: ``WordTextDataset``,
    ``SENT``: ``SentTextDataset``)."""
    return _lookup("dataset type", name, _DATASETS)
