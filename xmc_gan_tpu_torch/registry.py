"""String -> module registries for generators, discriminators and text
encoders, mirroring
``xmc_gan_tpu/registry.py`` (reference ``train_gan.py:40-49``).

Names the JAX package knows but this port has not reached yet raise
``NotImplementedError`` naming the slice that brings them; unknown names
raise ``KeyError``.  Imports are lazy, as in the JAX package.
"""

from __future__ import annotations

__all__ = ["get_generator", "get_discriminator", "get_text_encoder"]

_GEN_LATER = {
    "CONCEPT_IN_DF_GEN": "the concept-family slice",
    "CONCEPT_OUT_DF_GEN": "the concept-family slice",
    "CONCEPT_INATTN_GEN": "the concept-family slice",
    "CONCEPT_OUTATTN_GEN": "the concept-family slice",
}
_DISC_LATER = {"CONCEPT_NETD": "the concept-family slice"}
_ENC_LATER = {"SBERT": "the SBERT text-encoder slice"}


def _lookup(kind: str, name: str, ported: dict, later: dict):
    if name in ported:
        return ported[name]()
    if name in later:
        raise NotImplementedError(f"{kind} {name!r} is not ported yet; it comes with {later[name]}")
    raise KeyError(f"Unknown {kind} {name!r}; available: {sorted(ported) + sorted(later)}")


def _df_gen():
    from xmc_gan_tpu_torch.models.df_gan import NetG

    return NetG


def _df_disc():
    from xmc_gan_tpu_torch.models.df_gan import NetD

    return NetD


def _rnn():
    from xmc_gan_tpu_torch.models.encoder import RNNEncoder

    return RNNEncoder


def get_generator(name: str):
    return _lookup("generator", name, {"DF_GEN": _df_gen}, _GEN_LATER)


def get_discriminator(name: str):
    return _lookup("discriminator", name, {"DF_DISC": _df_disc}, _DISC_LATER)


def get_text_encoder(name: str):
    return _lookup("text encoder", name, {"RNN": _rnn}, _ENC_LATER)
