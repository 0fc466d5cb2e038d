"""Immutable, hashable configuration tree for the PyTorch port.

A verbatim copy of ``xmc_gan_tpu/config.py`` (the port imports nothing of the
JAX package, so it keeps its own copy; ``tests/test_torch_config.py`` holds
the two equal on every shipped YAML).  The config is a tree of frozen
dataclasses while the *public YAML schema is kept byte-compatible* with the
reference (same key names, same nesting, same defaults; reference
``config/gan.py:10-90``) and the strict-merge semantics of
``_merge_a_into_b`` (reference ``config/gan.py:92-122``) are reproduced exactly:
unknown keys raise ``KeyError``, type mismatches raise ``ValueError``.

Dead keys of the reference schema (``TRAIN.FLAG``, ``SAVE_INTERVAL``,
``DISC.UNCOND/COND``, ``TEXT.NUM_LAYERS``, ``FIX_BERT``, ``SENT_FT/WORD_FT/
JOINT_FT``) are kept for config-file parity; they are accepted and stored but not
read anywhere, mirroring the reference.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields
from typing import Any, Mapping

import yaml

__all__ = [
    "Config",
    "TrainConfig",
    "EncoderLossConfig",
    "SmoothConfig",
    "OptConfig",
    "GenConfig",
    "DiscConfig",
    "ImgConfig",
    "TextConfig",
    "cfg_from_file",
    "cfg_from_dict",
    "default_config",
]


@dataclass(frozen=True)
class EncoderLossConfig:
    """Contrastive-loss switches (reference ``config/gan.py:32-37``)."""

    B_GLOBAL: bool = False
    SENT: bool = False
    WORD: bool = False
    DISC: bool = False
    VGG: bool = False


@dataclass(frozen=True)
class SmoothConfig:
    """Loss weights (reference ``config/gan.py:39-43``).

    ``WORD`` and ``GAMMA1/2/3`` are schema *extensions*: the reference declares
    the ``ENCODER_LOSS.WORD`` flag but no weight (its implementation raises
    ``NotImplementedError``); this framework implements the word-region loss
    (``losses.word_loss``), weighted by ``WORD`` with the attentional-matching
    temperatures ``GAMMA1`` (word->region attention), ``GAMMA2`` (log-sum-exp
    aggregation) and ``GAMMA3`` (InfoNCE score scale) — defaults are the
    AttnGAN/DAMSM COCO values.  Reference YAMLs never set any of these, so
    strict-merge parity is unaffected."""

    MISMATCH: float = 1.0
    GLOBAL: float = 0.5
    SENT: float = 1.0
    DISC: float = 1.0
    WORD: float = 1.0
    GAMMA1: float = 4.0
    GAMMA2: float = 5.0
    GAMMA3: float = 10.0


@dataclass(frozen=True)
class OptConfig:
    """Adam hyper-parameters for G and D (reference ``config/gan.py:46-52``)."""

    G_LR: float = 0.0001
    G_BETA1: float = 0.5
    G_BETA2: float = 0.999
    D_LR: float = 0.0004
    D_BETA1: float = 0.5
    D_BETA2: float = 0.999


@dataclass(frozen=True)
class TrainConfig:
    """Training loop parameters (reference ``config/gan.py:14-52``)."""

    FLAG: bool = True  # dead key, schema parity
    MAX_EPOCH: int = 1000
    BATCH_SIZE: int = 256
    NUM_WORKERS: int = 8
    LOG_INTERVAL: int = 1
    SAVE_INTERVAL: int = 1  # dead key, schema parity
    N_CRITIC: int = 1
    HE_INIT: bool = False
    NEF: int = 128
    NCH: int = 32
    NOISE_DIM: int = 128
    RMIS_LOSS: bool = False
    MAGP: bool = False
    ENCODER_LOSS: EncoderLossConfig = field(default_factory=EncoderLossConfig)
    SMOOTH: SmoothConfig = field(default_factory=SmoothConfig)
    OPT: OptConfig = field(default_factory=OptConfig)


@dataclass(frozen=True)
class GenConfig:
    """Generator selection (reference ``config/gan.py:55-57``)."""

    ENCODER_NAME: str = ""
    NORMALIZE: bool = True


@dataclass(frozen=True)
class DiscConfig:
    """Discriminator selection and projection-head mode
    (reference ``config/gan.py:59-67``)."""

    ENCODER_NAME: str = ""
    ENCODER_DIR: str = ""
    SPEC_NORM: bool = True
    UNCOND: bool = True  # dead key, schema parity
    COND: bool = True  # dead key, schema parity
    SENT_MATCH: bool = False
    IMG_MATCH: bool = False
    SEPERATE: bool = False  # [sic] reference spelling


@dataclass(frozen=True)
class ImgConfig:
    """Image size (reference ``config/gan.py:69-70``)."""

    SIZE: int = 64


@dataclass(frozen=True)
class TextConfig:
    """Text encoder parameters (reference ``config/gan.py:73-90``)."""

    TYPE: str = "WORD"
    CAPTIONS_PER_IMAGE: int = 5
    MAX_LENGTH: int = 20
    VOCA_SIZE: int = 27297
    ENCODER_NAME: str = "RNN"
    ENCODER_DIR: str = ""
    EMBEDDING_DIM: int = 256
    NUM_LAYERS: int = 1  # dead key, schema parity
    RNN_TYPE: str = "LSTM"
    FIX_BERT: bool = True  # dead key, schema parity
    BERT_NORM: bool = False
    POOLING_MODE: str = "MEAN"
    SENT_FT: bool = False  # dead key, schema parity
    WORD_FT: bool = False  # dead key, schema parity
    JOINT_FT: bool = False  # dead key, schema parity


@dataclass(frozen=True)
class Config:
    """Root config mirroring the reference schema (``config/gan.py:10-90``)."""

    CONFIG_NAME: str = ""
    DATASET_NAME: str = "coco"
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    GEN: GenConfig = field(default_factory=GenConfig)
    DISC: DiscConfig = field(default_factory=DiscConfig)
    IMG: ImgConfig = field(default_factory=ImgConfig)
    TEXT: TextConfig = field(default_factory=TextConfig)

    def replace(self, **kwargs: Any) -> "Config":
        return dataclasses.replace(self, **kwargs)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def default_config() -> Config:
    return Config()


def _merge_into_dataclass(node: Any, overrides: Mapping[str, Any], path: str = "") -> Any:
    """Strict merge of a mapping into a dataclass node.

    Reproduces the validation semantics of the reference ``_merge_a_into_b``
    (``config/gan.py:92-122``): unknown keys -> KeyError; type mismatches ->
    ValueError (``int`` is accepted where ``float`` is expected, matching YAML
    parsing of values like ``1`` for a weight, and bool is *not* accepted for
    int, matching Python's ``type() is`` check in spirit while staying usable).
    """
    if not isinstance(overrides, Mapping):
        raise ValueError(f"Config node {path or '<root>'} must be a mapping, got {type(overrides)}")

    valid = {f.name: f for f in fields(node)}
    updates: dict[str, Any] = {}
    for key, value in overrides.items():
        if key not in valid:
            raise KeyError(f"{key} is not a valid config key")
        old = getattr(node, key)
        child_path = f"{path}.{key}" if path else key
        if dataclasses.is_dataclass(old):
            try:
                updates[key] = _merge_into_dataclass(old, value, child_path)
            except (KeyError, ValueError):
                print(f"Error under config key: {key}")
                raise
            continue
        old_type = type(old)
        if old_type is float and isinstance(value, int) and not isinstance(value, bool):
            value = float(value)
        elif old_type is bool:
            if not isinstance(value, bool):
                raise ValueError(
                    f"Type mismatch ({old_type} vs. {type(value)}) for config key: {child_path}"
                )
        elif not isinstance(value, old_type) or (old_type is int and isinstance(value, bool)):
            raise ValueError(
                f"Type mismatch ({old_type} vs. {type(value)}) for config key: {child_path}"
            )
        updates[key] = value
    return dataclasses.replace(node, **updates)


def cfg_from_dict(overrides: Mapping[str, Any], base: Config | None = None) -> Config:
    """Merge a (possibly nested) dict of overrides into the defaults, strictly."""
    return _merge_into_dataclass(base or Config(), overrides)


def cfg_from_file(filename: str, base: Config | None = None) -> Config:
    """Load a reference-schema YAML file and merge it into the defaults.

    Mirrors reference ``cfg_from_file`` (``config/gan.py:125-131``) but returns a
    new immutable Config instead of mutating a global.
    """
    with open(filename, "r") as f:
        yaml_cfg = yaml.safe_load(f)
    if yaml_cfg is None:
        return base or Config()
    return cfg_from_dict(yaml_cfg, base=base)
