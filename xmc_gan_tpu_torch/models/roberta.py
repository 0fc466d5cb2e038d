"""The RoBERTa encoder as ``nn.Module``s: the ``last_hidden_state`` of the
JAX package's ``FlaxRobertaModel`` (``xmc_gan_tpu/data/text_encode.py:45,61-64``),
which encodes SENT captions for the SBERT cache.

* Embeddings: word + position + token type (all ids 0), LayerNorm with the
  config's eps; position ids ``pad_id + cumsum(m) * m`` with ``m = ids !=
  pad_id``, as HF computes them.
* ``num_hidden_layers`` post-LN layers: self-attention scaled by
  ``1 / sqrt(d_head)`` with the padding keys' bias at the dtype's minimum
  (as Flax adds it), then the exact-erf GELU feed-forward.
* No pooler, no dropout.  The names of the parameters are HF's, so a
  ``RobertaModel`` state_dict loads as it is (``load_roberta``).

The products are ``F.linear``/``torch.matmul``: the JAX package leaves them to
XLA, not to a Pallas kernel.  ``load_roberta`` reads ``config.json`` and
``pytorch_model.bin``, the file JAX's ``from_pt=True`` converts.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["RobertaConfig", "RobertaModel", "load_roberta", "save_roberta"]

# HF checkpoint entries that hold no part of the encoder's last hidden state
SKIPPED_KEYS = ("embeddings.position_ids",)
SKIPPED_PREFIXES = ("pooler.",)


@dataclasses.dataclass(frozen=True)
class RobertaConfig:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1
    hidden_act: str = "gelu"

    @classmethod
    def from_json(cls, path: str) -> "RobertaConfig":
        with open(path) as f:
            doc = json.load(f)
        cfg = cls(**{f.name: doc[f.name] for f in dataclasses.fields(cls) if f.name in doc})
        if cfg.hidden_act != "gelu":
            raise ValueError(f"{path}: hidden_act {cfg.hidden_act!r}; the encoder takes 'gelu' "
                             "(exact erf) only")
        if doc.get("position_embedding_type", "absolute") != "absolute":
            raise ValueError(f"{path}: position_embedding_type "
                             f"{doc['position_embedding_type']!r}; the encoder takes 'absolute'")
        if cfg.hidden_size % cfg.num_attention_heads:
            raise ValueError(f"{path}: hidden_size {cfg.hidden_size} is not a multiple of "
                             f"num_attention_heads {cfg.num_attention_heads}")
        return cfg

    def to_json(self) -> dict:
        return {"model_type": "roberta", "architectures": ["RobertaModel"],
                "position_embedding_type": "absolute", "bos_token_id": 0, "eos_token_id": 2,
                **dataclasses.asdict(self)}


class Embeddings(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.pad_id = cfg.pad_token_id
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        real = (input_ids != self.pad_id).long()
        positions = torch.cumsum(real, dim=1) * real + self.pad_id
        x = (self.word_embeddings(input_ids) + self.position_embeddings(positions)
             + self.token_type_embeddings.weight[0])
        return self.LayerNorm(x)


class SelfAttention(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.heads = cfg.num_attention_heads
        self.query = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.key = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.value = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, t, h = x.shape
        split = lambda y: y.view(b, t, self.heads, h // self.heads).transpose(1, 2)
        q = split(self.query(x)) / math.sqrt(h // self.heads)
        k, v = split(self.key(x)), split(self.value(x))
        probs = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) + bias, dim=-1)
        return torch.matmul(probs, v).transpose(1, 2).reshape(b, t, h)


class SelfOutput(nn.Module):
    def __init__(self, cfg: RobertaConfig, width: int):
        super().__init__()
        self.dense = nn.Linear(width, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, y: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(self.dense(y) + residual)


class Attention(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.self = SelfAttention(cfg)
        self.output = SelfOutput(cfg, cfg.hidden_size)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return self.output(self.self(x, bias), x)


class Intermediate(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.dense(x))  # exact erf, HF's and Flax's "gelu"


class Layer(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.attention = Attention(cfg)
        self.intermediate = Intermediate(cfg)
        self.output = SelfOutput(cfg, cfg.intermediate_size)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = self.attention(x, bias)
        return self.output(self.intermediate(x), x)


class Encoder(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.layer = nn.ModuleList(Layer(cfg) for _ in range(cfg.num_hidden_layers))


class RobertaModel(nn.Module):
    """``(input_ids, attention_mask)`` ``[B, T]`` -> the last hidden state
    ``[B, T, hidden_size]`` in the parameters' dtype."""

    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = Embeddings(cfg)
        self.encoder = Encoder(cfg)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        x = self.embeddings(input_ids)
        # Flax's attention bias: 0 at a real key, the dtype's minimum at padding
        bias = torch.zeros(attention_mask.shape, dtype=x.dtype, device=x.device)
        bias = bias.masked_fill(attention_mask == 0, torch.finfo(x.dtype).min)[:, None, None, :]
        for layer in self.encoder.layer:
            x = layer(x, bias)
        return x


def load_roberta(path: str, device: str | torch.device = "cpu") -> RobertaModel:
    """The encoder of the checkpoint directory ``path`` (``config.json``,
    ``pytorch_model.bin``) on ``device``, fp32, in eval mode and frozen.

    Keys may carry the ``roberta.`` prefix of a task model; the pooler and
    the ``embeddings.position_ids`` buffer are skipped by name.  A missing
    file, a missing or other unexpected key, or a shape that differs raises,
    naming the file and the key."""
    config_file = os.path.join(path, "config.json")
    weights_file = os.path.join(path, "pytorch_model.bin")
    for f in (config_file, weights_file):
        if not os.path.isfile(f):
            raise FileNotFoundError(f"{f} not found (a RoBERTa checkpoint directory holds it)")
    model = RobertaModel(RobertaConfig.from_json(config_file))
    want = model.state_dict()
    got = {}
    for key, value in torch.load(weights_file, map_location="cpu", weights_only=True).items():
        name = key.removeprefix("roberta.")
        if name in SKIPPED_KEYS or name.startswith(SKIPPED_PREFIXES):
            continue
        if name not in want:
            raise ValueError(f"{weights_file}: unexpected key {key!r}")
        if tuple(value.shape) != tuple(want[name].shape):
            raise ValueError(f"{weights_file}: {key!r} has shape {tuple(value.shape)}, the "
                             f"config gives {tuple(want[name].shape)}")
        got[name] = value
    missing = sorted(set(want) - set(got))
    if missing:
        raise ValueError(f"{weights_file}: missing key {missing[0]!r}"
                         + (f" and {len(missing) - 1} more" if len(missing) > 1 else ""))
    model.load_state_dict(got, strict=True)
    return model.float().to(device).eval().requires_grad_(False)


def save_roberta(path: str, model: RobertaModel, vocab: dict[str, int],
                 merges: list[tuple[str, str]]) -> str:
    """Write ``model`` and its tokenizer files as a checkpoint directory that
    ``load_roberta`` and ``data.bpe.ByteLevelBPETokenizer.from_dir`` read
    (and HF's ``from_pretrained``): ``config.json``, ``pytorch_model.bin``,
    ``vocab.json``, ``merges.txt``."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(model.config.to_json(), f)
    torch.save({k: v.detach().cpu().contiguous() for k, v in model.state_dict().items()},
               os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return path
