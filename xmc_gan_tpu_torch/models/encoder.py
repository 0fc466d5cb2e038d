"""Frozen DAMSM text encoder (port of ``RNNEncoder`` in ``xmc_gan_tpu/models/encoder.py``).

Embedding(300) + dropout + one bidirectional LSTM or GRU layer (reference
``RNN_ENCODER``, ``encoder.py:73-153``).  Module names are the reference's
(``encoder.weight``, ``rnn.weight_ih_l0[_reverse]``, ...), so the pretrained
``text_encoder100.pth`` loads directly with ``load_state_dict``.

The RNN runs as ``torch.nn.LSTM``/``GRU`` over a packed batch, as the
reference does (the JAX package left the RNN to XLA, so there is no TPU kernel
to port here).  Semantics match the JAX masked scan: per-step outputs are zero
past each caption's length; the forward direction's final state is the state
at ``len-1`` and the backward direction's the state after index 0.  Packing
rejects length 0, so such captions run with length 1 and their outputs and
final states are zeroed afterwards (the JAX scan never updates their carry).

Outputs, as in the JAX package: ``words_embs`` ``[B, T, D]``, ``sent_embs``
``[B, D]``, ``mask`` ``[B, T]`` with True at padding (``caps == 0``).  The
encoder runs in fp32.  ``SBERTEncoder`` comes with a later slice.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from xmc_gan_tpu_torch.config import Config

__all__ = ["RNNEncoder"]

_RNN = {"LSTM": nn.LSTM, "GRU": nn.GRU}


class RNNEncoder(nn.Module):
    """DAMSM bi-RNN text encoder.  Frozen during GAN training (the reference
    loads ``text_encoder100.pth`` and calls ``.eval()``), so use it in eval
    mode: dropout is then off."""

    def __init__(self, cfg: Config, *, gen: torch.Generator):
        super().__init__()
        tc = cfg.TEXT
        if tc.RNN_TYPE not in _RNN:
            raise NotImplementedError(f"RNN_TYPE={tc.RNN_TYPE!r} (reference parity)")
        ninput, drop_prob = 300, 0.5  # reference encoder.py:80-81
        nhidden = tc.EMBEDDING_DIM // 2  # bidirectional, encoder.py:90
        self.rnn_type = tc.RNN_TYPE
        self.encoder = nn.Embedding(tc.VOCA_SIZE, ninput)
        self.drop = nn.Dropout(drop_prob)
        self.rnn = _RNN[tc.RNN_TYPE](ninput, nhidden, num_layers=1, batch_first=True,
                                     bidirectional=True)
        with torch.no_grad():
            # reference _init_weights (encoder.py:110); torch's default RNN init
            self.encoder.weight.uniform_(-0.1, 0.1, generator=gen)
            bound = 1.0 / math.sqrt(nhidden)
            for p in self.rnn.parameters():
                p.uniform_(-bound, bound, generator=gen)

    def forward(self, caps: torch.Tensor, cap_lens: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``caps`` int ``[B, T]`` token ids (0 = padding); ``cap_lens`` ``[B]``
        (default: the count of non-zero ids)."""
        T = caps.shape[1]
        if cap_lens is None:
            cap_lens = (caps != 0).sum(1)
        mask = caps == 0  # reference encoder.py:149
        embs = self.drop(self.encoder(caps))
        lens = cap_lens.to(device="cpu", dtype=torch.int64)
        packed = pack_padded_sequence(embs, lens.clamp(1, T), batch_first=True,
                                      enforce_sorted=False)
        out, h_n = self.rnn(packed)
        words, _ = pad_packed_sequence(out, batch_first=True, total_length=T)
        if self.rnn_type == "LSTM":
            h_n = h_n[0]
        # final hidden of both directions, forward first (encoder.py:144-147)
        sent = torch.cat([h_n[0], h_n[1]], dim=-1)
        valid = (lens > 0).to(caps.device)
        return words * valid[:, None, None], sent * valid[:, None], mask
