"""The port's DAMSM ``RNNEncoder`` against the JAX package's masked scan, with
weights carried by ``utils/convert.rnn_encoder_state_dict``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmc_gan_tpu.config import cfg_from_dict as jax_cfg_from_dict
from xmc_gan_tpu.models.encoder import RNNEncoder as JaxRNNEncoder
from xmc_gan_tpu_torch.config import cfg_from_dict
from xmc_gan_tpu_torch.models.encoder import RNNEncoder
from xmc_gan_tpu_torch.utils.convert import rnn_encoder_state_dict

T = 6


def _encoders(rnn_type):
    over = {"TEXT": {"EMBEDDING_DIM": 32, "MAX_LENGTH": T, "VOCA_SIZE": 40,
                     "RNN_TYPE": rnn_type}}
    jax_enc = JaxRNNEncoder(jax_cfg_from_dict(over))
    params = jax_enc.init(jax.random.PRNGKey(0), jnp.zeros((1, T), jnp.int32))["params"]
    params = jax.tree.map(np.asarray, params)
    port = RNNEncoder(cfg_from_dict(over), gen=torch.Generator().manual_seed(0))
    port.load_state_dict(rnn_encoder_state_dict(params), strict=True)
    return jax_enc, params, port.eval()


@pytest.mark.parametrize("rnn_type", ["LSTM", "GRU"])
def test_rnn_encoder_matches_jax_lengths_0_1_T(rnn_type):
    """Lengths 0, 1 and T (plus two in between).  Length 0 gives zero words
    and a zero sentence.  Tolerance: fp32 gate math in another order (1e-5)."""
    jax_enc, params, port = _encoders(rnn_type)
    rng = np.random.RandomState(1)
    lens = np.array([T, 0, 1, 3, 5], np.int64)
    caps = np.zeros((len(lens), T), np.int64)
    for i, n in enumerate(lens):
        caps[i, :n] = rng.randint(1, 40, n)
    want = jax_enc.apply({"params": params}, jnp.asarray(caps), jnp.asarray(lens))
    with torch.no_grad():
        got = port(torch.from_numpy(caps), torch.from_numpy(lens))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[0].shape == (len(lens), T, 32) and got[1].shape == (len(lens), 32)
    assert not got[0][1].any() and not got[1][1].any()
    assert not got[0][2, 1:].any()


def test_rnn_encoder_infers_lengths_from_padding():
    _, _, port = _encoders("LSTM")
    caps = torch.tensor([[3, 4, 5, 0, 0, 0], [7, 0, 0, 0, 0, 0]])
    with torch.no_grad():
        a = port(caps)
        b = port(caps, torch.tensor([3, 1]))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
