"""The port's masked cross-attention (``ops/cuda/cross_attention.py``, plain
version on CPU tensors) against the JAX package's ``masked_cross_attention``,
its XLA branch and its Pallas kernel in interpret mode, on the same numpy
inputs."""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from xmc_gan_tpu.ops.pallas.cross_attention import masked_cross_attention as jax_mca
from xmc_gan_tpu_torch.ops import cross_attention as seam
from xmc_gan_tpu_torch.ops.cuda import build as cuda_build
from xmc_gan_tpu_torch.ops.cuda import cross_attention as ca

BF16_ULP = 2.0 ** -7


def _inputs(seed, b, n, t, d, lens=None):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, m, d).astype(np.float32) for m in (n, t, t))
    mask = np.zeros((b, t), bool)
    for i, n_words in enumerate(lens or [t // 2, 3]):
        mask[i, n_words:] = True
    return q, k, v, mask


def _port(q, k, v, mask, scale=1.0):
    return ca.masked_cross_attention_kernel(*map(torch.from_numpy, (q, k, v, mask)), scale).numpy()


# (n, t, d, scale): the JAX package's kernel tests (test_pallas_ops.py:38-57),
# the concept shape (D = 4, T = 15) and a ragged D = 48 one.
CASES = [(64, 20, 32, 0.7), (300, 260, 32, 0.7), (256, 15, 4, 1.0), (77, 33, 48, 0.7)]


@pytest.mark.parametrize("n,t,d,scale", CASES)
def test_plain_matches_jax_xla(n, t, d, scale):
    """Tolerance 1e-5: the same fp32 math in another summation order."""
    q, k, v, mask = _inputs(0, 2, n, t, d)
    want = np.asarray(jax_mca(q, k, v, mask, scale=scale, backend="xla"))
    np.testing.assert_allclose(_port(q, k, v, mask, scale), want, rtol=1e-5, atol=1e-5)


def test_plain_matches_pallas_interpret_and_pins_the_fully_padded_row():
    """T = 150 streams two of the Pallas kernel's 128-word blocks; row 2 has
    no word.  The port and the Pallas kernel give that row 0; the JAX XLA
    branch's dense softmax gives NaN there (the recorded difference between
    the two JAX backends; the port follows the kernel).  Tolerance 2e-5, as
    the JAX package's own kernel test."""
    q, k, v, mask = _inputs(1, 3, 40, 150, 8, lens=[150, 7, 0])
    got = _port(q, k, v, mask, 0.5)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jax_mca(q, k, v, mask, scale=0.5, backend="pallas"))
    xla = np.asarray(jax_mca(q, k, v, mask, scale=0.5, backend="xla"))
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)
    assert (got[2] == 0).all() and (pallas[2] == 0).all()
    assert np.isnan(xla[2]).all()
    np.testing.assert_allclose(got[:2], xla[:2], rtol=1e-5, atol=1e-5)


def test_grouped_operands_share_the_row_mask():
    """``q`` ``[B, G, N, D]`` and ``k``/``v`` ``[B, G, T, D]`` as strided views
    (the In sampler's layout, ``[B, N, G, D]`` in memory) with a ``[B, T]``
    mask: the same as the JAX function on ``[B*G, ...]`` rows with the mask
    repeated over G."""
    rng = np.random.RandomState(2)
    b, g, n, t, d = 2, 3, 10, 6, 4
    qm = rng.randn(b, n, g, d).astype(np.float32)
    km = rng.randn(b, t, g, d).astype(np.float32)
    mask = np.array([[False] * 4 + [True] * 2, [False] * 2 + [True] * 4])
    q4 = torch.from_numpy(qm).transpose(1, 2)
    k4 = torch.from_numpy(km).transpose(1, 2)
    assert not q4.is_contiguous()
    got = seam.masked_cross_attention(q4, k4, k4, torch.from_numpy(mask))
    assert got.shape == (b, g, n, d) and got.is_contiguous()
    flat = lambda x: np.ascontiguousarray(x.transpose(0, 2, 1, 3)).reshape(b * g, -1, d)
    want = jax_mca(flat(qm), flat(km), flat(km), np.repeat(mask, g, axis=0), backend="xla")
    np.testing.assert_allclose(got.numpy().reshape(b * g, n, d), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_padded_words_do_not_matter():
    """As ``test_pallas_ops.py:60-76``: changing padded keys and values
    leaves the output as it was."""
    q, k, v, mask = _inputs(3, 1, 16, 10, 8, lens=[6])
    a = _port(q, k, v, mask)
    k2, v2 = k.copy(), v.copy()
    k2[0, 6:] += 50
    v2[0, 6:] -= 50
    np.testing.assert_allclose(_port(q, k2, v2, mask), a, rtol=1e-6)


def test_bf16_rounds_once_on_store():
    """bf16 operands: fp32 math inside, so the bf16 output is the fp32 result
    on the same (bf16-valued) operands rounded once: within one bf16 ulp."""
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(4, 2, 33, 19, 12))
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    got = ca.masked_cross_attention_kernel(qb, kb, vb, mask, 0.5)
    assert got.dtype == torch.bfloat16
    want = ca.masked_cross_attention_ref(qb.float(), kb.float(), vb.float(), mask, 0.5)
    torch.testing.assert_close(got.float(), want, rtol=BF16_ULP, atol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(5, 2, 8, 5, 4))
    with pytest.raises(ValueError, match="share one D"):
        ca.masked_cross_attention_kernel(q, k, torch.zeros(2, 5, 6), mask)
    with pytest.raises(ValueError, match="mask"):
        ca.masked_cross_attention_kernel(q, k, v, mask[:, :3])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ca.masked_cross_attention_kernel(q, k.bfloat16(), v, mask)
    with pytest.raises(ValueError, match="D <= 256"):
        big = torch.zeros(2, 5, 300)
        ca.masked_cross_attention_kernel(torch.zeros(2, 8, 300), big, big, mask)
    with pytest.raises(ValueError, match=r"\[B, \(G,\) N, D\]"):
        ca.masked_cross_attention_kernel(q[0], k, v, mask)


def test_cpu_tensors_take_the_plain_version_without_counting():
    """Autograd runs through the plain version on the CPU; the kernel's
    count stays put."""
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(6, 2, 8, 5, 4))
    before = ca.FORWARD.launches
    out = ca.masked_cross_attention_kernel(q.requires_grad_(), k, v, mask)
    assert out.requires_grad and ca.FORWARD.launches == before
    torch.testing.assert_close(out, ca.masked_cross_attention_ref(q, k, v, mask), rtol=0, atol=0)


def test_kernel_build_without_nvcc_raises_clearly(tmp_path, monkeypatch):
    """The CUDA path has no CPU mode: without the toolkit it raises."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.CudaLibrary("cross_attention.cu", ca.KERNEL.signatures).load()
