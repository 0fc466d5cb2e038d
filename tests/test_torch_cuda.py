"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the ``cuda`` marker and skips where there is no GPU:
a CUDA kernel has no CPU mode.  The file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch and the CUDA
toolkit (``tests/conftest.py`` imports JAX, hence ``--noconftest``)::

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from xmc_gan_tpu_torch.ops.cuda import fused_affine as fa

BF16_ULP = 2.0 ** -7  # spacing of bf16 values in [1, 2)
# Kernel vs plain version.  fp32: the kernel contracts each g*y+b into one
# FMA, the plain version rounds the product first; with N(0, 1) inputs the
# chain's terms reach ~1e2, so one fp32 rounding (2^-24 relative) of them is
# up to ~1e-5 absolute.  bf16: the same fp32 values rounded once on store, so
# one bf16 ulp, plus that fp32 difference where the result is near zero.
TOL = {torch.float32: (1e-5, 2e-5), torch.bfloat16: (BF16_ULP, 2e-5)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 256, 4, 4), (3, 32, 17, 9), (2, 13, 5, 7)])
def test_kernel_matches_plain_on_card(cuda_device, dtype, shape):
    """Both forms (1 and 2 modulations), the vector path (C a multiple of
    the 16-byte width) and the scalar one (C = 13)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    b, c, h, w = shape
    x = torch.randn(shape, generator=gen, device=cuda_device).to(dtype).contiguous(
        memory_format=torch.channels_last)
    mods = [torch.randn(b, c, generator=gen, device=cuda_device) for _ in range(4)]
    before = fa.KERNEL.launches
    got1 = fa.modulate_lrelu_kernel(x, *mods[:2])
    got2 = fa.double_modulate_lrelu_kernel(x, *mods)
    torch.cuda.synchronize()
    assert fa.KERNEL.launches == before + 2
    assert got2.is_contiguous(memory_format=torch.channels_last) and got2.dtype == dtype
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got1.float(), fa.modulate_lrelu_ref(x, *mods[:2]).float(),
                               rtol=rtol, atol=atol)
    torch.testing.assert_close(got2.float(), fa.double_modulate_lrelu_ref(x, *mods).float(),
                               rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_kernel_takes_bf16_modulation_vectors(cuda_device):
    """The generator hands bf16 gamma/beta in bf16 runs: the wrapper casts
    them to fp32, as the Pallas kernel does."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(2, 64, 8, 8, generator=gen, device=cuda_device).bfloat16().contiguous(
        memory_format=torch.channels_last)
    mods = [torch.randn(2, 64, generator=gen, device=cuda_device).bfloat16() for _ in range(4)]
    got = fa.double_modulate_lrelu_kernel(x, *mods)
    torch.testing.assert_close(got.float(), fa.double_modulate_lrelu_ref(x, *mods).float(),
                               rtol=TOL[torch.bfloat16][0], atol=TOL[torch.bfloat16][1])


@pytest.mark.cuda
def test_kernel_rejects_mixed_devices(cuda_device):
    x = torch.randn(2, 8, 4, 4, device=cuda_device).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="modulation vector on cpu"):
        fa.modulate_lrelu_kernel(x, torch.ones(2, 8), torch.zeros(2, 8))


@pytest.mark.cuda
def test_kernel_takes_misaligned_modulation_vectors(cuda_device):
    """A [B, C] vector that starts 4 bytes past a 16-byte boundary sends the
    launch down the scalar path; the result is the same."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(2, 32, 6, 6, generator=gen, device=cuda_device).contiguous(
        memory_format=torch.channels_last)
    g = torch.randn(2 * 32 + 1, generator=gen, device=cuda_device)[1:].view(2, 32)
    b = torch.randn(2, 32, generator=gen, device=cuda_device)
    assert g.is_contiguous() and g.data_ptr() % 16 == 4
    torch.testing.assert_close(fa.modulate_lrelu_kernel(x, g, b), fa.modulate_lrelu_ref(x, g, b),
                               rtol=TOL[torch.float32][0], atol=TOL[torch.float32][1])
