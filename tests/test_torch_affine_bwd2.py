"""The ``fused_affine`` single form differentiated twice (MAGP through
``CONCEPT_NETD``), on the CPU, where its plain versions run: the double
backward against JAX's second derivative of
``xmc_gan_tpu.ops.fused.modulate_lrelu`` (a scalar of the first ``grad``,
differentiated again), ``torch.autograd.gradgradcheck`` in fp64, and the
wrapper's contract (nothing recorded without ``create_graph``, the double
form's second derivative refused, a CUDA tensor never on the plain
version).  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmc_gan_tpu.ops import fused as jax_fused
from xmc_gan_tpu_torch.ops.cuda import fused_affine as fa

# fp32 on both sides, the same products summed in another order: 1e-5
# relative to each result's largest magnitude
RTOL = 1e-5


def _inputs(shape, seed):
    """x NHWC, gamma, beta and the weights of the scalar: dy (the first
    backward's cotangent) and (a, c, e) on (dx, dgamma, dbeta); a fifth of
    gamma*x + beta negative."""
    rng = np.random.RandomState(seed)
    b, h, w, c = shape
    x = rng.randn(b, h, w, c).astype(np.float32)
    g = (1.0 + 0.5 * rng.randn(b, c)).astype(np.float32)
    beta = (0.5 + 0.5 * rng.randn(b, c)).astype(np.float32)
    dy = rng.randn(b, h, w, c).astype(np.float32)
    a = rng.randn(b, h, w, c).astype(np.float32)
    cc, e = rng.randn(b, c).astype(np.float32), rng.randn(b, c).astype(np.float32)
    return x, g, beta, dy, a, cc, e


def _jax_second(x, g, beta, dy, a, cc, e):
    """JAX: grad in (x, gamma, beta, dy) of sum(a*dx) + sum(c*dgamma) +
    sum(e*dbeta), where (dx, dgamma, dbeta) = grad of sum(dy * y)."""
    def first(x, g, beta, dy):
        return jax.grad(lambda x, g, beta: jnp.sum(dy * jax_fused.modulate_lrelu(x, g, beta)),
                        argnums=(0, 1, 2))(x, g, beta)

    def scalar(x, g, beta, dy):
        dx, dg, db = first(x, g, beta, dy)
        return jnp.sum(a * dx) + jnp.sum(cc * dg) + jnp.sum(e * db)

    return [np.asarray(t) for t in jax.jit(jax.grad(scalar, argnums=(0, 1, 2, 3)))(
        x, g, beta, dy)]


def _nchw(x, dtype=torch.float32):
    return torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype).contiguous(
        memory_format=torch.channels_last)


def _port_second(x, g, beta, dy, a, cc, e, dtype=torch.float32):
    xt = _nchw(x, dtype).requires_grad_()
    gt, bt = (torch.from_numpy(v).to(dtype).requires_grad_() for v in (g, beta))
    dyt = _nchw(dy, dtype).requires_grad_()
    y = fa.modulate_lrelu_kernel(xt, gt, bt)
    dx, dg, db = torch.autograd.grad(y, (xt, gt, bt), dyt, create_graph=True)
    scalar = ((_nchw(a, dtype) * dx).sum() + (torch.from_numpy(cc).to(dtype) * dg).sum()
              + (torch.from_numpy(e).to(dtype) * db).sum())
    return torch.autograd.grad(scalar, (xt, gt, bt, dyt), allow_unused=True)


# D's shapes at NCH 4 (batch, H, W, 128 channels: the concept groups), a
# ragged C and an odd H*W
@pytest.mark.parametrize("shape", [(2, 8, 8, 128), (3, 4, 4, 128), (2, 5, 3, 13)])
def test_double_backward_matches_jax(shape):
    """``g_x = s*dy*c``, ``g_dy = s*(gamma*a + c*x + e)``, ``g_gamma =
    sum_hw s*dy*a`` and no ``beta`` gradient, against JAX's autodiff of its
    plain epilogue."""
    ins = _inputs(shape, seed=sum(shape))
    jx, jg, jb, jdy = _jax_second(*ins)
    gx, gg, gb, gdy = _port_second(*ins)
    assert gb is None and not jb.any()  # s is piecewise constant
    for got, want in ((gx, jx), (gdy, jdy)):
        got = got.permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * np.abs(want).max())
    np.testing.assert_allclose(gg.numpy(), jg, rtol=0, atol=RTOL * np.abs(jg).max())


def test_gradgradcheck_fp64():
    """The plain versions in fp64 against finite differences of the first
    backward (``torch.autograd.gradgradcheck``), dy and the incoming
    gradients random."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 6, 3, 5, generator=gen, dtype=torch.float64).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    g = (1 + 0.5 * torch.randn(2, 6, generator=gen, dtype=torch.float64)).requires_grad_()
    b = (0.3 * torch.randn(2, 6, generator=gen, dtype=torch.float64)).requires_grad_()
    assert torch.autograd.gradcheck(fa.modulate_lrelu_kernel, (x, g, b))
    assert torch.autograd.gradgradcheck(fa.modulate_lrelu_kernel, (x, g, b))


def test_double_backward_keeps_dtypes_and_records_nothing_without_create_graph():
    """bf16 in, bf16 out (fp32 math, rounded once); without ``create_graph``
    the backward's results carry no graph; no CPU call counts a launch."""
    ins = _inputs((2, 4, 4, 16), seed=3)
    before = (fa.BACKWARD.launches, fa.DOUBLE_BACKWARD.launches)
    grads = _port_second(*ins, dtype=torch.bfloat16)
    assert [t.dtype for t in grads if t is not None] == [torch.bfloat16] * 3
    want = _port_second(*ins)
    for got, w in zip(grads, want):
        if w is not None:
            np.testing.assert_allclose(got.float().numpy(), w.numpy(), rtol=2 ** -6,
                                       atol=2 ** -6 * w.abs().max().item())
    x = _nchw(ins[0]).requires_grad_()
    g, b = (torch.from_numpy(v).requires_grad_() for v in ins[1:3])
    y = fa.modulate_lrelu_kernel(x, g, b)
    firsts = torch.autograd.grad(y, (x, g, b), _nchw(ins[3]))
    assert not any(t.requires_grad for t in firsts)
    assert (fa.BACKWARD.launches, fa.DOUBLE_BACKWARD.launches) == before


def test_double_form_refuses_its_second_derivative():
    ins = _inputs((2, 4, 4, 8), seed=5)
    x = _nchw(ins[0]).requires_grad_()
    mods = [torch.from_numpy(v).requires_grad_() for v in (ins[1], ins[2], ins[1], ins[2])]
    y = fa.double_modulate_lrelu_kernel(x, *mods)
    dx = torch.autograd.grad(y.sum(), x, create_graph=True)[0]
    with pytest.raises(NotImplementedError, match="differentiate twice the double form"):
        dx.sum().backward()


def test_cuda_double_backward_never_takes_the_plain_version(monkeypatch):
    """On CUDA tensors the double backward reaches the launch (which raises
    here, with no card) and never the plain version."""
    class Reached(Exception):
        pass

    def launch(*args):
        raise Reached

    def plain(*args):
        raise AssertionError("a CUDA tensor took the plain double backward")

    ins = _inputs((2, 4, 4, 8), seed=6)
    x = _nchw(ins[0]).requires_grad_()
    g, b = (torch.from_numpy(v).requires_grad_() for v in ins[1:3])
    y = fa.modulate_lrelu_kernel(x, g, b)
    dx, dg, _ = torch.autograd.grad(y, (x, g, b), _nchw(ins[3]).requires_grad_(),
                                    create_graph=True)
    real_device = torch.Tensor.device
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fa, "_launch_bwd2", launch)
        mp.setattr(fa, "fused_affine_bwd2_ref", plain)
        mp.setattr(torch.Tensor, "device", property(lambda t: torch.device("cuda")))
        with pytest.raises(Reached):
            torch.autograd.grad(dx.sum() + dg.sum(), x)
    assert torch.Tensor.device is real_device


def test_bwd2_kernel_name_follows_the_plan():
    p = fa.plan_bwd(88, 32 * 32, 128, torch.bfloat16, torch.bfloat16, (0,) * 5, 132)
    assert p.kernel == fa.BWD_VEC
    assert fa.bwd2_kernel_name(p, torch.bfloat16, torch.bfloat16) == (
        "fused_affine_bwd2_vec<__nv_bfloat16, __nv_bfloat16>")
    p = fa.plan_bwd(2, 15, 13, torch.float32, torch.float32, (0,) * 5, 132)
    assert p.kernel == fa.BWD_SCALAR
    with pytest.raises(ValueError, match="multiple of 4 .* 16-byte aligned"):
        fa.bwd2_kernel_name(p, torch.float32, torch.float32)
