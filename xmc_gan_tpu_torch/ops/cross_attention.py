"""Masked word attention: the seam between the concept models and the kernel.

Port of the public function of ``xmc_gan_tpu/ops/pallas/cross_attention.py``
(``masked_cross_attention``, ``:95-145``).  The JAX package calls it from no
model: its word-attention concept generators run the same attention as an
einsum + softmax chain (``models/concept_gan.py:167-179,299-306``), because
their grouped state_dim=4 geometry pads 32x on the TPU's matrix unit.  That
reason does not hold on a GPU's CUDA cores, so the port's
``WordCondConceptSampler`` and ``OutConceptBlock`` call this function, which
launches the hand-written kernel (``ops/cuda/cross_attention.py``) on CUDA
tensors and uses its plain version on CPU tensors.

The one difference from the JAX einsum chain: a caption whose words are all
padded gets a zero context here (the Pallas kernel's result), NaN there.

It is the seam that ``ops/fused.py`` is for the epilogue kernel: the
models call this one name, and on CUDA tensors under autograd the wrapper
differentiates it through the port's own hand-written backward kernel
(``attn_bwd``, ``csrc/cross_attention.cu``), which the word-attention
generators train through.  The backward is the port's: the Pallas kernel
has none, and the JAX package differentiates its einsum chain instead.  Its
shapes: D <= 32 and T <= 256 (every word-attention shape: D = 4, T = 15,
20 or 200); a wider one raises ``ValueError`` under grad before any launch.
"""

from __future__ import annotations

import torch

from xmc_gan_tpu_torch.ops.cuda.cross_attention import masked_cross_attention_kernel

__all__ = ["masked_cross_attention"]


def masked_cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """``softmax_t(scale * q k^T, padding masked) @ v``: q ``[B, (G,) N, D]``,
    k/v ``[B, (G,) T, D]``, mask ``[B, T]`` True = padding; returns
    ``[B, (G,) N, D]`` in q's dtype (fp32 math inside)."""
    return masked_cross_attention_kernel(q, k, v, mask, scale)
