"""PyTorch + CUDA port of ``xmc_gan_tpu`` for NVIDIA Hopper (H100, sm_90a).

The JAX package beside it is the reference; this package imports neither JAX
nor anything of ``xmc_gan_tpu`` and keeps its own copies of what it needs.
The module layout mirrors the JAX package.  Ported so far: the serving path
(DAMSM RNN text encoder -> DF-GAN ``NetG`` -> images) with the hand-written
CUDA kernel for the generator's modulation epilogue
(``ops/cuda/fused_affine.py``, source ``csrc/fused_affine.cu``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU and no explicit CPU request they raise (``device.resolve_device``).
"""

__all__: list[str] = []
