"""PyTorch + CUDA port of ``xmc_gan_tpu`` for NVIDIA Hopper (H100, sm_90a).

The JAX package beside it is the reference; this package imports neither JAX
nor anything of ``xmc_gan_tpu`` and keeps its own copies of what it needs.
The module layout mirrors the JAX package.  Every config the JAX package
ships (``xmc_gan_tpu/cfg/*.yml``) trains and serves: the DAMSM RNN and
Sentence-BERT text encoders, the DF-GAN and concept generators and
discriminators, the train step, ``Trainer`` and the CLI, with the
hand-written CUDA kernels of ``csrc/`` (``ops/cuda/``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU and no explicit CPU request they raise (``device.resolve_device``).
"""

__all__: list[str] = []
