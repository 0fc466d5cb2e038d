"""Portable serving artifacts for the sampler via ``torch.export``.

Port of ``xmc_gan_tpu/utils/export.py``, whose seam is ``jax.export``: the
sampler traces once to a versioned program (``torch.export``'s
``ExportedProgram``, saved as a ``.pt2`` archive) that a process loads and
runs without the Python model code.  Parameters remain call-time inputs, so
one artifact serves every checkpoint of a config: they are a dict keyed like
``make_generator(cfg).state_dict()``, and G runs over them through
``torch.func.functional_call``.  The batch axis is exported symbolically by
default (``torch.export.Dim``, any request size from 1 up), so one artifact
serves any request size.

Word-attention generator families (``uses_words``) take ``words`` and
``mask`` and export with them; the DF-GAN and concept-DF families condition
on the sentence embedding only and export a 3-argument artifact.  The result
is ``[B, H, W, 3]`` fp32 in ``[-1, 1]``, as ``train.make_sample_fn`` returns.

The hand-written kernels cannot be traced (they launch through ``ctypes``),
so the program holds each of their calls as one node of a registered
operator (``torch.ops.xmc_gan_tpu_torch.*``, ``ops/cuda/fused_affine.py``
and ``ops/cuda/cross_attention.py``): on the card each node launches its
kernel, on CPU tensors it runs the plain version.  ``load_sampler`` imports
those registrations and nothing of the models.

``device`` stands in for the JAX version's ``platforms``: the program holds
the device it was traced on (``cuda`` unless the caller passes ``cpu``), and
the loaded sampler moves its inputs there.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch
from torch import nn

# the registered operators that an exported program's nodes call
from xmc_gan_tpu_torch.ops.cuda import cross_attention as _cross_attention  # noqa: F401
from xmc_gan_tpu_torch.ops.cuda import fused_affine as _fused_affine  # noqa: F401

__all__ = ["uses_words", "export_sampler", "save_sampler", "load_sampler", "sampler_fn",
           "sampler_ops"]

# the example batch of a symbolic export: torch.export specialises a
# dimension whose example size is 0 or 1, so it traces at 2 and declares 1 valid
_EXAMPLE_BATCH = 2


def uses_words(cfg) -> bool:
    """Whether the configured generator family consumes words/mask in G
    (the word-attention concept family, ``models/concept_gan.py``)."""
    return "ATTN" in cfg.GEN.ENCODER_NAME and "DF" not in cfg.GEN.ENCODER_NAME


def sampler_ops() -> tuple:
    """The registered operators an exported sampler may hold."""
    ops = torch.ops.xmc_gan_tpu_torch
    return ops.fused_affine.default, ops.masked_cross_attention.default


class _Sampler(nn.Module):
    """G's forward over call-time parameters; G is held outside the module
    tree, so its tensors are inputs of the program and none is stored in it."""

    def __init__(self, g: nn.Module):
        super().__init__()
        self.__dict__["g"] = g

    def forward(self, g_params: dict[str, torch.Tensor], noise: torch.Tensor,
                sent: torch.Tensor, words: torch.Tensor | None = None,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        img = torch.func.functional_call(self.g, g_params, (noise, sent, words, mask),
                                         strict=True)
        return img.permute(0, 2, 3, 1)


def export_sampler(cfg, *, batch_size: int | None = None, dtype: torch.dtype = torch.float32,
                   device: str | torch.device | None = None):
    """Trace the sampler of ``cfg`` (activations in ``dtype``) on ``device``
    into an ``ExportedProgram``.

    ``batch_size=None`` exports a symbolic batch dimension (any request size
    from 1 up); an int pins it.  Returns ``(exported, g_params_template)``,
    the template a dict of ``meta`` tensors with the shapes and dtypes of
    the generator parameters the program expects, keyed like
    ``make_generator(cfg).state_dict()`` (load real values from a
    checkpoint)."""
    from xmc_gan_tpu_torch.device import resolve_device
    from xmc_gan_tpu_torch.train import make_generator

    dev = resolve_device(device)
    g = make_generator(cfg, dtype, dev)
    params = dict(g.state_dict())
    words = uses_words(cfg)
    b = _EXAMPLE_BATCH if batch_size is None else batch_size
    gen = torch.Generator().manual_seed(0)
    t, e = cfg.TEXT.MAX_LENGTH, cfg.TEXT.EMBEDDING_DIM
    args = [params, torch.randn(b, cfg.TRAIN.NOISE_DIM, generator=gen).to(dev),
            torch.randn(b, e, generator=gen).to(dev)]
    if words:
        args += [torch.randn(b, t, e, generator=gen).to(dev),
                 (torch.arange(t) >= max(1, t // 2)).expand(b, t).contiguous().to(dev)]
    dynamic = None
    if batch_size is None:
        batch = torch.export.Dim("batch", min=1)
        dynamic = [{k: None for k in params}] + [{0: batch}] * (len(args) - 1)
    with torch.no_grad():
        exported = torch.export.export(_Sampler(g), tuple(args), dynamic_shapes=dynamic,
                                       strict=False)
    # the example inputs hold a whole random G: keep them out of the artifact
    exported.example_inputs = None
    template = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                for k, v in params.items()}
    return exported, template


def save_sampler(path: str, exported) -> str:
    torch.export.save(exported, path)
    return path


def _children(spec) -> list:
    """A pytree spec's children, in the API of this torch's version."""
    children = getattr(spec, "children", None)
    return list(children() if callable(children) else spec.children_specs)


def _inputs(exported) -> tuple[list[str], int, torch.device]:
    """The program's parameter keys in its input order, its number of
    inputs (3 or 5) and the device it was traced on."""
    args_spec = _children(exported.call_spec.in_spec)[0]
    inputs = _children(args_spec)
    keys = list(inputs[0].context)
    user = [n for n in exported.graph.nodes
            if n.op == "placeholder" and n.name in exported.graph_signature.user_inputs]
    devices = {n.meta["val"].device for n in user if isinstance(n.meta.get("val"), torch.Tensor)}
    (dev,) = devices
    return keys, len(inputs), dev


def load_sampler(path: str) -> Callable:
    """Deserialize an artifact into ``fn(g_params, noise, sent, words=None,
    mask=None) -> images`` (no model code needed; ``sampler_fn``)."""
    return sampler_fn(torch.export.load(path))


def sampler_fn(exported) -> Callable:
    """``fn(g_params, noise, sent, words=None, mask=None) -> images`` over an
    exported sampler.  ``g_params`` is a dict keyed like
    ``make_generator(cfg).state_dict()`` (tensors or arrays); every input is
    moved to the program's device, each parameter made dense.

    Turns TF32 off once, process-wide, as ``make_sample_fn`` does, so fp32
    convolutions on the card are full fp32."""
    keys, n_inputs, dev = _inputs(exported)
    program = exported.module()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    def to(x):
        return torch.as_tensor(x).to(dev)

    @torch.inference_mode()
    def call(g_params: Mapping, noise, sent, words=None, mask=None) -> torch.Tensor:
        missing = set(keys) ^ set(g_params)
        if missing:
            raise KeyError(f"g_params do not match the artifact's parameters: {sorted(missing)}")
        # dense, as a module's own parameters are (a converted state_dict may
        # hold transposed views, which the convolutions would take another way)
        args = [{k: to(g_params[k]).contiguous() for k in keys}, to(noise).float(),
                to(sent).float()]
        if n_inputs == 5:
            if words is None or mask is None:
                raise ValueError("this sampler's generator attends over words: pass words "
                                 "and mask")
            args += [to(words).float(), to(mask).bool()]
        return program(*args)

    return call
