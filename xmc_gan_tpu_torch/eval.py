"""Evaluation: sampling + Fréchet Inception Distance (port of ``xmc_gan_tpu/eval.py``).

Reference ``eval`` (``train_gan.py:338-396``): generate ``num_samples=6000``
test images with fresh noise, save PNGs per key, then
``pytorch_fid.calculate_fid_given_paths([org, fake], bs=100, dims=2048)``.
As in the JAX package, the images never leave the card: generated and real
batches stream through the Inception pool3 extractor, and the statistics
accumulate as a running sum, outer-product sum and count in fp64 on the
device (``FeatureStats``); one host-side ``sqrtm`` in fp64 gives the number
(``fid_from_stats``).  PNG saving is optional.

Weights: ``FID_WEIGHTS_PATH`` or ``weights_path=`` names a torchvision
``inception_v3`` or pytorch_fid ``state_dict`` (``.pth``, the same tensor
names) or the ``.npz`` of ``convert-fid-weights`` (either package's CLI;
``save_fid_weights_npz``).  Without weights,
``FidComputer`` takes a fixed-seed random-init Inception, standardized
against a fixed probe batch: its value tracks relative progress only and is
reported as ``FID_randinit_proxy``, never as ``FID``.  The random weights are
drawn with a ``torch.Generator``, so the proxy's values are not the JAX
package's.

Noise: ``evaluate_fid`` and ``evaluate_fid_30k`` take ``noise_fn(i, n)`` for
batch ``i`` of ``n`` samples (default: ``seeded_noise(seed, NOISE_DIM)``, a
``torch.Generator``), so a caller (the trainer, a parity test) chooses the
draw.

Data parallelism (``mesh``, a ``parallel.Mesh``): every rank scores its
shard of the test split, ``FeatureStats.finalize`` all-reduces the count,
the sum and the outer-product sum over the data group (JAX
``eval.py:90-100``; the ``tp`` ranks of a model group score the same rows),
and the loops count ``bs * dp`` samples a batch (JAX ``:235``, ``:283``), so
every rank stops at the same batch and returns the same FID.

Protocols: ``evaluate_fid`` is the reference's 6,000-sample eval;
``evaluate_fid_30k`` the XMC-GAN paper's FID-30K: 30,000 generated samples
(the test split cycled, fresh noise each pass) against the statistics of the
full test split.
"""

from __future__ import annotations

import os
from typing import Callable, Iterable

import numpy as np
import torch

from xmc_gan_tpu_torch.config import Config
from xmc_gan_tpu_torch.device import resolve_device, to_device
from xmc_gan_tpu_torch.models.inception import InceptionV3, preprocess
from xmc_gan_tpu_torch.ops.images import to_unit_range

__all__ = [
    "FeatureStats",
    "FidComputer",
    "fid_from_stats",
    "evaluate_fid",
    "evaluate_fid_30k",
    "load_fid_weights_npz",
    "save_fid_weights_npz",
    "seeded_noise",
]


def fid_from_stats(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray,
                   sigma2: np.ndarray) -> float:
    """Fréchet distance between two Gaussians (Heusel et al. 2017), on the
    host in fp64 (pytorch_fid's numerics)."""
    from scipy import linalg

    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * 1e-6
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


class FeatureStats:
    """Streaming mean and covariance of feature batches: the sum, the
    outer-product sum and the count, in fp64 on ``device`` (default ``cuda``);
    with ``mesh`` set (a ``parallel.Mesh``), ``finalize`` sums them over the
    ranks (a collective)."""

    def __init__(self, dim: int, device: str | torch.device | None = None):
        dev = resolve_device(device)
        self.mesh = None
        self.dim = dim
        self.n = 0
        self._sum = torch.zeros(dim, dtype=torch.float64, device=dev)
        self._outer = torch.zeros(dim, dim, dtype=torch.float64, device=dev)

    def update(self, feats) -> None:
        f = torch.as_tensor(feats).to(self._sum.device, torch.float64)
        self.n += int(f.shape[0])
        self._sum += f.sum(0)
        self._outer.addmm_(f.T, f)

    def finalize(self) -> tuple[np.ndarray, np.ndarray]:
        """(mean, covariance with ddof 1) as fp64 numpy arrays, of every
        rank's features under ``mesh``."""
        n, s, o = self.n, self._sum, self._outer
        if self.mesh is not None:
            import torch.distributed as dist

            count = torch.full((1,), n, dtype=torch.float64, device=s.device)
            s, o = s.clone(), o.clone()
            for t in (count, s, o):  # the model group's ranks hold the same features
                dist.all_reduce(t, group=self.mesh.data_group)
            n = int(count.item())
        if n < 2:
            raise ValueError(f"Need >= 2 samples for covariance, got {n}")
        s, o = s.cpu().numpy(), o.cpu().numpy()
        mu = s / n
        return mu, (o - n * np.outer(mu, mu)) / (n - 1)


def save_fid_weights_npz(variables: dict, path: str) -> None:
    """Converted variables (nested dicts of arrays: ``models.inception.
    inception_params_from_torch``, ``models.vgg.vgg19_params_from_torch``) ->
    a flat ``.npz`` of float32 arrays, '/'-joined paths in sorted key order,
    as the JAX package's ``save_fid_weights_npz`` writes it (``cli
    convert-fid-weights`` / ``convert-vgg-weights``)."""
    flat: dict[str, np.ndarray] = {}

    def walk(node: dict, prefix: str) -> None:
        for key in sorted(node):
            child = node[key]
            if isinstance(child, dict):
                walk(child, f"{prefix}{key}/")
            else:
                flat[f"{prefix}{key}"] = np.asarray(child, np.float32)

    walk(variables, "")
    np.savez(path, **flat)


def load_fid_weights_npz(path: str) -> dict:
    """A ``convert-fid-weights`` ``.npz`` ('/'-joined paths) as
    nested dicts of numpy arrays (``utils/convert.inception_state_dict_from_jax``
    takes them)."""
    tree: dict = {}
    with np.load(path) as data:
        for name in data.files:
            node = tree
            *parents, leaf = name.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[name]
    return tree


def _random_init(model: InceptionV3, seed: int) -> None:
    """Fixed-seed weights for the random-init fallback: convolutions
    ~ N(0, 1/fan_in) (the LeCun scale of the JAX package's init, not
    truncated), BatchNorm as initialized (scale 1, shift 0, running mean 0,
    variance 1)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) / fan_in ** 0.5)


class FidComputer:
    """Inception pool3 features on ``device`` (default ``cuda``) + streaming
    statistics + the final FID."""

    DIM = 2048

    def __init__(self, weights_path: str | None = None, batch_size: int = 100,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.batch_size = batch_size
        model = InceptionV3(fid_variant=True)
        weights_path = weights_path or os.environ.get("FID_WEIGHTS_PATH", "")
        self.pretrained = bool(weights_path) and os.path.isfile(weights_path)
        if self.pretrained:
            if weights_path.endswith(".npz"):
                from xmc_gan_tpu_torch.utils.convert import inception_state_dict_from_jax

                sd = inception_state_dict_from_jax(load_fid_weights_npz(weights_path))
            else:
                from xmc_gan_tpu_torch.utils.convert import load_state_dict

                sd = load_state_dict(weights_path)
            sd = {k: v for k, v in sd.items() if not k.startswith(("AuxLogits.", "fc."))}
            model.load_state_dict(sd, strict=True)
        else:
            _random_init(model, seed=2015)
        self.model = model.to(self.device, memory_format=torch.channels_last).eval()
        self._mu = self._sd = None
        if not self.pretrained:
            # random-init BN squashes activations to ~1e-4 scale, making FID
            # values vanish; standardize per dimension against a fixed probe
            # batch so relative comparisons live at a readable magnitude
            probe = torch.rand((16, 128, 128, 3), generator=torch.Generator().manual_seed(7))
            f = self.features(probe * 2 - 1)
            self._mu, self._sd = f.mean(0), f.std(0, unbiased=False).clamp_min(1e-8)

    @torch.inference_mode()
    def features(self, images) -> torch.Tensor:
        """``images``: NHWC, uint8 (the loader's) or [-1, 1] float (the
        sampler's), any spatial size -> ``[B, 2048]`` fp32 on the device."""
        x = to_unit_range(to_device(images, self.device), torch.float32).permute(0, 3, 1, 2)
        f = self.model(preprocess(x).contiguous(memory_format=torch.channels_last))
        return f if self._mu is None else (f - self._mu) / self._sd

    def stats(self) -> FeatureStats:
        return FeatureStats(self.DIM, self.device)

    def update(self, stats: FeatureStats, images) -> None:
        stats.update(self.features(images))

    def fid(self, real: FeatureStats, fake: FeatureStats) -> float:
        return fid_from_stats(*real.finalize(), *fake.finalize())


def seeded_noise(seed: int, noise_dim: int) -> Callable[[int, int], torch.Tensor]:
    """``noise_fn(i, n)``: ``n`` draws of ``N(0, 1)^noise_dim`` from a CPU
    ``torch.Generator`` seeded with ``seed``, batch after batch."""
    gen = torch.Generator().manual_seed(seed)
    return lambda i, n: torch.randn(n, noise_dim, generator=gen)


def _stats_pair(fid, mesh) -> tuple[FeatureStats, FeatureStats]:
    """Real and fake statistics, summed over ``mesh``'s ranks when finalized."""
    real, fake = fid.stats(), fid.stats()
    if mesh is not None:
        real.mesh = fake.mesh = mesh
    return real, fake


def _sampler(cfg: Config, g, sample_fn: Callable | None) -> Callable:
    if sample_fn is not None:
        return sample_fn
    from xmc_gan_tpu_torch.train import make_sample_fn

    return make_sample_fn(cfg, g)


def evaluate_fid(cfg: Config, g, encode_fn: Callable, test_loader: Iterable, *,
                 num_samples: int = 6000, seed: int = 0, save_dir: str | None = None,
                 org_dir: str | None = None, fid: FidComputer | None = None,
                 sample_fn: Callable | None = None,
                 noise_fn: Callable[[int, int], torch.Tensor] | None = None,
                 mesh=None) -> float:
    """The reference eval loop (``train_gan.py:338-396``) without the disk
    round trip: per test batch, noise -> G -> features; the real images
    stream through the same extractor.  ``g`` is the generator module (its
    own dtype and device); ``save_dir``/``org_dir`` keep the reference's
    per-key PNGs; ``mesh``: one data-parallel rank's part (module
    docstring)."""
    from xmc_gan_tpu_torch.utils.miscc import save_images

    fid = fid or FidComputer()
    sample = _sampler(cfg, g, sample_fn)
    noise_fn = noise_fn or seeded_noise(seed, cfg.TRAIN.NOISE_DIM)
    real_stats, fake_stats = _stats_pair(fid, mesh)
    world = 1 if mesh is None else mesh.dp
    done = 0
    for i, batch in enumerate(test_loader):
        words, sent, mask = encode_fn(batch)
        bs = sent.shape[0]
        fake = sample(noise_fn(i, bs), sent, words, mask)
        fid.update(fake_stats, fake)
        fid.update(real_stats, batch["imgs"])
        if save_dir:
            save_images(fake.float().cpu().numpy(), batch["keys"], save_dir)
        if org_dir:
            save_images(np.asarray(batch["imgs"]), batch["keys"], org_dir)
        done += bs * world
        if done >= num_samples:  # reference stops at 6000 (train_gan.py:386-387)
            break
    return fid.fid(real_stats, fake_stats)


def evaluate_fid_30k(cfg: Config, g, encode_fn: Callable, test_loader: Iterable, *,
                     num_samples: int = 30000, seed: int = 0, fid: FidComputer | None = None,
                     sample_fn: Callable | None = None,
                     noise_fn: Callable[[int, int], torch.Tensor] | None = None,
                     mesh=None) -> float:
    """XMC-GAN paper protocol: FID over ``num_samples`` generated samples
    against the statistics of the *full* test split.  The split is cycled
    (captions repeat across passes, fresh noise for every batch); the real
    statistics accumulate during the first pass only.  ``mesh`` as in
    ``evaluate_fid``."""
    fid = fid or FidComputer()
    sample = _sampler(cfg, g, sample_fn)
    noise_fn = noise_fn or seeded_noise(seed, cfg.TRAIN.NOISE_DIM)
    real_stats, fake_stats = _stats_pair(fid, mesh)
    world = 1 if mesh is None else mesh.dp
    done = i = 0
    first_pass = True
    while done < num_samples:
        saw_batch = False
        for batch in test_loader:
            saw_batch = True
            words, sent, mask = encode_fn(batch)
            bs = sent.shape[0]
            fid.update(fake_stats, sample(noise_fn(i, bs), sent, words, mask))
            i += 1
            if first_pass:
                fid.update(real_stats, batch["imgs"])
            done += bs * world
            if done >= num_samples:
                break
        if not saw_batch:
            raise ValueError("empty test loader")
        first_pass = False
    return fid.fid(real_stats, fake_stats)
